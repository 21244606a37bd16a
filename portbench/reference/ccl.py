"""Connected components of the range image for the reference: label
propagation with pointer jumping over the 4-connected graph whose edges are
``conn_right [R, H]`` (column c to c + 1, circular) and ``conn_up [R-1, H]``
(row r to r + 1).  Every label starts at its own flat index and only falls,
so at the fixpoint each component carries its smallest flat index: the
labels the program's CCL defines."""

from __future__ import annotations

import torch


def ccl_labels(conn_right: torch.Tensor, conn_up: torch.Tensor) -> torch.Tensor:
    """Component-minimum flat-index labels [R, H] int32."""
    R, H = conn_right.shape
    idx = torch.arange(R * H, device=conn_right.device).reshape(R, H)
    a = torch.cat([idx[conn_right], idx[:-1][conn_up]])
    b = torch.cat([torch.roll(idx, -1, dims=1)[conn_right], idx[1:][conn_up]])
    lab = idx.reshape(-1).clone()
    while True:
        m = torch.minimum(lab[a], lab[b])
        new = lab.clone()
        new.scatter_reduce_(0, a, m, "amin")
        new.scatter_reduce_(0, b, m, "amin")
        while True:
            jumped = new[new]
            if torch.equal(jumped, new):
                break
            new = jumped
        if torch.equal(new, lab):
            return lab.reshape(R, H).to(torch.int32)
        lab = new

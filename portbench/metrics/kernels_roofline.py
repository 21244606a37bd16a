"""The four kernels' share of their roofline (%) over the traced stretch:
the summed least time of every launch replayed there (``roofline.py``:
bytes at 3.35 TB/s or operations at 67 TFLOP/s, counted from the shapes
each launch was captured with) over the kernels' summed device time."""


def read(record):
    tr = record["trace"]
    bound = sum(record["kernel_bound_s"].values())
    if not tr or not tr["port_kernel_s"] or not bound:
        return None
    return 100.0 * bound / tr["port_kernel_s"]

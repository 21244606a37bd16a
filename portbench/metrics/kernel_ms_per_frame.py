"""Device milliseconds per frame in the program's own CUDA kernels
(``csrc/ccl.cu``, ``nn1.cu``, ``nn.cu``, ``gn.cu``, by their kernels'
names) over the traced frames."""


def read(record):
    tr, chunk = record["trace"], record["chunk"]
    frames = len(record["traced_attempt"]) * chunk
    return tr["port_kernel_s"] / frames * 1e3 if tr and frames and tr["port_kernel_s"] else None

"""Host synchronisations per frame: the runtime calls that block the host
until the device catches up (``cudaStreamSynchronize``, ``cudaMemcpy``, ...)
that start inside the traced frames' spans, over those frames."""


def read(record):
    tr, chunk = record["trace"], record["chunk"]
    frames = len(record["traced_attempt"]) * chunk
    return tr["syncs_in_frames"] / frames if tr and frames else None

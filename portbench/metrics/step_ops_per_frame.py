"""Device operations per frame (kernels, copies, fills) on the traced
frames that ran no loop attempt, averaged."""


def read(record):
    tr, chunk = record["trace"], record["chunk"]
    if not tr:
        return None
    ops = [o for o, a in zip(tr["frame_ops"], record["traced_attempt"]) if not a]
    return sum(ops) / (len(ops) * chunk) if ops else None

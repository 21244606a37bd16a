"""Device busy milliseconds per frame on the traced frames that ran no
loop attempt: the summed time of the device operations that start inside
each such call's span, over its frames, averaged."""


def read(record):
    tr, chunk = record["trace"], record["chunk"]
    if not tr:
        return None
    busy = [b for b, a in zip(tr["frame_busy_s"], record["traced_attempt"]) if not a]
    return sum(busy) / (len(busy) * chunk) * 1e3 if busy else None

"""Frames per second of the calls made before the profiler first started
(it slows the host from then on): their frames over the sum of their
latencies, hand-over to pose on the host.  The window's ``fps`` measured in
a traced run, for the cells where ``fps`` is not an end-to-end metric."""


def read(record):
    w = record["window"]
    n = s = 0
    for (session, k), t, c in zip(w.calls, w.latency_s, w.clean):
        if c:
            n += record["chunk"]
            s += t
    return n / s if s > 0 else None

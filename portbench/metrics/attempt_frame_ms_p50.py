"""Median latency (ms, hand-over to pose on the host) of the window's
frames after which a loop attempt ran (the loop graph replayed), before
the profiler first started (it slows the host from then on); None where
the feed hands over chunks or no attempt ran."""

import numpy as np


def read(record):
    w = record["window"]
    if record["chunk"] != 1:
        return None
    lat = [t for t, a, c in zip(w.latency_s, w.attempt, w.clean) if a and c]
    return float(np.median(lat)) * 1e3 if lat else None

"""Host milliseconds per frame inside ``SlamPipeline.process`` on the
frames that make no host read (no loop attempt, no capacity or overflow
check): the call returns once the frame's work is queued, so this is the
host's cost of driving the device.  The median over the window's frames
before the profiler first started (it slows the host's calls from then
on); None where the feed hands over chunks, whose call ends in a read."""

import numpy as np


def read(record):
    w = record["window"]
    if record["chunk"] != 1:
        return None
    every = record["host_check_every"]
    t = [e for (s, k), e, a, c in zip(w.calls, w.enqueue_s, w.attempt, w.clean)
         if c and not a and all((k + 1) % n for n in every)]
    return float(np.median(t)) * 1e3 if t else None

"""The device's idle share over the traced stretch: 1 - the device's busy
time (the union of its operations) over the traced window's length, both
from the profiler's trace (``profread.py``).  The window runs under the
profiler, whose cost on the host is part of what this reads.  None where
nothing was traced."""


def read(record):
    tr = record["trace"]
    if not tr or tr["window_s"] <= 0:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]

"""Seconds the program spent warming up and capturing its CUDA graphs in
the run's set-up: ``StepGraphs.capture_seconds`` plus, where the mix
closes loops, ``LoopAttemptGraph.capture_seconds``."""


def read(record):
    return record["capture_s"] or None

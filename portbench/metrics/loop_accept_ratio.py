"""Loops accepted per loop attempt over the window's drives: each drive's
loop factors held (``graph.loop_count``) and those accepted once the graph
was full (``graph.loop_overflow``: refused at ``max_loop_factors``), over
its attempts (``loop_attempts``), all read from the program's state at the
drive's end and summed over drives."""


def read(record):
    sessions = record["window"].sessions
    attempts = sum(s[1] for s in sessions)
    return sum(s[2] + s[3] for s in sessions) / attempts if attempts else None

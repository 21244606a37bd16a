"""The readings that the check's limits are set from, for one cell: over
many seeds, the numbers a sound run of the program gives (program against
reference) and those the control gives (the reference computed in TF32, in
the program's place, against the reference in float32), in one process.

Usage, on a machine with the cell's card::

    python3 portbench/control.py --workload <cell> --seconds <s> \\
        --seeds 11 12 13 ... [--control-seeds 3] [--out FILE]

Each seed is a run of ``run.py`` with a window of ``--seconds`` (long
enough to finish the first drive, whose frames the check samples); the
control reads at the same sampled frames, from the same states of the
program, on the first ``--control-seeds`` seeds, and is judged by the
cell's committed limits (``cells/<cell>.json``) as a run would be: it has
to come out not correct.  Prints one JSON object (also written to
``--out``): each seed's numbers and verdicts, per number the largest sound
reading and the smallest control reading, and the control's verdicts.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import check  # noqa: E402
import manifest  # noqa: E402
import run  # noqa: E402

NUMBERS = ("start_gap_m", "step_gap_m", "last_gap_m", "kf_gap_m", "discrete_diff")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    limits = manifest.cell(args.workload).plan["check"]["limits"]

    plain = check.compare
    taken = {}

    def both(ref, start, steps, step_frames=0):
        sound = plain(ref, start, steps, step_frames)
        taken["sound"] = sound
        if taken["with_control"]:
            ctl = check.Reference(ref.cfg, ref.points, ref.mask, ref.feed, ref.device,
                                  control=True)
            taken["control"] = plain(ctl, start, steps, step_frames)
            taken["control_correct"] = check.judge(taken["control"], limits)[0]
        return sound

    check.compare = both
    rows = []
    for i, seed in enumerate(args.seeds):
        taken.clear()
        taken["with_control"] = i < args.control_seeds
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = run.main(["--workload", args.workload, "--seed", str(seed),
                           "--seconds", str(args.seconds), "--trace", "0"])
        line = json.loads(buf.getvalue().strip().splitlines()[-1]) if rc == 0 else None
        rows.append(dict(seed=seed, rc=rc, correct=line and line["correct"],
                         metrics=line and line["metrics"],
                         sound=taken.get("sound"), control=taken.get("control"),
                         control_correct=taken.get("control_correct")))
        print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    summary = {}
    for k in NUMBERS:
        s = [r["sound"][k] for r in rows if r["sound"]]
        c = [r["control"][k] for r in rows if r["control"]]
        summary[k] = dict(sound_max=max(s) if s else None, control_min=min(c) if c else None,
                          sound=s, control=c)
    summary["control_correct"] = [r["control_correct"] for r in rows if r["control"]]
    out = dict(workload=args.workload, seconds=args.seconds, limits=limits, rows=rows,
               summary=summary)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())

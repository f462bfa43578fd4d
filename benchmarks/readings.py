"""The readings that the limits of ``correct`` are set from.

    python3 benchmarks/readings.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--seconds 3]

In one process on the card: for each seed, the cell's run at its own size
and load with a short window, judged as a run judges it (one JSON line of
the compared numbers); for each control seed, the same with the control
(the reference in bfloat16) in the program's place. The last line holds,
for each number, the largest reading of the program's seeds (the lower
reading) and the smallest of the control's (the upper one).
"""

import argparse
import json
import sys
import time
from pathlib import Path

if not __package__:
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from benchmarks import harness  # noqa: E402


def reading(cell, seed, seconds, control):
    runner = harness.runner_for(cell, "cuda")
    runner.set_seed(seed)
    runner.setup()
    e2e = runner.window(seconds)
    runner.release()
    t0 = time.perf_counter()
    numbers = runner.judge(control=control)
    return dict(seed=seed, control=control, judge_s=time.perf_counter() - t0, **e2e, **numbers)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    rows = []
    for seeds, control in ((args.seeds, False), (args.control_seeds, True)):
        for seed in (int(s) for s in seeds.split(",")):
            rows.append(reading(cell, seed, args.seconds, control))
            print(json.dumps(rows[-1]), flush=True)
    names = [k for k in rows[0] if k not in ("seed", "control", "judge_s")]
    print(json.dumps({"workload": args.workload, "lower": {
        k: max(r[k] for r in rows if not r["control"]) for k in names}, "upper": {
        k: min(r[k] for r in rows if r["control"]) for k in names}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

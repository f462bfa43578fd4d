"""Run one cell of the benchmark and print its result line.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(also ``python3 -m benchmarks.run``), from the repository's root, on a
machine with as many CUDA cards as the cell asks for; it exits with 2 and
prints no result on one without. One run: the cell's inputs from the
seed, the program built and warmed up on them (``setup_s``, from process
start), a window of ``--seconds`` (the end-to-end metrics), with
``--trace 1`` a traced stretch after it (the per-layer metrics instead),
then the comparison with the plain reference. Standard error ends with one
line per compared number beside its limit; standard output ends with the
result line, one JSON object whose last key, ``checks``, holds the same.
It exits with 3 and prints no result when a module of JAX or of the JAX
package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if not __package__:  # run as a file: import from the repository's root
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from benchmarks import harness  # noqa: E402


def _finite(v):
    return v if isinstance(v, (int, bool)) or (isinstance(v, float) and math.isfinite(v)) \
        else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        c["value"] = _finite(c["value"])
        ok = c["value"] is not None and c["value"] <= c["limit"]
        print(f"check {name} {c['value']} limit {c['limit']} {'ok' if ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

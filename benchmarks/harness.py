"""One run of one cell: find its files by name, set up, measure, trace,
judge, and assemble the result line.

Everything that belongs to one cell is found by the names in
``BENCHMARK.json``:

- the configuration: the ``file`` of its entry under ``configs``;
- the traffic mix: ``benchmarks/traffic/<traffic>.json``; its ``kind``
  names its runner, ``benchmarks/kinds/<kind>.py``;
- the limits of the comparison: ``benchmarks/limits/<cell>.json``;
- each per-layer metric: ``benchmarks/metrics/<metric>.py``, whose
  ``read(ctx)`` returns the value or None when it finds nothing to read.

A runner makes the run's inputs from the seed (``set_seed``), builds and
warms up the program on them (``setup``), measures a window
(``window(seconds)`` -> the end-to-end values), traces a stretch of the
same calls (``traced()`` -> the per-layer readers' context), drops what
it holds of the program (``release``) and compares a sample of the
window's solves with the plain reference (``judge()`` -> the numbers).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ilqr_tpu")  # top-level module names


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict  # the configuration's file
    traffic: dict
    limits: dict
    end_to_end: list  # BENCHMARK.json's metric entries that this cell reports
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``/BENCHMARK.json and its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(work)}")
    w = work[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=json.loads((root / cfg["file"]).read_text()),
        traffic=json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((HERE / "limits" / f"{name}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def runner_for(cell: Cell, device: str):
    mod = importlib.import_module(f"benchmarks.kinds.{cell.traffic['kind']}")
    return mod.Runner(cell, device)


def reader(metric: str):
    """``read`` of ``benchmarks/metrics/<metric>.py`` (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"benchmarks_metric_{metric}",
                                                  HERE / "metrics" / f"{metric}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout
        return out.strip().splitlines()[0].strip()
    except (OSError, IndexError, subprocess.SubprocessError):
        return None


def checks_of(numbers: dict, limits: dict) -> dict:
    """Each compared number beside its limit; a number above its limit, or
    one that is not a number, fails."""
    out = {}
    for name, limit in limits.items():
        value = numbers.get(name, float("nan"))
        out[name] = {"value": value, "limit": limit, "ok": bool(value <= limit)}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: Optional[float] = None, control: bool = False) -> dict:
    """One run; returns the result line's dict (``checks`` last). ``control``
    puts the bfloat16 reference in the program's place for the judged
    answers (the check's own test of itself; no benchmark run sets it)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    runner = runner_for(cell, device)
    runner.set_seed(seed)
    runner.setup()
    setup_s = time.perf_counter() - t_start
    e2e = runner.window(seconds)
    ctx = runner.traced() if trace else None
    cuda = device == "cuda"
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell.chips if cuda else 1,
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if cuda else 0}
    if cuda:
        device_info["card"] = card_line()
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = ctx.trace.busy_s
        device_info["window_s"] = ctx.trace.window_s
    else:
        values = dict(e2e, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    attempted = runner.attempted
    runner.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = runner.judge(control=control)
    checks = checks_of(numbers, cell.limits)
    line = {"correct": all(c["ok"] for c in checks.values()), "attempted": attempted,
            "failed": 0, "metrics": metrics, "device": device_info}
    if trace:
        line["breakdown"] = ctx.trace.breakdown()
    line["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    return line

"""Steps of a sweep of cold solves: each call hands a batch of host-side
starts to the parallel layer (``shard_batch`` over a one-card mesh), solves
it cold through ``sharded_kernel_solve_fn`` and copies the all-reduced
summary to the host in one copy, as ``apps/sweep.py`` steps. Starts cycle
through the run's pool; the agents' predictions are those of tick ``tick``.

Traffic keys: ``batch``, ``pool``, ``tick``, ``window``, ``w_back``,
``straggler_cap``, ``keep_rows`` (rows of each step kept for the
comparison), ``sample``, ``trace_calls`` (steps traced).

End to end: ``cold_solves_per_s``, batch x steps over the summed step
time, and ``cold_step_ms_p95``, the 95th percentile of every step's time.
Judged: a sample of (step, row) solves against the reference, and every
step's summary against the sums of that step's own per-row stats
(``summary_gap``, exact).
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmarks import tracing
from benchmarks.kinds import Base
from benchmarks.reference.judge import Answers, Tasks, compare, control_answers

SUMS = ("num_solves", "converged", "lamb_overflow", "total_iters")


class Runner(Base):
    kind = "cold_sweep"

    def __init__(self, cell, device):
        super().__init__(cell, device)
        t = int(self.tr["tick"])
        self.obs = self.obs[:, t:t + self.N + 1]

    def setup(self) -> None:
        from torch.profiler import record_function

        from ilqr_tpu_torch.parallel import make_mesh, shard_batch
        from ilqr_tpu_torch.parallel.sharding import replicate, sharded_kernel_solve_fn
        from ilqr_tpu_torch.types import Scenario

        cfg, w = self.program(False, device="cpu")
        mesh = make_mesh(1) if self.device.type == "cuda" else make_mesh(1, [self.device])
        B = self.B
        fn = sharded_kernel_solve_fn(mesh, cfg, window=self.W,
                                     straggler_cap=self.tr["straggler_cap"],
                                     proj_rows_per_step=self.rows, w_back=self.w_back)
        w_d = replicate(mesh, w)
        # the scenario is the same every step: placed once, as views of one
        # copy on the card, as apps/sweep.py places it
        dev = mesh.devices[0]
        scen = shard_batch(mesh, Scenario(
            ref_line=self.line.to(dev)[None].expand(B, -1, -1),
            ref_velo=self.ref_velo.to(dev).expand(B),
            obs_preds=self.obs.to(dev)[None].expand(B, -1, -1, -1),
            road_borders=self.road.to(dev).expand(B, 2)))

        def call(j):
            with record_function("bench.shard_batch"):
                x0 = shard_batch(mesh, self.pool[j % len(self.pool)])
            with record_function("bench.solve"):
                u, x, stats, summary = fn(w_d, x0, scen)
            with record_function("bench.summary"):
                summary = dict(zip(summary, torch.stack(list(summary.values())).tolist()))
            return u, x, stats, summary

        self.call = call
        call(0)  # builds the kernel
        self.sync()

    def window(self, seconds: float) -> dict:
        self.times, self.kept = [], []
        t0 = time.perf_counter()
        while not self.times or time.perf_counter() - t0 < seconds:
            a = time.perf_counter()
            out = self.call(len(self.times))
            self.times.append(time.perf_counter() - a)
            self.kept.append(self._keep(out, len(self.kept)))
        steps = len(self.times)
        self.attempted = steps * self.B
        return {"cold_solves_per_s": self.attempted / sum(self.times),
                "cold_step_ms_p95": float(np.percentile(self.times, 95)) * 1e3}

    def _keep(self, out, j):
        u, x, stats, summary = out
        rows = torch.as_tensor(self.rng(1, j).choice(self.B, int(self.tr["keep_rows"]),
                                                     replace=False), device=u.device)
        sums = torch.stack([torch.tensor(float(stats.iters.shape[0]), dtype=torch.float64,
                                         device=u.device),
                            stats.converged.double().sum(), stats.lamb_overflow.double().sum(),
                            stats.iters.double().sum()])
        return (rows, u[rows], x[rows], stats.iters[rows], stats.status[rows], sums,
                torch.tensor([summary[k] for k in SUMS], dtype=torch.float64))

    def traced(self):
        n = int(self.tr["trace_calls"])
        outs = []
        first = len(self.times)
        calls = [lambda j=j: outs.append(self.call(first + j)) for j in range(n)]
        tr = tracing.profile(calls, "step", self.sync)
        solves = [self.solve_shape(float(o[2].iters.double().sum())) for o in outs]
        return SimpleNamespace(kind=self.kind, trace=tr, calls=n, ticks=1, solves=solves)

    def release(self) -> None:
        self.kept = [tuple(t.cpu() for t in k) for k in self.kept]
        self.call = None

    def judge(self, control: bool = False) -> dict:
        k = self.kept[0][0].shape[0]
        total = len(self.kept) * k
        S = min(int(self.tr["sample"]), total)
        picks = [divmod(f, k) for f in self.rng(2).choice(total, S, replace=False).tolist()]
        x0 = torch.stack([self.pool[j % len(self.pool)][self.kept[j][0][r]] for j, r in picks])
        tasks = Tasks(x0, torch.zeros(S, self.N, 2, dtype=x0.dtype),
                      self.obs[None].expand(S, -1, -1, -1))
        answers = Answers(*(torch.stack([self.kept[j][f][r] for j, r in picks])
                            for f in (1, 2, 3, 4)))
        if control:
            answers = control_answers(self.params, self.setting(), tasks, self.device)
        numbers = compare(self.params, self.setting(), tasks, answers, self.device)
        numbers["summary_gap"] = max(float((k[5] - k[6]).abs().max()) for k in self.kept)
        return numbers

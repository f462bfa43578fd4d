"""Closed-loop MPC episodes: each call runs one receding-horizon episode of
the whole batch through ``run_mpc_kernel_chunked`` (the episode packed
once, each chunk of ticks a CUDA-graph replay with the carry on the
device), and the next call starts when it has returned. Starts cycle
through the run's pool.

The episode runs the scenario's ticks. Traffic keys: ``batch``, ``pool``,
``chunk``, ``window``, ``w_back``, ``straggler_cap``, ``warm_start`` (the
shifted-u warm start between ticks), ``keep_rows`` (rows of each episode
kept for the comparison), ``sample`` (solves drawn for the comparison),
``trace_calls`` (episodes traced).

End to end: ``mpc_solves_per_s``, batch x ticks of every episode begun in
the window over the time from the window's start to the end of the last
of them. Judged: a sample of (episode, row, tick) solves, each from the
ego state and the shifted controls the program had at that tick, so the
reference follows the program tick by tick from its own state. In a warm
episode, tick t - 1 of the same episode and row is judged beside each
drawn tick t > 0, so every warm start handed to the reference is itself a
judged answer. The advance of the ego (the state the tick returned next)
and the episodes' starts are checked by themselves.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import torch

from benchmarks import tracing
from benchmarks.kinds import Base
from benchmarks.reference.judge import Answers, Tasks, compare, control_answers


class Runner(Base):
    kind = "mpc_episodes"

    def __init__(self, cell, device):
        super().__init__(cell, device)
        self.ticks = self.scene.ticks
        self.warm = bool(self.tr["warm_start"])
        self.obs = self.obs[:, :self.ticks + self.N + 1]

    def setup(self) -> None:
        from ilqr_tpu_torch.sim.mpc import run_mpc_kernel_chunked

        cfg, w = self.program(self.warm)
        dev, B = self.device, self.B
        line = self.line.to(dev)[None].expand(B, -1, -1)
        ref_velo = self.ref_velo.to(dev).expand(B)
        obs = self.obs.to(dev)[None].expand(B, -1, -1, -1)
        road = self.road.to(dev).expand(B, 2)
        self.starts = [x.to(dev) for x in self.pool]
        tr = self.tr

        def call(j):
            return run_mpc_kernel_chunked(
                cfg, w, self.starts[j % len(self.starts)], line, ref_velo, obs, road,
                self.ticks, chunk=int(tr["chunk"]), window=self.W,
                straggler_cap=tr["straggler_cap"], proj_rows_per_step=self.rows,
                w_back=self.w_back)

        self.call = call
        call(0)  # builds the kernel and captures the episode's graphs
        self.sync()

    def window(self, seconds: float) -> dict:
        self.times, self.kept = [], []
        t0 = time.perf_counter()
        end = t0
        while not self.times or end - t0 < seconds:
            a = time.perf_counter()
            out = self.call(len(self.times))
            self.sync()
            end = time.perf_counter()
            self.times.append(end - a)
            self.kept.append(self._keep(out, len(self.kept)))
        episodes = len(self.times)
        self.attempted = episodes * self.B * self.ticks
        return {"mpc_solves_per_s": self.attempted / (end - t0)}

    def _keep(self, out, e):
        ego, u, stats = out
        rows = torch.as_tensor(self.rng(1, e).choice(self.B, int(self.tr["keep_rows"]),
                                                     replace=False), device=self.device)
        return (rows, ego[:, rows], u[:, rows], stats.iters[:, rows], stats.status[:, rows])

    def traced(self):
        n = int(self.tr["trace_calls"])
        outs = []
        first = len(self.times)
        calls = [lambda j=j: outs.append(self.call(first + j)) for j in range(n)]
        tr = tracing.profile(calls, "episode", self.sync)
        per_tick = torch.stack([o[2].iters.sum(1) for o in outs]).double().cpu()
        solves = [self.solve_shape(float(i)) for i in per_tick.flatten()]
        return SimpleNamespace(kind=self.kind, trace=tr, calls=n, ticks=self.ticks, solves=solves)

    def release(self) -> None:
        self.kept = [tuple(t.cpu() for t in k) for k in self.kept]
        self.starts = self.call = None

    def judge(self, control: bool = False) -> dict:
        N, T = self.N, self.ticks
        k = self.kept[0][0].shape[0]
        total = len(self.kept) * k * T
        S = min(int(self.tr["sample"]), total)
        picks = {(f // T, f % T) for f in self.rng(2).choice(total, S, replace=False).tolist()}
        if self.warm:  # the tick whose controls warm-start each drawn tick
            picks |= {(er, t - 1) for er, t in picks if t > 0}
        x0, u0, obs, u, x, iters, status = [], [], [], [], [], [], []
        for er, t in sorted(picks):
            e, r = divmod(er, k)
            _, ego, us, it, st = self.kept[e]
            x0.append(ego[t, r])
            prev = us[t - 1, r] if self.warm and t > 0 else torch.zeros_like(us[t, r])
            u0.append(torch.cat([prev[1:], prev[-1:]]))
            obs.append(self.obs[:, t:t + N + 1])
            u.append(us[t, r])
            x.append(ego[t:t + 2, r])
            iters.append(it[t, r])
            status.append(st[t, r])
        tasks = Tasks(torch.stack(x0), torch.stack(u0), torch.stack(obs))
        answers = Answers(torch.stack(u), torch.stack(x), torch.stack(iters),
                          torch.stack(status))
        if control:
            answers = control_answers(self.params, self.setting(), tasks, self.device)
        numbers = compare(self.params, self.setting(), tasks, answers, self.device)
        numbers["start_gap"] = max(
            float((ego[0] - self.pool[e % len(self.pool)][rows]).abs().max())
            for e, (rows, ego, _, _, _) in enumerate(self.kept))
        return numbers

"""A run at a CPU size with the timed path broken underneath comes out not
correct, once for each fault a cell can have: a solve that returns its
state unchanged, half of the batch left out (the sweep's summary taken
over the rest), an answer altered where it is produced. (A cell on one
chip has no exchange between chips to leave out.) The breaks go into the
port's plain solve, which its CPU path runs under every entry."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from benchmarks import harness
from benchmarks.tests.conftest import small_cell

CELLS = ["two_straight.mpc", "three_bend.mpc", "two_straight.sweep"]
SEED = 2**31 + 99


def _break(monkeypatch, how):
    from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck
    from ilqr_tpu_torch.parallel import sharding

    plain = ck.cilqr_solve_ref

    def broken(cfg, w, p, work=None, max_iter=None):
        out = plain(cfg, w, p, work=work, max_iter=max_iter)
        if how == "unchanged":
            x = p.x0[:4, None].expand(-1, cfg.N + 1, -1).contiguous()
            return out._replace(u=p.uinit.clone(), x=x, stats=torch.zeros_like(out.stats))
        if how == "half":
            half = p.x0.shape[1] // 2
            u, x, stats = out.u.clone(), out.x.clone(), out.stats.clone()
            u[..., half:], stats[:, half:] = 0, 0
            x[..., half:] = p.x0[:4, None, half:]
            return out._replace(u=u, x=x, stats=stats)
        u = out.u.clone()
        u[0] += 0.05
        return out._replace(u=u)

    monkeypatch.setattr(ck, "cilqr_solve_ref", broken)
    if how == "half":
        sums = sharding._stat_sums

        def half_sums(stats):
            n = stats.iters.shape[0] // 2
            return sums(type(stats)(**{f.name: getattr(stats, f.name)[:n]
                                       for f in dataclasses.fields(stats)}))

        monkeypatch.setattr(sharding, "_stat_sums", half_sums)


@pytest.mark.parametrize("cell", CELLS)
def test_clean_run_is_correct(cell):
    line = harness.run_cell(small_cell(cell), SEED, 0.1, False, "cpu")
    assert line["correct"] is True, line["checks"]


@pytest.mark.parametrize("how", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, how, monkeypatch):
    _break(monkeypatch, how)
    line = harness.run_cell(small_cell(cell), SEED, 0.1, False, "cpu")
    assert line["correct"] is False, line["checks"]

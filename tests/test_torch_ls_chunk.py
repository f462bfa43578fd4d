"""The chunked line search (``ls_chunk``) on the plain path, and how a
solve's modes are resolved.

Chunks of 3, 4 and 8 alphas must equal the serial line search bit for bit
(``torch.equal``) in every output, in float32 and float64, in barrier mode
and in ALM mode with compaction, duals included -- as the JAX package holds
its own chunked line search to the serial loop
(``tests/test_pallas_kernel.py::test_kernel_chunked_line_search_*``); also
over a 3-tick ``run_mpc_kernel`` episode. The CUDA kernel is held to the
same on the card (``tests/test_torch_kernel_gpu.py``, ``chip_smoke.py``).
"""

import dataclasses

import pytest
import torch

from ilqr_tpu_torch.apps.validate_kernel import CASES
from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck
from ilqr_tpu_torch.sim.mpc import run_mpc_kernel
from ilqr_tpu_torch.sim.scenario import perturbed_initial_states
from ilqr_tpu_torch.solvers.cilqr import alpha_schedule
from ilqr_tpu_torch.types import CILQRConfig, CILQRWeights

from tests.torch_parity import W_BACK, WINDOW, load_both

WIDTHS = (3, 4, 8)  # uneven, the JAX hardware default, and a last chunk past the 20 alphas


def _problem(case, dtype, B=8, max_iter=8, N=6, seed=0):
    """A cold batch of a ``CASES`` entry at the sizes of
    ``tests/test_pallas_kernel.py``."""
    name, over, wover = CASES[case]
    _, _, gc, st = load_both(name)
    cfg = dataclasses.replace(CILQRConfig.from_global_config(gc, max_iter=max_iter), N=N,
                              use_last_solution=False, **over)
    w = CILQRWeights.from_global_config(gc, dtype=dtype, device="cpu", **wover)
    x0 = torch.as_tensor(perturbed_initial_states(st.ego_x0, B, seed=seed), dtype=dtype)
    return cfg, w, x0, st.device_scenario(tick=0, horizon=N, dtype=dtype, batch=B)


def _solve(cfg, w, x0, sc, **kw):
    """``cilqr_solve_cuda`` on CPU tensors as one tuple of tensors, duals
    included in ALM mode; checks that no kernel launched."""
    before = sum(ck.launches.values())
    alm = cfg.solve_type == "alm"
    out = ck.cilqr_solve_cuda(cfg, w, x0, sc, window=WINDOW, w_back=W_BACK, return_alm=alm, **kw)
    assert sum(ck.launches.values()) == before
    return _flat(*out[:3], *(out[3] if alm else ()))


def _flat(u, x, st, *duals):
    """u, x, the six stats and the duals as one tuple of tensors."""
    return (u, x, *(getattr(st, f.name) for f in dataclasses.fields(st)), *duals)


def _assert_bitwise(a, b):
    assert len(a) == len(b)
    for i, (p, q) in enumerate(zip(a, b)):
        assert torch.equal(p, q), f"output {i} differs"


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("case", ["rear_barrier", "gravity_alm_duals_move"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_chunked_line_search_bitwise(dtype, case, width):
    """Chunks equal the serial line search in every output; the ALM case
    with compaction at (2, 5), so the duals cross a resume too."""
    cfg, w, x0, sc = _problem(case, dtype)
    kw = dict(straggler_cap=(2, 5)) if cfg.solve_type == "alm" else {}
    _assert_bitwise(_solve(cfg, w, x0, sc, ls_chunk=0, **kw),
                    _solve(cfg, w, x0, sc, ls_chunk=width, **kw))


@pytest.mark.parametrize("modes", [ck.Modes(False, 0, True), ck.Modes(True, 4, True)],
                         ids=["fold", "dot_fold_ls"])
@pytest.mark.parametrize("case", ["rear_barrier", "gravity_alm_duals_move"])
def test_fold_compaction_bitwise(case, modes):
    """With the fold on, compaction at (2, 5) equals one pass bit for bit:
    the resumed rows are projected through the fold again, on a sub-batch
    of their own."""
    cfg, w, x0, sc = _problem(case, torch.float64)
    kw = modes._asdict()
    _assert_bitwise(_solve(cfg, w, x0, sc, **kw),
                    _solve(cfg, w, x0, sc, straggler_cap=(2, 5), **kw))


def test_chunked_line_search_bitwise_main_path_dot_form():
    """The main path's cold solve (N = 30, window 384, the derived search
    bound), float32, in the card's default modes: chunks of 4 with the dot
    form equal the serial dot form."""
    _, _, gc, st = load_both("scenario_two_straight")
    cfg = CILQRConfig.from_global_config(gc)
    w = CILQRWeights.from_global_config(gc, dtype=torch.float32)
    x0 = torch.as_tensor(perturbed_initial_states(st.ego_x0, 12, seed=0), dtype=torch.float32)
    sc = st.device_scenario(tick=0, dtype=torch.float32, batch=12)
    kw = dict(window=384, w_back=24, proj_rows_per_step=ck.derive_proj_rows(8, 0.1),
              proj_dot=True)
    one = ck.cilqr_solve_cuda(cfg, w, x0, sc, ls_chunk=0, **kw)
    four = ck.cilqr_solve_cuda(cfg, w, x0, sc, ls_chunk=4, **kw)
    _assert_bitwise(_flat(*one), _flat(*four))


def test_episode_chunked_bitwise():
    """A 3-tick warm ALM ``run_mpc_kernel`` episode with chunks of 4 equals
    the serial one, tick for tick, duals included."""
    name, over, wover = CASES["gravity_alm_duals_move"]
    _, _, gc, st = load_both(name)
    cfg = dataclasses.replace(CILQRConfig.from_global_config(gc, max_iter=6), N=6,
                              use_last_solution=True, **over)
    w = CILQRWeights.from_global_config(gc, dtype=torch.float64, **wover)
    B, ticks = 3, 3
    x0 = torch.as_tensor(perturbed_initial_states(st.ego_x0, B, seed=3), dtype=torch.float64)
    sc = st.device_scenario(tick=0, dtype=torch.float64, batch=B)
    obs = torch.as_tensor(st.obs_preds_array(), dtype=torch.float64).expand(B, -1, -1, -1)
    args = (cfg, w, x0, sc.ref_line, sc.ref_velo, obs, sc.road_borders, ticks)
    runs = [run_mpc_kernel(*args, window=WINDOW, w_back=W_BACK, return_alm=True, ls_chunk=cw)
            for cw in (0, 4)]
    _assert_bitwise(*(_flat(ego, us, s, *duals) for ego, us, s, duals in runs))


def test_work_counts_a_chunks_rollouts():
    """``work["trials"]`` counts the rollouts a chunked search computes:
    for each searching row, a whole chunk (cut at the last alpha) per chunk
    it enters; ``work["evals"]`` the trials projected and costed, which the
    serial search counts as its trials. One iteration per solve, so each
    row's count follows from its own serial search."""
    cfg, w, x0, sc = _problem("rear_barrier", torch.float64, B=6, max_iter=1)
    n_alphas = len(alpha_schedule(cfg.min_alpha))

    def work(rows, ls_chunk):
        out = {}
        part = dataclasses.replace(sc, ref_line=sc.ref_line[rows], ref_velo=sc.ref_velo[rows],
                                   obs_preds=sc.obs_preds[rows],
                                   road_borders=sc.road_borders[rows])
        p = ck.pack_problem(cfg, x0[rows], part, WINDOW, w_back=W_BACK,
                            modes=ck.Modes(ls_chunk=ls_chunk))
        ck.cilqr_solve_ref(cfg, w, p, work=out)
        return out

    for width in WIDTHS:
        want = 0
        for row in range(6):
            serial = work([row], 0)
            assert serial["trials"] == serial["evals"]
            chunks = -(-serial["evals"] // width)
            want += min(chunks * width, n_alphas)
        got = work(list(range(6)), width)
        assert got["evals"] == work(list(range(6)), 0)["evals"]
        assert got["trials"] == want


def test_resolve_modes():
    """None resolves as ``cilqr_solve_pallas`` resolves it: the interpret-
    mode defaults for CPU tensors, the hardware ones for CUDA tensors, the
    ``ILQR_*`` variables over both, a given value over everything; an
    unknown value or a width outside [0, 8] raises."""
    assert ck.resolve_modes("cpu", env={}) == ck.Modes(False, 0, False)
    assert ck.resolve_modes("cuda", env={}) == ck.Modes(True, 4, False)
    assert ck.resolve_modes(torch.device("cuda", 0), env={}) == ck.Modes(True, 4, False)
    env = {"ILQR_PROJ_DOT": "0", "ILQR_LS_CHUNK": "8", "ILQR_PROJ_FOLD": "1"}
    assert ck.resolve_modes("cuda", env=env) == ck.Modes(False, 8, True)
    assert ck.resolve_modes("cpu", env={"ILQR_PROJ_DOT": "1"}) == ck.Modes(True, 0, False)
    assert ck.resolve_modes("cuda", True, 0, False, env=env) == ck.Modes(True, 0, False)
    for bad in ({"ILQR_LS_CHUNK": "9"}, {"ILQR_LS_CHUNK": "-1"}, {"ILQR_LS_CHUNK": "four"},
                {"ILQR_PROJ_DOT": "yes"}, {"ILQR_PROJ_FOLD": "2"}):
        with pytest.raises(ValueError):
            ck.resolve_modes("cuda", env=bad)
    for bad in (dict(ls_chunk=9), dict(ls_chunk=-1), dict(ls_chunk=2.0), dict(ls_chunk=True),
                dict(proj_dot="1"), dict(proj_fold=2)):
        with pytest.raises(ValueError):
            ck.resolve_modes("cuda", env={}, **bad)


def test_modes_name_the_variant_and_are_checked(monkeypatch):
    """A mode on adds its suffix to the variant's name; the kernel's input
    checks refuse a mode it lacks, so a CUDA tensor never falls back; with
    no variable set, a CPU solve runs all modes off."""
    cfg, w, x0, sc = _problem("gravity_barrier", torch.float32, B=2)
    assert ck.variant(cfg, torch.float32, ck.Modes(True, 4, False)) == \
        "cilqr_solve_f32_gravity_barrier_dot_ls"
    assert ck.variant(cfg, torch.float64, ck.Modes(True, 0, True)) == \
        "cilqr_solve_f64_gravity_barrier_dot_fold"
    # one instantiation runs every mode: the modes are runtime arguments
    assert ck.instantiation(cfg, torch.float32, ck.Modes(True, 3, True)) == ("f32", True, False)
    p = ck.pack_problem(cfg, x0, sc, WINDOW, w_back=W_BACK)
    assert p.modes == ck.Modes()
    for bad in (ck.Modes(ls_chunk=9), ck.Modes(proj_dot=2)):
        with pytest.raises(ValueError):
            ck.check_packed(cfg, dataclasses.replace(p, modes=bad))
        with pytest.raises(ValueError):
            ck.cilqr_solve_kernel(cfg, w, dataclasses.replace(p, modes=bad))
    for var in ("ILQR_PROJ_DOT", "ILQR_LS_CHUNK", "ILQR_PROJ_FOLD"):
        monkeypatch.delenv(var, raising=False)
    calls = []
    ref = ck.cilqr_solve_ref
    monkeypatch.setattr(ck, "cilqr_solve_ref", lambda cfg, w, p, **kw: (
        calls.append(p.modes), ref(cfg, w, p, **kw))[1])
    ck.cilqr_solve_cuda(cfg, w, x0, sc, window=WINDOW, w_back=W_BACK)
    monkeypatch.setenv("ILQR_LS_CHUNK", "3")
    ck.cilqr_solve_cuda(cfg, w, x0, sc, window=WINDOW, w_back=W_BACK, proj_fold=True)
    assert calls == [ck.Modes(), ck.Modes(False, 3, True)]

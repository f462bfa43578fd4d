"""The fused solve's projection modes on the plain path, against ``ilqr_tpu``.

On CPU tensors ``cilqr_solve_cuda`` runs its plain version, which carries
the CUDA kernel's projection modes: the centred dot-form score
(``proj_dot``) and the pair-fold tournament (``proj_fold``). Held here to
the JAX package's Pallas kernel in interpret mode in the same modes, with
chunks of 4 alphas (``ls_chunk=4``, the JAX package's hardware default), on
the small problem of ``tests/test_pallas_kernel.py``: scenario_two_straight,
N = 6, max_iter 8, 8 rows, float32, window 256, w_back 64 on both sides.
Bars (those of ``test_kernel_matches_xla_solver``): equal iterations and
statuses, u and x within 1e-4, the final cost within rtol 1e-4.

Port-only checks mirror the JAX package's own: the fold alone against the
squared distance, the dot form far from the origin, and the fold's
tie-breaking on crafted ties.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.ops.pallas.cilqr_kernel import cilqr_solve_pallas
from ilqr_tpu.types import CILQRConfig as JaxConfig
from ilqr_tpu.types import CILQRWeights as JaxWeights
from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck
from ilqr_tpu_torch.ops.projection import Modes, fold_argmin, nearest_ref_points
from ilqr_tpu_torch.sim.scenario import perturbed_initial_states
from ilqr_tpu_torch.types import Scenario

from tests.torch_parity import load_both, port_config, port_weights

WINDOW, W_BACK = 256, 64  # the JAX kernel test's window and cilqr_solve_pallas's w_back
SHIFT = (12345.0, -6789.0)  # metres: the JAX translation-invariance test's offset
JAX_MODES = {"dot": dict(proj_dot=True), "dot_fold": dict(proj_dot=True, proj_fold=True)}


@pytest.fixture(scope="module")
def small_f32():
    """The JAX kernel test's small problem in both packages, float32."""
    jgc, jst, _, st = load_both("scenario_two_straight")
    jcfg = dataclasses.replace(JaxConfig.from_global_config(jgc, max_iter=8), N=6)
    jw = JaxWeights.from_global_config(jgc, dtype=jnp.float32)
    B = 8
    x0 = perturbed_initial_states(jst.ego_x0, B, seed=0)
    jsc = jax.tree.map(lambda a: jnp.stack([a] * B),
                       jst.device_scenario(tick=0, horizon=jcfg.N, dtype=jnp.float32))
    sc = st.device_scenario(tick=0, horizon=jcfg.N, dtype=torch.float32, batch=B)
    return (jcfg, jw, jnp.asarray(x0, jnp.float32), jsc, port_config(jcfg),
            port_weights(jw, torch.float32), torch.as_tensor(x0, dtype=torch.float32), sc)


@pytest.fixture(scope="module")
def jax_interpret(small_f32):
    """The Pallas kernel in interpret mode, chunks of 4, in each mode of
    ``JAX_MODES`` (one call takes tens of seconds on a CPU: made once)."""
    jcfg, jw, jx0, jsc = small_f32[:4]
    return {mode: cilqr_solve_pallas(jcfg, jw, jx0, jsc, window=WINDOW, interpret=True,
                                     w_back=W_BACK, ls_chunk=4, **kw)
            for mode, kw in JAX_MODES.items()}


def _port(small, sc=None, x0=None, **modes):
    cfg, w = small[4], small[5]
    before = sum(ck.launches.values())
    out = ck.cilqr_solve_cuda(cfg, w, small[6] if x0 is None else x0,
                              small[7] if sc is None else sc, window=WINDOW, w_back=W_BACK,
                              **modes)
    assert sum(ck.launches.values()) == before  # CPU tensors never launch the kernel
    return out


@pytest.mark.parametrize("mode", list(JAX_MODES))
def test_plain_modes_match_pallas_interpret(small_f32, jax_interpret, mode):
    ju, jx, jst = jax_interpret[mode]
    u, x, st = _port(small_f32, ls_chunk=4, **JAX_MODES[mode])
    np.testing.assert_array_equal(st.iters.numpy(), np.asarray(jst.iters))
    np.testing.assert_array_equal(st.status.numpy(), np.asarray(jst.status))
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), atol=1e-4)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-4)
    np.testing.assert_allclose(st.final_cost.numpy(), np.asarray(jst.final_cost), rtol=1e-4)


def test_fold_alone_agrees_with_squared_distance(small_f32):
    """The fold changes only how ties break, and this problem has none that
    matter (``test_kernel_proj_fold_statistical``'s fold_alone case)."""
    _, x1, st1 = _port(small_f32, proj_dot=False, proj_fold=False)
    _, x2, st2 = _port(small_f32, proj_dot=False, proj_fold=True)
    np.testing.assert_array_equal(st1.status.numpy(), st2.status.numpy())
    np.testing.assert_allclose(x1.numpy(), x2.numpy(), atol=1e-3)


def test_dot_form_translation_invariance(small_f32):
    """Far from the origin the centred dot form still agrees with the
    squared distance (``test_kernel_proj_dot_translation_invariance``):
    equal iterations and statuses on the scenario moved by (+12345,
    -6789) m."""
    sc = small_f32[7]
    shift = torch.tensor(SHIFT, dtype=torch.float32)
    ref = sc.ref_line.clone()
    ref[..., :2] += shift
    obs = sc.obs_preds.clone()
    obs[..., :2] += shift
    moved = Scenario(ref_line=ref, ref_velo=sc.ref_velo, obs_preds=obs,
                     road_borders=sc.road_borders)
    x0 = small_f32[6].clone()
    x0[:, :2] += shift
    _, x1, st1 = _port(small_f32, moved, x0, proj_dot=False)
    _, x2, st2 = _port(small_f32, moved, x0, proj_dot=True)
    np.testing.assert_array_equal(st1.status.numpy(), st2.status.numpy())
    np.testing.assert_array_equal(st1.iters.numpy(), st2.iters.numpy())
    np.testing.assert_allclose(x1.numpy(), x2.numpy(), atol=1e-2)


def _tournament(scores):
    """The JAX kernel's fold (ilqr_tpu/ops/pallas/cilqr_kernel.py:381-395)
    written out on one list: (score, row) pairs, the later one of a pair
    kept only on strict <."""
    vals = [(s, i) for i, s in enumerate(scores)]
    n = len(vals)
    while n > 1:
        h = n // 2
        merged = [hi if hi[0] < lo[0] else lo for lo, hi in zip(vals[:h], vals[h:2 * h])]
        vals = merged + vals[2 * h:n]
        n = n - h
    return vals[0][1]


def test_fold_tie_breaking():
    """Crafted ties: the fold keeps the tournament's winner, not the first
    minimum; across row counts and tie-heavy random scores it equals the
    JAX kernel's fold written out row by row."""
    scores = torch.tensor([[[1.0, 0.0, 0.0, 5.0, 0.0]]])
    assert int(fold_argmin(scores, [5])[0, 0]) == 2 == _tournament([1, 0, 0, 5, 0])
    assert int(torch.argmin(scores)) == 1  # the first minimum
    assert int(fold_argmin(scores, [2])[0, 0]) == 1  # rows [0, 2) only
    assert int(fold_argmin(scores, [1])[0, 0]) == 0
    rng = np.random.default_rng(0)
    rows = [1, 2, 3, 5, 7, 8, 13, 16, 31, 40]
    s = rng.integers(0, 3, size=(6, len(rows), 40)).astype(np.float64)
    got = fold_argmin(torch.as_tensor(s), rows).numpy()
    for b in range(6):
        for t, n in enumerate(rows):
            assert got[b, t] == _tournament(list(s[b, t, :n])), (b, n)


def test_nearest_ref_points_modes():
    """All four modes find the same row where there is no tie; with a tie
    between distinct rows the fold and the first minimum differ; the row
    limits bound every mode."""
    xs = torch.arange(10, dtype=torch.float64) * 0.5
    line = torch.stack([xs, torch.zeros(10), xs * 0.1, xs], dim=-1)[None]  # (1, 10, 4)
    pos = torch.tensor([[[1.1, 0.2], [3.0, -0.4], [9.0, 0.0]]], dtype=torch.float64)
    limits = torch.tensor([10, 10, 4])
    for mode in (Modes(), Modes(proj_dot=True), Modes(proj_fold=True),
                 Modes(proj_dot=True, proj_fold=True)):
        got = nearest_ref_points(pos, line, limits, mode)
        np.testing.assert_array_equal(got[0, :, 0].numpy(), [1.0, 3.0, 1.5])
    tied = torch.tensor([[[2.0, 0.0], [0.0, 0.0], [0.0, 0.0], [2.0, 0.0]]], dtype=torch.float64)
    query = torch.tensor([[[0.0, 0.0]]], dtype=torch.float64)
    line4 = torch.cat([tied, torch.zeros(1, 4, 2, dtype=torch.float64)], dim=-1)
    line4[..., 3] = torch.arange(4)
    first = nearest_ref_points(query, line4)[0, 0, 3]
    fold = nearest_ref_points(query, line4, modes=Modes(proj_fold=True))[0, 0, 3]
    # squared distances 4, 0, 0, 4: row 2 beats row 0, row 1 holds row 3,
    # then row 1 does not beat row 2 (strict <): the fold keeps row 2
    assert (float(first), float(fold)) == (1.0, 2.0) == (1.0, _tournament([4.0, 0, 0, 4.0]))

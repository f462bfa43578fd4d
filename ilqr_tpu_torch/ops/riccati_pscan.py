"""Parallel-in-time Riccati backward pass: a log-depth scan of value maps.

Counterpart of ``ilqr_tpu/ops/riccati_pscan.py``, the solver's
``riccati_impl="pscan"``. The sequential recursion (``ops/riccati.py``)
has depth N; this one composes the steps' value maps with a log-depth
prefix scan. The JAX package measured it never faster on its chip; on this
port it stays an option whose speed is measured on the card
(``chip_smoke.py`` phase 10), not assumed.

Formulation: augment the state with a homogeneous coordinate x~ = [dx; 1]
so that the affine cost terms (l_x, l_u) fold into one (nx+1)-dim quadratic;
a step's Riccati map is then

    V_k = F_k(V_{k+1}),   F(V) = Q + A^T V (I + S V)^{-1} A,
    S = B R^{-1} B^T,

and maps of this form (A, C, J) are closed under composition:

    (A1,C1,J1) o (A2,C2,J2) = (A1 Z A2, C1 + A1 Z C2 A1^T, J2 + A2^T Y J1 A2),
    Z = (I + C2 J1)^{-1},  Y = (I + J1 C2)^{-1}.

The scan (Hillis-Steele: at offset 1, 2, 4, ... element i takes
``_combine(e[i - offset], e[i])``) yields every V_k at once; the gains
d_k, K_k follow in one batched sweep. ``_combine`` is not commutative: the
elements run terminal-first and the first operand is the inner
(terminal-side) map. The grouping is not ``lax.associative_scan``'s, so the
two packages agree up to rounding. Equal (up to rounding) to the sequential
pass at lambda = 0; with lambda > 0 the regularizer steers the gains only,
not the value maps (the sequential pass regularizes both, as the reference
does, src/cilqr_solver.cpp:407-432).

Every tensor carries a leading scenario axis b. The solves do not check
for singular blocks (``solve_ex``: no host sync on the card; a singular
block gives non-finite values where ``jnp`` gives NaN).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ParallelBackwardResult(NamedTuple):
    d: torch.Tensor  # (b, N, nu)
    K: torch.Tensor  # (b, N, nu, nx)
    dV1: torch.Tensor  # (b,)
    dV2: torch.Tensor  # (b,)
    fail: torch.Tensor  # (b,) bool: any non-PD Quu along the horizon


def _combine(e1, e2):
    """Compose value maps: combined(V) = f_{e2}(f_{e1}(V)), e1 the inner
    (terminal-side) map. With f(V) = J + A^T V (I + C V)^{-1} A:

      J = J2 + A2^T J1 (I + C2 J1)^{-1} A2
      A = A1 (I + C2 J1)^{-1} A2
      C = C1 + A1 (I + C2 J1)^{-1} C2 A1^T
    """
    A1, C1, J1 = e1
    A2, C2, J2 = e2
    eye = torch.eye(A1.shape[-1], dtype=A1.dtype, device=A1.device).expand(C1.shape)
    Z = torch.linalg.solve_ex(eye + C2 @ J1, eye)[0]
    Y = torch.linalg.solve_ex(eye + J1 @ C2, eye)[0]
    A = A1 @ (Z @ A2)
    C = C1 + A1 @ (Z @ (C2 @ A1.transpose(-1, -2)))
    J = J2 + A2.transpose(-1, -2) @ (Y @ (J1 @ A2))
    return A, C, J


def _prefix_scan(elems):
    """Inclusive scan of ``_combine`` along axis 1 in log depth."""
    n = elems[0].shape[1]
    offset = 1
    while offset < n:
        head = tuple(e[:, :offset] for e in elems)
        tail = _combine(tuple(e[:, :-offset] for e in elems),
                        tuple(e[:, offset:] for e in elems))
        elems = tuple(torch.cat([h, t], dim=1) for h, t in zip(head, tail))
        offset *= 2
    return elems


def parallel_lqr_backward(A, B, l_x, l_u, l_xx, l_uu, lamb=None) -> ParallelBackwardResult:
    """In place of ``ops.riccati.backward_pass`` with O(log N) depth.

    A (b,N,nx,nx), B (b,N,nx,nu), l_x (b,N+1,nx), l_u (b,N,nu),
    l_xx (b,N+1,nx,nx), l_uu (b,N,nu,nu); ``lamb`` (optional, (b,)) adds
    the Levenberg regularizer to the gain stage only (Quu + lamb I when
    solving for d, K and in dV1, dV2).
    """
    nb, N, nx = A.shape[0], A.shape[1], A.shape[-1]
    nu = B.shape[-1]
    na = nx + 1

    # augmented per-step quantities
    A_aug = A.new_zeros((nb, N, na, na))
    A_aug[..., :nx, :nx] = A
    A_aug[..., nx, nx] = 1.0
    B_aug = B.new_zeros((nb, N, na, nu))
    B_aug[..., :nx, :] = B
    # quadratic cost in homogeneous coordinates: x~^T Q~ x~ reproduces
    # dx^T l_xx dx + 2 l_x . dx up to a constant (no 1/2 factors, as the
    # reference's convention)
    Q_aug = A.new_zeros((nb, N, na, na))
    Q_aug[..., :nx, :nx] = l_xx[:, :N]
    Q_aug[..., :nx, nx] = l_x[:, :N]
    Q_aug[..., nx, :nx] = l_x[:, :N]
    # l_u folds in through u = v - R^{-1} l_u: the dynamics' affine column
    # gains -B R^{-1} l_u, and the completed cost's constant is dropped
    Rinv_lu = torch.linalg.solve_ex(l_uu, l_u[..., None])[0][..., 0]  # (b, N, nu)
    A_aug[..., :nx, nx] -= (B @ Rinv_lu[..., None])[..., 0]
    S_aug = B_aug @ torch.linalg.inv_ex(l_uu)[0] @ B_aug.transpose(-1, -2)

    V_term = A.new_zeros((nb, 1, na, na))
    V_term[:, 0, :nx, :nx] = l_xx[:, N]
    V_term[:, 0, :nx, nx] = l_x[:, N]
    V_term[:, 0, nx, :nx] = l_x[:, N]

    # elements terminal-first: e[0] = terminal, e[i] = step N - i
    zeros = A.new_zeros((nb, 1, na, na))
    elems = (torch.cat([zeros, A_aug.flip(1)], dim=1),
             torch.cat([zeros, S_aug.flip(1)], dim=1),
             torch.cat([V_term, Q_aug.flip(1)], dim=1))
    J_all = _prefix_scan(elems)[2]
    # J_all[:, i] = V at step N - i; V_{k+1} = J_all[:, N - 1 - k]
    V_next = J_all[:, :N].flip(1)
    Vxx_n = V_next[..., :nx, :nx]
    Vx_n = V_next[..., :nx, nx]

    # batched gains (reference Q-term assembly, src/cilqr_solver.cpp:400-424)
    Bt = B.transpose(-1, -2)
    Qu = l_u + (Bt @ Vx_n[..., None])[..., 0]
    Quu = l_uu + Bt @ Vxx_n @ B
    if lamb is not None:
        Quu = Quu + lamb[:, None, None, None] * torch.eye(nu, dtype=A.dtype, device=A.device)
    Qux = Bt @ Vxx_n @ A
    # the sequential pass's LLT check (src/cilqr_solver.cpp:415-420): a
    # failed factorization reports info > 0 where jnp's gives NaN
    L, info = torch.linalg.cholesky_ex(Quu)
    fail = ((info != 0) | L.isnan().any(dim=(-2, -1))).any(dim=1)
    sol = torch.linalg.solve_ex(Quu, torch.cat([Qu[..., None], Qux], dim=-1))[0]
    d = -sol[..., 0]
    K = -sol[..., 1:]
    dV1 = 0.5 * (d * (Quu @ d[..., None])[..., 0]).sum(dim=(1, 2))
    dV2 = (d * Qu).sum(dim=(1, 2))
    return ParallelBackwardResult(d, K, dV1, dV2, fail)

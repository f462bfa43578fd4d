"""Riccati backward recursion + closed-loop forward rollout (PyTorch port).

Counterpart of ``ilqr_tpu/ops/riccati.py`` (reference
src/cilqr_solver.cpp:383-461), with the horizon as a Python loop and the
scenarios as a leading batch axis B:

- the PD check on Q_uu (Eigen LLT failure, src/cilqr_solver.cpp:415-420)
  is Quu[0,0] > 0 and det(Quu) > 0 per row; failures latch a flag and the
  caller discards the pass;
- Q_uu is inverted in closed form (2x2 adjugate);
- ``l_ux`` is identically zero in the reference (src/cilqr_solver.cpp:79-80),
  so Q_ux has no cost term.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ilqr_tpu_torch.models.bicycle import kinematic_propagate


class BackwardResult(NamedTuple):
    d: torch.Tensor  # (B, N, 2) feedforward
    K: torch.Tensor  # (B, N, 2, 4) feedback gains
    dV1: torch.Tensor  # (B,): sum 0.5 d^T Quu d
    dV2: torch.Tensor  # (B,): sum d^T Qu
    fail: torch.Tensor  # (B,) bool: any non-PD Quu along the horizon


def backward_pass(A, B, l_x, l_u, l_xx, l_uu, lamb) -> BackwardResult:
    """A (b,N,4,4), B (b,N,4,2), l_x (b,N+1,4), l_u (b,N,2),
    l_xx (b,N+1,4,4), l_uu (b,N,2,2), lamb (b,) (Levenberg regularizer
    on Q_uu, src/cilqr_solver.cpp:407-410)."""
    nb, N = A.shape[0], A.shape[1]
    eye2 = torch.eye(2, dtype=A.dtype, device=A.device)
    V_x = l_x[:, N, :, None]  # (b, 4, 1)
    V_xx = l_xx[:, N]
    dV1 = A.new_zeros(nb)
    dV2 = A.new_zeros(nb)
    fail = torch.zeros(nb, dtype=torch.bool, device=A.device)
    d = A.new_empty((nb, N, 2))
    K = A.new_empty((nb, N, 2, 4))
    for i in range(N - 1, -1, -1):
        A_i, B_i = A[:, i], B[:, i]
        At, Bt = A_i.transpose(-1, -2), B_i.transpose(-1, -2)
        Q_x = l_x[:, i, :, None] + At @ V_x
        Q_u = l_u[:, i, :, None] + Bt @ V_x
        BtV = Bt @ V_xx  # (b, 2, 4)
        Q_xx = l_xx[:, i] + At @ V_xx @ A_i
        Q_uu = l_uu[:, i] + BtV @ B_i + lamb[:, None, None] * eye2
        Q_ux = BtV @ A_i  # (b, 2, 4)

        q00, q01 = Q_uu[:, 0, 0], Q_uu[:, 0, 1]
        q10, q11 = Q_uu[:, 1, 0], Q_uu[:, 1, 1]
        det = q00 * q11 - q01 * q10
        pd = (q00 > 0) & (det > 0)
        det_safe = torch.where(pd, det, torch.ones_like(det))
        Q_uu_inv = torch.stack([torch.stack([q11, -q01], -1),
                                torch.stack([-q10, q00], -1)], -2) / det_safe[:, None, None]

        d_i = -(Q_uu_inv @ Q_u)  # (b, 2, 1)
        K_i = -(Q_uu_inv @ Q_ux)  # (b, 2, 4)
        Kt = K_i.transpose(-1, -2)
        Q_uxt = Q_ux.transpose(-1, -2)
        KtQuu = Kt @ Q_uu
        V_x = Q_x + KtQuu @ d_i + Kt @ Q_u + Q_uxt @ d_i
        V_xx = Q_xx + KtQuu @ K_i + Kt @ Q_ux + Q_uxt @ K_i
        dV1 = dV1 + 0.5 * (d_i * (Q_uu @ d_i)).sum(dim=(1, 2))
        dV2 = dV2 + (d_i * Q_u).sum(dim=(1, 2))
        fail = fail | ~pd
        d[:, i] = d_i[..., 0]
        K[:, i] = K_i
    return BackwardResult(d, K, dV1, dV2, fail)


def forward_pass(u, x, d, K, alpha, dt, wheelbase, ref_point: str):
    """Closed-loop rollout with gains:  u' = u + K (x' - x) + alpha d
    (reference src/cilqr_solver.cpp:442-461; no control clamping).
    u (B,N,2), x (B,N+1,4), d (B,N,2), K (B,N,2,4)."""
    new_x = [x[:, 0]]
    new_u = []
    for i in range(u.shape[1]):
        dx = (new_x[-1] - x[:, i])[..., None]
        new_u.append(u[:, i] + (K[:, i] @ dx)[..., 0] + alpha * d[:, i])
        new_x.append(kinematic_propagate(new_x[-1], new_u[-1], dt, wheelbase, ref_point))
    return torch.stack(new_u, dim=1), torch.stack(new_x, dim=1)

"""Discrete-time algebraic Riccati equation (DARE) by fixed-point iteration.

Counterpart of ``ilqr_tpu/ops/dare.py`` (reference scripts/0-lqr-demo.py:5-20
and scripts/1-lqr-pathtracking.py:147-160): iterate

  P <- A^T P A - A^T P B (R + B^T P B)^{-1} B^T P A + Q

up to ``max_iter`` times, stopping when max|P_next - P| < eps.

Batched over leading axes: every row stops at its own convergence. Each
iteration steps every row and keeps a converged row's P (a ``done`` mask
and ``torch.where``), which is what the JAX package's ``lax.while_loop``
does under ``vmap``; a row therefore ends bitwise where it would alone.
The loop asks the device whether every row is done only every
``_SYNC_EVERY`` iterations: the mask makes the extra iterations no-ops.
The solves do not check for a singular system (``solve_ex``, no host sync
on the card); a singular one gives non-finite values, as ``jnp`` does.
"""

from __future__ import annotations

import torch

_SYNC_EVERY = 8  # iterations between host checks of the done mask


def _batched(*mats):
    """The leading batch shape of the matrices, and each broadcast to it and
    flattened to one batch axis (one system is a batch of one, so that it
    takes the batched products and rounds as a row of a batch does)."""
    lead = torch.broadcast_shapes(*(m.shape[:-2] for m in mats))
    return lead, [m.expand(*lead, *m.shape[-2:]).reshape(-1, *m.shape[-2:]) for m in mats]


def _step(A, B, Q, R, P):
    AtP = A.transpose(-1, -2) @ P
    BtP = B.transpose(-1, -2) @ P
    return AtP @ A - AtP @ B @ torch.linalg.solve_ex(R + BtP @ B, BtP @ A)[0] + Q


def solve_dare(A, B, Q, R, max_iter: int = 150, eps: float = 0.01):
    """P (..., nx, nx) for A (..., nx, nx), B (..., nx, nu), Q (..., nx, nx),
    R (..., nu, nu), broadcast over their leading axes."""
    lead, (A, B, Q, R) = _batched(A, B, Q, R)
    P = Q.clone()
    done = torch.zeros(P.shape[0], dtype=torch.bool, device=P.device)
    for it in range(max_iter):
        if it % _SYNC_EVERY == 0 and bool(done.all()):
            break
        P_next = _step(A, B, Q, R, P)
        conv = (P_next - P).abs().amax(dim=(-2, -1)) < eps
        P = torch.where(done[:, None, None], P, P_next)
        done = done | conv
    return P.reshape(*lead, *P.shape[-2:])


def lqr_gain(A, B, Q, R, P=None):
    """K* = (R + B^T P B)^{-1} B^T P A (reference scripts/0-lqr-demo.py:59)."""
    if P is None:
        P = solve_dare(A, B, Q, R)
    lead, (A, B, R, P) = _batched(A, B, R, P)
    BtP = B.transpose(-1, -2) @ P
    K = torch.linalg.solve_ex(R + BtP @ B, BtP @ A)[0]
    return K.reshape(*lead, *K.shape[-2:])

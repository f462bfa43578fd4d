"""Linear LQR closed-loop regulator (capability of reference demo 0).

Counterpart of ``ilqr_tpu/solvers/lqr.py`` (reference scripts/0-lqr-demo.py:
DARE by fixed-point iteration (:5-20), gain K* = (R + B^T P B)^{-1} B^T P A
(:59), open- against closed-loop rollouts of an unstable LTI system
(:31-70)). Everything broadcasts over leading axes, so a batch of starts
(or of systems) rolls out together; ``lqr_demo_batch_x0`` is the JAX
package's ``vmap`` over the start.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ilqr_tpu_torch.ops.dare import lqr_gain, solve_dare


class LQRRollout(NamedTuple):
    x: torch.Tensor  # (..., N, nx) state trajectory
    u: torch.Tensor  # (..., N, nu) controls (zero for open loop)
    u_norm: torch.Tensor  # (..., N) control norms


def _mv(M, x):
    return (M @ x[..., None])[..., 0]


def open_loop_rollout(A, x0, steps: int) -> LQRRollout:
    """x_{k+1} = A x_k (reference scripts/0-lqr-demo.py:31-35)."""
    xs = [x0]
    for _ in range(steps - 1):
        xs.append(_mv(A, xs[-1]))
    x = torch.stack(xs, dim=-2)
    return LQRRollout(x, torch.zeros_like(x), x.new_zeros(x.shape[:-1]))


def closed_loop_rollout(A, B, K, x0, steps: int) -> LQRRollout:
    """u_k = -K x_k;  x_{k+1} = A x_k + B u_k
    (reference scripts/0-lqr-demo.py:67-70)."""
    xs, us = [], []
    x = x0
    for _ in range(steps):
        u = -_mv(K, x)
        xs.append(x)
        us.append(u)
        x = _mv(A, x) + _mv(B, u)
    x, u = torch.stack(xs, dim=-2), torch.stack(us, dim=-2)
    return LQRRollout(x, u, torch.linalg.vector_norm(u, dim=-1))


def lqr_demo(A, B, Q, R, x0, steps: int = 50):
    """The whole demo-0 computation: (P*, K*, open loop, closed loop)."""
    P = solve_dare(A, B, Q, R)
    K = lqr_gain(A, B, Q, R, P)
    return P, K, open_loop_rollout(A, x0, steps), closed_loop_rollout(A, B, K, x0, steps)


def lqr_demo_batch_x0(A, B, Q, R, x0_b, steps: int = 50):
    """``lqr_demo`` of one system from a batch of starts x0_b (S, nx): the
    DARE is solved once and P*, K* come out per row, (S, nx, nx) and
    (S, nu, nx), as the JAX package's ``vmap`` over x0 gives them."""
    P, K, ol, cl = lqr_demo(A, B, Q, R, x0_b, steps)
    S = x0_b.shape[0]
    return P.expand(S, *P.shape[-2:]), K.expand(S, *K.shape[-2:]), ol, cl

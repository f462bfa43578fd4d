"""Nearest-reference-point projection (PyTorch port of
``ilqr_tpu/ops/projection.py``).

A global brute-force argmin (the reference's Python semantics,
scripts/utils/kinematic.py:69-75), ``method="exact"``, or its two-stage
form ``method="hier"`` (the solver's ``CILQRConfig.projection``): a
stride-``HIER_STRIDE`` coarse first-min argmin, then a first-min argmin
over the +-stride rows around the coarse winner, in row order, clipped to
the line. The two agree wherever the line is locally smooth at the 0.8 m
scale (every shipped scenario), and rows padded with far coordinates
never win either. ``hier`` is the JAX package's option for its XLA
solver's whole line only, so it takes no ``row_limits`` and no modes.

``row_limits`` restricts the search of query step k to rows
[0, row_limits[k]) of the line: that is the windowed
search of the fused solve (``ilqr_tpu/ops/pallas/cilqr_kernel.py:432-445``),
which ``ops/cuda/cilqr_kernel.py`` reproduces for its plain version.

``Modes`` holds the fused solve's modes, which the plain solver threads
whole down to this projection and its line search. The two projection
modes are the plain versions of the CUDA kernel's, rounded as the TPU
kernel rounds them:

- ``proj_dot``: score a row with the centred dot form ``(p_cr + p_nx * x') +
  p_ny * y'`` (``dot_terms``; primes: coordinates minus the line's row 0)
  instead of the squared distance (ilqr_tpu/ops/pallas/cilqr_kernel.py:
  267-286, :364-367, :433-434). The argmin is the same in exact arithmetic,
  the rounding is not;
- ``proj_fold``: take the minimum through the pair-fold tournament (:368-399)
  instead of the first minimum: ties go by tournament order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


HIER_STRIDE = 8


class Modes(NamedTuple):
    """A fused solve's projection and line-search modes (all off: the
    squared distance, the first minimum, the serial line search)."""

    proj_dot: bool = False
    ls_chunk: int = 0  # 0: serial; else the line search's chunk width
    proj_fold: bool = False


def dot_terms(rx, ry, dim: int = -1):
    """(p_cr, p_nx, p_ny) of the dot-form score for lines of rows along
    ``dim``, centred on each line's row 0: p_cr = |r - r0|^2, p_nx =
    -2 (rx - r0x), p_ny = -2 (ry - r0y)."""
    rxc = rx - rx.narrow(dim, 0, 1)
    ryc = ry - ry.narrow(dim, 0, 1)
    return rxc * rxc + ryc * ryc, -2.0 * rxc, -2.0 * ryc


def fold_argmin(score, rows):
    """Tournament winner of each query: score (B, T, P), ``rows`` the T
    counts of rows each query takes part with. While n > 1: slot i meets
    slot i + h (h = n // 2) and the later one wins only on strict <; an odd
    tail slot 2h moves to slot h; n -= h. Returns (B, T) row indices.

    All queries fold together; slot i + h of a query is gathered for every
    slot i, which at i == h is the odd tail."""
    B, T, P = score.shape
    dev = score.device
    idx = torch.arange(P, device=dev).expand(B, T, P)
    n = torch.as_tensor(rows, device=dev)[:, None]  # (T, 1)
    while int(n.max()) > 1:
        h = n // 2
        width = int((n - h).max())
        slot = torch.arange(width, device=dev)
        src = (slot + h).clamp_max(score.shape[-1] - 1).expand(B, T, width)
        hi_s, hi_i = score.gather(-1, src), idx.gather(-1, src)
        lo_s, lo_i = score[..., :width], idx[..., :width]
        take = ((slot < h) & (hi_s < lo_s)) | ((slot == h) & (n % 2 == 1))
        score = torch.where(take, hi_s, lo_s)
        idx = torch.where(take, hi_i, lo_i)
        n = n - h
    return idx[..., 0]


def _hier_index(pos, ref_line, stride: int):
    """(B, T) row indices of the two-stage argmin."""
    P = ref_line.shape[1]
    coarse = ref_line[:, ::stride]  # (B, Pc, 4)
    dx = pos[..., 0:1] - coarse[:, None, :, 0]
    dy = pos[..., 1:2] - coarse[:, None, :, 1]
    cidx = torch.argmin(dx * dx + dy * dy, dim=-1)  # (B, T)
    offs = torch.arange(-stride, stride + 1, device=pos.device)
    cand = (cidx[..., None] * stride + offs).clamp(0, P - 1)  # (B, T, 2S+1)
    B, T, S = cand.shape
    cxy = torch.gather(ref_line[..., :2], 1, cand.reshape(B, T * S, 1).expand(-1, -1, 2))
    cxy = cxy.view(B, T, S, 2)
    ddx = pos[..., None, 0] - cxy[..., 0]
    ddy = pos[..., None, 1] - cxy[..., 1]
    best = torch.argmin(ddx * ddx + ddy * ddy, dim=-1)
    return torch.gather(cand, -1, best[..., None])[..., 0]


def nearest_ref_points(pos, ref_line, row_limits=None, modes: Modes = Modes(),
                       method: str = "exact"):
    """For query positions pos (B, T, 2) against ref_line (B, P, 4)
    [x, y, yaw, s], return the nearest rows as (B, T, 4).

    Ties resolve to the first row (``torch.argmin`` returns the first
    minimal index), or by tournament order with ``modes.proj_fold``.
    ``row_limits``: optional (T,) integer tensor. ``method``: "exact" or
    "hier" (without row limits or modes).
    """
    if method == "hier":
        if row_limits is not None or modes != Modes():
            raise ValueError("the hier projection takes no row_limits and no modes")
        idx = _hier_index(pos, ref_line, HIER_STRIDE)
        return torch.gather(ref_line, 1, idx[..., None].expand(-1, -1, ref_line.shape[-1]))
    if method != "exact":
        raise ValueError(f"unknown projection method {method!r}")
    rx, ry = ref_line[..., 0], ref_line[..., 1]
    if modes.proj_dot:
        p_cr, p_nx, p_ny = (t[:, None, :] for t in dot_terms(rx, ry))
        qx = (pos[..., 0] - rx[:, :1])[..., None]
        qy = (pos[..., 1] - ry[:, :1])[..., None]
        score = (p_cr + p_nx * qx) + p_ny * qy  # (B, T, P)
    else:
        dx = pos[..., 0:1] - rx[:, None, :]
        dy = pos[..., 1:2] - ry[:, None, :]
        score = dx * dx + dy * dy  # (B, T, P)
    if modes.proj_fold:
        rows = [ref_line.shape[1]] * pos.shape[1] if row_limits is None else row_limits
        idx = fold_argmin(score, rows)
    else:
        if row_limits is not None:
            rows = torch.arange(ref_line.shape[1], device=score.device)
            score = score.masked_fill(rows >= row_limits[:, None], float("inf"))
        idx = torch.argmin(score, dim=-1)
    return torch.gather(ref_line, 1, idx[..., None].expand(-1, -1, ref_line.shape[-1]))

"""Nearest-reference-point projection (PyTorch port of the ``exact`` method
of ``ilqr_tpu/ops/projection.py``).

A global brute-force first-min argmin (the reference's Python semantics,
scripts/utils/kinematic.py:69-75). ``row_limits`` restricts the search of
query step k to rows [0, row_limits[k]) of the line: that is the windowed
search of the fused solve (``ilqr_tpu/ops/pallas/cilqr_kernel.py:432-445``),
which ``ops/cuda/cilqr_kernel.py`` reproduces for its plain version.
"""

from __future__ import annotations

import torch


def nearest_ref_points(pos, ref_line, row_limits=None):
    """For query positions pos (B, T, 2) against ref_line (B, P, 4)
    [x, y, yaw, s], return the nearest rows as (B, T, 4).

    Ties resolve to the first row (``torch.argmin`` returns the first
    minimal index). ``row_limits``: optional (T,) integer tensor.
    """
    dx = pos[..., 0:1] - ref_line[:, None, :, 0]
    dy = pos[..., 1:2] - ref_line[:, None, :, 1]
    d2 = dx * dx + dy * dy  # (B, T, P)
    if row_limits is not None:
        rows = torch.arange(ref_line.shape[1], device=d2.device)
        d2 = d2.masked_fill(rows >= row_limits[:, None], float("inf"))
    idx = torch.argmin(d2, dim=-1)
    return torch.gather(ref_line, 1, idx[..., None].expand(-1, -1, ref_line.shape[-1]))

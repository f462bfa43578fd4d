"""Batch sharding and the stats all-reduce.

Counterpart of ``ilqr_tpu/parallel/sharding.py``, on PyTorch devices and
``torch.distributed``:

- the scenario batch is row-partitioned over the mesh's devices
  (``shard_batch``: contiguous row blocks, each on its device) and, across
  processes, over the ranks (each passes its own rows,
  ``shard_batch_multihost``). The solves are embarrassingly parallel, so
  each shard runs the single-device solver on its rows with no
  cross-device traffic: padding, windows and straggler compaction stay
  shard-local;
- the convergence statistics are the only collective: each shard's five
  sums are added on the mesh's first device and, under a process group,
  all-reduced as one stacked tensor.

The solve functions return what their JAX counterparts return, with rows
in the caller's order, gathered on the mesh's first device. Under a
process group, a rank's outputs are its own rows and the summary covers
every rank's.

The JAX package's TPU knobs ``groups`` and ``interpret`` are accepted and
must keep their defaults.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ilqr_tpu_torch.ops.cuda.cilqr_kernel import W_BACK, cilqr_solve_cuda
from ilqr_tpu_torch.parallel.mesh import DATA_AXIS, Mesh
from ilqr_tpu_torch.sim.mpc import run_mpc_kernel_chunked
from ilqr_tpu_torch.solvers.cilqr import solve
from ilqr_tpu_torch.types import CILQRConfig, SolveStats
from ilqr_tpu_torch.utils.tree import tree_leaves, tree_map

# the summed statistics, in the order of the all-reduced tensor
_SUMS = ("num_solves", "converged", "lamb_overflow", "total_iters", "total_cost")


class Shards(list):
    """A batched tree split over a mesh: one tree of rows per device, in
    row order (``shard_batch``)."""


class Replicas(list):
    """A tree copied to every device of a mesh (``replicate``)."""


def _check_axis(mesh: Mesh, axis_name: str) -> None:
    if axis_name != mesh.axis_name:
        raise ValueError(f"axis {axis_name!r}: the mesh's one axis is {mesh.axis_name!r}")


def shard_batch(mesh: Mesh, tree, axis_name: str = DATA_AXIS) -> Shards:
    """``tree``'s leaves split along their leading (batch) axis into
    ``mesh.size`` contiguous blocks, block i on device i. The batch must
    divide by the mesh size."""
    _check_axis(mesh, axis_name)
    rows = {int(torch.as_tensor(a).shape[0]) for a in tree_leaves(tree)}
    if len(rows) != 1 or next(iter(rows)) % mesh.size:
        raise ValueError(f"batch sizes {sorted(rows)} do not split over {mesh.size} devices")
    n = next(iter(rows)) // mesh.size
    return Shards(tree_map(lambda a: torch.as_tensor(a).narrow(0, i * n, n).to(dev), tree)
                  for i, dev in enumerate(mesh.devices))


def replicate(mesh: Mesh, tree) -> Replicas:
    """A copy of ``tree`` on every device of the mesh."""
    return Replicas(tree_map(lambda a: torch.as_tensor(a).to(dev), tree)
                    for dev in mesh.devices)


def shard_batch_multihost(mesh: Mesh, local_tree, axis_name: str = DATA_AXIS) -> Shards:
    """This process's rows of a global batch, split over its devices.

    Each rank passes its own block of rows (leading axis = local rows);
    together the ranks' blocks, in rank order, are the global batch that
    the solves' all-reduced summary covers -- the multi-process feeding
    path (single-process :func:`shard_batch` places all rows)."""
    if mesh.group is None:
        raise ValueError("shard_batch_multihost needs a mesh made after initialize_distributed")
    return shard_batch(mesh, local_tree, axis_name)


def _as_shards(mesh: Mesh, tree) -> Shards:
    return tree if isinstance(tree, Shards) else shard_batch(mesh, tree, mesh.axis_name)


def _as_replicas(mesh: Mesh, tree) -> Replicas:
    return tree if isinstance(tree, Replicas) else replicate(mesh, tree)


def _gather(mesh: Mesh, pieces, dim: int = 0):
    """Per-shard output trees joined along ``dim`` on the first device."""
    dev = mesh.devices[0]
    if len(pieces) == 1:
        return tree_map(lambda a: a.to(dev), pieces[0])
    return tree_map(lambda *xs: torch.cat([x.to(dev) for x in xs], dim), *pieces)


def _stat_sums(stats: SolveStats) -> torch.Tensor:
    """The five sums of ``_SUMS`` over a batch of stats, one float64
    tensor on the stats' device."""
    n = stats.iters.shape[0] if stats.iters.dim() else 1
    return torch.stack([
        torch.tensor(float(n), dtype=torch.float64, device=stats.iters.device),
        stats.converged.to(torch.float64).sum(),
        stats.lamb_overflow.to(torch.float64).sum(),
        stats.iters.to(torch.float64).sum(),
        stats.final_cost.to(torch.float64).sum(),
    ])


def _all_reduce(sums: torch.Tensor, group) -> torch.Tensor:
    """``sums`` summed over the group's ranks, in one collective (on the
    current card under NCCL, on the CPU under gloo)."""
    if dist.get_backend(group) == "nccl":
        dev = sums.device if sums.is_cuda else torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device("cpu")
    buf = sums.to(dev, copy=True)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(sums.device)


def _summary(sums: torch.Tensor) -> dict:
    """The summary dict of the JAX package's ``aggregate_stats`` from the
    five sums: float32 0-d tensors, the sums accumulated in float64."""
    s = dict(zip(_SUMS, sums.to(torch.float32).unbind()))
    denom = torch.clamp(s["num_solves"], min=1.0)
    s["converged_frac"] = s["converged"] / denom
    s["mean_iters"] = s["total_iters"] / denom
    s["mean_cost"] = s["total_cost"] / denom
    return s


def aggregate_stats(stats: SolveStats, group=None) -> dict:
    """Global scalar summary of a batch of ``SolveStats``: the keys of
    ``ilqr_tpu.parallel.sharding.aggregate_stats`` (``num_solves``,
    ``converged``, ``lamb_overflow``, ``total_iters``, ``total_cost``,
    ``converged_frac``, ``mean_iters``, ``mean_cost``), float32.

    With a process ``group``, the five sums are all-reduced over its ranks
    as one stacked tensor; without, they are this batch's."""
    sums = _stat_sums(stats)
    if group is not None:
        sums = _all_reduce(sums, group)
    return _summary(sums)


def _run_shards(mesh: Mesh, solve_shard, w, batched, with_stats_psum: bool):
    """``solve_shard(w_i, *batched_i)`` on every shard; returns the outputs
    gathered in row order and the summary over their stats (the outputs'
    third element), all-reduced over the mesh's group when
    ``with_stats_psum``."""
    ws = _as_replicas(mesh, w)
    parts = [_as_shards(mesh, b) for b in batched]
    outs = [solve_shard(ws[i], *(p[i] for p in parts)) for i in range(mesh.size)]
    dev = mesh.devices[0]
    sums = sum(_stat_sums(o[2]).to(dev) for o in outs)
    if with_stats_psum and mesh.group is not None:
        sums = _all_reduce(sums, mesh.group)
    return _gather(mesh, outs), _summary(sums)


def _no_tpu_knobs(groups: int, interpret: bool) -> None:
    if groups != 1 or interpret:
        raise ValueError(f"groups={groups}, interpret={interpret}: TPU kernel knobs; the CUDA "
                         "kernel has neither (keep groups=1, interpret=False)")


def sharded_kernel_solve_fn(mesh: Mesh, cfg: CILQRConfig, *, window: int = 512,
                            straggler_cap=0, proj_rows_per_step: int = 0, groups: int = 1,
                            interpret: bool = False, axis_name: str = DATA_AXIS,
                            with_stats_psum: bool = True, with_alm_io: bool = False,
                            w_back: int = W_BACK):
    """Mesh-sharded batched solve through the fused CUDA kernel.

    ``fn(w, x0_batch, scenario_batch) -> (u, x, stats, summary)``: each
    shard runs :func:`~ilqr_tpu_torch.ops.cuda.cilqr_kernel.cilqr_solve_cuda`
    on its rows (the plain version on CPU devices) with ``window``,
    ``straggler_cap``, ``proj_rows_per_step`` and ``w_back``; per-shard
    results are exactly the single-device solve's. The batch arguments may
    be whole batches or ``shard_batch`` results, ``w`` a ``replicate``
    result or the weights.

    ``with_alm_io`` (ALM configs): ``fn`` takes two more row-partitioned
    arguments ``(alm_mu0 (B, N, C0), alm_rho0 (B,))`` and returns a fifth
    element ``(alm_mu, alm_rho)``, the duals to carry to the next solve.
    """
    _check_axis(mesh, axis_name)
    _no_tpu_knobs(groups, interpret)
    if with_alm_io and cfg.solve_type != "alm":
        raise ValueError("with_alm_io requires an ALM config")
    kw = dict(window=window, straggler_cap=straggler_cap, proj_rows_per_step=proj_rows_per_step,
              w_back=w_back)

    def solve_shard(w, x0, scenario, *duals):
        if not with_alm_io:
            return cilqr_solve_cuda(cfg, w, x0, scenario, **kw)
        return cilqr_solve_cuda(cfg, w, x0, scenario, alm_mu0=duals[0], alm_rho0=duals[1],
                                return_alm=True, **kw)

    def fn(w, x0_b, scen_b, *duals):
        if len(duals) != (2 if with_alm_io else 0):
            raise TypeError(f"fn takes {5 if with_alm_io else 3} arguments "
                            f"(with_alm_io={with_alm_io})")
        out, summary = _run_shards(mesh, solve_shard, w, (x0_b, scen_b) + duals,
                                   with_stats_psum)
        return tuple(out[:3]) + (summary,) + tuple(out[3:])

    return fn


def run_mpc_chunked_sharded(mesh: Mesh, cfg: CILQRConfig, w, x0_b, ref_line_b, ref_velo_b,
                            obs_full_b, road_borders_b, *, ticks: int, chunk: int = 10,
                            window: int = 512, straggler_cap=0, proj_rows_per_step: int = 0,
                            interpret: bool = False, straggler_cap_warm=None,
                            axis_name: str = DATA_AXIS, w_back: int = W_BACK):
    """Reference-length MPC episodes, the batch row-partitioned over the
    mesh: :func:`~ilqr_tpu_torch.sim.mpc.run_mpc_kernel_chunked` (the
    CUDA-graph driver on a card, the plain version on the CPU) on each
    shard's rows, the carry staying on the shard's device. Episodes are
    embarrassingly parallel, so per-shard results are exactly the
    single-device driver's.

    Returns (ego (ticks+1, B, 4), u_hist (ticks, B, N, 2), SolveStats with a
    leading ticks axis), rows in the caller's order.
    """
    _check_axis(mesh, axis_name)
    _no_tpu_knobs(1, interpret)
    ws = _as_replicas(mesh, w)
    parts = [_as_shards(mesh, b) for b in (x0_b, ref_line_b, ref_velo_b, obs_full_b,
                                           road_borders_b)]
    outs = [run_mpc_kernel_chunked(cfg, ws[i], *(p[i] for p in parts), ticks, chunk=chunk,
                                   window=window, straggler_cap=straggler_cap,
                                   proj_rows_per_step=proj_rows_per_step,
                                   straggler_cap_warm=straggler_cap_warm, w_back=w_back)
            for i in range(mesh.size)]
    return _gather(mesh, outs, dim=1)


def sharded_solve_fn(mesh: Mesh, cfg: CILQRConfig, axis_name: str = DATA_AXIS,
                     with_stats_psum: bool = True):
    """Mesh-sharded batched solve through the eager solver.

    Returns ``fn(w, x0_batch, scenario_batch) -> (u, x, stats, summary)``:
    each shard runs :func:`ilqr_tpu_torch.solvers.cilqr.solve` (cold) on
    its rows; ``summary`` is the global stat dict, all-reduced over the
    mesh's process group when there is one and ``with_stats_psum``.
    """
    _check_axis(mesh, axis_name)

    def solve_shard(w, x0, scenario):
        return solve(cfg, w, x0, scenario)[:3]

    def fn(w, x0_b, scen_b):
        out, summary = _run_shards(mesh, solve_shard, w, (x0_b, scen_b), with_stats_psum)
        return tuple(out) + (summary,)

    return fn

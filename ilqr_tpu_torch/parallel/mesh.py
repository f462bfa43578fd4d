"""Device mesh and multi-process bring-up.

Counterpart of ``ilqr_tpu/parallel/mesh.py``. The workload's only axis of
parallelism is the scenario batch (SURVEY.md section 2 table): a 1-D
``data`` mesh row-partitions the batch over the devices this process
drives, and across processes over ``torch.distributed`` ranks, whose
group carries the one collective (the stats all-reduce).

A ``Mesh`` holds the local devices and, when ``torch.distributed`` is
initialized, its default process group. On one card it has one device;
on the CPU it may hold N copies of ``cpu`` (the tests' stand-in for the
JAX package's virtual CPU devices), so the split and the reduction run
there too.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``devices`` of this process along ``axis_name``, and the
    process group the ranks share (None in a single process)."""

    devices: Tuple[torch.device, ...]
    axis_name: str = DATA_AXIS
    group: Optional[Any] = None

    @property
    def size(self) -> int:
        """Devices of this process."""
        return len(self.devices)

    @property
    def world_size(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def global_size(self) -> int:
        """Devices over every rank (each rank drives as many)."""
        return self.size * self.world_size


def _default_devices() -> list:
    """Every card (under a process group, the rank's own card: one process
    a card, as NCCL expects), else one CPU."""
    if not torch.cuda.is_available():
        return [torch.device("cpu")]
    if dist.is_initialized():
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        return [torch.device("cuda", local)]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None,
              axis_name: str = DATA_AXIS) -> Mesh:
    """1-D mesh over the first ``n_devices`` of ``devices`` (default: every
    card, or the CPU). A CPU-only device list shorter than ``n_devices`` is
    repeated to that length; asking for more cards than there are raises."""
    devices = [torch.device(d) for d in (_default_devices() if devices is None else devices)]
    if n_devices is not None:
        if len(devices) < n_devices and all(d.type == "cpu" for d in devices):
            devices = devices[:1] * n_devices
        if len(devices) < n_devices:
            raise ValueError(f"make_mesh({n_devices}): only {len(devices)} devices: {devices}")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("make_mesh: no devices")
    group = dist.group.WORLD if dist.is_initialized() else None
    return Mesh(tuple(devices), axis_name, group)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> None:
    """Multi-process bring-up, one call per process before any collective.

    ``torch.distributed.init_process_group`` with NCCL when there is a
    card and gloo on the CPU (``backend`` overrides). Given nothing, the
    rank, world size and rendezvous come from the environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), as
    ``jax.distributed.initialize`` detects them. ``coordinator_address`` is
    ``host:port`` (a TCP rendezvous) or a URL (``tcp://...``,
    ``file:///path``, which needs no socket).
    """
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
        return
    if num_processes is None or process_id is None:
        raise ValueError("coordinator_address needs num_processes and process_id")
    url = coordinator_address if "://" in coordinator_address else (
        f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id)

"""Checkpoint and resume for long sweeps.

Counterpart of ``ilqr_tpu/utils/checkpoint.py`` (an orbax round trip
there). The reference has no checkpointing (SURVEY.md section 5); all
cross-solve state of the port is already explicit containers of tensors
(``CILQRCarry``, batched stats, sweep cursors), saved with ``torch.save``
and read back with ``torch.load(weights_only=True)``.

A save writes a temporary file beside ``path`` and renames it over
``path``, so a process killed mid-save leaves the previous checkpoint
whole, never a torn one.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import numpy as np
import torch


def _plain(x):
    """``x`` as ``torch.load(weights_only=True)`` reads it back: dicts,
    lists and tuples (a NamedTuple as a tuple, a dataclass as a dict of
    its fields) of CPU tensors and Python scalars."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x))
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_plain(v) for v in x]
    if isinstance(x, tuple):
        return tuple(_plain(v) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return x


def save_state(path: str, state: Any) -> None:
    """Save ``state`` (dicts, lists, tuples of tensors, numpy arrays and
    Python scalars, NamedTuples and dataclasses of them; tensors on any
    device) to the file ``path``, atomically. Numpy arrays come back as
    CPU tensors, NamedTuples as tuples and dataclasses as dicts unless
    :func:`restore_state` is given a template."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        torch.save(_plain(state), tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def restore_state(path: str, template: Optional[Any] = None) -> Any:
    """Read a state saved by :func:`save_state`.

    Without ``template``, tensors come back on the CPU. With it (the same
    structure; NamedTuples and dataclasses are rebuilt from it), each
    tensor comes back on its template tensor's device and in its dtype.
    """
    state = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    return state if template is None else _like(template, state)


def _like(template, state):
    """``state`` (as saved: dicts, lists and tuples) in the containers of
    ``template``, each tensor on its template tensor's device and dtype."""
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(state).to(device=template.device, dtype=template.dtype)
    if isinstance(template, dict):
        return type(template)((k, _like(v, state[k])) for k, v in template.items())
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_like(t, s) for t, s in zip(template, state)))
    if isinstance(template, (list, tuple)):
        return type(template)(_like(t, s) for t, s in zip(template, state))
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _like(getattr(template, f.name), state[f.name])
            for f in dataclasses.fields(template) if f.init})
    return state

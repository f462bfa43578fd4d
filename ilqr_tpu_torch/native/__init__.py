"""Native (C++) host-side scenario generation.

Counterpart of ``ilqr_tpu/native``, with the port's own copy of its source
(``scenario_gen.cpp``): cubic-spline reference-line construction and agent
routing generation, the data-loading hot path of batched sweeps. The
source is built at first use with g++ (OpenMP) into a shared library in
``ilqr_tpu_torch/_build/``, named by a hash of the source and flags, and
bound with ctypes. This is host code, not a device path: the routings it
makes are numpy arrays that callers move to the card. ``available()`` is
False when no g++ can build it; the pure-Python code in
``ilqr_tpu_torch.utils.refline`` and ``ilqr_tpu_torch.sim.scenario``
computes the same lines.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "scenario_gen.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-fopenmp", "-std=c++17")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> Optional[Path]:
    """The library built from ``_SRC`` (once per hash of source and
    flags), or None when g++ is missing or fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    key = hashlib.sha256(_SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    so = _BUILD_DIR / f"libscenario_gen_{key}.so"
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([gxx, *GXX_FLAGS, str(_SRC), "-o", str(tmp)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if tmp.exists():
            tmp.unlink()
    return so


def load() -> Optional[ctypes.CDLL]:
    """The bound library, building it on first use; None if unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = _build()
        if path is None:
            _build_failed = True
            return None
        lib = ctypes.CDLL(str(path))
        dp = ctypes.POINTER(ctypes.c_double)
        ip = ctypes.POINTER(ctypes.c_int64)
        lib.ilqr_refline_build.restype = ctypes.c_int64
        lib.ilqr_refline_build.argtypes = [
            dp, dp, ctypes.c_int64, ctypes.c_double, ctypes.c_double, dp,
            ctypes.c_int64,
        ]
        lib.ilqr_routing_generate.restype = ctypes.c_int64
        lib.ilqr_routing_generate.argtypes = [
            dp, dp, ctypes.c_int64, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_int, ctypes.c_uint64, ctypes.c_double,
            dp, ctypes.c_int64,
        ]
        lib.ilqr_routing_generate_batch.restype = None
        lib.ilqr_routing_generate_batch.argtypes = [
            dp, dp, ctypes.c_int64, ctypes.c_int64, ip, dp, dp, dp,
            ctypes.c_int64, ctypes.c_double, ctypes.c_double, ctypes.c_int,
            ctypes.c_uint64, ctypes.c_double, ctypes.c_int64, ctypes.c_int64,
            dp,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def _lib_or_raise() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError("native scenario_gen unavailable (no g++ could build it)")
    return lib


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def refline_build(knots_x, knots_y, width: float, accuracy: float = 0.1) -> np.ndarray:
    """(P, 4) [x, y, yaw, s] dense offset line (native)."""
    lib = _lib_or_raise()
    kx = np.ascontiguousarray(knots_x, dtype=np.float64)
    ky = np.ascontiguousarray(knots_y, dtype=np.float64)
    n = lib.ilqr_refline_build(_dptr(kx), _dptr(ky), len(kx), width, accuracy, None, 0)
    out = np.zeros((n, 4), dtype=np.float64)
    lib.ilqr_refline_build(_dptr(kx), _dptr(ky), len(kx), width, accuracy, _dptr(out), n)
    return out


def routing_generate(knots_x, knots_y, line_width: float, start_s: float,
                     v0: float, yaw0: float, delta_t: float, total_time: float,
                     noise: bool = False, seed: int = 0,
                     noise_std: float = 0.02) -> np.ndarray:
    """(T, 3) [x, y, yaw] routing line (native)."""
    lib = _lib_or_raise()
    kx = np.ascontiguousarray(knots_x, dtype=np.float64)
    ky = np.ascontiguousarray(knots_y, dtype=np.float64)
    args = (_dptr(kx), _dptr(ky), len(kx), line_width, start_s, v0, yaw0, delta_t,
            total_time, int(noise), seed, noise_std)
    n = lib.ilqr_routing_generate(*args, None, 0)
    out = np.zeros((n, 3), dtype=np.float64)
    lib.ilqr_routing_generate(*args, _dptr(out), n)
    return out


def routing_generate_batch(knots_xy, line_widths, veh_line, veh_start, veh_v0,
                           veh_yaw0, delta_t: float, total_time: float,
                           n_variants: int, noise: bool = True, seed: int = 0,
                           noise_std: float = 0.02) -> np.ndarray:
    """(n_variants, V, T, 3) noisy routing variants, OpenMP-parallel.

    knots_xy: (L, n_knots, 2) with [:, :, 0] = x and [:, :, 1] = y.
    """
    lib = _lib_or_raise()
    knots = np.ascontiguousarray(knots_xy, dtype=np.float64)
    L, n_knots = knots.shape[0], knots.shape[1]
    # the C side takes each line's knots as two runs, x then y
    packed = np.ascontiguousarray(knots.transpose(0, 2, 1).reshape(-1))
    widths = np.ascontiguousarray(line_widths, dtype=np.float64)
    vline = np.ascontiguousarray(veh_line, dtype=np.int64)
    vstart = np.ascontiguousarray(veh_start, dtype=np.float64)
    vv0 = np.ascontiguousarray(veh_v0, dtype=np.float64)
    vyaw = np.ascontiguousarray(veh_yaw0, dtype=np.float64)
    V = len(vline)
    T = int(np.ceil(total_time / delta_t - 1e-12))
    out = np.zeros((n_variants, V, T, 3), dtype=np.float64)
    lib.ilqr_routing_generate_batch(
        _dptr(packed), _dptr(widths), L, n_knots,
        vline.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        _dptr(vstart), _dptr(vv0), _dptr(vyaw), V, delta_t, total_time,
        int(noise), seed, noise_std, n_variants, T, _dptr(out))
    return out

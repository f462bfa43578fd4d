"""The CUDA solve kernel's source, run on the CPU.

``tests/cuda_emulation/cuda_runtime.h`` stands in for the CUDA runtime (a
thread per CUDA thread, a barrier per warp for ``__syncwarp`` and the
shuffles), so g++ builds ``ilqr_tpu_torch/csrc/cilqr_kernel.cu`` as it is,
after two textual rewrites (the dynamic shared memory and the launch
syntax), into a host library with the kernel's C entry points. Its solves
are held in float64 to the plain version, and its chunked line search and
compaction bitwise to its serial and one-launch solves: the kernel's
logic, warp by warp, checked without a card. Times and the card's own
rounding are the GPU tests' and ``chip_smoke.py``'s.
"""

import ctypes
import dataclasses
import re
import subprocess
from pathlib import Path

import pytest
import torch

from ilqr_tpu_torch.apps.validate_kernel import CASES, packed_cold
from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck

HEADERS = Path(__file__).resolve().parent / "cuda_emulation"
B = 9  # scenarios: nine blocks of one warp


def build_emulated(src: str, out: Path):
    """The kernel source ``src`` built for the host with the emulation
    header in directory ``out``, bound as ``ck.load_library`` binds the
    card's."""
    smem = ("extern __shared__ __align__(16) unsigned char smem_raw[];\n"
            "  return reinterpret_cast<T*>(smem_raw);")
    assert smem in src
    src = src.replace(smem, "return reinterpret_cast<T*>(emu_smem);")
    src, launches = re.subn(r"(\w+)<<<(.*?)>>>\(", r"emu_launch(\1, \2, ", src, flags=re.S)
    assert launches == 1
    (out / "cilqr_kernel.cpp").write_text(src)
    so = out / "libcilqr_emulated.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                    "-pthread", f"-I{HEADERS}", "-o", str(so), str(out / "cilqr_kernel.cpp")],
                   check=True, capture_output=True, text=True, timeout=600)
    return ck.bind_kernel(ctypes.CDLL(str(so)))


@pytest.fixture(scope="module")
def kernel_lib(tmp_path_factory):
    """The kernel source built for the host with the emulation header."""
    return build_emulated(ck._SOURCE.read_text(), tmp_path_factory.mktemp("cuda_emulation"))


def _emulated(lib, window_out=None):
    """A ``solve(cfg, w, p, max_iter=)`` over the emulated kernel, as
    ``ck.cilqr_solve_kernel`` launches the card's (``window_out`` as
    there)."""
    def solve(cfg, w, p, max_iter=None):
        launch = ck.prepare_launch(cfg, w, p, max_iter, window_out)
        plan = ck.launch_plan(p.x0.shape[1], cfg.N, p.ox.shape[0], max(p.row_limits),
                              p.x0.dtype, p.modes)
        fn = lib.cilqr_solve_f32 if p.x0.dtype == torch.float32 else lib.cilqr_solve_f64
        assert fn(*launch.args, plan.shared_bytes, None) == 0
        return launch.out
    return solve


def _bitwise(a, b):
    return all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("modes", [ck.Modes(), ck.Modes(True, 4, False), ck.Modes(True, 4, True)],
                         ids=["squared", "dot_ls", "dot_fold_ls"])
@pytest.mark.parametrize("case", ["rear_barrier", "gravity_alm_duals_move"])
def test_emulated_kernel_matches_plain_f64(kernel_lib, case, modes):
    """Float64, cold: iterations and statuses equal to the plain version's
    on every row, u, x and the duals within 1e-9 (sum orders differ)."""
    name, over, wover = CASES[case]
    cfg, w, p = packed_cold(name, B, torch.float64, "cpu", weights=wover, modes=modes, **over)
    k = _emulated(kernel_lib)(cfg, w, p)
    r = ck.cilqr_solve_ref(cfg, w, p)
    assert torch.equal(k.stats[:2], r.stats[:2])
    for a, b in zip(k, r):
        if a is not None:
            assert float((a - b).abs().max()) <= 1e-9


@pytest.mark.parametrize("case", ["gravity_barrier", "rear_alm", "gravity_alm_duals_move"])
def test_emulated_chunks_and_compaction_bitwise(kernel_lib, case):
    """Chunks of 3 equal the serial line search bit for bit (dot form on),
    and compaction at (2, 5) equals one launch."""
    name, over, wover = CASES[case]
    cfg, w, p = packed_cold(name, B, torch.float64, "cpu", weights=wover,
                            modes=ck.Modes(True, 3, False), **over)
    solve = _emulated(kernel_lib)
    one = solve(cfg, w, p)
    assert _bitwise(one, solve(cfg, w, dataclasses.replace(p, modes=ck.Modes(True, 0, False))))
    assert _bitwise(one, ck.solve_packed(cfg, w, p, (2, 5), solve=solve))

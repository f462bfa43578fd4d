"""The ``tools/debug`` repro kernels' host side and CUDA source, on the CPU.

``ilqr_tpu_torch/ops/cuda/debug_repros.py``: the library yardsticks
(``LIBRARY``) bitwise their plain versions, also on -0 and infinities;
``launch_plan`` covering every element exactly once; the alignment check;
the plain versions against the repros' closed forms (``want`` in
``tools/debug/*.py``) at several widths. Then ``csrc/debug_repros.cu``
built with g++ against ``tests/cuda_emulation/cuda_runtime.h`` (a thread
per CUDA thread) and held bitwise to the plain versions at odd widths,
with the launch plan the wrapper computes. The card's own runs are
``tests/test_torch_kernel_gpu.py`` and ``chip_smoke.py`` phase 7.
"""

import ctypes
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from ilqr_tpu_torch.ops.cuda import debug_repros as dr

HEADERS = Path(__file__).resolve().parent / "cuda_emulation"
KERNELS = ("min_resume_echo", "min_dataflow_k1", "min_dataflow_k2", "min_carry")
ODD_WIDTHS = (1, 5, 2047, 2049)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _k2_inputs(bp, planted):
    x = dr.repro_inputs(bp=bp)["dataflow"][0]
    u, s = dr.dataflow_k1_ref(x)
    if planted:
        dr._plant(dr._plant(u, 5, float("inf")), 7, -0.0)
        dr._plant(dr._plant(s, 3, float("-inf")), 7, -0.0)  # inf - inf at every 15th
    return u, s


def _carry_inputs(bp, planted):
    return dr.repro_inputs(bp=bp, planted=planted)["carry"]


def test_library_table_entries():
    """One entry per kernel name; K2, K3-k1 and K4 have no one-call
    equivalent."""
    assert set(dr.LIBRARY) == {"min_resume_echo", "min_dataflow_k1", "min_dataflow_k2",
                               "min_carry", "min_zerotrip"}
    assert {k for k, v in dr.LIBRARY.items() if v is None} == {
        "min_resume_echo", "min_dataflow_k1", "min_carry"}
    # the clone that stood for K4 and K5 copies rows 6..7 of res, which the
    # kernels write as zeros
    x0, res = dr.repro_inputs()["carry"]
    assert not torch.equal(res.clone(), dr.carry_ref(x0, res, 2))


@pytest.mark.parametrize("planted", [False, True], ids=["repro", "planted"])
def test_library_dataflow_k2_bitwise(planted):
    u, s = _k2_inputs(dr.BP, planted)
    want = dr.dataflow_k2_ref(u, s)
    assert torch.equal(_bits(dr.LIBRARY["min_dataflow_k2"](u, s)), _bits(want))
    if planted:
        assert bool(want.isnan().any()) and bool((_bits(want) == _bits(torch.tensor(-0.0))).any())


@pytest.mark.parametrize("planted", [False, True], ids=["repro", "planted"])
@pytest.mark.parametrize("bp", [1, 5, 2047, 2048])
def test_library_zerotrip_bitwise(bp, planted):
    x0, res = _carry_inputs(bp, planted)
    got = dr.LIBRARY["min_zerotrip"](x0, res)
    assert got.shape == (8, bp)
    assert torch.equal(_bits(got), _bits(dr.carry_ref(x0, res, 0)))


@pytest.mark.parametrize("kernel", KERNELS)
def test_launch_plan_covers_each_element_once(kernel):
    """Thread q writes quad q (elements 4q..4q+3) of an 8-row block, and
    ``dataflow_k1`` also u's zero quads q + k 2Bp, k = 1..7: every quad
    exactly once, no block idle, blocks of whole warps."""
    stretches = 8 if kernel == "min_dataflow_k1" else 1
    for bp in (1, 2, 3, 5, 2047, 2048, 2049, 8192):
        for block in (None, 32, 64, 128):
            grid, block = dr.launch_plan(kernel, bp, block)
            nq = 2 * bp
            thread = np.arange(grid * block)
            live = thread[thread < nq]
            quads = (live[:, None] + nq * np.arange(stretches)).ravel()
            assert np.array_equal(np.bincount(quads, minlength=nq * stretches),
                                  np.ones(nq * stretches, dtype=np.int64))
            assert (grid - 1) * block < nq and block % 32 == 0 and block <= 1024


def _past(rows, cols, skip):
    """A contiguous (rows, cols) view that starts ``skip`` floats into its
    allocation."""
    return torch.zeros(rows * cols + skip)[skip:].view(rows, cols)


def _echo_blocks(bp, skip):
    """The echo's nine blocks, zeros, the last (res) ``skip`` floats into
    its allocation."""
    rows = (8, 2 * dr.NH, dr.W, dr.W, dr.W, dr.M * dr.NH, dr.M * dr.NH, dr.M * dr.NH)
    return (*(torch.zeros(r, bp) for r in rows), _past(8, bp, skip))


@pytest.mark.parametrize("fn, args", [
    (dr.resume_echo, lambda: _echo_blocks(8, 1)),
    (dr.dataflow_k1, lambda: (_past(8, 8, 2),)),
    (dr.dataflow_k2, lambda: (_past(64, 8, 1), torch.zeros(8, 8))),
    (dr.dataflow_k2, lambda: (torch.zeros(64, 8), _past(8, 8, 2))),
    (dr.carry, lambda: (torch.zeros(8, 6), _past(8, 6, 3))),
    (dr.zerotrip, lambda: (torch.zeros(8, 6), torch.zeros(9, 6)[1:])),
], ids=["echo_res", "k1_x", "k2_u", "k2_s", "carry_res", "zerotrip_res"])
def test_misaligned_view_raises(fn, args):
    """A block that does not start on 16 bytes (a view into its
    allocation) is refused by every wrapper (the kernels move float4s), on
    every device."""
    with pytest.raises(ValueError, match="16-byte aligned"):
        fn(*args())


@pytest.mark.parametrize("bp", [1, 5, 2049])
def test_plain_versions_closed_forms(bp):
    """The repros' own checks at other widths: the echo returns res, k1 and
    k2 give 2x + 1, 3x - 5 and their sum, the carries return res[:6]."""
    before = sum(dr.launches.values())
    ins = dr.repro_inputs(bp=bp)
    assert torch.equal(dr.resume_echo(*ins["resume"]), ins["resume"][-1])
    x, done = ins["dataflow"]
    out, u1, s1 = dr.dataflow(x, done)
    xn = x.numpy()
    want_u, want_s = 2.0 * xn + 1.0, 3.0 * xn - 5.0
    np.testing.assert_array_equal(u1[:8].numpy(), want_u)
    np.testing.assert_array_equal(s1.numpy(), want_s)
    np.testing.assert_array_equal(out.numpy(), want_s + want_u)
    x0, res = ins["carry"]
    for trips in (0, 1, 2):
        out = dr.carry_trips(x0, res, trips)
        assert torch.equal(out[:6], res[:6]) and not out[6:].any()
    assert sum(dr.launches.values()) == before  # CPU tensors never launch


# the CUDA source on the CPU


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """``csrc/debug_repros.cu`` built for the host with the emulation
    header (the ``<<<>>>`` launches rewritten into ``emu_launch``); its C
    entries bound as the wrapper binds the card's."""
    src, n = re.subn(r"(\w+)<<<(.*?)>>>\(", r"emu_launch(\1, \2, ", dr._SOURCE.read_text(),
                     flags=re.S)
    assert n >= 4
    out = tmp_path_factory.mktemp("repro_emulation")
    (out / "debug_repros.cpp").write_text(src)
    so = out / "libdebug_repros_emulated.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                    "-pthread", f"-I{HEADERS}", "-o", str(so), str(out / "debug_repros.cpp")],
                   check=True, capture_output=True, text=True, timeout=300)
    return dr.bind_library(ctypes.CDLL(str(so)))


# the outputs' fill before a launch: a NaN that no kernel computes, so an
# element the kernel leaves unwritten shows
FILL = 0x7FC5A5A5


def _run(lib, kernel, bp, ins, outs, *ints, plan=None):
    """Call the emulated C entry ``kernel`` over fresh NaN-filled ``outs``
    (shapes) with ``launch_plan``'s shape; returns (status, outputs)."""
    outs = [torch.full(shape, FILL, dtype=torch.int32).view(torch.float32) for shape in outs]
    ptrs = [t.data_ptr() for t in (*ins, *outs)]
    err = lib[kernel](*ptrs, bp, *ints, *(plan or dr.launch_plan(kernel, bp)), None)
    return err, outs


@pytest.mark.parametrize("planted", [False, True], ids=["repro", "planted"])
@pytest.mark.parametrize("bp", ODD_WIDTHS)
def test_emulated_dataflow_k2_bitwise(emulated, bp, planted):
    u, s = _k2_inputs(bp, planted)
    err, (out,) = _run(emulated, "min_dataflow_k2", bp, (u, s), [(8, bp)])
    assert err == 0 and torch.equal(_bits(out), _bits(dr.dataflow_k2_ref(u, s)))


@pytest.mark.parametrize("planted", [False, True], ids=["repro", "planted"])
@pytest.mark.parametrize("trips", [0, 1, 2])
@pytest.mark.parametrize("bp", ODD_WIDTHS + (8,))
def test_emulated_carry_bitwise(emulated, bp, trips, planted):
    """Rows 6..7 of res are poisoned with NaN: the kernel never reads them.
    At a width that is a multiple of 4 a quad's x0 is one float4."""
    x0, res = _carry_inputs(bp, planted)
    res = res.clone()
    res[6:] = float("nan")
    err, (out,) = _run(emulated, "min_carry", bp, (x0, res), [(8, bp)], trips)
    assert err == 0 and torch.equal(_bits(out), _bits(dr.carry_ref(x0, res, trips)))


@pytest.mark.parametrize("planted", [False, True], ids=["repro", "planted"])
@pytest.mark.parametrize("bp", ODD_WIDTHS + (8,))
def test_emulated_resume_echo_bitwise(emulated, bp, planted):
    """Planted: +-inf and NaN in the blocks multiplied by 0 (0 inf is NaN),
    -0 in res (-0 + 0 is +0)."""
    ins = dr.repro_inputs(bp=bp, planted=planted)["resume"]
    want = dr.resume_echo_ref(*ins)
    assert bool(want.isnan().any()) == planted
    err, (out,) = _run(emulated, "min_resume_echo", bp, ins, [(8, bp)])
    assert err == 0 and torch.equal(_bits(out), _bits(want))


@pytest.mark.parametrize("planted", [False, True], ids=["repro", "planted"])
@pytest.mark.parametrize("bp", ODD_WIDTHS + (8,))
def test_emulated_dataflow_k1_bitwise(emulated, bp, planted):
    """Planted: -0, +-inf and NaN in x; rows 8..63 of u must be written."""
    x = dr.repro_inputs(bp=bp, planted=planted)["dataflow"][0]
    err, (u, s) = _run(emulated, "min_dataflow_k1", bp, (x,), [(64, bp), (8, bp)])
    assert err == 0
    for a, b in zip((u, s), dr.dataflow_k1_ref(x)):
        assert torch.equal(_bits(a), _bits(b))


# per C entry: the rows of its inputs, of its outputs, its ints between Bp
# and the plan
ENTRY_ARGS = {
    "min_resume_echo": ((8, 2 * dr.NH, dr.W, dr.W, dr.W, dr.M * dr.NH, dr.M * dr.NH,
                         dr.M * dr.NH, 8), (8,), ()),
    "min_dataflow_k1": ((8,), (2 * dr.NH, 8), ()),
    "min_dataflow_k2": ((2 * dr.NH, 8), (8,), ()),
    "min_carry": ((8, 8), (8,), (0,)),
}


@pytest.mark.parametrize("kernel", KERNELS)
def test_emulated_entries_refuse(emulated, kernel):
    """A pointer that does not start on 16 bytes (each in turn), a plan
    short of the work, for ``carry`` a negative trip count and for
    ``resume_echo`` a block above its launch bounds (128) return
    cudaErrorInvalidValue (1) before any launch."""
    bp = 2049
    in_rows, out_rows, ints = ENTRY_ARGS[kernel]
    blocks = [torch.zeros(r * bp + 4) for r in (*in_rows, *out_rows)]
    ptrs = [t.data_ptr() for t in blocks]
    grid, block = dr.launch_plan(kernel, bp)
    fn = emulated[kernel]
    for k in range(len(ptrs)):
        moved = ptrs[:k] + [ptrs[k] + 4] + ptrs[k + 1:]
        assert fn(*moved, bp, *ints, grid, block, None) == 1
    assert fn(*ptrs, bp, *ints, grid - 1, block, None) == 1
    assert fn(*ptrs, bp, *ints, 0, block, None) == 1
    if kernel == "min_carry":
        assert fn(*ptrs, bp, -1, grid, block, None) == 1
    if kernel == "min_resume_echo":
        assert fn(*ptrs, bp, *dr.launch_plan(kernel, bp, 256), None) == 1

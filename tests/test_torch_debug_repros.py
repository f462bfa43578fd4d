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


def _planted(t, every, value):
    """A copy of ``t`` with ``value`` at every ``every``-th element."""
    t = t.clone()
    t.view(-1)[::every] = value
    return t


def _k2_inputs(bp, planted):
    x = dr.repro_inputs(bp=bp)["dataflow"][0]
    u, s = dr.dataflow_k1_ref(x)
    if planted:
        u = _planted(_planted(u, 5, float("inf")), 7, -0.0)
        s = _planted(_planted(s, 3, float("-inf")), 7, -0.0)  # inf - inf at every 15th
    return u, s


def _carry_inputs(bp, planted):
    x0, res = dr.repro_inputs(bp=bp)["carry"]
    if planted:
        res = _planted(_planted(res, 3, -0.0), 7, float("-inf"))
        x0 = _planted(_planted(x0, 4, float("inf")), 5, -1.0)  # 0 inf = NaN, 0 -1 = -0
    return x0, res


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
    """Each thread writes the elements the kernel's index map gives it
    (one, or the quad 4q..4q+3); every output element exactly once, no
    block idle, blocks of whole warps."""
    for bp in (1, 2, 3, 5, 2047, 2048, 2049, 8192):
        grid, block = dr.launch_plan(kernel, bp)
        _, _, rows, per_thread, _ = dr._ENTRIES[kernel]
        n = rows * bp
        thread = np.arange(grid * block)
        live = thread[thread * per_thread < n]
        elems = (live[:, None] * per_thread + np.arange(per_thread)).ravel()
        assert np.array_equal(np.bincount(elems, minlength=n), np.ones(n, dtype=np.int64))
        assert (grid - 1) * block < n // per_thread and block % 32 == 0 and block <= 1024


def _past(rows, cols, skip):
    """A contiguous (rows, cols) view that starts ``skip`` floats into its
    allocation."""
    return torch.zeros(rows * cols + skip)[skip:].view(rows, cols)


@pytest.mark.parametrize("fn, args", [
    (dr.dataflow_k2, lambda: (_past(64, 8, 1), torch.zeros(8, 8))),
    (dr.dataflow_k2, lambda: (torch.zeros(64, 8), _past(8, 8, 2))),
    (dr.carry, lambda: (torch.zeros(8, 6), _past(8, 6, 3))),
    (dr.zerotrip, lambda: (torch.zeros(8, 6), torch.zeros(9, 6)[1:])),
], ids=["k2_u", "k2_s", "carry_res", "zerotrip_res"])
def test_misaligned_view_raises(fn, args):
    """A block that does not start on 16 bytes (a view into its
    allocation) is refused by the float4 kernels' wrappers, on every
    device."""
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


def _run(lib, kernel, bp, ins, outs, *ints, plan=None):
    """Call the emulated C entry ``kernel`` over fresh NaN-filled ``outs``
    (shapes) with ``launch_plan``'s shape; returns (status, outputs)."""
    outs = [torch.full(shape, float("nan")) for shape in outs]
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


def test_emulated_unchanged_kernels_bitwise(emulated):
    """The per-element kernels K2 and K3 k1 with the same plan at an odd
    width."""
    bp = 5
    ins = dr.repro_inputs(bp=bp)
    err, (out,) = _run(emulated, "min_resume_echo", bp, ins["resume"], [(8, bp)])
    assert err == 0 and torch.equal(_bits(out), _bits(dr.resume_echo_ref(*ins["resume"])))
    x = ins["dataflow"][0]
    err, (u, s) = _run(emulated, "min_dataflow_k1", bp, (x,), [(64, bp), (8, bp)])
    assert err == 0
    for a, b in zip((u, s), dr.dataflow_k1_ref(x)):
        assert torch.equal(_bits(a), _bits(b))


def test_emulated_entries_refuse(emulated):
    """A misaligned pointer, a plan short of the work and a negative trip
    count return cudaErrorInvalidValue (1) before any launch."""
    bp = 5
    x0, res = dr.repro_inputs(bp=bp)["carry"]
    flat = torch.zeros(8 * bp + 1)
    grid, block = dr.launch_plan("min_carry", bp)
    fn = emulated["min_carry"]
    assert fn(x0.data_ptr(), flat[1:].data_ptr(), flat.data_ptr(), bp, 0, grid, block, None) == 1
    assert fn(x0.data_ptr(), res.data_ptr(), flat.data_ptr(), bp, 0, 0, block, None) == 1
    assert fn(x0.data_ptr(), res.data_ptr(), flat.data_ptr(), bp, -1, grid, block, None) == 1
    u, s = _k2_inputs(bp, False)
    err, _ = _run(emulated, "min_dataflow_k2", bp, (u, s), [(8, bp)], plan=(1, 2))
    assert err == 1

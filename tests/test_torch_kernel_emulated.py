"""The CUDA solve kernel's source, run on the CPU.

``tests/cuda_emulation/cuda_runtime.h`` stands in for the CUDA runtime (a
thread per CUDA thread, a barrier per warp for ``__syncwarp``, the
shuffles, the votes and the reductions), so g++ builds ``ilqr_tpu_torch/csrc/cilqr_kernel.cu`` as it is,
after two textual rewrites (the dynamic shared memory and the launch
syntax), into a host library with the kernel's C entry points. Its solves
are held in float64 to the plain version, and its chunked line search and
compaction bitwise to its serial and one-launch solves: the kernel's
logic, warp by warp, checked without a card. A probe of the window scan
alone reads the kernel's plan of the scan and holds the scan split across
lanes to a serial first minimum, ties and NaN included, here and (marked
``gpu``) in the card's build. Times and the card's own rounding are the
GPU tests' and ``chip_smoke.py``'s.
"""

import ctypes
import dataclasses
import random
import re
import subprocess
from pathlib import Path

import pytest
import torch

from ilqr_tpu_torch.apps.validate_kernel import CASES, packed_cold
from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck

HEADERS = Path(__file__).resolve().parent / "cuda_emulation"
B = 9  # scenarios: nine blocks of one warp


def _emu_launches(src: str, launches: int) -> str:
    """``src`` with its ``launches`` launches written as ``emu_launch``."""
    src, n = re.subn(r"(\w+)<<<(.*?)>>>\(", r"emu_launch(\1, \2, ", src, flags=re.S)
    assert n == launches
    return src


def build_emulated(src: str, out: Path, probe: str = ""):
    """The kernel source ``src``, with ``probe`` (a launch of its own)
    after it, built for the host with the emulation header in directory
    ``out``, bound as ``ck.load_library`` binds the card's."""
    smem = ("extern __shared__ __align__(16) unsigned char smem_raw[];\n"
            "  return reinterpret_cast<T*>(smem_raw);")
    assert smem in src
    src = src.replace(smem, "return reinterpret_cast<T*>(emu_smem);")
    src = _emu_launches(src, 1) + _emu_launches(probe, 1 if probe else 0)
    (out / "cilqr_kernel.cpp").write_text(src)
    so = out / "libcilqr_emulated.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                    "-pthread", f"-I{HEADERS}", "-o", str(so), str(out / "cilqr_kernel.cpp")],
                   check=True, capture_output=True, text=True, timeout=600)
    return ck.bind_kernel(ctypes.CDLL(str(so)))


# A probe of the window scan alone, appended to the kernel's source (built
# for the host here, for the card by test_scan_split_bitwise_on_card): one
# warp runs the kernel's `scan_min` over staged window terms (F R, laid out
# as the staging lays them, in `region`, `ck.region_bytes` of it) for each
# step's query, and writes each step's row, each lane's plan
# (`scan_lane`: own, partner, lo, n) and the busiest lane's rows.
SCAN_PROBE = r"""
namespace {
template <typename T>
__global__ void scan_probe(const T* terms, int R, int N, const int* limits, const T* qx,
                           const T* qy, int proj_dot, T* region, int* rows, int* plan,
                           unsigned* busiest) {
  Ctx<T, false, false> c;
  c.p.R = R;
  c.p.N = N;
  c.p.proj_dot = proj_dot;
  c.p.proj_fold = 0;
  c.p.ls_chunk = 0;
  c.N = N;
  c.M = 0;
  c.S = N + 1;
  c.k = threadIdx.x;
  c.lim = c.k <= N ? limits[c.k] : 1;
  c.sm = region;
  T* win = c.win();
  for (int r = c.k; r < window_fields(proj_dot) * R; r += kWarp) win[r] = terms[r];
  __syncwarp();
  const T x = c.k <= N ? qx[c.k] : T(0), y = c.k <= N ? qy[c.k] : T(0);
  const int bi = proj_dot ? scan_min<true>(c, x, y) : scan_min<false>(c, x, y);
  const ScanLane sl = scan_lane(c);
  if (c.k <= N) {
    rows[c.k] = bi;
    plan[4 * c.k] = sl.own;
    plan[4 * c.k + 1] = sl.partner;
    plan[4 * c.k + 2] = sl.lo;
    plan[4 * c.k + 3] = sl.n;
  }
  const unsigned most = __reduce_max_sync(kFull, static_cast<unsigned>(sl.n));
  if (c.k == 0) *busiest = most;
}

template <typename T>
int run_scan_probe(const T* terms, int R, int N, const int* limits, const T* qx, const T* qy,
                   int proj_dot, T* region, int* rows, int* plan, unsigned* busiest) {
  auto* probe = scan_probe<T>;
  probe<<<1, kWarp, 0, nullptr>>>(terms, R, N, limits, qx, qy, proj_dot, region, rows, plan,
                                  busiest);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

extern "C" int scan_probe_f32(const float* terms, int R, int N, const int* limits,
                              const float* qx, const float* qy, int proj_dot, float* region,
                              int* rows, int* plan, unsigned* busiest) {
  return run_scan_probe(terms, R, N, limits, qx, qy, proj_dot, region, rows, plan, busiest);
}
extern "C" int scan_probe_f64(const double* terms, int R, int N, const int* limits,
                              const double* qx, const double* qy, int proj_dot, double* region,
                              int* rows, int* plan, unsigned* busiest) {
  return run_scan_probe(terms, R, N, limits, qx, qy, proj_dot, region, rows, plan, busiest);
}
"""


def bind_scan_probe(lib):
    """Declare the scan probe's argument types on ``lib``; returns it."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.scan_probe_f32, lib.scan_probe_f64):
        fn.argtypes = [vp, ci, ci, vp, vp, vp, ci, vp, vp, vp, vp]
        fn.restype = ci
    return lib


def run_scan_probe(lib, terms, limits, qx, qy, proj_dot: bool):
    """The probe over window terms ``terms`` (F, R) and queries ``qx``,
    ``qy`` (N + 1,) under ``limits``, on their device: (each step's row,
    each lane's (own, partner, lo, n), the busiest lane's rows)."""
    R, N = terms.shape[1], len(limits) - 1
    dev = terms.device
    size = ck.region_bytes(N, 0, R, terms.dtype, ck.Modes(proj_dot, 0, False))
    region = torch.full((size // terms.element_size(),), float("nan"), dtype=terms.dtype,
                        device=dev)
    rows = torch.full((N + 1,), -1, dtype=torch.int32, device=dev)
    plan = torch.full((N + 1, 4), -1, dtype=torch.int32, device=dev)
    busiest = torch.zeros((), dtype=torch.int32, device=dev)
    lims = torch.tensor(limits, dtype=torch.int32, device=dev)
    terms, qx, qy = (t.contiguous() for t in (terms, qx, qy))
    fn = lib.scan_probe_f32 if terms.dtype == torch.float32 else lib.scan_probe_f64
    assert fn(terms.data_ptr(), R, N, lims.data_ptr(), qx.data_ptr(), qy.data_ptr(),
              int(proj_dot), region.data_ptr(), rows.data_ptr(), plan.data_ptr(),
              busiest.data_ptr()) == 0
    return rows.tolist(), [tuple(r) for r in plan.tolist()], int(busiest)


def busiest_rows(limits) -> int:
    """The rows the busiest lane scores a projection under ``limits``:
    ceil((a + b) / 2) of the pair of steps k and N - k with the most."""
    return max((a + b + 1) // 2 for a, b in zip(limits, reversed(limits)))


@pytest.fixture(scope="module")
def kernel_lib(tmp_path_factory):
    """The kernel source built for the host with the emulation header, with
    the scan probe (``SCAN_PROBE``)."""
    lib = build_emulated(ck._SOURCE.read_text(), tmp_path_factory.mktemp("cuda_emulation"),
                         SCAN_PROBE)
    return bind_scan_probe(lib)


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


# row limits the scan is probed at: the cells' (N 30, window 384; w_back
# 24 or 64, 9 or 10 rows a step), a short horizon, 32 steps (no lane past
# step N, no middle step), uniform limits (no second run), and limits that
# are not multiples of 4 (one row a turn), also with odd pair sums
SCAN_LIMITS = {
    "two_straight": ck.row_limits(30, 384, 24, 9),
    "three_straight": ck.row_limits(30, 384, 24, 10),
    "sweep": ck.row_limits(30, 384, 64, 9),
    "short_n": ck.row_limits(6, 384, 24, 9),
    "n31": ck.row_limits(31, 384, 24, 9),
    "uniform": ck.row_limits(30, 384, 24, 0),
    "odd": tuple(11 + 7 * k for k in range(31)),
    "uneven": tuple(sorted(random.Random(5).sample(range(40, 384), 31))),
}
BUSIEST = {"two_straight": 180, "three_straight": 196, "sweep": 220, "uniform": 384}
# the plan is also checked at the S-bend's limits (two_straight's), on a
# one- and a two-step horizon, and at limits in no order
PLAN_LIMITS = {**SCAN_LIMITS, "n0": ck.row_limits(0, 384, 24, 9),
               "n1": ck.row_limits(1, 384, 24, 9),
               "shuffled": tuple(random.Random(19).sample(SCAN_LIMITS["two_straight"], 31))}


def _splits(limits):
    """(short lane, long lane, split row h) of each pair whose scan splits:
    steps k and N - k whose limits a < b differ split at ceil((a + b) / 2)."""
    N = len(limits) - 1
    return [(k, N - k, (a + limits[N - k] + 1) // 2) for k, a in enumerate(limits)
            if a < limits[N - k]]


def _plan(lib, limits):
    """The kernel's own plan under ``limits`` (``scan_lane``, through the
    probe): (own, partner, lo, n) a step, and the busiest lane's rows."""
    R, N = max(limits), len(limits) - 1
    zeros = torch.zeros(N + 1)
    _, plan, busiest = run_scan_probe(lib, torch.zeros(2, R), limits, zeros, zeros, False)
    return plan, busiest


@pytest.mark.parametrize("shape", list(PLAN_LIMITS))
def test_every_row_scored_once_in_at_most_two_runs(kernel_lib, shape):
    """The kernel's plan: each query's rows [0, lim) are scored exactly
    once, by its own lane from row 0, then by its partner (lane N - k) up
    to the limit; a lane scores at most one run of another query."""
    limits = PLAN_LIMITS[shape]
    N = len(limits) - 1
    plan, _ = _plan(kernel_lib, limits)
    runs = {k: [] for k in range(N + 1)}  # query: [(lane, lo, hi), ...]
    for k, (own, partner, lo, n) in enumerate(plan):
        assert partner == N - k and 0 <= own <= n
        runs[k].append((k, 0, own))
        if n > own:
            runs[partner].append((k, lo, lo + n - own))
    for q, rs in runs.items():
        rs.sort(key=lambda run: run[1])
        assert 1 <= len(rs) <= 2
        assert sorted(r for _, lo, hi in rs for r in range(lo, hi)) == list(range(limits[q])), q
        assert rs[0] == (q, 0, plan[q][0])
        if len(rs) == 2:
            assert rs[1][0] == N - q and rs[1][1] == plan[q][0] and rs[1][2] == limits[q]


@pytest.mark.parametrize("shape", list(PLAN_LIMITS))
def test_busiest_lane_scores_half_its_pair(kernel_lib, shape):
    """The kernel's busiest lane scores ceil((a + b) / 2) rows of the pair
    with the most (equal limits, or the middle step, their own limit): 180
    / 196 / 220 at the cells' limits, against 312 / 344 / 352 for the
    longest lane alone; the full window's uniform limits split nothing."""
    limits = PLAN_LIMITS[shape]
    plan, busiest = _plan(kernel_lib, limits)
    loads = [n for _, _, _, n in plan]
    assert max(loads) == busiest == busiest_rows(limits) == BUSIEST.get(shape, busiest)
    assert sum(loads) == sum(limits)
    if shape in ("uniform", "n0"):
        assert all(n == own for own, _, _, n in plan)
        assert busiest == max(limits)
    else:
        assert bool(_splits(limits))
        assert busiest < max(limits)


def _scan_case(limits, dtype, gen, tail: int, planted: bool):
    """A window of max(limits) rows and one query a step. The window is a
    random walk of ~0.1 m steps whose rows from ``tail`` on repeat row
    ``tail - 1``, as a window past line row P - 1 repeats it. Across every
    other pair's split a row of the long lane's first run is copied into
    its second and the long lane's query sits on it (a tie across the
    runs); the other long lanes' queries sit near a row past their split.
    The other queries sit near a random row of their own range, or far
    past the tail's end, or are NaN or +-inf. ``planted``: NaN and +inf
    window rows at the start of each second run and in the first runs."""
    N, R = len(limits) - 1, max(limits)
    splits = _splits(limits)
    xy = torch.cumsum(torch.randn(R, 2, generator=gen, dtype=torch.float64) * 0.1, 0)
    for i, (_, long, h) in enumerate(splits):
        if i % 2 == 0:
            xy[min(h + 2, limits[long] - 1)] = xy[h - 3]
    xy[tail:] = xy[tail - 1]
    if planted:
        for i, (short, _, h) in enumerate(splits):
            xy[h, i % 2] = float("nan")
            xy[h + 1, 0] = float("inf")
            xy[limits[short] // 2, 1] = float("nan")
    xy = xy.to(dtype)

    def near(r):
        noise = torch.randn(2, generator=gen, dtype=torch.float64) * 0.03
        return xy[r] + noise.to(dtype)

    q = torch.stack([near(int(torch.randint(limits[k], (), generator=gen)))
                     for k in range(N + 1)])
    for i, (_, long, h) in enumerate(splits):
        q[long] = xy[h - 3] if i % 2 == 0 else near(min(h + 4 + i % 5, limits[long] - 1))
    q[N] = xy[-1] + 50.0
    specials = [(float("nan"), 0.0), (float("inf"), 0.0), (float("-inf"), 0.0),
                (0.0, float("-inf")), (float("inf"), float("inf"))]
    lanes = sorted({1, 4, N // 2 + 2, N - 2, N - 4} - {N})
    for k, v in zip(lanes, specials):
        q[k] = torch.tensor(v, dtype=dtype)
    return xy, q


def _serial_first_min(score, limits):
    """Each step's first minimum over its rows, scanned in order from row 0
    (a NaN at row 0 pins it, a later NaN never wins): the kernel's scan of
    one lane's rows."""
    out = []
    for k, n in enumerate(limits):
        best, bi = score[k][0], 0
        for r in range(1, n):
            if score[k][r] < best:
                best, bi = score[k][r], r
        out.append(bi)
    return out


def _check_scan(lib, shape, proj_dot, dtype, device):
    """The probe's rows at ``SCAN_LIMITS[shape]``, on ``device``, against a
    serial first minimum and torch.argmin (``_scan_case``'s three windows),
    and its busiest lane's rows."""
    from ilqr_tpu_torch.ops.projection import Modes, dot_terms, nearest_ref_points

    limits = SCAN_LIMITS[shape]
    N, R = len(limits) - 1, max(limits)
    splits = _splits(limits)
    assert bool(splits) == (shape != "uniform")
    lims = torch.tensor(limits)
    gen = torch.Generator().manual_seed(19 + len(shape))
    first_split = splits[0][2] if splits else R - 40
    for tail, planted in ((first_split - 6, False), (R - 40, False), (R - 40, True)):
        xy, q = _scan_case(limits, dtype, gen, tail, planted)
        if proj_dot:
            p_cr, p_nx, p_ny = dot_terms(xy[:, 0], xy[:, 1])
            qx, qy = q[:, 0] - xy[0, 0], q[:, 1] - xy[0, 1]
            score = (p_cr[None] + p_nx[None] * qx[:, None]) + p_ny[None] * qy[:, None]
            terms = torch.stack([p_cr, p_nx, p_ny])
        else:
            qx, qy = q[:, 0], q[:, 1]
            dx, dy = qx[:, None] - xy[None, :, 0], qy[:, None] - xy[None, :, 1]
            score = dx * dx + dy * dy
            terms = xy.T
        rows, _, busiest = run_scan_probe(lib, terms.to(device), limits, qx.to(device),
                                          qy.to(device), proj_dot)
        assert rows == _serial_first_min(score.tolist(), limits), (tail, planted)
        if not planted:
            line = torch.stack([xy[:, 0], xy[:, 1], torch.zeros(R, dtype=dtype),
                                torch.arange(R, dtype=dtype)], -1)[None]
            idx = nearest_ref_points(q[None], line, lims, Modes(proj_dot=proj_dot))
            assert rows == idx[0, :, 3].long().tolist(), tail
        assert busiest == busiest_rows(limits) == BUSIEST.get(shape, busiest)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("proj_dot", [False, True], ids=["squared", "dot"])
@pytest.mark.parametrize("shape", list(SCAN_LIMITS))
def test_scan_split_matches_plain_first_argmin(kernel_lib, shape, proj_dot, dtype):
    """The kernel's window scan, split across the lanes, picks for every
    step the row of a scan of the step's rows alone, which is the plain
    version's projection (torch.argmin over the same scores, bit for bit)
    where the window is finite: across ties inside the repeated tail
    (starting just before the first pair's split, or late), ties across a
    pair's split and NaN or infinite queries; with NaN and +inf window rows
    planted at the splits, still the scan of one lane's rows. The busiest
    lane scores 180 / 196 / 220 rows at the cells' limits, the largest
    limit where nothing splits."""
    _check_scan(kernel_lib, shape, proj_dot, dtype, "cpu")


@pytest.fixture(scope="module")
def card_scan_probe(tmp_path_factory):
    """The kernel source with the scan probe, built for the card with the
    kernel's flags; skips without a CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the probe's card build has no CPU mode")
    src = tmp_path_factory.mktemp("scan_probe") / "cilqr_scan_probe.cu"
    src.write_text(ck._SOURCE.read_text() + SCAN_PROBE)
    lib, _ = ck.build_library(src, "libcilqr_scan_probe", ck.KERNEL_FLAGS)
    return bind_scan_probe(lib)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("proj_dot", [False, True], ids=["squared", "dot"])
@pytest.mark.parametrize("shape", ["two_straight", "three_straight", "sweep", "uniform", "odd"])
def test_scan_split_bitwise_on_card(card_scan_probe, shape, proj_dot, dtype):
    """``test_scan_split_matches_plain_first_argmin`` on the card, in the
    kernel's own build (-fmad=false): every step's row bit for bit the
    serial first minimum's and torch.argmin's, at the cells' limits, the
    uniform ones and ones that are no multiple of 4."""
    _check_scan(card_scan_probe, shape, proj_dot, dtype, "cuda")
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("name", ["scenario_three_bend", "scenario_three_straight"])
def test_emulated_window_past_line_end(kernel_lib, name, dtype):
    """Cold solves at the cells' limits and modes on a line cut 170 rows
    past the earliest window start, so every window runs past line row P -
    1 and its tail -- rows that repeat that row, tied in every score --
    starts before the first pair's split and runs through it: iterations
    and statuses equal to the plain version's (torch.argmin's first row of
    the tie), u, x and the stats within 1e-9 in float64; in float32, where
    the sums' order parts the two after a few iterations, the same over
    three iterations within 1e-4 of 1 + |value|."""
    cfg, w, p = packed_cold(name, B, dtype, "cpu", modes=ck.Modes(True, 4, False))
    start = ck.window_start(p.line, p.x0, p.w_back)
    P = int(start.min()) + 170
    p = dataclasses.replace(p, line=p.line[:, :P].contiguous())
    assert torch.equal(ck.window_start(p.line, p.x0, p.w_back), start)
    tail = P - 1 - start  # window row where each solve's tie starts
    split = _splits(p.row_limits)[0][2]
    assert int(tail.max()) < split < max(p.row_limits)
    max_iter = 3 if dtype == torch.float32 else None
    k = _emulated(kernel_lib)(cfg, w, p, max_iter=max_iter)
    r = ck.cilqr_solve_ref(cfg, w, p, max_iter=max_iter)
    assert torch.equal(k.stats[:2], r.stats[:2])
    tol = 1e-4 if dtype == torch.float32 else 1e-9
    for a, b in zip(k[:3], r[:3]):
        assert float(((a - b).abs() / (1 + b.abs())).max()) <= tol

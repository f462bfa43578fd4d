// Fused CILQR solve for NVIDIA Hopper (sm_90a): one warp per scenario, lane
// k owning horizon step k.
//
// Replaces the Pallas TPU kernel of ilqr_tpu/ops/pallas/cilqr_kernel.py: the
// `kernel` built by `_build_kernel` (:80-1222) and launched by `call_kernel`
// (:1545-1594), in these variants: both bicycle reference points (rear
// center; gravity center with its Jacobian quirk), both penalty families
// (exponential barrier; augmented Lagrangian with the duals as input and
// output), warm-start controls, the serial or the chunked line search
// (`ls_chunk`, :844-890, :1021-1080), the projection over a per-scenario
// reference-line window with per-step row limits in its four modes
// (squared distance or the centred dot form `proj_dot`, :267-286, :364-367,
// :433-434; first minimum or the pair-fold tournament `proj_fold`,
// :368-399), and the resume entry of straggler compaction (:97-105,
// :1156-1168: restart at iteration it0 from a stats slab). It computes what
// that kernel computes (reference semantics: src/cilqr_solver.cpp:85-461 of
// the C++ project), not its TPU layout.
//
// Design. A solve is a chain of dependent iterations, and its work splits
// into what is independent across the horizon (the window scan of every
// projection, ~80% of a trial's operations; the cost terms; the cost
// derivatives and dynamics Jacobians; the dual update) and what is serial
// over it (the rollouts, the Riccati recursion). So a warp owns a scenario:
// lane k (N + 1 <= 32 lanes) projects, costs and differentiates step k, and
// a horizon sum is one fixed shuffle tree (`warp_sum`). The Riccati
// recursion runs redundantly in every lane on the shared state (no
// divergence, no broadcast), lane 0 storing the gains; a rollout runs in
// one lane (the initial one in lane 0, a line-search chunk's alphas one
// per lane). The solve's state lives in
// dynamic shared memory, the block's one region (`warp_floats`; `Ctx::cur()`
// and the other accessors): the current trajectory, the gains, the
// per-step derivatives, the chunk's trials, the obstacle predictions (with
// the cosine and sine of their yaw, computed once per solve) and the
// searched window rows, staged once per solve; the lanes of a scan read
// one broadcast address per row. The window is the kernel's own: each solve
// finds the line row nearest its start (`nearest_row`, torch.argmin's
// first minimum of the squared distance over all P rows, the lanes
// striding over them), starts `w_back` rows behind it and stages the
// searched rows straight from the line (`stage_window`), which the batch
// shares as one (3, P) array or holds per row as (3, P, B). Control flow is uniform across the warp
// outside the per-lane and per-chain sections, so no block or warp ever
// waits on another. One warp a block: a finished scenario hands its slot
// to the next at once (faster than 2 or 4 a block, and the staged window
// faster than scanning device memory, at the main path's shape; PERF.md).
//
// What bounds it on this card: the latency of one scenario's dependent
// chain -- per iteration the Riccati recursion (~450 operations a step, 30
// steps) and per trial a rollout (30 steps) and the busiest lane's window
// scan -- and, across the batch, issue slots: scenarios resident per SM are
// bounded by registers and shared bytes, and the tick waits for its slowest
// scenario. Bytes are not the limit: each scenario reads its inputs once.
// The row limits rise with the step, so lane k shares its scan with lane
// N - k (`scan_lane`): the busiest lane scores ~180 rows a projection on
// the main path, not the longest limit's 312.
//
// Layout: every input and output array with a batch axis is
// scenario-fastest ([row][B]), as the plain version packs them; a line the
// batch shares has none. See ilqr_tpu_torch/ops/cuda/cilqr_kernel.py
// for the packing, the launch plan (the grid, and the shared bytes this
// file's `warp_floats` counts) and the plain PyTorch version of the same
// function.
//
// Built without fast-math and with -fmad=false (ops/cuda/cilqr_kernel.py,
// KERNEL_FLAGS): every product and sum rounds on its own, as the plain
// version's do, whatever the inlining context. The scalar type, the
// reference point and the penalty family are template parameters: float is
// the production type, double exists to check semantics against the plain
// version without float32 chaos. The projection modes and the line search's
// chunk width are warp-uniform runtime arguments.
//
// Bitwise guarantees and what carries them:
// - chunked line search = serial: a chunk's chain a runs in lane a the
//   instructions chain 0 runs in lane 0, so a trial's bits do not depend on
//   its place in a chunk, and the chains of a chunk run in parallel;
// - compaction = one launch: the resume entry rolls out the carried
//   controls with the `propagate` a trial used and costs them with the one
//   `total_cost` (the same per-lane terms, the same shuffle tree), and
//   without FMA contraction the separately inlined copies of each round
//   alike (with it, float64 ALM compaction differed from one launch on the
//   card);
// - window scores are rounded op by op (`__fmul_rn`, `__fadd_rn`) in both
//   projection modes, so a lane's first minimum is the same function of the
//   same bits in any build. The dot form cancels (a score is |r - q|^2 -
//   |q - r0|^2): contracted into FMAs its near-ties broke otherwise than the
//   plain version's (three_bend ALM, first tick: cost p90 1.5e-3 against
//   5e-6 with the squared distance, on the card).
//
// The modes on this card:
// - dot form: the staging computes the three window terms (p_cr, p_nx,
//   p_ny) of each searched row, rounded op by op as ops/projection.py's
//   `dot_terms` rounds them, in place of the squared distance's two; a row
//   costs 3 shared loads, 2 products and 2 sums;
// - fold: each lane's tournament keeps ceil(R/2) scores and row indices in a
//   (slot, step, scenario) global scratch the wrapper allocates;
// - chunked line search: chain a in lane a, trials judged in alpha order by
//   the whole warp.
//
// K1's record. Every launch adds to a persistent int64 array of
// kNumK1Fields (`K1Field`; ops/cuda/cilqr_kernel.py allocates one a device,
// utils/counters.py reads it): each solve's clocks per phase (P0-P7, read
// with clock64 at warp-converged marks, every mark closing one phase and
// opening the next, so the eight sum to the solve's clocks from entry to
// its last store), its wall nanoseconds (%globaltimer), counts of solves,
// launches, iterations, line-search chunks, trials judged and iterations by
// the status they ended in, and the rows the busiest lane scores in its
// projections (`scan_trips`). Lane f of the warp keeps field f
// of its solve in a register and adds it with one atomic at the solve's
// end. Side writes only: the outputs do not depend on them.

#include <cuda_runtime.h>

#include <cmath>
#include <cstring>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxSteps = kWarp;  // N + 1 <= kMaxSteps: lane k owns step k
// The launch bounds' resident blocks per SM: a float32 solve asks for 16,
// which caps it at 128 registers, as many as it uses without spilling (16
// are resident at M = 3 either way); without the hint ptxas gave some
// builds 80 registers and spills. A float64 solve asks for 1 (255).
template <typename T>
constexpr int kMinResident = sizeof(T) == 4 ? 16 : 1;
constexpr int kMaxChunk = 8;  // widest line-search chunk
constexpr unsigned kFull = 0xffffffffu;

enum Status {
  kRunning = 0,
  kConverged = 1,
  kBackwardPassFail = 2,
  kForwardPassFail = 3,
  kForwardPassSmallStep = 4,
};
constexpr int kNumStatuses = 5;

// Fields of K1's record, in the order of utils/counters.py:K1_FIELDS; lane
// f keeps field f of its solve.
enum K1Field {
  // phase clocks: P0 staging (the ALM dual copy, the nearest row, the
  // window, the obstacles, uinit); P1 the initial rollout, projection and
  // cost (and a resumed solve's stats); P2 `derivatives`; P3 `backward`;
  // P4 `forward_chunk`; P5 the trials' `project`; P6 the trials'
  // `total_cost`, verdict and `adopt`; P7 the rest (`dual_update`, the
  // lambda and status update, the output stores)
  kStage, kInit, kDeriv, kBackward, kForward, kProject, kCost, kRest,
  kClocks,   // clocks from the solve's entry to its last store
  kSolveNs,  // %globaltimer nanoseconds over the same
  kSolves, kLaunches, kIters, kChunks,
  kTrials,       // trials judged: projected, costed and given a verdict
  kStatusFirst,  // + Status: the iterations that ended in each status
  // the busiest lane's rows a projection (`scan_lane`), over every
  // projection of the solve: the warp's trips through the window scan
  kScanTrips = kStatusFirst + kNumStatuses,
  kNumK1Fields,
};
static_assert(kNumK1Fields <= 32, "a lane a field");

__device__ __forceinline__ unsigned clock32() { return static_cast<unsigned>(clock64()); }

// The card's nanosecond clock. The CPU stand-in for the CUDA runtime that
// runs this file in the tests (tests/cuda_emulation) brings its own.
#ifndef CUDA_EMULATION
__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#endif

// Field order = _WEIGHT_ORDER in ops/cuda/cilqr_kernel.py.
template <typename T>
struct Weights {
  T dt, wb, width, length, d_safe, velo_max, velo_min, acc_max, acc_min, stl_lim;
  T w_pos, w_vel, w_yaw, w_acc, w_stl, sq1, sq2, oq1, oq2;
  T init_lamb, lamb_decay, lamb_amplify, max_lamb, conv_thresh, accept_thresh, exp_clip;
};
constexpr int kNumWeights = 26;
constexpr int kNumAlmWeights = 3;  // alm_gamma, max_rho, max_mu follow in _WEIGHT_ORDER

struct RowLimits {
  int r[kMaxSteps];
};

template <typename T>
struct Problem {
  const T* __restrict__ x0;     // (8, B): x, y, v, yaw, rb_hi, rb_lo, ref_velo, 0
  const T* __restrict__ uinit;  // (2, N, B)
  // the reference line's x, y, yaw: (3, P) shared by the batch (batch
  // stride line_bs 0, row stride line_rs 1) or (3, P, B) per row (1 and B)
  const T* __restrict__ line;
  const T* __restrict__ ox;     // (M, N+1, B) obstacle predictions
  const T* __restrict__ oy;
  const T* __restrict__ oyaw;
  T* __restrict__ u_out;        // (2, N, B)
  T* __restrict__ x_out;        // (4, N+1, B)
  T* __restrict__ stats_out;    // (6, B)
  T* __restrict__ fold_s;       // (ceil(R / 2), N+1, B) fold scratch (proj_fold)
  int* __restrict__ fold_i;
  // (1 + F R, B), F = window_fields(proj_dot), or null: each solve's window
  // start and its staged rows, read back for tests
  T* __restrict__ window_out;
  int B, N, M, W, R, max_iter, n_alphas;  // R: the largest row limit, rows staged
  int P, w_back, line_bs, line_rs;        // line rows; window rows behind the nearest
  int proj_dot, proj_fold, ls_chunk;      // ls_chunk: the chunk width, 0 (serial) to kMaxChunk
};

// ALM arguments: the duals in and out, C = 8 + 2M columns, and the
// dual-update weights.
template <typename T>
struct AlmArgs {
  const T* __restrict__ mu_in;   // (C, N, B)
  const T* __restrict__ rho_in;  // (B)
  T* __restrict__ mu_out;        // (C, N, B): the solve's working duals
  T* __restrict__ rho_out;       // (B)
  T gamma, max_rho, max_mu;
};

// Per-solve ALM state: empty in the barrier builds.
template <typename T, bool kAlm>
struct AlmState {};

template <typename T>
struct AlmState<T, true> {
  AlmArgs<T> a;
  T rho;  // the penalty weight
};

// Shared memory of one warp, in scalars: the fields of `Smem`, each of
// N + 1 steps unless noted. The wrapper's launch plan counts the same.
constexpr int kTrajFields = 9;   // ua, us, px, py, pv, ph, rx, ry, rh
constexpr int kGainFields = 10;  // K (2 x 4, row-major), d (2)
constexpr int kDerivFields = 15; // lx (4), lxx 00 01 03 11 13 22 33, lu (2), luu00, luu11
constexpr int kJacFields = 8;    // a02, a03, a12, a13, a32, b01, b11, b31
constexpr int kTrialFields = 6;  // ua, us, px, py, pv, ph of each chain
constexpr int kObsFields = 4;    // x, y, cos(yaw), sin(yaw) of each obstacle
__host__ __device__ constexpr int window_fields(int proj_dot) { return proj_dot ? 3 : 2; }

__host__ __device__ inline long warp_floats(int N, int M, int R, int chunk, int proj_dot) {
  const long S = N + 1;
  const long m = chunk > 0 ? chunk : 1;
  return S * (kTrajFields + kGainFields + kDerivFields + kJacFields + kTrialFields * m +
              kObsFields * (long)M) +
         (long)window_fields(proj_dot) * R;
}

// bytes of one warp's region, a block's dynamic shared memory, rounded up to
// a multiple of 16
template <typename T>
inline long warp_bytes(int N, int M, int R, int chunk, int proj_dot) {
  return (warp_floats(N, M, R, chunk, proj_dot) * (long)sizeof(T) + 15) / 16 * 16;
}

template <typename T>
__device__ __forceinline__ T* dynamic_smem() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return reinterpret_cast<T*>(smem_raw);
}

__device__ __forceinline__ float sin_(float a) { return sinf(a); }
__device__ __forceinline__ double sin_(double a) { return sin(a); }
__device__ __forceinline__ float cos_(float a) { return cosf(a); }
__device__ __forceinline__ double cos_(double a) { return cos(a); }
__device__ __forceinline__ float tan_(float a) { return tanf(a); }
__device__ __forceinline__ double tan_(double a) { return tan(a); }
__device__ __forceinline__ float exp_(float a) { return expf(a); }
__device__ __forceinline__ double exp_(double a) { return exp(a); }
__device__ __forceinline__ float sqrt_(float a) { return sqrtf(a); }
__device__ __forceinline__ double sqrt_(double a) { return sqrt(a); }
__device__ __forceinline__ float hypot_(float a, float b) { return hypotf(a, b); }
__device__ __forceinline__ double hypot_(double a, double b) { return hypot(a, b); }
// iterations and statuses come back from a stats slab of T: round, do not
// truncate
__device__ __forceinline__ int rint_(float a) { return __float2int_rn(a); }
__device__ __forceinline__ int rint_(double a) { return __double2int_rn(a); }

// Products and sums rounded to nearest that nvcc never contracts into an
// FMA.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// Per-scenario constants of one solve, the lane's step and row limit, the
// warp's shared region, and the ALM state. Every lane holds the same
// values but `k` and `lim`.
template <typename T, bool kGravity, bool kAlm>
struct Ctx : AlmState<T, kAlm> {
  Weights<T> w;
  Problem<T> p;
  T* sm;  // the warp's region (`warp_floats`)
  int b, N, M, S, k, lim;
  int start;  // the line row of window row 0
  T up_bound, lo_bound, ref_velo, ell_a2, ell_b2, q0x, q0y;

  __device__ T at(const T* a, int row) const { return a[(size_t)row * p.B + b]; }

  // Field f (0 x, 1 y, 2 yaw) of line row `row`, and of window row r: line
  // row min(start + r, P - 1), so the window's tail repeats the last row.
  // Through the strides, not a branch on the layout: K1 ran ~2% faster.
  __device__ T line_row(int f, int row) const {
    return p.line[((size_t)f * p.P + row) * p.line_rs + (size_t)b * p.line_bs];
  }
  __device__ T window_row(int f, int r) const { return line_row(f, min(start + r, p.P - 1)); }

  // The region's arrays, in its order. Step arrays are indexed [f * S + k]
  // (S = N + 1); the trials [(a * kTrialFields + f) * S + k]; the
  // obstacles [(f * M + j) * S + k]; the window rows [f * R + r].
  __device__ T* cur() const { return sm; }
  __device__ T* gain() const { return sm + kTrajFields * S; }
  __device__ T* deriv() const { return gain() + kGainFields * S; }
  __device__ T* jac() const { return deriv() + kDerivFields * S; }
  __device__ T* trial() const { return jac() + kJacFields * S; }
  __device__ T* obs() const {
    return trial() + kTrialFields * (p.ls_chunk > 0 ? p.ls_chunk : 1) * S;
  }
  __device__ T* win() const { return obs() + kObsFields * M * S; }

  // ALM dual of constraint column `col` at horizon step k (ALM builds
  // only). The duals live in mu_out itself (scenario-fastest like every
  // other array), so nothing bounds the obstacle count. Columns follow the
  // reference's dual layout (src/cilqr_solver.cpp:622-676): 0-3 the control
  // bounds on steps 0..N-1; 4-7 velocity and road-border bounds, then 8+2j
  // / 9+2j obstacle j's front / rear disc, on steps 1..N.
  __device__ T& mu(int col, int k) const {
    const int n = col < 4 ? k : k - 1;
    return this->a.mu_out[((size_t)col * N + n) * p.B + b];
  }
};

// A trajectory in shared memory: controls 0..N-1 and states 0..N, and for
// the current trajectory the nearest window row (x, y, yaw) of every state.
template <typename T>
struct TrajView {
  T *ua, *us, *px, *py, *pv, *ph;
};

// One lane's step of a trajectory, with its projection.
template <typename T>
struct Step {
  T ua, us, px, py, pv, ph, rx, ry, rh;
};

template <typename T, bool G, bool A>
__device__ __forceinline__ TrajView<T> cur_view(const Ctx<T, G, A>& c) {
  T* t = c.cur();
  const int S = c.S;
  return {t, t + S, t + 2 * S, t + 3 * S, t + 4 * S, t + 5 * S};
}

template <typename T, bool G, bool A>
__device__ __forceinline__ TrajView<T> trial_view(const Ctx<T, G, A>& c, int a) {
  T* t = c.trial() + a * kTrialFields * c.S;
  const int S = c.S;
  return {t, t + S, t + 2 * S, t + 3 * S, t + 4 * S, t + 5 * S};
}

// The lane's step of trajectory `t` (controls 0 at step N; zeros past it).
template <typename T, bool G, bool A>
__device__ __forceinline__ Step<T> load_step(const Ctx<T, G, A>& c, TrajView<T> t) {
  const int k = c.k;
  Step<T> s = {};
  if (k > c.N) return s;
  s.ua = k < c.N ? t.ua[k] : T(0);
  s.us = k < c.N ? t.us[k] : T(0);
  s.px = t.px[k];
  s.py = t.py[k];
  s.pv = t.pv[k];
  s.ph = t.ph[k];
  return s;
}

// The lane's step of the current trajectory, with its projection.
template <typename T, bool G, bool A>
__device__ __forceinline__ Step<T> cur_step(const Ctx<T, G, A>& c) {
  Step<T> s = load_step(c, cur_view(c));
  if (c.k > c.N) return s;
  const T* r = c.cur() + 6 * c.S;
  s.rx = r[c.k];
  s.ry = r[c.S + c.k];
  s.rh = r[2 * c.S + c.k];
  return s;
}

// Sum over the lanes in one fixed order (a shuffle tree into lane 0), the
// result in every lane: the one horizon sum of the kernel.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) v += __shfl_down_sync(kFull, v, off);
  return __shfl_sync(kFull, v, 0);
}

template <typename T, bool G, bool A>
__device__ __forceinline__ T barrier(const Ctx<T, G, A>& c, T con, T q1, T q2) {
  T e = q2 * con;
  e = e > c.w.exp_clip ? c.w.exp_clip : e;
  return q1 * exp_(e);
}

// Gradient and Hessian factors of one penalty term: its gradient is
// g * dc/dx and its Hessian h * dc/dx dc/dx' (src/cilqr_solver.cpp:692-713).
template <typename T>
struct Pen {
  T g, h;
};

// Penalty value of constraint `col` at step k (include/cilqr_solver.hpp:
// 80-83). Barrier: q1 exp(q2 c). ALM: with s = c + mu / rho, 0.5 rho s^2
// when s > 0, else 0. rho = 0 (scenario_three_straight.yaml) gives
// s = 0/0 = NaN and an inactive term, as in the JAX package: the division
// is not guarded, and the build does not use fast-math.
template <typename T, bool G, bool A>
__device__ __forceinline__ T pen_val(const Ctx<T, G, A>& c, T con, T q1, T q2, int col, int k) {
  if constexpr (A) {
    const T s = con + c.mu(col, k) / c.rho;
    return s > T(0) ? T(0.5) * c.rho * s * s : T(0);
  } else {
    return barrier(c, con, q1, q2);
  }
}

// Barrier: g = q2 b, h = q2^2 b. ALM: g = h = rho s when s > 0 -- the
// reference's rank-1 Hessian, kept as the JAX package keeps it.
template <typename T, bool G, bool A>
__device__ __forceinline__ Pen<T> pen(const Ctx<T, G, A>& c, T con, T q1, T q2, int col, int k) {
  if constexpr (A) {
    const T s = con + c.mu(col, k) / c.rho;
    const T g = s > T(0) ? c.rho * s : T(0);
    return {g, g};
  } else {
    const T bv = barrier(c, con, q1, q2);
    return {q2 * bv, (q2 * q2) * bv};
  }
}

// One step of the discrete bicycle (reference src/utils.cpp:265-279).
template <typename T, bool G, bool A>
__device__ __forceinline__ void propagate(const Ctx<T, G, A>& c, T& x, T& y, T& v, T& h, T ua,
                                          T us) {
  const T dt = c.w.dt;
  T nx, ny, nv, nh;
  if constexpr (G) {
    // slip angle beta = atan(tan(us) / 2), through sin/cos without atan:
    // sin = (t/2) / sqrt(1 + t^2/4), cos = 1 / sqrt(1 + t^2/4)
    // (JAX kernel `_beta_trig`, :292-298)
    const T tn = tan_(us);
    const T inv = T(1) / sqrt_(T(1) + T(0.25) * tn * tn);
    const T sb = T(0.5) * tn * inv, cb = inv;
    const T cyw = cos_(h), syw = sin_(h);
    const T cby = cb * cyw - sb * syw;  // cos(beta + yaw)
    const T sby = sb * cyw + cb * syw;  // sin(beta + yaw)
    nx = x + v * cby * dt;
    ny = y + v * sby * dt;
    nv = v + ua * dt;
    nh = h + T(2) * v * sb * dt / c.w.wb;
  } else {
    nx = x + v * cos_(h) * dt;
    ny = y + v * sin_(h) * dt;
    nv = v + ua * dt;
    nh = h + v * tan_(us) * dt / c.w.wb;
  }
  x = nx;
  y = ny;
  v = nv;
  h = nh;
}

// Front and rear disc centres of the ego footprint (src/utils.cpp:344-361):
// rear center: front = position + wb (cos, sin), rear = position; gravity
// center: +-wb/2 along the yaw.
template <typename T, bool G, bool A>
__device__ __forceinline__ void front_rear(const Ctx<T, G, A>& c, T px, T py, T cy, T sy, T& fx,
                                           T& fy, T& rx, T& ry) {
  if constexpr (G) {
    const T hx = T(0.5) * (c.w.wb * cy), hy = T(0.5) * (c.w.wb * sy);
    fx = px + hx;
    fy = py + hy;
    rx = px - hx;
    ry = py - hy;
  } else {
    fx = px + c.w.wb * cy;
    fy = py + c.w.wb * sy;
    rx = px;
    ry = py;
  }
}

// Score of window row r for the query (qx, qy), from the staged rows: the
// squared distance, or the dot form (p_cr + p_nx qx) + p_ny qy with the
// query centred on window row 0 (JAX kernel :280-286, :366-367, :434); both
// have the same argmin in exact arithmetic. Both rounded op by op.
template <bool kDot, typename T>
__device__ __forceinline__ T score(T f0, T f1, T f2, T qx, T qy) {
  if constexpr (kDot) {
    return add_rn(add_rn(f0, mul_rn(f1, qx)), mul_rn(f2, qy));
  } else {
    const T dx = qx - f0, dy = qy - f1;
    return add_rn(mul_rn(dx, dx), mul_rn(dy, dy));
  }
}

template <bool kDot, typename T, bool G, bool A>
__device__ __forceinline__ T row_score(const Ctx<T, G, A>& c, int r, T qx, T qy) {
  const T* win = c.win();
  const int R = c.p.R;
  return score<kDot>(win[r], win[R + r], kDot ? win[2 * R + r] : T(0), qx, qy);
}

// Two T's in one shared-memory load (float2, double2).
template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<double> {
  using type = double2;
};

// The scores of window rows r and r + 1 (r even), each field's two rows in
// one load: the region's window starts on an even element and R is even.
template <bool kDot, typename T, bool G, bool A>
__device__ __forceinline__ void row_scores2(const Ctx<T, G, A>& c, int r, T qx, T qy, T& s0,
                                            T& s1) {
  using V = typename Pair<T>::type;
  const T* win = c.win() + r;
  const int R = c.p.R;
  const V f0 = *reinterpret_cast<const V*>(win), f1 = *reinterpret_cast<const V*>(win + R);
  const V f2 = kDot ? *reinterpret_cast<const V*>(win + 2 * R) : V{};
  s0 = score<kDot>(f0.x, f1.x, f2.x, qx, qy);
  s1 = score<kDot>(f0.y, f1.y, f2.y, qx, qy);
}

// A lane's share of a projection's window scan. Lane k's query searches
// rows [0, lim[k]), and the limits rise with k, so a warp scanning each
// lane's rows alone runs as long as its longest limit. Lanes k and N - k
// pair up instead: where their limits a < b differ, the pair's a + b rows
// split at h = ceil((a + b) / 2) -- the long lane scores its own query on
// [0, h), the short one its own on [0, a) and then the long lane's on [h,
// b) -- so each scores about half. Equal limits, the middle step and the
// lanes past step N split nothing.
struct ScanLane {
  int own;      // rows [0, own) of the lane's own query
  int partner;  // the paired lane, or the lane itself
  int lo, n;    // rows [lo, lo + n - own) of the partner's query follow
};

template <typename T, bool G, bool A>
__device__ __forceinline__ ScanLane scan_lane(const Ctx<T, G, A>& c) {
  const int k = c.k, j = k <= c.N ? c.N - k : k;
  const int a = c.lim, b = __shfl_sync(kFull, c.lim, j), h = (a + b + 1) / 2;
  if (k > c.N) return {0, k, 0, 0};
  if (a < b) return {a, j, h, a + b - h};
  const int own = a > b ? h : a;
  return {own, j, 0, own};
}

// Each lane's first minimum over rows [0, lim) (strict < keeps the first
// row on ties), the scan split as `scan_lane` splits it: bit for bit a
// scan of the lane's rows in order. The first run starts from row 0 (a NaN
// there pins row 0, a later NaN never wins), the second from no row and
// +inf; the long lane takes the second run's row only where its score is
// strictly below its own best, so a tie across the runs goes to the lower
// row; a lane with no second run (uniform limits) scans its rows alone.
// One loop over both of the lane's runs, switching query and row base
// where the first ends: two loops in turn would run the longest first run
// and then the longest second. U rows a turn, scored before they are
// compared, two rows a load where U is even; every run's length, its start
// and R are multiples of U.
template <int U, bool kDot, typename T, bool G, bool A>
__device__ __forceinline__ int split_min(const Ctx<T, G, A>& c, const ScanLane& sl, T qx, T qy) {
  const T px = __shfl_sync(kFull, qx, sl.partner), py = __shfl_sync(kFull, qy, sl.partner);
  T best = row_score<kDot>(c, 0, qx, qy), best1 = best;
  int bi = 0, bi1 = 0, base = 0;
  for (int t = 0; t < sl.n; t += U) {  // row 0 again, which changes nothing
    if (t == sl.own) {
      best1 = best;
      bi1 = bi;
      best = T(INFINITY);
      bi = -1;
      qx = px;
      qy = py;
      base = sl.lo - sl.own;
    }
    const int r0 = base + t;
    T s[U];
    if constexpr (U % 2 == 0) {
#pragma unroll
      for (int u = 0; u < U; u += 2) row_scores2<kDot>(c, r0 + u, qx, qy, s[u], s[u + 1]);
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u) s[u] = row_score<kDot>(c, r0 + u, qx, qy);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s[u] < best) {
        best = s[u];
        bi = r0 + u;
      }
    }
  }
  if (sl.n == sl.own) {  // no second run
    best1 = best;
    bi1 = bi;
    best = T(INFINITY);
    bi = -1;
  }
  const T other = __shfl_sync(kFull, best, sl.partner);
  const int other_i = __shfl_sync(kFull, bi, sl.partner);
  return other < best1 ? other_i : bi1;
}

// Each lane's first minimum over rows [0, lim): 4 rows a turn where every
// run allows it, else 1.
template <bool kDot, typename T, bool G, bool A>
__device__ __forceinline__ int scan_min(const Ctx<T, G, A>& c, T qx, T qy) {
  const ScanLane sl = scan_lane(c);
  if (__all_sync(kFull, ((sl.own | sl.n | c.p.R) & 3) == 0))
    return split_min<4, kDot>(c, sl, qx, qy);
  return split_min<1, kDot>(c, sl, qx, qy);
}

// The pair-fold tournament over rows [0, n) (JAX kernel :381-395): while
// n > 1, slot i meets slot i + h (h = n / 2) and the later one wins only
// on strict <; an odd tail slot 2h moves to slot h; n -= h. Ties go by
// tournament order, not by first index. The first round scores the window
// rows; later rounds halve the lane's scratch in place (slot i < h is
// written, slots >= h are read).
template <bool kDot, typename T, bool G, bool A>
__device__ int fold_min(const Ctx<T, G, A>& c, T qx, T qy, int n) {
  const size_t base = (size_t)c.k * c.p.B + c.b, slot = (size_t)c.S * c.p.B;
  T* const fs = c.p.fold_s + base;
  int* const fi = c.p.fold_i + base;
  if (n == 1) return 0;
  int h = n / 2;
  for (int i = 0; i < h; ++i) {
    const T lo = row_score<kDot>(c, i, qx, qy), hi = row_score<kDot>(c, i + h, qx, qy);
    const bool up = hi < lo;
    fs[i * slot] = up ? hi : lo;
    fi[i * slot] = up ? i + h : i;
  }
  if (n & 1) {
    fs[h * slot] = row_score<kDot>(c, 2 * h, qx, qy);
    fi[h * slot] = 2 * h;
  }
  for (n -= h; n > 1; n -= h) {
    h = n / 2;
    for (int i = 0; i < h; ++i) {
      const T hi = fs[(i + h) * slot];
      if (hi < fs[i * slot]) {
        fs[i * slot] = hi;
        fi[i * slot] = fi[(i + h) * slot];
      }
    }
    if (n & 1) {
      fs[h * slot] = fs[2 * h * slot];
      fi[h * slot] = fi[2 * h * slot];
    }
  }
  return fi[0];
}

// Nearest window row of the lane's state over rows [0, lim), in the
// solve's projection mode, called by the whole warp; lanes past step N
// keep their zeros. Forced inline at its two calls: a build that left it
// to the compiler spilled in the f32 rear-center barrier instantiation.
template <typename T, bool G, bool A>
__device__ __forceinline__ void project(const Ctx<T, G, A>& c, Step<T>& s) {
  const Problem<T>& p = c.p;
  int bi;
  if (p.proj_fold) {
    if (c.k > c.N) return;
    bi = p.proj_dot ? fold_min<true>(c, s.px - c.q0x, s.py - c.q0y, c.lim)
                    : fold_min<false>(c, s.px, s.py, c.lim);
  } else {
    bi = p.proj_dot ? scan_min<true>(c, s.px - c.q0x, s.py - c.q0y)
                    : scan_min<false>(c, s.px, s.py);
    if (c.k > c.N) return;
  }
  s.rx = c.window_row(0, bi);
  s.ry = c.window_row(1, bi);
  s.rh = c.window_row(2, bi);
}

// Whether (s, r) comes before (best, bi) in torch.argmin's order as it
// runs on the card: a NaN is the minimum, equal scores and two NaNs go to
// the lower row; r < 0 is no row, after every row.
template <typename T>
__device__ __forceinline__ bool precedes(T s, int r, T best, int bi) {
  if (r < 0) return false;
  if (bi < 0) return true;
  if (s != s) return best == best || r < bi;
  if (best != best) return false;
  return s < best || (s == best && r < bi);
}

// Rows a lane of the nearest-row search scores before it compares them, so
// that their loads are in flight together (one row at a time, K1 ran ~0.5%
// slower at the cells' cold shapes).
constexpr int kSearchBatch = 8;

// The first minimum over all P line rows of the squared distance to (ex,
// ey), rounded as the PyTorch version rounds it ((lx - ex)^2 + (ly - ey)^2,
// each operation on its own), in every lane: lane i keeps its first
// minimum of rows i, i + 32, ..., and a shuffle tree merges the lanes'.
template <typename T, bool G, bool A>
__device__ int nearest_row(const Ctx<T, G, A>& c, T ex, T ey) {
  const int P = c.p.P;
  T best = T(0);
  int bi = -1;
  for (int r0 = c.k; r0 < P; r0 += kSearchBatch * kWarp) {
    T s[kSearchBatch];
#pragma unroll
    for (int u = 0; u < kSearchBatch; ++u) {  // rows past P - 1 read row P - 1
      const int r = min(r0 + u * kWarp, P - 1);
      const T dx = c.line_row(0, r) - ex, dy = c.line_row(1, r) - ey;
      s[u] = add_rn(mul_rn(dx, dx), mul_rn(dy, dy));
    }
#pragma unroll
    for (int u = 0; u < kSearchBatch; ++u) {  // and are not compared
      const int r = r0 + u * kWarp;
      if (r < P && precedes(s[u], r, best, bi)) {
        best = s[u];
        bi = r;
      }
    }
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) {
    const T s = __shfl_down_sync(kFull, best, off);
    const int r = __shfl_down_sync(kFull, bi, off);
    if (precedes(s, r, best, bi)) {
      best = s;
      bi = r;
    }
  }
  return __shfl_sync(kFull, bi, 0);
}

// The solve's window, from its start (x0[0], x0[1]): window row 0 is line
// row max(nearest - w_back, 0) (not clamped to P - W), and the R searched
// rows are staged into the region -- x and y, or the dot form's terms
// centred on window row 0 (p_cr = |r - r0|^2, p_nx = -2 (rx - r0x), p_ny =
// -2 (ry - r0y)), rounded op by op as ops/projection.py's `dot_terms`.
// With `window_out`, the start and the staged rows are written back.
template <typename T, bool G, bool A>
__device__ void stage_window(Ctx<T, G, A>& c) {
  const Problem<T>& p = c.p;
  c.start = max(nearest_row(c, c.at(p.x0, 0), c.at(p.x0, 1)) - p.w_back, 0);
  // the dot form's query is centred on window row 0
  c.q0x = p.proj_dot ? c.window_row(0, 0) : T(0);
  c.q0y = p.proj_dot ? c.window_row(1, 0) : T(0);
  const int R = p.R, F = window_fields(p.proj_dot);
  T* win = c.win();
  for (int r = c.k; r < R; r += kWarp) {
    const T x = c.window_row(0, r), y = c.window_row(1, r);
    if (p.proj_dot) {
      const T xc = x - c.q0x, yc = y - c.q0y;
      win[r] = add_rn(mul_rn(xc, xc), mul_rn(yc, yc));
      win[R + r] = T(-2) * xc;
      win[2 * R + r] = T(-2) * yc;
    } else {
      win[r] = x;
      win[R + r] = y;
    }
  }
  if (p.window_out) {  // each lane reads back the rows it staged
    if (c.k == 0) p.window_out[c.b] = T(c.start);
    for (int f = 0; f < F; ++f)
      for (int r = c.k; r < R; r += kWarp)
        p.window_out[(size_t)(1 + f * R + r) * p.B + c.b] = win[f * R + r];
  }
}

// Ellipse safety margin of point (qx, qy) against obstacle j at step k
// (reference src/utils.cpp:387-439); writes dc/dq when g is given.
template <typename T, bool G, bool A>
__device__ __forceinline__ T ellipse(const Ctx<T, G, A>& c, int j, int k, T qx, T qy, T* gx,
                                     T* gy) {
  const int S = c.S, MS = c.M * S, e = j * S + k;
  const T* o = c.obs();
  const T ct = o[2 * MS + e], st = o[3 * MS + e];
  const T ddx = qx - o[e], ddy = qy - o[MS + e];
  const T xs = ct * ddx + st * ddy;
  const T ys = -st * ddx + ct * ddy;
  if (gx) {
    const T gxs = T(-2) * xs / c.ell_a2;
    const T gys = T(-2) * ys / c.ell_b2;
    *gx = ct * gxs - st * gys;
    *gy = st * gxs + ct * gys;
  }
  return T(1) - (xs * xs / c.ell_a2 + ys * ys / c.ell_b2);
}

// Signed lateral offset to the projected row, sign(0) = +1
// (src/cilqr_solver.cpp:507-509).
template <typename T>
__device__ __forceinline__ T lateral(const Step<T>& s, T* ddx, T* ddy, T* h, T* dsign) {
  *ddx = s.px - s.rx;
  *ddy = s.py - s.ry;
  *dsign = *ddy * cos_(s.rh) - *ddx * sin_(s.rh);
  *h = hypot_(*ddx, *ddy);
  return *dsign < T(0) ? -*h : *h;
}

// Cost of the lane's step of a projected trajectory
// (src/cilqr_solver.cpp:199-287): tracking cost on steps 0..N, control
// cost and control-bound penalties on steps 0..N-1, state, border and
// obstacle penalties on steps 1..N; 0 past step N.
template <typename T, bool G, bool A>
__device__ __forceinline__ T step_cost(const Ctx<T, G, A>& c, const Step<T>& s) {
  const Weights<T>& w = c.w;
  const int k = c.k;
  if (k > c.N) return T(0);
  const T dx = s.px - s.rx, dy = s.py - s.ry;
  const T dv = s.pv - c.ref_velo, dh = s.ph - s.rh;
  T J = w.w_pos * (dx * dx + dy * dy) + w.w_vel * dv * dv + w.w_yaw * dh * dh;
  if (k < c.N) {
    J += w.w_acc * s.ua * s.ua + w.w_stl * s.us * s.us;
    J += pen_val(c, s.ua - w.acc_max, w.sq1, w.sq2, 0, k) +
         pen_val(c, w.acc_min - s.ua, w.sq1, w.sq2, 1, k) +
         pen_val(c, s.us - w.stl_lim, w.sq1, w.sq2, 2, k) +
         pen_val(c, -w.stl_lim - s.us, w.sq1, w.sq2, 3, k);
  }
  if (k >= 1) {
    J += pen_val(c, s.pv - w.velo_max, w.sq1, w.sq2, 4, k) +
         pen_val(c, w.velo_min - s.pv, w.sq1, w.sq2, 5, k);
    T ddx, ddy, h, ds;
    const T cur_d = lateral(s, &ddx, &ddy, &h, &ds);
    J += pen_val(c, cur_d - c.up_bound, w.sq1, w.sq2, 6, k) +
         pen_val(c, c.lo_bound - cur_d, w.sq1, w.sq2, 7, k);
    T fx, fy, rx, ry;
    front_rear(c, s.px, s.py, cos_(s.ph), sin_(s.ph), fx, fy, rx, ry);
    for (int j = 0; j < c.M; ++j) {
      J += pen_val(c, ellipse(c, j, k, fx, fy, (T*)nullptr, (T*)nullptr), w.oq1, w.oq2,
                   8 + 2 * j, k);
      J += pen_val(c, ellipse(c, j, k, rx, ry, (T*)nullptr, (T*)nullptr), w.oq1, w.oq2,
                   9 + 2 * j, k);
    }
  }
  return J;
}

// Total cost of a projected trajectory: each lane's step, summed by the
// shuffle tree. The one cost function of the kernel, so the cost of an
// adopted trial is the cost the resume entry recomputes, bit for bit.
template <typename T, bool G, bool A>
__device__ T total_cost(const Ctx<T, G, A>& c, const Step<T>& s) {
  return warp_sum(step_cost(c, s));
}

// Cost derivatives at one step (src/cilqr_solver.cpp:463-690); l_ux == 0 and
// l_uu is diagonal.
template <typename T>
struct StepDerivs {
  T lx[4], lxx[4][4], lu[2], luu00, luu11;
};

template <typename T, bool G, bool A>
__device__ void step_derivs(const Ctx<T, G, A>& c, const Step<T>& t, StepDerivs<T>& D) {
  const Weights<T>& w = c.w;
  const int k = c.k;
  const T dx = t.px - t.rx, dy = t.py - t.ry;
  const T dv = t.pv - c.ref_velo, dh = t.ph - t.rh;
  D.lx[0] = T(2) * w.w_pos * dx;
  D.lx[1] = T(2) * w.w_pos * dy;
  D.lx[2] = T(2) * w.w_vel * dv;
  D.lx[3] = T(2) * w.w_yaw * dh;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) D.lxx[i][j] = T(0);
  D.lxx[0][0] = D.lxx[1][1] = T(2) * w.w_pos;
  D.lxx[2][2] = T(2) * w.w_vel;
  D.lxx[3][3] = T(2) * w.w_yaw;
  D.lu[0] = D.lu[1] = D.luu00 = D.luu11 = T(0);
  if (k < c.N) {
    const T ua = t.ua, us = t.us;
    const Pen<T> p0 = pen(c, ua - w.acc_max, w.sq1, w.sq2, 0, k);
    const Pen<T> p1 = pen(c, w.acc_min - ua, w.sq1, w.sq2, 1, k);
    const Pen<T> p2 = pen(c, us - w.stl_lim, w.sq1, w.sq2, 2, k);
    const Pen<T> p3 = pen(c, -w.stl_lim - us, w.sq1, w.sq2, 3, k);
    D.lu[0] = T(2) * w.w_acc * ua + (p0.g - p1.g);
    D.lu[1] = T(2) * w.w_stl * us + (p2.g - p3.g);
    D.luu00 = T(2) * w.w_acc + (p0.h + p1.h);
    D.luu11 = T(2) * w.w_stl + (p2.h + p3.h);
  }
  if (k >= 1) {
    const T v = t.pv;
    const Pen<T> p4 = pen(c, v - w.velo_max, w.sq1, w.sq2, 4, k);
    const Pen<T> p5 = pen(c, w.velo_min - v, w.sq1, w.sq2, 5, k);
    D.lx[2] += p4.g - p5.g;
    D.lxx[2][2] += p4.h + p5.h;
    // road borders: gradient (+-gx, +-gy, 0, 0), zero at h == 0
    T ddx, ddy, h, ds;
    const T cur_d = lateral(t, &ddx, &ddy, &h, &ds);
    const Pen<T> p6 = pen(c, cur_d - c.up_bound, w.sq1, w.sq2, 6, k);
    const Pen<T> p7 = pen(c, c.lo_bound - cur_d, w.sq1, w.sq2, 7, k);
    const T flip = ds < T(0) ? T(-1) : T(1);
    const T gpx = h > T(0) ? flip * (ddx / h) : T(0);
    const T gpy = h > T(0) ? flip * (ddy / h) : T(0);
    const T gsum = p6.g - p7.g, hsum = p6.h + p7.h;
    D.lx[0] += gsum * gpx;
    D.lx[1] += gsum * gpy;
    D.lxx[0][0] += hsum * gpx * gpx;
    D.lxx[0][1] += hsum * gpx * gpy;
    D.lxx[1][1] += hsum * gpy * gpy;
    // obstacle ellipses, chained through the front/rear point Jacobians
    const T sy = sin_(t.ph), cy = cos_(t.ph);
    T fx, fy, rx, ry;
    front_rear(c, t.px, t.py, cy, sy, fx, fy, rx, ry);
    for (int j = 0; j < c.M; ++j) {
      for (int front = 1; front >= 0; --front) {
        T gx, gy;
        const T m = front ? ellipse(c, j, k, fx, fy, &gx, &gy)
                          : ellipse(c, j, k, rx, ry, &gx, &gy);
        const Pen<T> pj = pen(c, m, w.oq1, w.oq2, front ? 8 + 2 * j : 9 + 2 * j, k);
        const T gcoef = pj.g, hcoef = pj.h;
        // d(point)/d(yaw): front (-s, c) and rear (s, -c) times wb/2 at the
        // gravity center (JAX kernel :644-646); front wb (-s, c) and a
        // fixed rear point at the rear center
        T g3;
        if constexpr (G) {
          const T hw = T(0.5) * w.wb;
          g3 = front ? (-hw * sy) * gx + (hw * cy) * gy : (hw * sy) * gx + (-hw * cy) * gy;
        } else {
          g3 = front ? (-w.wb * sy) * gx + (w.wb * cy) * gy : T(0);
        }
        D.lx[0] += gcoef * gx;
        D.lx[1] += gcoef * gy;
        D.lx[3] += gcoef * g3;
        D.lxx[0][0] += hcoef * gx * gx;
        D.lxx[0][1] += hcoef * gx * gy;
        D.lxx[0][3] += hcoef * gx * g3;
        D.lxx[1][1] += hcoef * gy * gy;
        D.lxx[1][3] += hcoef * gy * g3;
        D.lxx[3][3] += hcoef * g3 * g3;
      }
    }
  }
}

// The bicycle Jacobians at one step (src/utils.cpp:285-342):
// A = I + a02 e0e2' + a03 e0e3' + a12 e1e2' + a13 e1e3' + a32 e3e2',
// B = dt e2e0' + (b01 e0 + b11 e1 + b31 e3) e1', where b01 = b11 = 0 at the
// rear center.
template <typename T>
struct Jac {
  T a02, a03, a12, a13, a32, b01, b11, b31;
};

template <typename T, bool G, bool A>
__device__ __forceinline__ Jac<T> jacobian(const Ctx<T, G, A>& c, const Step<T>& t) {
  const T dt = c.w.dt, wb = c.w.wb;
  const T v = t.pv, yaw = t.ph, stl = t.us;
  const T cyw = cos_(yaw), syw = sin_(yaw);
  Jac<T> J;
  if constexpr (G) {
    // REFERENCE QUIRK, kept on purpose: the Jacobian's slip angle is
    // atan(tan(stl / 2)) (src/utils.cpp:292; JAX kernel `_beta_jac_trig`
    // :300-307), not the dynamics' atan(tan(stl) / 2); the derivative
    // factor dbds is the exact d/dstl of the dynamics' beta.
    const T tj = tan_(T(0.5) * stl);
    const T ij = T(1) / sqrt_(T(1) + tj * tj);
    const T sb = tj * ij, cb = ij;
    const T tn = tan_(stl);
    const T t2 = tn * tn;
    const T dbds = T(0.5) * (T(1) + t2) / (T(1) + T(0.25) * t2);
    const T cby = cb * cyw - sb * syw, sby = sb * cyw + cb * syw;
    J.a02 = cby * dt;
    J.a03 = -v * sby * dt;
    J.a12 = sby * dt;
    J.a13 = v * cby * dt;
    J.a32 = T(2) * sb * dt / wb;
    J.b01 = -v * sby * dt * dbds;
    J.b11 = v * cby * dt * dbds;
    J.b31 = (T(2) * v * dt / wb) * cb * dbds;
  } else {
    const T cs = cos_(stl);
    J.a02 = cyw * dt;
    J.a03 = -v * syw * dt;
    J.a12 = syw * dt;
    J.a13 = v * cyw * dt;
    J.a32 = tan_(stl) * dt / wb;
    J.b01 = J.b11 = T(0);
    J.b31 = (v * dt / wb) / (cs * cs);
  }
  return J;
}

// Each lane stores the cost derivatives of its step of the current
// trajectory and, below step N, the dynamics Jacobians there.
template <typename T, bool G, bool A>
__device__ void derivatives(const Ctx<T, G, A>& c) {
  const int k = c.k, S = c.S;
  __syncwarp();  // the last iteration's backward pass has read them
  if (k <= c.N) {
    const Step<T> t = cur_step(c);
    StepDerivs<T> D;
    step_derivs(c, t, D);
    T* o = c.deriv() + k;
    const T f[kDerivFields] = {D.lx[0],     D.lx[1],     D.lx[2],     D.lx[3],     D.lxx[0][0],
                               D.lxx[0][1], D.lxx[0][3], D.lxx[1][1], D.lxx[1][3], D.lxx[2][2],
                               D.lxx[3][3], D.lu[0],     D.lu[1],     D.luu00,     D.luu11};
#pragma unroll
    for (int i = 0; i < kDerivFields; ++i) o[i * S] = f[i];
    if (k < c.N) {
      const Jac<T> J = jacobian(c, t);
      T* q = c.jac() + k;
      const T g[kJacFields] = {J.a02, J.a03, J.a12, J.a13, J.a32, J.b01, J.b11, J.b31};
#pragma unroll
      for (int i = 0; i < kJacFields; ++i) q[i * S] = g[i];
    }
  }
  __syncwarp();
}

// Step k's derivatives from the warp's shared arrays (lxx's zero entries
// are exact zeros, as step_derivs leaves them).
template <typename T, bool G, bool A>
__device__ __forceinline__ void read_derivs(const Ctx<T, G, A>& c, int k, StepDerivs<T>& D) {
  const T* o = c.deriv() + k;
  const int S = c.S;
  for (int i = 0; i < 4; ++i) D.lx[i] = o[i * S];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) D.lxx[i][j] = T(0);
  D.lxx[0][0] = o[4 * S];
  D.lxx[0][1] = D.lxx[1][0] = o[5 * S];
  D.lxx[0][3] = D.lxx[3][0] = o[6 * S];
  D.lxx[1][1] = o[7 * S];
  D.lxx[1][3] = D.lxx[3][1] = o[8 * S];
  D.lxx[2][2] = o[9 * S];
  D.lxx[3][3] = o[10 * S];
  D.lu[0] = o[11 * S];
  D.lu[1] = o[12 * S];
  D.luu00 = o[13 * S];
  D.luu11 = o[14 * S];
}

// Riccati backward pass (src/cilqr_solver.cpp:383-440) over the stored
// derivatives and Jacobians, run by every lane alike; lane 0 stores the
// gains. Returns false when some Q_uu is not positive definite (the pass is
// then discarded).
template <typename T, bool G, bool A>
__device__ bool backward(const Ctx<T, G, A>& c, T lamb, T& dV1, T& dV2) {
  const T dt = c.w.dt;
  const int S = c.S;
  StepDerivs<T> D;
  read_derivs(c, c.N, D);
  T Vx[4], V[4][4];
  for (int i = 0; i < 4; ++i) {
    Vx[i] = D.lx[i];
    for (int j = 0; j < 4; ++j) V[i][j] = D.lxx[i][j];
  }
  dV1 = dV2 = T(0);
  for (int k = c.N - 1; k >= 0; --k) {
    read_derivs(c, k, D);
    const T* q = c.jac() + k;
    const T a02 = q[0], a03 = q[S], a12 = q[2 * S], a13 = q[3 * S], a32 = q[4 * S];
    const T b01 = q[5 * S], b11 = q[6 * S], b31 = q[7 * S];

    T Qx[4], Qu[2], M1[4][4], Qxx[4][4], Qux[2][4];
    Qx[0] = D.lx[0] + Vx[0];
    Qx[1] = D.lx[1] + Vx[1];
    Qx[2] = D.lx[2] + (a02 * Vx[0] + a12 * Vx[1] + Vx[2] + a32 * Vx[3]);
    Qx[3] = D.lx[3] + (a03 * Vx[0] + a13 * Vx[1] + Vx[3]);
    Qu[0] = D.lu[0] + dt * Vx[2];
    if constexpr (G) {
      Qu[1] = D.lu[1] + (b01 * Vx[0] + b11 * Vx[1] + b31 * Vx[3]);
    } else {
      Qu[1] = D.lu[1] + b31 * Vx[3];
    }
    for (int i = 0; i < 4; ++i) {  // M1 = V A
      M1[i][0] = V[i][0];
      M1[i][1] = V[i][1];
      M1[i][2] = a02 * V[i][0] + a12 * V[i][1] + V[i][2] + a32 * V[i][3];
      M1[i][3] = a03 * V[i][0] + a13 * V[i][1] + V[i][3];
    }
    for (int j = 0; j < 4; ++j) {  // Qxx = lxx + A' M1, Qux = B' M1
      Qxx[0][j] = D.lxx[0][j] + M1[0][j];
      Qxx[1][j] = D.lxx[1][j] + M1[1][j];
      Qxx[2][j] = D.lxx[2][j] + (a02 * M1[0][j] + a12 * M1[1][j] + M1[2][j] + a32 * M1[3][j]);
      Qxx[3][j] = D.lxx[3][j] + (a03 * M1[0][j] + a13 * M1[1][j] + M1[3][j]);
      Qux[0][j] = dt * M1[2][j];
      if constexpr (G) {
        Qux[1][j] = b01 * M1[0][j] + b11 * M1[1][j] + b31 * M1[3][j];
      } else {
        Qux[1][j] = b31 * M1[3][j];
      }
    }
    // Quu = luu + B' V B + lamb I (symmetric)
    T q00, q01, q11;
    q00 = D.luu00 + dt * (dt * V[2][2]) + lamb;
    if constexpr (G) {
      q01 = dt * (b01 * V[2][0] + b11 * V[2][1] + b31 * V[2][3]);  // dt (V B)[2][1]
      q11 = D.luu11 +
            (b01 * (b01 * V[0][0] + b11 * V[0][1] + b31 * V[0][3]) +
             b11 * (b01 * V[1][0] + b11 * V[1][1] + b31 * V[1][3]) +
             b31 * (b01 * V[3][0] + b11 * V[3][1] + b31 * V[3][3])) +
            lamb;
    } else {
      q01 = dt * (b31 * V[2][3]);
      q11 = D.luu11 + b31 * (b31 * V[3][3]) + lamb;
    }
    const T det = q00 * q11 - q01 * q01;
    if (!(q00 > T(0) && det > T(0))) return false;
    const T i00 = q11 / det, i01 = -q01 / det, i11 = q00 / det;
    const T d0 = -(i00 * Qu[0] + i01 * Qu[1]);
    const T d1 = -(i01 * Qu[0] + i11 * Qu[1]);
    T Kr[2][4];
    for (int j = 0; j < 4; ++j) {
      Kr[0][j] = -(i00 * Qux[0][j] + i01 * Qux[1][j]);
      Kr[1][j] = -(i01 * Qux[0][j] + i11 * Qux[1][j]);
    }
    if (c.k == 0) {
      T* g = c.gain() + k;
      for (int j = 0; j < 4; ++j) {
        g[j * S] = Kr[0][j];
        g[(4 + j) * S] = Kr[1][j];
      }
      g[8 * S] = d0;
      g[9 * S] = d1;
    }
    // value update (src/cilqr_solver.cpp:427-432)
    const T Qud0 = q00 * d0 + q01 * d1, Qud1 = q01 * d0 + q11 * d1;
    for (int j = 0; j < 4; ++j)
      Vx[j] = Qx[j] + Kr[0][j] * (Qud0 + Qu[0]) + Kr[1][j] * (Qud1 + Qu[1]) +
              Qux[0][j] * d0 + Qux[1][j] * d1;
    for (int i = 0; i < 4; ++i) {
      for (int j = i; j < 4; ++j) {
        const T KQuuK = Kr[0][i] * (q00 * Kr[0][j] + q01 * Kr[1][j]) +
                        Kr[1][i] * (q01 * Kr[0][j] + q11 * Kr[1][j]);
        const T KQux = Kr[0][i] * Qux[0][j] + Kr[1][i] * Qux[1][j];
        const T QuxK = Qux[0][i] * Kr[0][j] + Qux[1][i] * Kr[1][j];
        V[i][j] = V[j][i] = Qxx[i][j] + KQuuK + KQux + QuxK;
      }
    }
    dV1 += T(0.5) * (d0 * Qud0 + d1 * Qud1);
    dV2 += d0 * Qu[0] + d1 * Qu[1];
  }
  return true;
}

// The trial rollouts of one line-search chunk: lane a < m rolls out the
// closed loop u' = u + K (x' - x) + alpha_a d, then the dynamics
// (src/cilqr_solver.cpp:442-461), at alpha_a = alpha0 / 2^a, into trial a
// (JAX kernel `forward_packed`, :857-890). Every chain runs the same
// instructions, so a trial's bits do not depend on its lane.
template <typename T, bool G, bool A>
__device__ void forward_chunk(const Ctx<T, G, A>& c, T alpha0, int m) {
  __syncwarp();  // the previous chunk's trials are judged
  const int a = c.k;
  if (a < m) {
    T alpha = alpha0;
    for (int i = 0; i < a; ++i) alpha *= T(0.5);
    const TrajView<T> cur = cur_view(c), tr = trial_view(c, a);
    const T* g = c.gain();
    const int S = c.S;
    T x = tr.px[0] = cur.px[0], y = tr.py[0] = cur.py[0];
    T v = tr.pv[0] = cur.pv[0], h = tr.ph[0] = cur.ph[0];
    for (int k = 0; k < c.N; ++k) {
      const T e0 = x - cur.px[k], e1 = y - cur.py[k], e2 = v - cur.pv[k], e3 = h - cur.ph[k];
      const T na = cur.ua[k] + (g[k] * e0 + g[S + k] * e1 + g[2 * S + k] * e2 + g[3 * S + k] * e3) +
                   alpha * g[8 * S + k];
      const T ns = cur.us[k] +
                   (g[4 * S + k] * e0 + g[5 * S + k] * e1 + g[6 * S + k] * e2 + g[7 * S + k] * e3) +
                   alpha * g[9 * S + k];
      propagate(c, x, y, v, h, na, ns);
      tr.ua[k] = na;
      tr.us[k] = ns;
      tr.px[k + 1] = x;
      tr.py[k + 1] = y;
      tr.pv[k + 1] = v;
      tr.ph[k + 1] = h;
    }
  }
  __syncwarp();
}

// A judged trial, projected, becomes the current trajectory: each lane
// copies its step.
template <typename T, bool G, bool A>
__device__ void adopt(const Ctx<T, G, A>& c, const Step<T>& s) {
  const int k = c.k, S = c.S;
  __syncwarp();
  if (k <= c.N) {
    T* t = c.cur() + k;
    if (k < c.N) {
      t[0] = s.ua;
      t[S] = s.us;
    }
    t[2 * S] = s.px;
    t[3 * S] = s.py;
    t[4 * S] = s.pv;
    t[5 * S] = s.ph;
    t[6 * S] = s.rx;
    t[7 * S] = s.ry;
    t[8 * S] = s.rh;
  }
  __syncwarp();
}

// The verdict on line-search trial t at alpha (src/cilqr_solver.cpp:352-372):
// convergence is tested on the first trial only, and a converged trial is
// not adopted.
enum Verdict { kReject, kConverge, kAccept };

template <typename T>
__device__ __forceinline__ Verdict verdict(const Weights<T>& w, int t, T alpha, T J, T nJ, T dV1,
                                           T dV2) {
  const T decay = J - nJ;
  if (t == 0 && fabs(decay) < w.conv_thresh) return kConverge;
  const T approx = -(alpha * alpha * dV1 + alpha * dV2);
  const bool ratio_ok = approx != T(0) ? decay / approx > w.accept_thresh : true;
  return decay > T(0) && (approx < T(0) || ratio_ok) ? kAccept : kReject;
}

// mu <- clip(mu + rho c, 0, max_mu) for one column; NaN stays NaN, as
// torch.clamp and jnp.clip keep it.
template <typename T, bool G>
__device__ __forceinline__ void dual_step(const Ctx<T, G, true>& c, T con, int col, int k) {
  T& m = c.mu(col, k);
  T nm = m + c.rho * con;
  nm = nm < T(0) ? T(0) : nm;
  m = nm > c.a.max_mu ? c.a.max_mu : nm;
}

// ALM dual update on line-search exhaustion (src/cilqr_solver.cpp:377-379;
// JAX kernel :1125-1134): every dual steps with the constraint values of
// the current trajectory (each lane its step's), then rho <- min((1 +
// gamma) rho, max_rho). The JAX kernel precomputes mu_next from the
// iteration's trajectory every iteration (:664-672) and keeps it only on
// exhaustion; an exhausted iteration leaves the trajectory unchanged, so
// computing it here, from the current trajectory, gives the same values.
template <typename T, bool G>
__device__ void dual_update(Ctx<T, G, true>& c, const Step<T>& t) {
  const Weights<T>& w = c.w;
  const int k = c.k;
  if (k <= c.N) {
    if (k < c.N) {
      dual_step(c, t.ua - w.acc_max, 0, k);
      dual_step(c, w.acc_min - t.ua, 1, k);
      dual_step(c, t.us - w.stl_lim, 2, k);
      dual_step(c, -w.stl_lim - t.us, 3, k);
    }
    if (k >= 1) {
      dual_step(c, t.pv - w.velo_max, 4, k);
      dual_step(c, w.velo_min - t.pv, 5, k);
      T ddx, ddy, h, ds;
      const T cur_d = lateral(t, &ddx, &ddy, &h, &ds);
      dual_step(c, cur_d - c.up_bound, 6, k);
      dual_step(c, c.lo_bound - cur_d, 7, k);
      T fx, fy, rx, ry;
      front_rear(c, t.px, t.py, cos_(t.ph), sin_(t.ph), fx, fy, rx, ry);
      for (int j = 0; j < c.M; ++j) {
        dual_step(c, ellipse(c, j, k, fx, fy, (T*)nullptr, (T*)nullptr), 8 + 2 * j, k);
        dual_step(c, ellipse(c, j, k, rx, ry, (T*)nullptr, (T*)nullptr), 9 + 2 * j, k);
      }
    }
  }
  const T r = (T(1) + c.a.gamma) * c.rho;
  c.rho = r > c.a.max_rho ? c.a.max_rho : r;
  __syncwarp();
}

// One scenario per block of one warp: block blockIdx.x solves scenario
// blockIdx.x in the block's dynamic shared memory.
//
// Resume entry (stats_in != nullptr): the warp restarts a solve stopped
// before iteration it0. uinit holds the controls it had, whose rollout
// (the same `propagate` on the same values as the trial that produced
// them) is the trajectory it had, bit for bit; J is recomputed from it
// under the incoming duals (mu_in / rho_in, the stopped solve's mu_out /
// rho_out), as the stopped solve carried it; iterations, status and lambda
// come from stats_in, in the stats_out layout. A row that stopped
// converged or overflowed is passed through unchanged.
//
// `totals` is K1's record (`K1Field`), added to at the solve's end.
template <typename T, bool G, bool A>
__global__ void __launch_bounds__(kWarp, kMinResident<T>)
    cilqr_solve_kernel(const Weights<T> w, const RowLimits lim, const Problem<T> p,
                       const AlmArgs<T> alm, const T* __restrict__ stats_in, const int it0,
                       unsigned long long* __restrict__ totals) {
  const int lane = threadIdx.x, b = blockIdx.x;
  // lane f's field f of K1's record for this solve; clocks and nanoseconds
  // wrap at 2^32, far beyond a solve
  unsigned tally = lane == kSolves || (lane == kLaunches && b == 0) ? 1u : 0u;
  unsigned last = clock32();
  if (lane == kClocks) tally = 0u - last;
  if (lane == kSolveNs) tally = 0u - static_cast<unsigned>(globaltimer());
  // close phase `ph` at a point the warp reaches converged (after a
  // __syncwarp or a shuffle: every lane reads the same clock), lane ph
  // adding the time since the last mark
  const auto mark = [&](int ph) {
    const unsigned now = clock32();
    if (lane == ph) tally += now - last;
    last = now;
  };
  const auto count = [&](int field) {
    if (lane == field) ++tally;
  };
  Ctx<T, G, A> c;
  c.w = w;
  c.p = p;
  c.b = b;
  c.N = p.N;
  c.M = p.M;
  c.S = p.N + 1;
  c.k = lane;
  c.lim = lane <= p.N ? lim.r[lane] : 1;
  const int N = p.N, S = c.S, M = p.M;
  c.sm = dynamic_smem<T>();
  // road-border bounds and inflated ellipse axes (src/utils.cpp:387-393,
  // ego disc radius = width / 2)
  c.up_bound = c.at(p.x0, 4) - w.width / T(2);
  c.lo_bound = c.at(p.x0, 5) + w.width / T(2);
  c.ref_velo = c.at(p.x0, 6);
  const T ea = T(0.5) * w.length + T(6) * w.d_safe + T(0.5) * w.width;
  const T eb = T(0.5) * w.width + w.d_safe + T(0.5) * w.width;
  c.ell_a2 = ea * ea;
  c.ell_b2 = eb * eb;
  if constexpr (A) {  // the solve updates its duals in place in mu_out
    c.a = alm;
    const int rows = (8 + 2 * M) * N;
    for (int r = lane; r < rows; r += kWarp)
      alm.mu_out[(size_t)r * p.B + b] = alm.mu_in[(size_t)r * p.B + b];
    c.rho = alm.rho_in[b];
  }
  // stage the window and the obstacle predictions
  stage_window(c);
  {
    T* o = c.obs();
    const int MS = M * S;
    for (int e = lane; e < MS; e += kWarp) {
      const T th = c.at(p.oyaw, e);
      o[e] = c.at(p.ox, e);
      o[MS + e] = c.at(p.oy, e);
      o[2 * MS + e] = cos_(th);
      o[3 * MS + e] = sin_(th);
    }
  }
  const TrajView<T> cur = cur_view(c);
  if (lane < N) {
    cur.ua[lane] = c.at(p.uinit, lane);
    cur.us[lane] = c.at(p.uinit, N + lane);
  }
  __syncwarp();
  mark(kStage);
  if (lane == 0) {  // rollout of the initial controls
    T x = c.at(p.x0, 0), y = c.at(p.x0, 1), v = c.at(p.x0, 2), h = c.at(p.x0, 3);
    cur.px[0] = x;
    cur.py[0] = y;
    cur.pv[0] = v;
    cur.ph[0] = h;
    for (int k = 0; k < N; ++k) {
      propagate(c, x, y, v, h, cur.ua[k], cur.us[k]);
      cur.px[k + 1] = x;
      cur.py[k + 1] = y;
      cur.pv[k + 1] = v;
      cur.ph[k + 1] = h;
    }
  }
  __syncwarp();
  {
    Step<T> s = load_step(c, cur);
    project(c, s);
    count(kScanTrips);
    adopt(c, s);  // the projection into the current trajectory
  }
  // cost of the current trajectory under the current duals, kept in step
  // with both
  T J = total_cost(c, cur_step(c));

  T lamb = w.init_lamb;
  int status = kRunning, iters = 0, it = 0;
  bool converged = false, overflow = false;
  if (stats_in) {
    iters = rint_(c.at(stats_in, 0));
    status = rint_(c.at(stats_in, 1));
    converged = c.at(stats_in, 2) > T(0.5);
    overflow = c.at(stats_in, 3) > T(0.5);
    lamb = c.at(stats_in, 5);
    it = converged || overflow ? p.max_iter : it0;
  }
  mark(kInit);
  for (; it < p.max_iter; ++it) {
    derivatives(c);
    mark(kDeriv);
    T dV1, dV2;
    const bool pd = backward(c, lamb, dV1, dV2);
    __syncwarp();  // lane 0 stored the gains
    mark(kBackward);
    bool accepted = false, conv_now = false, small = false;
    if (pd) {
      // the alphas 1, 1/2, ... in order, rolled out in chunks of ls_chunk
      // (1 when serial); each trial is projected and costed only while no
      // earlier one was adopted or converged. Alphas past n_alphas are not
      // rolled out (the TPU kernel rolled them out and masked them,
      // :1060-1064).
      const int width = p.ls_chunk > 0 ? p.ls_chunk : 1;
      T alpha = T(1), nJ = T(0);
      int t = 0;
      Verdict vd = kReject;
      while (t < p.n_alphas && vd == kReject) {
        const int m = min(width, p.n_alphas - t);
        forward_chunk(c, alpha, m);
        count(kChunks);
        mark(kForward);
        for (int a = 0; a < m; ++a, ++t, alpha *= T(0.5)) {
          Step<T> s = load_step(c, trial_view(c, a));
          project(c, s);
          count(kScanTrips);
          __syncwarp();  // the lanes' scans end apart
          mark(kProject);
          nJ = total_cost(c, s);
          vd = verdict(w, t, alpha, J, nJ, dV1, dV2);
          if (vd == kAccept) adopt(c, s);
          count(kTrials);
          mark(kCost);
          if (vd != kReject) break;
        }
      }
      if (vd == kConverge) {
        conv_now = true;
      } else if (vd == kAccept) {
        accepted = true;
        small = t > 0;
        J = nJ;
      }
    }
    // status precedence and the lambda schedule (src/cilqr_solver.cpp:110-142)
    if (!pd) {
      status = kBackwardPassFail;
    } else if (conv_now) {
      status = kConverged;
    } else if (!accepted) {
      status = kForwardPassFail;
    } else {
      status = small ? kForwardPassSmallStep : kRunning;
    }
    if constexpr (A) {
      // duals move only on line-search exhaustion; the JAX kernel
      // recomputes the iteration's cost with the current duals (:924-925),
      // so the carried cost is recomputed after they move
      if (status == kForwardPassFail) {
        const Step<T> s = cur_step(c);
        dual_update(c, s);
        J = total_cost(c, s);
      }
    }
    if (status == kBackwardPassFail || status == kForwardPassFail) {
      const T amp = lamb * w.lamb_amplify;
      lamb = w.lamb_amplify > amp ? w.lamb_amplify : amp;
    } else if (status == kRunning) {
      lamb = lamb * w.lamb_decay;
    }
    ++iters;
    count(kIters);
    count(kStatusFirst + status);
    overflow = lamb > w.max_lamb;
    converged = conv_now;
    mark(kRest);
    if (overflow || converged) break;
  }

  const size_t B = p.B;
  if (lane < N) {
    p.u_out[lane * B + b] = cur.ua[lane];
    p.u_out[(N + lane) * B + b] = cur.us[lane];
  }
  if (lane <= N) {
    p.x_out[(0 * S + lane) * B + b] = cur.px[lane];
    p.x_out[(1 * S + lane) * B + b] = cur.py[lane];
    p.x_out[(2 * S + lane) * B + b] = cur.pv[lane];
    p.x_out[(3 * S + lane) * B + b] = cur.ph[lane];
  }
  if (lane == 0) {
    p.stats_out[0 * B + b] = T(iters);
    p.stats_out[1 * B + b] = T(status);
    p.stats_out[2 * B + b] = converged ? T(1) : T(0);
    p.stats_out[3 * B + b] = overflow ? T(1) : T(0);
    // the final cost under the final duals (JAX kernel :1181-1182)
    p.stats_out[4 * B + b] = J;
    p.stats_out[5 * B + b] = lamb;
    if constexpr (A) alm.rho_out[b] = c.rho;
  }
  {  // the projections counted so far, times the busiest lane's rows
    const int rows = p.proj_fold ? c.lim : scan_lane(c).n;
    const unsigned busiest = __reduce_max_sync(kFull, static_cast<unsigned>(rows));
    if (lane == kScanTrips) tally *= busiest;
  }
  __syncwarp();
  mark(kRest);
  if (lane == kClocks) tally += last;
  if (lane == kSolveNs) tally += static_cast<unsigned>(globaltimer());
  if (lane < kNumK1Fields && tally)
    atomicAdd(totals + lane, static_cast<unsigned long long>(tally));
}

template <typename T, bool G, bool A>
int launch_variant(const Weights<T>& w, const RowLimits& lim, const Problem<T>& p,
                   const AlmArgs<T>& alm, const T* stats_in, int it0,
                   unsigned long long* totals, int bytes, cudaStream_t stream) {
  auto kernel = cilqr_solve_kernel<T, G, A>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<p.B, kWarp, bytes, stream>>>(w, lim, p, alm, stats_in, it0, totals);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* wts, const int* limits, const T* x0, const T* uinit, const T* line,
           const T* ox, const T* oy, const T* oyaw, const T* mu_in, const T* rho_in,
           const T* stats_in, T* u_out, T* x_out, T* stats_out, T* mu_out, T* rho_out,
           T* fold_s, int* fold_i, T* window_out, long long* totals, int B, int N, int M, int W,
           int P, int w_back, int line_bs, int max_iter, int it0, int n_alphas, int gravity,
           int alm, int proj_dot, int proj_fold, int ls_chunk, int shared_bytes,
           cudaStream_t stream) {
  static_assert(sizeof(Weights<T>) == kNumWeights * sizeof(T), "weights layout");
  if (B < 0 || N < 1 || N + 1 > kMaxSteps || M < 0 || W < 1 || max_iter < 0 || n_alphas < 0)
    return cudaErrorInvalidValue;
  if (!totals) return cudaErrorInvalidValue;
  if (!line || P < 1 || w_back < 0 || (line_bs != 0 && line_bs != 1))
    return cudaErrorInvalidValue;
  if (it0 < 0 || (!stats_in && it0 != 0)) return cudaErrorInvalidValue;
  if (alm && !(mu_in && rho_in && mu_out && rho_out)) return cudaErrorInvalidValue;
  if ((proj_dot != 0 && proj_dot != 1) || (proj_fold != 0 && proj_fold != 1) || ls_chunk < 0 ||
      ls_chunk > kMaxChunk)
    return cudaErrorInvalidValue;
  if (proj_fold && !(fold_s && fold_i)) return cudaErrorInvalidValue;
  Weights<T> w;
  std::memcpy(&w, wts, sizeof(w));
  RowLimits lim = {};
  int R = 0;
  for (int k = 0; k <= N; ++k) {
    if (limits[k] < 1 || limits[k] > W) return cudaErrorInvalidValue;
    lim.r[k] = limits[k];
    R = limits[k] > R ? limits[k] : R;
  }
  // the launch plan the wrapper computed: its shared bytes must be this
  // file's count
  if (shared_bytes != warp_bytes<T>(N, M, R, ls_chunk, proj_dot)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const Problem<T> p = {x0,     uinit,  line,       ox,       oy,       oyaw,   u_out,
                        x_out,  stats_out, fold_s,  fold_i,   window_out, B,    N,
                        M,      W,      R,          max_iter, n_alphas, P,      w_back,
                        line_bs, line_bs ? B : 1, proj_dot, proj_fold, ls_chunk};
  const AlmArgs<T> a = {mu_in, rho_in, mu_out, rho_out, wts[kNumWeights],
                        wts[kNumWeights + 1], wts[kNumWeights + 2]};
  const int sb = shared_bytes;
  const auto tot = reinterpret_cast<unsigned long long*>(totals);
  if (gravity) {
    return alm ? launch_variant<T, true, true>(w, lim, p, a, stats_in, it0, tot, sb, stream)
               : launch_variant<T, true, false>(w, lim, p, a, stats_in, it0, tot, sb, stream);
  }
  return alm ? launch_variant<T, false, true>(w, lim, p, a, stats_in, it0, tot, sb, stream)
             : launch_variant<T, false, false>(w, lim, p, a, stats_in, it0, tot, sb, stream);
}

// Blocks (scenarios) resident on one SM at `shared_bytes` a block.
template <typename T, bool G, bool A>
int occupancy_variant(int shared_bytes, int* blocks) {
  auto kernel = cilqr_solve_kernel<T, G, A>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         shared_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kWarp, shared_bytes));
}

template <typename T>
int occupancy(int gravity, int alm, int shared_bytes, int* blocks) {
  if (shared_bytes < 0 || !blocks) return cudaErrorInvalidValue;
  if (gravity) {
    return alm ? occupancy_variant<T, true, true>(shared_bytes, blocks)
               : occupancy_variant<T, true, false>(shared_bytes, blocks);
  }
  return alm ? occupancy_variant<T, false, true>(shared_bytes, blocks)
             : occupancy_variant<T, false, false>(shared_bytes, blocks);
}

}  // namespace

// Plain C entry points (bound with ctypes). `wts` and `limits` are host
// arrays: kNumWeights + kNumAlmWeights scalars in _WEIGHT_ORDER and N+1 row
// limits; every other pointer is device memory (the four dual pointers may
// be null when alm == 0, the fold scratch when proj_fold == 0, and
// `window_out` is null but in tests; `totals`, K1's record of kNumK1Fields
// int64, is not). `line` holds P rows, (3, P) with
// `line_bs` 0 or (3, P, B) with `line_bs` 1; each solve's window of W rows
// starts `w_back` rows behind its start's nearest row. `stats_in` (6, B),
// or null, selects the resume entry, which runs iterations [it0,
// max_iter); it0 is 0 without it.
// `gravity` and `alm` pick the instantiation; `proj_dot` and `proj_fold`
// the projection mode; `ls_chunk` is the line search's chunk width, 0
// (serial) to kMaxChunk. `shared_bytes` (one scenario's region, a block of
// one warp) is the wrapper's launch plan. Returns the launch's cudaError_t.
#define CILQR_ENTRY(NAME, T)                                                                   \
  extern "C" int NAME(const T* wts, const int* limits, const T* x0, const T* uinit,            \
                      const T* line, const T* ox, const T* oy, const T* oyaw, const T* mu_in,  \
                      const T* rho_in, const T* stats_in, T* u_out, T* x_out, T* stats_out,    \
                      T* mu_out, T* rho_out, T* fold_s, int* fold_i, T* window_out,            \
                      long long* totals, int B, int N, int M, int W, int P, int w_back,        \
                      int line_bs, int max_iter, int it0, int n_alphas, int gravity, int alm,  \
                      int proj_dot, int proj_fold, int ls_chunk, int shared_bytes,             \
                      void* stream) {                                                          \
    return launch<T>(wts, limits, x0, uinit, line, ox, oy, oyaw, mu_in, rho_in, stats_in,     \
                     u_out, x_out, stats_out, mu_out, rho_out, fold_s, fold_i, window_out,    \
                     totals, B, N, M, W, P, w_back, line_bs, max_iter, it0, n_alphas, gravity, \
                     alm, proj_dot, proj_fold, ls_chunk, shared_bytes,                        \
                     static_cast<cudaStream_t>(stream));                                      \
  }

CILQR_ENTRY(cilqr_solve_f32, float)
CILQR_ENTRY(cilqr_solve_f64, double)

// Blocks (scenarios) of the instantiation (`gravity`, `alm`) resident on
// one SM at `shared_bytes` a block, into *blocks.
extern "C" int cilqr_occupancy_f32(int gravity, int alm, int shared_bytes, int* blocks) {
  return occupancy<float>(gravity, alm, shared_bytes, blocks);
}
extern "C" int cilqr_occupancy_f64(int gravity, int alm, int shared_bytes, int* blocks) {
  return occupancy<double>(gravity, alm, shared_bytes, blocks);
}

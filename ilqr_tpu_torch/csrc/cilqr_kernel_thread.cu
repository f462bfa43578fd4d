// Fused CILQR solve for NVIDIA Hopper (sm_90a): one thread per scenario.
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
// :1156-1168: restart at iteration it0 from a stats slab). It computes what that kernel computes (reference
// semantics: src/cilqr_solver.cpp:85-461 of the C++ project), not its
// TPU layout: each thread walks the reference's loop shape over its own
// scenario, with trajectory, gains and projection in per-thread arrays.
//
// What bounds it on this card: each solve is a serial dependent chain of
// roughly 1e5-1e6 flops (the window scan of every line-search trial is the
// largest term), and the per-thread arrays live in local memory. The main
// path's 8192 scenarios at 128 threads per block are 64 blocks on 132 SMs,
// so latency and occupancy bound it, not bytes; and a block waits for its
// slowest scenario. Compaction of unfinished scenarios between launches
// (the resume entry) cannot shorten that slowest chain when the whole batch
// is resident at once; it is exact, and off by default. Later work: smaller
// blocks, a warp per scenario for the window scan.
//
// Layout: every input and output array is scenario-fastest ([row][B]), so
// neighbouring threads read neighbouring addresses. See
// ilqr_tpu_torch/ops/cuda/cilqr_kernel.py for the packing and the plain
// PyTorch version of the same function.
//
// Built without fast-math; the scalar type, the reference point and the
// penalty family are template parameters: float is the production type,
// double exists to check semantics against the plain version without
// float32 chaos. The rear-center barrier instantiation is the code of the
// first port (the variant branches are `if constexpr`). The projection
// modes and the line search's chunk width are warp-uniform runtime
// arguments, the projection's branched outside the window-row loop.
//
// The modes on this card:
// - dot form: the TPU hoisted three window slabs once per solve; here the
//   wrapper computes them once per launch as three (W, B) arrays (p_cr,
//   p_nx, p_ny), so a row costs 3 loads, 2 products and 2 sums against the
//   squared distance's 2 loads, 2 differences, a product and an FMA;
// - fold: the tournament keeps ceil(R/2) scores and row indices in a
//   (rows, B) scratch the wrapper allocates, not on the thread's stack,
//   which every mode would then carry (~2.5 KB at R <= 312);
// - chunked line search: a thread has no sublanes to pack trials into.
//   Up to kMaxChunk rollout chains advance in one loop over the horizon,
//   reading the gains and the current trajectory once for all of them.
//   A trial is projected and costed in place in the chunk, and copied
//   into the current trajectory only when it is adopted.
//   The serial search is the chunked one at width 1, and the loop over a
//   chunk's chains is not unrolled, so every trial of every width runs the
//   same instructions: that is what makes a chunk bitwise the serial
//   search. Two separately compiled kernels are not enough: nvcc contracts
//   multiply-adds differently in each (a float64 ALM build with the chunk
//   as a template flag differed from the serial build on the card). So the
//   chains run one after another and the chunk buys no instruction-level
//   parallelism; it costs the stack of kMaxChunk rollouts in every mode.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kMaxSteps = 32;  // N + 1 <= kMaxSteps
constexpr int kBlock = 128;
constexpr int kMaxChunk = 8;  // widest line-search chunk

enum Status {
  kRunning = 0,
  kConverged = 1,
  kBackwardPassFail = 2,
  kForwardPassFail = 3,
  kForwardPassSmallStep = 4,
};

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
  const T* __restrict__ rx;     // (W, B) reference-line window
  const T* __restrict__ ry;
  const T* __restrict__ ryaw;
  const T* __restrict__ ox;     // (M, N+1, B) obstacle predictions
  const T* __restrict__ oy;
  const T* __restrict__ oyaw;
  T* __restrict__ u_out;        // (2, N, B)
  T* __restrict__ x_out;        // (4, N+1, B)
  T* __restrict__ stats_out;    // (6, B)
  // dot form (proj_dot): window terms (W, B) centred on window row 0,
  // p_cr = |r - r0|^2, p_nx = -2 (rx - r0x), p_ny = -2 (ry - r0y)
  const T* __restrict__ pcr;
  const T* __restrict__ pnx;
  const T* __restrict__ pny;
  T* __restrict__ fold_s;       // (ceil(max row limit / 2), B) fold scratch (proj_fold)
  int* __restrict__ fold_i;
  int B, N, M, W, max_iter, n_alphas;
  int proj_dot, proj_fold, ls_chunk;  // ls_chunk: the chunk width, 0 (serial) to kMaxChunk
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

// Per-solve ALM state: empty in the barrier builds, so their per-thread
// context is the first port's, byte for byte.
template <typename T, bool kAlm>
struct AlmState {};

template <typename T>
struct AlmState<T, true> {
  AlmArgs<T> a;
  T rho;  // the penalty weight
};

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

// One scenario's trajectory: controls 0..N-1, states 0..N and the nearest
// window row (x, y, yaw) of every state.
template <typename T>
struct Traj {
  T ua[kMaxSteps], us[kMaxSteps];
  T px[kMaxSteps], py[kMaxSteps], pv[kMaxSteps], ph[kMaxSteps];
  T rx[kMaxSteps], ry[kMaxSteps], rh[kMaxSteps];
};

// A trajectory's arrays by address: `project` and `total_cost` read and
// write the current trajectory and a line-search chunk's trials in place
// through it, one instantiation for both, so the cost of an adopted trial
// is the cost the resume entry recomputes from the same states, bit for bit.
template <typename T>
struct TrajView {
  T *ua, *us, *px, *py, *pv, *ph, *rx, *ry, *rh;
};

template <typename T>
__device__ __forceinline__ TrajView<T> view(Traj<T>& t) {
  return {t.ua, t.us, t.px, t.py, t.pv, t.ph, t.rx, t.ry, t.rh};
}

// Per-thread constants of one solve, and its ALM state.
template <typename T, bool kGravity, bool kAlm>
struct Ctx : AlmState<T, kAlm> {
  Weights<T> w;
  Problem<T> p;
  int b, N, M;
  T up_bound, lo_bound, ref_velo, ell_a2, ell_b2;
  int lim[kMaxSteps];

  __device__ T at(const T* a, int row) const { return a[(size_t)row * p.B + b]; }

  // ALM dual of constraint column `col` at horizon step k (ALM builds
  // only). The duals live in mu_out itself (scenario-fastest like every
  // other array), so no per-thread copy bounds the obstacle count. Columns
  // follow the reference's dual layout (src/cilqr_solver.cpp:622-676): 0-3
  // the control bounds on steps 0..N-1; 4-7 velocity and road-border
  // bounds, then 8+2j / 9+2j obstacle j's front / rear disc, on steps 1..N.
  __device__ T& mu(int col, int k) const {
    const int n = col < 4 ? k : k - 1;
    return this->a.mu_out[((size_t)col * N + n) * p.B + b];
  }
};

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

// Products and sums rounded to nearest that nvcc never contracts into an
// FMA.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// Score of window row r for the query (qx, qy): the squared distance, or
// the dot form (p_cr + p_nx qx) + p_ny qy with the query centred on window
// row 0 (JAX kernel :280-286, :366-367, :434); both have the same argmin in
// exact arithmetic. The dot form cancels (a score is |r - q|^2 - |q - r0|^2),
// so it is rounded op by op as the plain version and the TPU kernel round
// it: contracted into FMAs its near-ties broke otherwise than the plain
// version's, enough to part float32 paths (three_bend ALM, first tick: cost
// p90 1.5e-3 against 5e-6 with the squared distance, on the card).
template <bool kDot, typename T, bool G, bool A>
__device__ __forceinline__ T row_score(const Ctx<T, G, A>& c, int r, T qx, T qy) {
  if constexpr (kDot) {
    return add_rn(add_rn(c.at(c.p.pcr, r), mul_rn(c.at(c.p.pnx, r), qx)),
                  mul_rn(c.at(c.p.pny, r), qy));
  } else {
    const T dx = qx - c.at(c.p.rx, r), dy = qy - c.at(c.p.ry, r);
    return dx * dx + dy * dy;
  }
}

// First minimum over rows [0, n) (strict < keeps the first index on ties).
template <bool kDot, typename T, bool G, bool A>
__device__ __forceinline__ int first_min(const Ctx<T, G, A>& c, T qx, T qy, int n) {
  T best = row_score<kDot>(c, 0, qx, qy);
  int bi = 0;
  for (int r = 1; r < n; ++r) {
    const T s = row_score<kDot>(c, r, qx, qy);
    if (s < best) {
      best = s;
      bi = r;
    }
  }
  return bi;
}

// The pair-fold tournament over rows [0, n) (JAX kernel :381-395): while
// n > 1, slot i meets slot i + h (h = n / 2) and the later one wins only
// on strict <; an odd tail slot 2h moves to slot h; n -= h. Ties go by
// tournament order, not by first index. The first round scores the window
// rows; later rounds halve the scratch in place (slot i < h is written,
// slots >= h are read).
template <bool kDot, typename T, bool G, bool A>
__device__ int fold_min(const Ctx<T, G, A>& c, T qx, T qy, int n) {
  T* const fs = c.p.fold_s + c.b;
  int* const fi = c.p.fold_i + c.b;
  const size_t B = c.p.B;
  if (n == 1) return 0;
  int h = n / 2;
  for (int i = 0; i < h; ++i) {
    const T lo = row_score<kDot>(c, i, qx, qy), hi = row_score<kDot>(c, i + h, qx, qy);
    const bool up = hi < lo;
    fs[i * B] = up ? hi : lo;
    fi[i * B] = up ? i + h : i;
  }
  if (n & 1) {
    fs[h * B] = row_score<kDot>(c, 2 * h, qx, qy);
    fi[h * B] = 2 * h;
  }
  for (n -= h; n > 1; n -= h) {
    h = n / 2;
    for (int i = 0; i < h; ++i) {
      const T hi = fs[(i + h) * B];
      if (hi < fs[i * B]) {
        fs[i * B] = hi;
        fi[i * B] = fi[(i + h) * B];
      }
    }
    if (n & 1) {
      fs[h * B] = fs[2 * h * B];
      fi[h * B] = fi[2 * h * B];
    }
  }
  return fi[0];
}

// Nearest window row of every state over rows [0, lim[k]), in the solve's
// projection mode.
template <typename T, bool G, bool A>
__device__ void project(const Ctx<T, G, A>& c, TrajView<T> t) {
  const Problem<T>& p = c.p;
  // the dot form's query is centred on this scenario's window row 0
  const T ox = p.proj_dot ? c.at(p.rx, 0) : T(0), oy = p.proj_dot ? c.at(p.ry, 0) : T(0);
  for (int k = 0; k <= c.N; ++k) {
    const int lim = c.lim[k];
    int bi;
    if (p.proj_fold) {
      bi = p.proj_dot ? fold_min<true>(c, t.px[k] - ox, t.py[k] - oy, lim)
                      : fold_min<false>(c, t.px[k], t.py[k], lim);
    } else {
      bi = p.proj_dot ? first_min<true>(c, t.px[k] - ox, t.py[k] - oy, lim)
                      : first_min<false>(c, t.px[k], t.py[k], lim);
    }
    t.rx[k] = c.at(p.rx, bi);
    t.ry[k] = c.at(p.ry, bi);
    t.rh[k] = c.at(p.ryaw, bi);
  }
}

// Ellipse safety margin of point (qx, qy) against obstacle j at step k
// (reference src/utils.cpp:387-439); writes dc/dq when g is given.
template <typename T, bool G, bool A>
__device__ __forceinline__ T ellipse(const Ctx<T, G, A>& c, int j, int k, T qx, T qy, T* gx,
                                     T* gy) {
  const Problem<T>& p = c.p;
  const int row = j * (c.N + 1) + k;
  const T th = c.at(p.oyaw, row);
  const T ct = cos_(th), st = sin_(th);
  const T ddx = qx - c.at(p.ox, row), ddy = qy - c.at(p.oy, row);
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
template <typename T, typename Tr>
__device__ __forceinline__ T lateral(const Tr& t, int k, T* ddx, T* ddy, T* h, T* dsign) {
  *ddx = t.px[k] - t.rx[k];
  *ddy = t.py[k] - t.ry[k];
  *dsign = *ddy * cos_(t.rh[k]) - *ddx * sin_(t.rh[k]);
  *h = hypot_(*ddx, *ddy);
  return *dsign < T(0) ? -*h : *h;
}

// Total cost of a projected trajectory (src/cilqr_solver.cpp:199-287):
// tracking cost on steps 0..N, control cost and control-bound penalties on
// steps 0..N-1, state, border and obstacle penalties on steps 1..N.
template <typename T, bool G, bool A>
__device__ T total_cost(const Ctx<T, G, A>& c, TrajView<T> t) {
  const Weights<T>& w = c.w;
  T J = T(0);
  for (int k = 0; k <= c.N; ++k) {
    const T dx = t.px[k] - t.rx[k], dy = t.py[k] - t.ry[k];
    const T dv = t.pv[k] - c.ref_velo, dh = t.ph[k] - t.rh[k];
    J += w.w_pos * (dx * dx + dy * dy) + w.w_vel * dv * dv + w.w_yaw * dh * dh;
    if (k < c.N) {
      const T ua = t.ua[k], us = t.us[k];
      J += w.w_acc * ua * ua + w.w_stl * us * us;
      J += pen_val(c, ua - w.acc_max, w.sq1, w.sq2, 0, k) +
           pen_val(c, w.acc_min - ua, w.sq1, w.sq2, 1, k) +
           pen_val(c, us - w.stl_lim, w.sq1, w.sq2, 2, k) +
           pen_val(c, -w.stl_lim - us, w.sq1, w.sq2, 3, k);
    }
    if (k >= 1) {
      const T v = t.pv[k];
      J += pen_val(c, v - w.velo_max, w.sq1, w.sq2, 4, k) +
           pen_val(c, w.velo_min - v, w.sq1, w.sq2, 5, k);
      T ddx, ddy, h, ds;
      const T cur_d = lateral(t, k, &ddx, &ddy, &h, &ds);
      J += pen_val(c, cur_d - c.up_bound, w.sq1, w.sq2, 6, k) +
           pen_val(c, c.lo_bound - cur_d, w.sq1, w.sq2, 7, k);
      T fx, fy, rx, ry;
      front_rear(c, t.px[k], t.py[k], cos_(t.ph[k]), sin_(t.ph[k]), fx, fy, rx, ry);
      for (int j = 0; j < c.M; ++j) {
        J += pen_val(c, ellipse(c, j, k, fx, fy, (T*)nullptr, (T*)nullptr), w.oq1, w.oq2,
                     8 + 2 * j, k);
        J += pen_val(c, ellipse(c, j, k, rx, ry, (T*)nullptr, (T*)nullptr), w.oq1, w.oq2,
                     9 + 2 * j, k);
      }
    }
  }
  return J;
}

// Cost derivatives at one step (src/cilqr_solver.cpp:463-690); l_ux == 0 and
// l_uu is diagonal.
template <typename T>
struct StepDerivs {
  T lx[4], lxx[4][4], lu[2], luu00, luu11;
};

template <typename T, bool G, bool A>
__device__ void step_derivs(const Ctx<T, G, A>& c, const Traj<T>& t, int k, StepDerivs<T>& D) {
  const Weights<T>& w = c.w;
  const T dx = t.px[k] - t.rx[k], dy = t.py[k] - t.ry[k];
  const T dv = t.pv[k] - c.ref_velo, dh = t.ph[k] - t.rh[k];
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
    const T ua = t.ua[k], us = t.us[k];
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
    const T v = t.pv[k];
    const Pen<T> p4 = pen(c, v - w.velo_max, w.sq1, w.sq2, 4, k);
    const Pen<T> p5 = pen(c, w.velo_min - v, w.sq1, w.sq2, 5, k);
    D.lx[2] += p4.g - p5.g;
    D.lxx[2][2] += p4.h + p5.h;
    // road borders: gradient (+-gx, +-gy, 0, 0), zero at h == 0
    T ddx, ddy, h, ds;
    const T cur_d = lateral(t, k, &ddx, &ddy, &h, &ds);
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
    const T sy = sin_(t.ph[k]), cy = cos_(t.ph[k]);
    T fx, fy, rx, ry;
    front_rear(c, t.px[k], t.py[k], cy, sy, fx, fy, rx, ry);
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
  D.lxx[1][0] = D.lxx[0][1];
  D.lxx[3][0] = D.lxx[0][3];
  D.lxx[3][1] = D.lxx[1][3];
}

// Riccati backward pass (src/cilqr_solver.cpp:383-440) with the bicycle
// Jacobians of src/utils.cpp:285-342:
// A = I + a02 e0e2' + a03 e0e3' + a12 e1e2' + a13 e1e3' + a32 e3e2',
// B = dt e2e0' + (b01 e0 + b11 e1 + b31 e3) e1', where b01 = b11 = 0 at the
// rear center. Returns false when some Q_uu is not positive definite (the
// pass is then discarded).
template <typename T, bool G, bool A>
__device__ bool backward(const Ctx<T, G, A>& c, const Traj<T>& t, T lamb, T (*K)[8], T (*d)[2],
                         T& dV1, T& dV2) {
  const T dt = c.w.dt, wb = c.w.wb;
  StepDerivs<T> D;
  step_derivs(c, t, c.N, D);
  T Vx[4], V[4][4];
  for (int i = 0; i < 4; ++i) {
    Vx[i] = D.lx[i];
    for (int j = 0; j < 4; ++j) V[i][j] = D.lxx[i][j];
  }
  dV1 = dV2 = T(0);
  for (int k = c.N - 1; k >= 0; --k) {
    step_derivs(c, t, k, D);
    const T v = t.pv[k], yaw = t.ph[k], stl = t.us[k];
    const T cyw = cos_(yaw), syw = sin_(yaw);
    T a02, a03, a12, a13, a32, b01, b11, b31;
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
      a02 = cby * dt;
      a03 = -v * sby * dt;
      a12 = sby * dt;
      a13 = v * cby * dt;
      a32 = T(2) * sb * dt / wb;
      b01 = -v * sby * dt * dbds;
      b11 = v * cby * dt * dbds;
      b31 = (T(2) * v * dt / wb) * cb * dbds;
    } else {
      const T cs = cos_(stl);
      a02 = cyw * dt;
      a03 = -v * syw * dt;
      a12 = syw * dt;
      a13 = v * cyw * dt;
      a32 = tan_(stl) * dt / wb;
      b01 = b11 = T(0);
      b31 = (v * dt / wb) / (cs * cs);
    }

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
      K[k][j] = Kr[0][j];
      K[k][4 + j] = Kr[1][j];
    }
    d[k][0] = d0;
    d[k][1] = d1;
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

// One step of a closed-loop trial rollout, u' = u + K (x' - x) + alpha d,
// then the dynamics (src/cilqr_solver.cpp:442-461).
template <typename T, bool G, bool A>
__device__ __forceinline__ void trial_step(const Ctx<T, G, A>& c, const Traj<T>& cur,
                                           const T* Kk, const T* dk, int k, T alpha, T& x, T& y,
                                           T& v, T& h, T& na, T& ns) {
  const T e0 = x - cur.px[k], e1 = y - cur.py[k], e2 = v - cur.pv[k], e3 = h - cur.ph[k];
  na = cur.ua[k] + (Kk[0] * e0 + Kk[1] * e1 + Kk[2] * e2 + Kk[3] * e3) + alpha * dk[0];
  ns = cur.us[k] + (Kk[4] * e0 + Kk[5] * e1 + Kk[6] * e2 + Kk[7] * e3) + alpha * dk[1];
  propagate(c, x, y, v, h, na, ns);
}

// The trial rollouts of one line-search chunk, chain by chain: controls
// and states of up to kMaxChunk alphas (JAX kernel `forward_packed`,
// :857-890), and the projection of the trial being judged.
template <typename T>
struct Chunk {
  T ua[kMaxChunk][kMaxSteps], us[kMaxChunk][kMaxSteps];
  T px[kMaxChunk][kMaxSteps], py[kMaxChunk][kMaxSteps];
  T pv[kMaxChunk][kMaxSteps], ph[kMaxChunk][kMaxSteps];
  T rx[kMaxSteps], ry[kMaxSteps], rh[kMaxSteps];

  // trial a, in place
  __device__ __forceinline__ TrajView<T> trial(int a) {
    return {ua[a], us[a], px[a], py[a], pv[a], ph[a], rx, ry, rh};
  }
};

// Closed-loop trial rollouts at alpha0, alpha0 / 2, ... (m of them, 1 <=
// m <= kMaxChunk) as independent chains advanced together, step by step.
// The chain loop stays a loop (unroll 1): chain a runs the instructions
// chain 0 runs, so a trial's bits do not depend on its place in a chunk.
template <typename T, bool G, bool A>
__device__ void forward_chunk(const Ctx<T, G, A>& c, const Traj<T>& cur, T (*K)[8], T (*d)[2],
                              T alpha0, int m, Chunk<T>& ch) {
  T al[kMaxChunk], x[kMaxChunk], y[kMaxChunk], v[kMaxChunk], h[kMaxChunk];
#pragma unroll 1
  for (int a = 0; a < m; ++a) {
    al[a] = a == 0 ? alpha0 : al[a - 1] * T(0.5);
    x[a] = ch.px[a][0] = cur.px[0];
    y[a] = ch.py[a][0] = cur.py[0];
    v[a] = ch.pv[a][0] = cur.pv[0];
    h[a] = ch.ph[a][0] = cur.ph[0];
  }
  for (int k = 0; k < c.N; ++k) {
#pragma unroll 1
    for (int a = 0; a < m; ++a) {
      trial_step(c, cur, K[k], d[k], k, al[a], x[a], y[a], v[a], h[a], ch.ua[a][k], ch.us[a][k]);
      ch.px[a][k + 1] = x[a];
      ch.py[a][k + 1] = y[a];
      ch.pv[a][k + 1] = v[a];
      ch.ph[a][k + 1] = h[a];
    }
  }
}

// Trial a of a chunk, projected, becomes the current trajectory.
template <typename T>
__device__ void adopt(const Chunk<T>& ch, int a, int N, Traj<T>& cur) {
  for (int k = 0; k <= N; ++k) {
    if (k < N) {
      cur.ua[k] = ch.ua[a][k];
      cur.us[k] = ch.us[a][k];
    }
    cur.px[k] = ch.px[a][k];
    cur.py[k] = ch.py[a][k];
    cur.pv[k] = ch.pv[a][k];
    cur.ph[k] = ch.ph[a][k];
    cur.rx[k] = ch.rx[k];
    cur.ry[k] = ch.ry[k];
    cur.rh[k] = ch.rh[k];
  }
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
// the current trajectory, then rho <- min((1 + gamma) rho, max_rho). The
// JAX kernel precomputes mu_next from the iteration's trajectory every
// iteration (:664-672) and keeps it only on exhaustion; an exhausted
// iteration leaves the trajectory unchanged, so computing it here, from
// `cur`, gives the same values.
template <typename T, bool G>
__device__ void dual_update(Ctx<T, G, true>& c, const Traj<T>& t) {
  const Weights<T>& w = c.w;
  for (int k = 0; k <= c.N; ++k) {
    if (k < c.N) {
      const T ua = t.ua[k], us = t.us[k];
      dual_step(c, ua - w.acc_max, 0, k);
      dual_step(c, w.acc_min - ua, 1, k);
      dual_step(c, us - w.stl_lim, 2, k);
      dual_step(c, -w.stl_lim - us, 3, k);
    }
    if (k >= 1) {
      const T v = t.pv[k];
      dual_step(c, v - w.velo_max, 4, k);
      dual_step(c, w.velo_min - v, 5, k);
      T ddx, ddy, h, ds;
      const T cur_d = lateral(t, k, &ddx, &ddy, &h, &ds);
      dual_step(c, cur_d - c.up_bound, 6, k);
      dual_step(c, c.lo_bound - cur_d, 7, k);
      T fx, fy, rx, ry;
      front_rear(c, t.px[k], t.py[k], cos_(t.ph[k]), sin_(t.ph[k]), fx, fy, rx, ry);
      for (int j = 0; j < c.M; ++j) {
        dual_step(c, ellipse(c, j, k, fx, fy, (T*)nullptr, (T*)nullptr), 8 + 2 * j, k);
        dual_step(c, ellipse(c, j, k, rx, ry, (T*)nullptr, (T*)nullptr), 9 + 2 * j, k);
      }
    }
  }
  const T r = (T(1) + c.a.gamma) * c.rho;
  c.rho = r > c.a.max_rho ? c.a.max_rho : r;
}

// Resume entry (stats_in != nullptr): the thread restarts a solve stopped
// before iteration it0. uinit holds the controls it had, whose rollout
// (the same `propagate` on the same values as the trial that produced
// them) is the trajectory it had, bit for bit; J is recomputed from it
// under the incoming duals (mu_in / rho_in, the stopped solve's mu_out /
// rho_out), as the stopped solve carried it; iterations, status and lambda
// come from stats_in, in the stats_out layout. A row that stopped
// converged or overflowed is passed through unchanged.
template <typename T, bool G, bool A>
__global__ void __launch_bounds__(kBlock)
    cilqr_solve_kernel(const Weights<T> w, const RowLimits lim, const Problem<T> p,
                       const AlmArgs<T> alm, const T* __restrict__ stats_in, const int it0) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.B) return;  // ragged last block
  Ctx<T, G, A> c;
  c.w = w;
  c.p = p;
  c.b = b;
  c.N = p.N;
  c.M = p.M;
  for (int k = 0; k <= p.N; ++k) c.lim[k] = lim.r[k];
  // road-border bounds and inflated ellipse axes (src/utils.cpp:387-393,
  // ego disc radius = width / 2)
  c.up_bound = c.at(p.x0, 4) - w.width / T(2);
  c.lo_bound = c.at(p.x0, 5) + w.width / T(2);
  c.ref_velo = c.at(p.x0, 6);
  const T ea = T(0.5) * w.length + T(6) * w.d_safe + T(0.5) * w.width;
  const T eb = T(0.5) * w.width + w.d_safe + T(0.5) * w.width;
  c.ell_a2 = ea * ea;
  c.ell_b2 = eb * eb;
  const int N = p.N;
  if constexpr (A) {  // the solve updates its duals in place in mu_out
    c.a = alm;
    const size_t rows = (size_t)(8 + 2 * p.M) * N;
    for (size_t r = 0; r < rows; ++r) alm.mu_out[r * p.B + b] = alm.mu_in[r * p.B + b];
    c.rho = alm.rho_in[b];
  }

  Traj<T> cur;
  T K[kMaxSteps][8], d[kMaxSteps][2];
  Chunk<T> chunk;
  T x = c.at(p.x0, 0), y = c.at(p.x0, 1), v = c.at(p.x0, 2), h = c.at(p.x0, 3);
  cur.px[0] = x;
  cur.py[0] = y;
  cur.pv[0] = v;
  cur.ph[0] = h;
  for (int k = 0; k < N; ++k) {  // rollout of the initial controls
    cur.ua[k] = c.at(p.uinit, k);
    cur.us[k] = c.at(p.uinit, N + k);
    propagate(c, x, y, v, h, cur.ua[k], cur.us[k]);
    cur.px[k + 1] = x;
    cur.py[k + 1] = y;
    cur.pv[k + 1] = v;
    cur.ph[k + 1] = h;
  }
  project(c, view(cur));
  // cost of `cur` under the current duals, kept in step with both
  T J = total_cost(c, view(cur));

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
  for (; it < p.max_iter; ++it) {
    T dV1, dV2;
    const bool pd = backward(c, cur, lamb, K, d, dV1, dV2);
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
        forward_chunk(c, cur, K, d, alpha, m, chunk);
#pragma unroll 1
        for (int a = 0; a < m; ++a, ++t, alpha *= T(0.5)) {
          const TrajView<T> trial = chunk.trial(a);
          project(c, trial);
          nJ = total_cost(c, trial);
          vd = verdict(w, t, alpha, J, nJ, dV1, dV2);
          if (vd == kAccept) adopt(chunk, a, N, cur);
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
        dual_update(c, cur);
        J = total_cost(c, view(cur));
      }
    }
    if (status == kBackwardPassFail || status == kForwardPassFail) {
      const T amp = lamb * w.lamb_amplify;
      lamb = w.lamb_amplify > amp ? w.lamb_amplify : amp;
    } else if (status == kRunning) {
      lamb = lamb * w.lamb_decay;
    }
    ++iters;
    overflow = lamb > w.max_lamb;
    converged = conv_now;
    if (overflow || converged) break;
  }

  const size_t B = p.B;
  for (int k = 0; k < N; ++k) {
    p.u_out[k * B + b] = cur.ua[k];
    p.u_out[(N + k) * B + b] = cur.us[k];
  }
  for (int k = 0; k <= N; ++k) {
    p.x_out[(0 * (N + 1) + k) * B + b] = cur.px[k];
    p.x_out[(1 * (N + 1) + k) * B + b] = cur.py[k];
    p.x_out[(2 * (N + 1) + k) * B + b] = cur.pv[k];
    p.x_out[(3 * (N + 1) + k) * B + b] = cur.ph[k];
  }
  p.stats_out[0 * B + b] = T(iters);
  p.stats_out[1 * B + b] = T(status);
  p.stats_out[2 * B + b] = converged ? T(1) : T(0);
  p.stats_out[3 * B + b] = overflow ? T(1) : T(0);
  // the final cost under the final duals (JAX kernel :1181-1182)
  p.stats_out[4 * B + b] = J;
  p.stats_out[5 * B + b] = lamb;
  if constexpr (A) alm.rho_out[b] = c.rho;
}

template <typename T, bool G, bool A>
int launch_variant(const Weights<T>& w, const RowLimits& lim, const Problem<T>& p,
                   const AlmArgs<T>& alm, const T* stats_in, int it0, cudaStream_t stream) {
  cilqr_solve_kernel<T, G, A><<<(p.B + kBlock - 1) / kBlock, kBlock, 0, stream>>>(
      w, lim, p, alm, stats_in, it0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* wts, const int* limits, const T* x0, const T* uinit, const T* rx,
           const T* ry, const T* ryaw, const T* ox, const T* oy, const T* oyaw, const T* mu_in,
           const T* rho_in, const T* stats_in, T* u_out, T* x_out, T* stats_out, T* mu_out,
           T* rho_out, const T* pcr, const T* pnx, const T* pny, T* fold_s, int* fold_i, int B,
           int N, int M, int W, int max_iter, int it0, int n_alphas, int gravity, int alm,
           int proj_dot, int proj_fold, int ls_chunk, cudaStream_t stream) {
  static_assert(sizeof(Weights<T>) == kNumWeights * sizeof(T), "weights layout");
  if (B < 0 || N < 1 || N + 1 > kMaxSteps || M < 0 || W < 1 || max_iter < 0 || n_alphas < 0)
    return cudaErrorInvalidValue;
  if (it0 < 0 || (!stats_in && it0 != 0)) return cudaErrorInvalidValue;
  if (alm && !(mu_in && rho_in && mu_out && rho_out)) return cudaErrorInvalidValue;
  if ((proj_dot != 0 && proj_dot != 1) || (proj_fold != 0 && proj_fold != 1) || ls_chunk < 0 ||
      ls_chunk > kMaxChunk)
    return cudaErrorInvalidValue;
  if (proj_dot && !(pcr && pnx && pny)) return cudaErrorInvalidValue;
  if (proj_fold && !(fold_s && fold_i)) return cudaErrorInvalidValue;
  Weights<T> w;
  std::memcpy(&w, wts, sizeof(w));
  RowLimits lim = {};
  for (int k = 0; k <= N; ++k) {
    if (limits[k] < 1 || limits[k] > W) return cudaErrorInvalidValue;
    lim.r[k] = limits[k];
  }
  if (B == 0) return cudaSuccess;
  const Problem<T> p = {x0,       uinit,  rx,     ry,        ryaw,      ox,       oy,
                        oyaw,     u_out,  x_out,  stats_out, pcr,       pnx,      pny,
                        fold_s,   fold_i, B,      N,         M,         W,        max_iter,
                        n_alphas, proj_dot, proj_fold, ls_chunk};
  const AlmArgs<T> a = {mu_in, rho_in, mu_out, rho_out, wts[kNumWeights],
                        wts[kNumWeights + 1], wts[kNumWeights + 2]};
  if (gravity) {
    return alm ? launch_variant<T, true, true>(w, lim, p, a, stats_in, it0, stream)
               : launch_variant<T, true, false>(w, lim, p, a, stats_in, it0, stream);
  }
  return alm ? launch_variant<T, false, true>(w, lim, p, a, stats_in, it0, stream)
             : launch_variant<T, false, false>(w, lim, p, a, stats_in, it0, stream);
}

}  // namespace

// Plain C entry points (bound with ctypes). `wts` and `limits` are host
// arrays: kNumWeights + kNumAlmWeights scalars in _WEIGHT_ORDER and N+1 row
// limits; every other pointer is device memory (the four dual pointers may
// be null when alm == 0, the dot-form terms when proj_dot == 0, the fold
// scratch when proj_fold == 0). `stats_in` (6, B), or null, selects the
// resume entry, which runs iterations [it0, max_iter); it0 is 0 without it.
// `gravity` and `alm` pick the instantiation; `proj_dot` and `proj_fold`
// the projection mode; `ls_chunk` is the line search's chunk width, 0
// (serial) to kMaxChunk. Returns the launch's cudaError_t.
#define CILQR_ENTRY(NAME, T)                                                                   \
  extern "C" int NAME(const T* wts, const int* limits, const T* x0, const T* uinit,            \
                      const T* rx, const T* ry, const T* ryaw, const T* ox, const T* oy,       \
                      const T* oyaw, const T* mu_in, const T* rho_in, const T* stats_in,       \
                      T* u_out, T* x_out, T* stats_out, T* mu_out, T* rho_out, const T* pcr,   \
                      const T* pnx, const T* pny, T* fold_s, int* fold_i, int B, int N, int M, \
                      int W, int max_iter, int it0, int n_alphas, int gravity, int alm,        \
                      int proj_dot, int proj_fold, int ls_chunk, void* stream) {               \
    return launch<T>(wts, limits, x0, uinit, rx, ry, ryaw, ox, oy, oyaw, mu_in, rho_in,       \
                     stats_in, u_out, x_out, stats_out, mu_out, rho_out, pcr, pnx, pny,       \
                     fold_s, fold_i, B, N, M, W, max_iter, it0, n_alphas, gravity, alm,       \
                     proj_dot, proj_fold, ls_chunk, static_cast<cudaStream_t>(stream));       \
  }

CILQR_ENTRY(cilqr_solve_f32, float)
CILQR_ENTRY(cilqr_solve_f64, double)

// Fused CILQR solve for NVIDIA Hopper (sm_90a): one thread per scenario.
//
// Replaces the Pallas TPU kernel of ilqr_tpu/ops/pallas/cilqr_kernel.py: the
// `kernel` built by `_build_kernel` (:80-1222) and launched by `call_kernel`
// (:1545-1594), in its main-path variant -- barrier constraints, rear-center
// bicycle, warm-start controls, serial line search, squared-distance
// first-min projection over a per-scenario reference-line window with
// per-step row limits. It computes what that kernel computes (reference
// semantics: src/cilqr_solver.cpp:85-461 of the C++ project), not its
// TPU layout: each thread walks the reference's loop shape over its own
// scenario, with trajectory, gains and projection in per-thread arrays.
//
// What bounds it on this card: each solve is a serial dependent chain of
// roughly 1e5-1e6 flops (the window scan of every line-search trial is the
// largest term), and the per-thread arrays live in local memory. The main
// path's 8192 scenarios at 128 threads per block are 64 blocks on 132 SMs,
// so latency and occupancy bound it, not bytes; and a block waits for its
// slowest scenario. Later work: smaller blocks, a warp per scenario for the
// window scan, compaction of unfinished scenarios between launches.
//
// Layout: every input and output array is scenario-fastest ([row][B]), so
// neighbouring threads read neighbouring addresses. See
// ilqr_tpu_torch/ops/cuda/cilqr_kernel.py for the packing and the plain
// PyTorch version of the same function.
//
// Built without fast-math; the scalar type is a template parameter: float
// is the main path, double exists to check semantics against the plain
// version without float32 chaos.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kMaxSteps = 32;  // N + 1 <= kMaxSteps
constexpr int kBlock = 128;

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
  int B, N, M, W, max_iter, n_alphas;
};

__device__ __forceinline__ float sin_(float a) { return sinf(a); }
__device__ __forceinline__ double sin_(double a) { return sin(a); }
__device__ __forceinline__ float cos_(float a) { return cosf(a); }
__device__ __forceinline__ double cos_(double a) { return cos(a); }
__device__ __forceinline__ float tan_(float a) { return tanf(a); }
__device__ __forceinline__ double tan_(double a) { return tan(a); }
__device__ __forceinline__ float exp_(float a) { return expf(a); }
__device__ __forceinline__ double exp_(double a) { return exp(a); }
__device__ __forceinline__ float hypot_(float a, float b) { return hypotf(a, b); }
__device__ __forceinline__ double hypot_(double a, double b) { return hypot(a, b); }

// One scenario's trajectory: controls 0..N-1, states 0..N and the nearest
// window row (x, y, yaw) of every state.
template <typename T>
struct Traj {
  T ua[kMaxSteps], us[kMaxSteps];
  T px[kMaxSteps], py[kMaxSteps], pv[kMaxSteps], ph[kMaxSteps];
  T rx[kMaxSteps], ry[kMaxSteps], rh[kMaxSteps];
};

// Per-thread constants of one solve.
template <typename T>
struct Ctx {
  Weights<T> w;
  Problem<T> p;
  int b, N, M;
  T up_bound, lo_bound, ref_velo, ell_a2, ell_b2;
  int lim[kMaxSteps];

  __device__ T at(const T* a, int row) const { return a[(size_t)row * p.B + b]; }
};

template <typename T>
__device__ __forceinline__ T barrier(const Ctx<T>& c, T con, T q1, T q2) {
  T e = q2 * con;
  e = e > c.w.exp_clip ? c.w.exp_clip : e;
  return q1 * exp_(e);
}

template <typename T>
__device__ __forceinline__ void propagate(const Ctx<T>& c, T& x, T& y, T& v, T& h, T ua,
                                          T us) {
  const T dt = c.w.dt;
  const T nx = x + v * cos_(h) * dt;
  const T ny = y + v * sin_(h) * dt;
  const T nv = v + ua * dt;
  const T nh = h + v * tan_(us) * dt / c.w.wb;
  x = nx;
  y = ny;
  v = nv;
  h = nh;
}

// Nearest window row of every state: first minimum of the squared distance
// over rows [0, lim[k]) (strict < keeps the first index on ties).
template <typename T>
__device__ void project(const Ctx<T>& c, Traj<T>& t) {
  const Problem<T>& p = c.p;
  for (int k = 0; k <= c.N; ++k) {
    const T qx = t.px[k], qy = t.py[k];
    T dx = qx - c.at(p.rx, 0), dy = qy - c.at(p.ry, 0);
    T best = dx * dx + dy * dy;
    int bi = 0;
    const int lim = c.lim[k];
    for (int r = 1; r < lim; ++r) {
      dx = qx - c.at(p.rx, r);
      dy = qy - c.at(p.ry, r);
      const T d2 = dx * dx + dy * dy;
      if (d2 < best) {
        best = d2;
        bi = r;
      }
    }
    t.rx[k] = c.at(p.rx, bi);
    t.ry[k] = c.at(p.ry, bi);
    t.rh[k] = c.at(p.ryaw, bi);
  }
}

// Ellipse safety margin of point (qx, qy) against obstacle j at step k
// (reference src/utils.cpp:387-439); writes dc/dq when g is given.
template <typename T>
__device__ __forceinline__ T ellipse(const Ctx<T>& c, int j, int k, T qx, T qy, T* gx,
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
template <typename T>
__device__ __forceinline__ T lateral(const Traj<T>& t, int k, T* ddx, T* ddy, T* h,
                                     T* dsign) {
  *ddx = t.px[k] - t.rx[k];
  *ddy = t.py[k] - t.ry[k];
  *dsign = *ddy * cos_(t.rh[k]) - *ddx * sin_(t.rh[k]);
  *h = hypot_(*ddx, *ddy);
  return *dsign < T(0) ? -*h : *h;
}

// Total cost of a projected trajectory (src/cilqr_solver.cpp:199-287):
// tracking cost on steps 0..N, control cost and control-bound barriers on
// steps 0..N-1, state, border and obstacle barriers on steps 1..N.
template <typename T>
__device__ T total_cost(const Ctx<T>& c, const Traj<T>& t) {
  const Weights<T>& w = c.w;
  T J = T(0);
  for (int k = 0; k <= c.N; ++k) {
    const T dx = t.px[k] - t.rx[k], dy = t.py[k] - t.ry[k];
    const T dv = t.pv[k] - c.ref_velo, dh = t.ph[k] - t.rh[k];
    J += w.w_pos * (dx * dx + dy * dy) + w.w_vel * dv * dv + w.w_yaw * dh * dh;
    if (k < c.N) {
      const T ua = t.ua[k], us = t.us[k];
      J += w.w_acc * ua * ua + w.w_stl * us * us;
      J += barrier(c, ua - w.acc_max, w.sq1, w.sq2) + barrier(c, w.acc_min - ua, w.sq1, w.sq2)
         + barrier(c, us - w.stl_lim, w.sq1, w.sq2) + barrier(c, -w.stl_lim - us, w.sq1, w.sq2);
    }
    if (k >= 1) {
      const T v = t.pv[k];
      J += barrier(c, v - w.velo_max, w.sq1, w.sq2) + barrier(c, w.velo_min - v, w.sq1, w.sq2);
      T ddx, ddy, h, ds;
      const T cur_d = lateral(t, k, &ddx, &ddy, &h, &ds);
      J += barrier(c, cur_d - c.up_bound, w.sq1, w.sq2)
         + barrier(c, c.lo_bound - cur_d, w.sq1, w.sq2);
      const T fx = t.px[k] + w.wb * cos_(t.ph[k]), fy = t.py[k] + w.wb * sin_(t.ph[k]);
      for (int j = 0; j < c.M; ++j) {
        J += barrier(c, ellipse(c, j, k, fx, fy, (T*)nullptr, (T*)nullptr), w.oq1, w.oq2);
        J += barrier(c, ellipse(c, j, k, t.px[k], t.py[k], (T*)nullptr, (T*)nullptr), w.oq1,
                     w.oq2);
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

template <typename T>
__device__ void step_derivs(const Ctx<T>& c, const Traj<T>& t, int k, StepDerivs<T>& D) {
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
    const T q2 = w.sq2, q22 = w.sq2 * w.sq2;
    const T b0 = barrier(c, ua - w.acc_max, w.sq1, q2);
    const T b1 = barrier(c, w.acc_min - ua, w.sq1, q2);
    const T b2 = barrier(c, us - w.stl_lim, w.sq1, q2);
    const T b3 = barrier(c, -w.stl_lim - us, w.sq1, q2);
    D.lu[0] = T(2) * w.w_acc * ua + (q2 * b0 - q2 * b1);
    D.lu[1] = T(2) * w.w_stl * us + (q2 * b2 - q2 * b3);
    D.luu00 = T(2) * w.w_acc + (q22 * b0 + q22 * b1);
    D.luu11 = T(2) * w.w_stl + (q22 * b2 + q22 * b3);
  }
  if (k >= 1) {
    const T q2 = w.sq2, q22 = w.sq2 * w.sq2;
    const T v = t.pv[k];
    const T b4 = barrier(c, v - w.velo_max, w.sq1, q2);
    const T b5 = barrier(c, w.velo_min - v, w.sq1, q2);
    D.lx[2] += q2 * b4 - q2 * b5;
    D.lxx[2][2] += q22 * b4 + q22 * b5;
    // road borders: gradient (+-gx, +-gy, 0, 0), zero at h == 0
    T ddx, ddy, h, ds;
    const T cur_d = lateral(t, k, &ddx, &ddy, &h, &ds);
    const T b6 = barrier(c, cur_d - c.up_bound, w.sq1, q2);
    const T b7 = barrier(c, c.lo_bound - cur_d, w.sq1, q2);
    const T flip = ds < T(0) ? T(-1) : T(1);
    const T gpx = h > T(0) ? flip * (ddx / h) : T(0);
    const T gpy = h > T(0) ? flip * (ddy / h) : T(0);
    const T gsum = q2 * b6 - q2 * b7, hsum = q22 * b6 + q22 * b7;
    D.lx[0] += gsum * gpx;
    D.lx[1] += gsum * gpy;
    D.lxx[0][0] += hsum * gpx * gpx;
    D.lxx[0][1] += hsum * gpx * gpy;
    D.lxx[1][1] += hsum * gpy * gpy;
    // obstacle ellipses, chained through the front/rear point Jacobians
    const T sy = sin_(t.ph[k]), cy = cos_(t.ph[k]);
    const T fx = t.px[k] + w.wb * cy, fy = t.py[k] + w.wb * sy;
    const T oq2 = w.oq2, oq22 = w.oq2 * w.oq2;
    for (int j = 0; j < c.M; ++j) {
      for (int front = 1; front >= 0; --front) {
        T gx, gy;
        const T m = front ? ellipse(c, j, k, fx, fy, &gx, &gy)
                          : ellipse(c, j, k, t.px[k], t.py[k], &gx, &gy);
        const T bj = barrier(c, m, w.oq1, oq2);
        const T gcoef = oq2 * bj, hcoef = oq22 * bj;
        // d(front)/d(yaw) = wb * (-sin, cos); the rear point is the state
        const T g3 = front ? (-w.wb * sy) * gx + (w.wb * cy) * gy : T(0);
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

// Riccati backward pass with the rear-center Jacobians
// (src/cilqr_solver.cpp:383-440, src/utils.cpp:285-342):
// A = I + a02 e0e2' + a03 e0e3' + a12 e1e2' + a13 e1e3' + a32 e3e2',
// B = dt e2e0' + b31 e3e1'. Returns false when some Q_uu is not positive
// definite (the pass is then discarded).
template <typename T>
__device__ bool backward(const Ctx<T>& c, const Traj<T>& t, T lamb, T (*K)[8], T (*d)[2],
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
    const T cyw = cos_(yaw), syw = sin_(yaw), cs = cos_(stl);
    const T a02 = cyw * dt, a03 = -v * syw * dt, a12 = syw * dt, a13 = v * cyw * dt;
    const T a32 = tan_(stl) * dt / wb;
    const T b31 = (v * dt / wb) / (cs * cs);

    T Qx[4], Qu[2], M1[4][4], Qxx[4][4], Qux[2][4];
    Qx[0] = D.lx[0] + Vx[0];
    Qx[1] = D.lx[1] + Vx[1];
    Qx[2] = D.lx[2] + (a02 * Vx[0] + a12 * Vx[1] + Vx[2] + a32 * Vx[3]);
    Qx[3] = D.lx[3] + (a03 * Vx[0] + a13 * Vx[1] + Vx[3]);
    Qu[0] = D.lu[0] + dt * Vx[2];
    Qu[1] = D.lu[1] + b31 * Vx[3];
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
      Qux[1][j] = b31 * M1[3][j];
    }
    // Quu = luu + B' V B + lamb I (symmetric)
    const T q00 = D.luu00 + dt * (dt * V[2][2]) + lamb;
    const T q01 = dt * (b31 * V[2][3]);
    const T q11 = D.luu11 + b31 * (b31 * V[3][3]) + lamb;
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

// Closed-loop trial rollout u' = u + K (x' - x) + alpha d
// (src/cilqr_solver.cpp:442-461).
template <typename T>
__device__ void forward(const Ctx<T>& c, const Traj<T>& cur, T (*K)[8], T (*d)[2],
                        T alpha, Traj<T>& tr) {
  T x = cur.px[0], y = cur.py[0], v = cur.pv[0], h = cur.ph[0];
  tr.px[0] = x;
  tr.py[0] = y;
  tr.pv[0] = v;
  tr.ph[0] = h;
  for (int k = 0; k < c.N; ++k) {
    const T e0 = x - cur.px[k], e1 = y - cur.py[k], e2 = v - cur.pv[k], e3 = h - cur.ph[k];
    const T na = cur.ua[k] + (K[k][0] * e0 + K[k][1] * e1 + K[k][2] * e2 + K[k][3] * e3) +
                 alpha * d[k][0];
    const T ns = cur.us[k] + (K[k][4] * e0 + K[k][5] * e1 + K[k][6] * e2 + K[k][7] * e3) +
                 alpha * d[k][1];
    tr.ua[k] = na;
    tr.us[k] = ns;
    propagate(c, x, y, v, h, na, ns);
    tr.px[k + 1] = x;
    tr.py[k + 1] = y;
    tr.pv[k + 1] = v;
    tr.ph[k + 1] = h;
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
    cilqr_solve_kernel(const Weights<T> w, const RowLimits lim, const Problem<T> p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.B) return;  // ragged last block
  Ctx<T> c;
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

  Traj<T> cur, trial;
  T K[kMaxSteps][8], d[kMaxSteps][2];
  const int N = p.N;
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
  project(c, cur);
  T J = total_cost(c, cur);  // cost of `cur`, kept in step with it

  T lamb = w.init_lamb;
  int status = kRunning, iters = 0;
  bool converged = false, overflow = false;
  for (int it = 0; it < p.max_iter; ++it) {
    T dV1, dV2;
    const bool pd = backward(c, cur, lamb, K, d, dV1, dV2);
    bool accepted = false, conv_now = false, small = false;
    if (pd) {
      T alpha = T(1);
      for (int t = 0; t < p.n_alphas; ++t, alpha *= T(0.5)) {
        forward(c, cur, K, d, alpha, trial);
        project(c, trial);
        const T nJ = total_cost(c, trial);
        const T decay = J - nJ;
        // convergence is tested on the first trial only, and a converged
        // trial is not adopted (src/cilqr_solver.cpp:352-365)
        if (t == 0 && fabs(decay) < w.conv_thresh) {
          conv_now = true;
          break;
        }
        const T approx = -(alpha * alpha * dV1 + alpha * dV2);
        const bool ratio_ok = approx != T(0) ? decay / approx > w.accept_thresh : true;
        if (decay > T(0) && (approx < T(0) || ratio_ok)) {
          accepted = true;
          small = t > 0;
          cur = trial;
          J = nJ;
          break;
        }
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
  p.stats_out[4 * B + b] = J;
  p.stats_out[5 * B + b] = lamb;
}

template <typename T>
int launch(const T* wts, const int* limits, const T* x0, const T* uinit, const T* rx,
           const T* ry, const T* ryaw, const T* ox, const T* oy, const T* oyaw, T* u_out,
           T* x_out, T* stats_out, int B, int N, int M, int W, int max_iter, int n_alphas,
           cudaStream_t stream) {
  static_assert(sizeof(Weights<T>) == kNumWeights * sizeof(T), "weights layout");
  if (B < 0 || N < 1 || N + 1 > kMaxSteps || M < 0 || W < 1 || max_iter < 0 || n_alphas < 0)
    return cudaErrorInvalidValue;
  Weights<T> w;
  std::memcpy(&w, wts, sizeof(w));
  RowLimits lim = {};
  for (int k = 0; k <= N; ++k) {
    if (limits[k] < 1 || limits[k] > W) return cudaErrorInvalidValue;
    lim.r[k] = limits[k];
  }
  if (B == 0) return cudaSuccess;
  const Problem<T> p = {x0, uinit, rx, ry, ryaw, ox, oy, oyaw, u_out, x_out, stats_out,
                        B, N, M, W, max_iter, n_alphas};
  cilqr_solve_kernel<T><<<(B + kBlock - 1) / kBlock, kBlock, 0, stream>>>(w, lim, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). `wts` and `limits` are host
// arrays: kNumWeights scalars in _WEIGHT_ORDER and N+1 row limits; every
// other pointer is device memory. Returns the launch's cudaError_t.
extern "C" int cilqr_solve_f32(const float* wts, const int* limits, const float* x0,
                               const float* uinit, const float* rx, const float* ry,
                               const float* ryaw, const float* ox, const float* oy,
                               const float* oyaw, float* u_out, float* x_out,
                               float* stats_out, int B, int N, int M, int W, int max_iter,
                               int n_alphas, void* stream) {
  return launch<float>(wts, limits, x0, uinit, rx, ry, ryaw, ox, oy, oyaw, u_out, x_out,
                       stats_out, B, N, M, W, max_iter, n_alphas,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int cilqr_solve_f64(const double* wts, const int* limits, const double* x0,
                               const double* uinit, const double* rx, const double* ry,
                               const double* ryaw, const double* ox, const double* oy,
                               const double* oyaw, double* u_out, double* x_out,
                               double* stats_out, int B, int N, int M, int W, int max_iter,
                               int n_alphas, void* stream) {
  return launch<double>(wts, limits, x0, uinit, rx, ry, ryaw, ox, oy, oyaw, u_out, x_out,
                        stats_out, B, N, M, W, max_iter, n_alphas,
                        static_cast<cudaStream_t>(stream));
}

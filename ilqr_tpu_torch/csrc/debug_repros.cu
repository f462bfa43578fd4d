// The Pallas repro kernels of tools/debug/ for NVIDIA Hopper (sm_90a).
//
// Each TPU repro isolated one piece of the straggler-resume dataflow of the
// CILQR kernel (ilqr_tpu/ops/pallas/cilqr_kernel.py: a tenth input block,
// kernel output -> column permute -> second kernel, input slices carried
// through a loop, a loop that runs zero times). The same dataflow on the
// card: the kernels below compute what those repros compute, at their
// shapes with one group (G = 1: the card has no lane interleave), every
// array float32 and column-fastest ([row][Bp]).
//
//   K2 min_resume_echo  <- tools/debug/min_resume_repro.py:18  `kernel`
//   K3 min_dataflow_k1  <- tools/debug/min_dataflow_repro.py:25 `k1`
//      min_dataflow_k2  <- tools/debug/min_dataflow_repro.py:33 `k2`
//   K4/K5 min_carry     <- tools/debug/min_carry_repro.py:16 `kernel` (2 trips)
//                          and tools/debug/min_zerotrip_repro.py:14 (0 trips)
//
// Bound: bytes. Each is a copy or an affine map of a few hundred KB, so at
// these shapes a launch costs its fixed overhead (~1 us) against a bytes
// bound of 0.03-0.2 us. Every kernel is a flat pass over the 2 Bp quads
// (float4s, 16 bytes) of an 8-row block: thread q owns quad q, neighbouring
// threads on neighbouring quads, in small blocks so that the quads spread
// over many SMs. Rows are column-fastest and 8 Bp is a multiple of 4, so a
// quad may straddle two rows but never leaves the block. The launch shape
// (grid, block) comes from the host (debug_repros.launch_plan); each entry
// checks that it covers the 2 Bp quads and that every pointer starts on 16
// bytes. Every product and sum is written with the round-to-nearest
// intrinsics, so nvcc contracts nothing into an FMA: 3x - 5 is rounded
// twice, as the repros' numpy expectation and the plain versions in
// ilqr_tpu_torch/ops/cuda/debug_repros.py round it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// a + 0 x per component, rounded as the repro's `a + 0 * x`.
__device__ __forceinline__ float4 add_zero_times(float4 a, float4 x) {
  return make_float4(__fadd_rn(a.x, __fmul_rn(0.f, x.x)), __fadd_rn(a.y, __fmul_rn(0.f, x.y)),
                     __fadd_rn(a.z, __fmul_rn(0.f, x.z)), __fadd_rn(a.w, __fmul_rn(0.f, x.w)));
}

// m x + c per component, the product rounded, then the sum.
__device__ __forceinline__ float4 affine(float4 x, float m, float c) {
  return make_float4(__fadd_rn(__fmul_rn(m, x.x), c), __fadd_rn(__fmul_rn(m, x.y), c),
                     __fadd_rn(__fmul_rn(m, x.z), c), __fadd_rn(__fmul_rn(m, x.w), c));
}

// K2: out = res + 0 x0 + 0 uinit + 0 rx + 0 ry + 0 ryaw + 0 ox + 0 oy + 0 oyaw
// over the first 8 rows of every input (nq = 2 Bp quads, one a thread). The
// nine float4 loads go first, all in flight at once: that takes 36
// registers for the loaded values, and without the launch bounds ptxas
// keeps to 32 (full occupancy) and sends the loads in two waves, which cost
// ~0.15 us more on the H100. So a block has at most 128 threads (the entry
// refuses more). Then each component's chain runs left to right, as the
// repro adds, so NaN, inf and -0 + 0 = +0 come out as the plain version's.
__global__ void __launch_bounds__(128, 1)
    resume_echo(const float4* __restrict__ x0, const float4* __restrict__ uinit,
                const float4* __restrict__ rx, const float4* __restrict__ ry,
                const float4* __restrict__ ryaw, const float4* __restrict__ ox,
                const float4* __restrict__ oy, const float4* __restrict__ oyaw,
                const float4* __restrict__ res, float4* __restrict__ out, int nq) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= nq) return;
  const float4 in[8] = {x0[q], uinit[q], rx[q], ry[q], ryaw[q], ox[q], oy[q], oyaw[q]};
  float4 a = res[q];
#pragma unroll
  for (int k = 0; k < 8; ++k) a = add_zero_times(a, in[k]);
  out[q] = a;
}

// K3 k1: x (8, Bp) -> u (64, Bp) with rows 0..7 = 2x + 1 and rows 8..63 = 0,
// and s (8, Bp) = 3x - 5. Thread q owns quad q of x (nq = 2 Bp quads): one
// float4 load, u's quad q and s's quad q. Rows 8..63 of u are 7 nq quads
// more, and thread q stores their quads q + k nq, k = 1..7: every thread
// the same nine float4 stores, each of the seven zero stretches written by
// neighbouring threads on neighbouring quads.
__global__ void dataflow_k1(const float4* __restrict__ x, float4* __restrict__ u,
                            float4* __restrict__ s, int nq) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= nq) return;
  const float4 v = x[q];
  u[q] = affine(v, 2.f, 1.f);
  s[q] = affine(v, 3.f, -5.f);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int k = 1; k < 8; ++k) u[q + k * nq] = zero;
}

// K3 k2: out (8, Bp) = s + u[0:8]. Rows 0..7 of u are its first 8 Bp floats,
// so this is a flat pass over nq = 2 Bp quads, one a thread.
__global__ void dataflow_k2(const float4* __restrict__ u, const float4* __restrict__ s,
                            float4* __restrict__ out, int nq) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= nq) return;
  const float4 a = s[q], b = u[q];
  out[q] = make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                       __fadd_rn(a.w, b.w));
}

// K4 / K5: rows 0..5 of res are the carries of a `trips`-trip loop that adds
// lane0 = 0 x0[0] to each; out (8, Bp) = those 6 rows, then 2 zero rows. A
// flat pass over the 2 Bp output quads, one a thread: flat element i < 6 Bp
// is res[i] plus, `trips` times in turn, 0 x0[0, i % Bp]; the rest is 0. 6 Bp
// need not be a multiple of 4, so the one quad that straddles it reads its
// res elements one at a time; rows 6..7 of res are never read. With no trip
// (or past 6 Bp) the quad is a copy. Else its x0 loads go first: the quad's
// first column from five compares (no division), and when Bp is a multiple
// of 4 its four lane0 inputs are one float4 of x0, else four loads with the
// row wrap. The trip loop is outside the quad's (a short loop, as the
// repro's).
__device__ __forceinline__ void load_res(const float* __restrict__ res, int q, int n6,
                                         float (&v)[4]) {
  const int i = 4 * q;
  if (i + 4 <= n6) {
    const float4 r = reinterpret_cast<const float4*>(res)[q];
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = i + k < n6 ? res[i + k] : 0.f;
  }
}

__global__ void carry(const float* __restrict__ x0, const float* __restrict__ res,
                      float4* __restrict__ out, int Bp, int trips) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= 2 * Bp) return;
  const int i = 4 * q, n6 = 6 * Bp;
  float v[4];
  if (trips == 0 || i >= n6) {
    load_res(res, q, n6, v);
    out[q] = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
  int b = i;  // i % Bp, as i < 6 Bp
#pragma unroll
  for (int m = 1; m < 6; ++m) b -= i >= m * Bp ? Bp : 0;
  float x[4] = {0.f, 0.f, 0.f, 0.f};
  if (Bp % 4 == 0) {  // the quad lies in one row
    const float4 r = reinterpret_cast<const float4*>(x0)[b / 4];
    x[0] = r.x;
    x[1] = r.y;
    x[2] = r.z;
    x[3] = r.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int c = b + k;  // < Bp + 3: at most three wraps (Bp >= 1)
      c -= c >= Bp ? Bp : 0;
      c -= c >= Bp ? Bp : 0;
      c -= c >= Bp ? Bp : 0;
      if (i + k < n6) x[k] = x0[c];
    }
  }
  load_res(res, q, n6, v);
  // past 6 Bp, x = v = +0 and +0 + 0 x (+0) stays +0: no test needed
  float lane0[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) lane0[k] = __fmul_rn(x[k], 0.f);
#pragma unroll 1
  for (int t = 0; t < trips; ++t)
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __fadd_rn(v[k], lane0[k]);
  out[q] = make_float4(v[0], v[1], v[2], v[3]);
}

// A launch of grid x block threads covers `threads` work items, in the
// limits of a launch.
bool covers(long long threads, int grid, int block) {
  return block >= 1 && block <= 1024 && grid >= 1 &&
         static_cast<long long>(grid) * block >= threads;
}

// Every pointer starts on 16 bytes (a float4).
template <class... P>
bool aligned16(const P*... p) {
  return ((reinterpret_cast<std::uintptr_t>(p) % 16 == 0) && ...);
}

// Bp is valid when 64 Bp, the largest element count, fits an int.
bool columns_ok(int Bp) { return Bp >= 0 && Bp < (1 << 25); }

int status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// Plain C entry points (bound with ctypes): device pointers, the column
// count Bp, the launch shape, the stream; each returns the launch's
// cudaError_t, cudaErrorInvalidValue for a shape or a plan it refuses.
extern "C" int min_resume_echo(const float* x0, const float* uinit, const float* rx,
                               const float* ry, const float* ryaw, const float* ox,
                               const float* oy, const float* oyaw, const float* res, float* out,
                               int Bp, int grid, int block, void* stream) {
  if (!columns_ok(Bp)) return cudaErrorInvalidValue;
  if (Bp == 0) return cudaSuccess;
  if (!covers(2 * Bp, grid, block) || block > 128 ||
      !aligned16(x0, uinit, rx, ry, ryaw, ox, oy, oyaw, res, out))
    return cudaErrorInvalidValue;
  const auto f4 = [](const float* p) { return reinterpret_cast<const float4*>(p); };
  resume_echo<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      f4(x0), f4(uinit), f4(rx), f4(ry), f4(ryaw), f4(ox), f4(oy), f4(oyaw), f4(res),
      reinterpret_cast<float4*>(out), 2 * Bp);
  return status();
}

extern "C" int min_dataflow_k1(const float* x, float* u, float* s, int Bp, int grid, int block,
                               void* stream) {
  if (!columns_ok(Bp)) return cudaErrorInvalidValue;
  if (Bp == 0) return cudaSuccess;
  if (!covers(2 * Bp, grid, block) || !aligned16(x, u, s)) return cudaErrorInvalidValue;
  dataflow_k1<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(u),
      reinterpret_cast<float4*>(s), 2 * Bp);
  return status();
}

extern "C" int min_dataflow_k2(const float* u, const float* s, float* out, int Bp, int grid,
                               int block, void* stream) {
  if (!columns_ok(Bp)) return cudaErrorInvalidValue;
  if (Bp == 0) return cudaSuccess;
  if (!covers(2 * Bp, grid, block) || !aligned16(u, s, out)) return cudaErrorInvalidValue;
  dataflow_k2<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(u), reinterpret_cast<const float4*>(s),
      reinterpret_cast<float4*>(out), 2 * Bp);
  return status();
}

extern "C" int min_carry(const float* x0, const float* res, float* out, int Bp, int trips,
                         int grid, int block, void* stream) {
  if (!columns_ok(Bp) || trips < 0) return cudaErrorInvalidValue;
  if (Bp == 0) return cudaSuccess;
  if (!covers(2 * Bp, grid, block) || !aligned16(x0, res, out)) return cudaErrorInvalidValue;
  carry<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      x0, res, reinterpret_cast<float4*>(out), Bp, trips);
  return status();
}

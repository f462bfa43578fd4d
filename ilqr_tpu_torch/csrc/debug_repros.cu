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
// these shapes a launch costs its fixed overhead; one thread per element
// (per column for the carry loop), neighbouring threads on neighbouring
// addresses. Every product and sum is written with the round-to-nearest
// intrinsics, so nvcc contracts nothing into an FMA: 3x - 5 is rounded
// twice, as the repros' numpy expectation and the plain versions in
// ilqr_tpu_torch/ops/cuda/debug_repros.py round it.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

int blocks(int n) { return (n + kBlock - 1) / kBlock; }

// K2: out = res + 0 x0 + 0 uinit + 0 rx + 0 ry + 0 ryaw + 0 ox + 0 oy + 0 oyaw
// over the first 8 rows of every input (n = 8 Bp elements), left to right.
__global__ void resume_echo(const float* __restrict__ x0, const float* __restrict__ uinit,
                            const float* __restrict__ rx, const float* __restrict__ ry,
                            const float* __restrict__ ryaw, const float* __restrict__ ox,
                            const float* __restrict__ oy, const float* __restrict__ oyaw,
                            const float* __restrict__ res, float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float a = __fadd_rn(res[i], __fmul_rn(0.f, x0[i]));
  a = __fadd_rn(a, __fmul_rn(0.f, uinit[i]));
  a = __fadd_rn(a, __fmul_rn(0.f, rx[i]));
  a = __fadd_rn(a, __fmul_rn(0.f, ry[i]));
  a = __fadd_rn(a, __fmul_rn(0.f, ryaw[i]));
  a = __fadd_rn(a, __fmul_rn(0.f, ox[i]));
  a = __fadd_rn(a, __fmul_rn(0.f, oy[i]));
  a = __fadd_rn(a, __fmul_rn(0.f, oyaw[i]));
  out[i] = a;
}

// K3 k1: x (8, Bp) -> u (64, Bp) with rows 0..7 = 2x + 1 and rows 8..63 = 0,
// and s (8, Bp) = 3x - 5; n8 = 8 Bp, nu = 64 Bp.
__global__ void dataflow_k1(const float* __restrict__ x, float* __restrict__ u,
                            float* __restrict__ s, int n8, int nu) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nu) return;
  if (i < n8) {
    const float xi = x[i];
    u[i] = __fadd_rn(__fmul_rn(2.f, xi), 1.f);
    s[i] = __fadd_rn(__fmul_rn(3.f, xi), -5.f);
  } else {
    u[i] = 0.f;
  }
}

// K3 k2: out (8, Bp) = s + u[0:8].
__global__ void dataflow_k2(const float* __restrict__ u, const float* __restrict__ s,
                            float* __restrict__ out, int n8) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  out[i] = __fadd_rn(s[i], u[i]);
}

// K4 / K5: rows 0..5 of res are the carries of a `trips`-trip loop that adds
// lane0 = 0 x0[0] to each; out (8, Bp) = those 6 rows, then 2 zero rows. One
// thread per column.
__global__ void carry(const float* __restrict__ x0, const float* __restrict__ res,
                      float* __restrict__ out, int Bp, int trips) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= Bp) return;
  const float lane0 = __fmul_rn(x0[b], 0.f);
  float c[6];
  for (int k = 0; k < 6; ++k) c[k] = res[k * Bp + b];
  for (int t = 0; t < trips; ++t)
    for (int k = 0; k < 6; ++k) c[k] = __fadd_rn(c[k], lane0);
  for (int k = 0; k < 6; ++k) out[k * Bp + b] = c[k];
  out[6 * Bp + b] = 0.f;
  out[7 * Bp + b] = 0.f;
}

int status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// Plain C entry points (bound with ctypes): device pointers, the column
// count Bp, the stream; each returns the launch's cudaError_t.
extern "C" int min_resume_echo(const float* x0, const float* uinit, const float* rx,
                               const float* ry, const float* ryaw, const float* ox,
                               const float* oy, const float* oyaw, const float* res, float* out,
                               int Bp, void* stream) {
  if (Bp < 0) return cudaErrorInvalidValue;
  if (Bp == 0) return cudaSuccess;
  const int n = 8 * Bp;
  resume_echo<<<blocks(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      x0, uinit, rx, ry, ryaw, ox, oy, oyaw, res, out, n);
  return status();
}

extern "C" int min_dataflow_k1(const float* x, float* u, float* s, int Bp, void* stream) {
  if (Bp < 0) return cudaErrorInvalidValue;
  if (Bp == 0) return cudaSuccess;
  dataflow_k1<<<blocks(64 * Bp), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      x, u, s, 8 * Bp, 64 * Bp);
  return status();
}

extern "C" int min_dataflow_k2(const float* u, const float* s, float* out, int Bp,
                               void* stream) {
  if (Bp < 0) return cudaErrorInvalidValue;
  if (Bp == 0) return cudaSuccess;
  dataflow_k2<<<blocks(8 * Bp), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(u, s, out,
                                                                                8 * Bp);
  return status();
}

extern "C" int min_carry(const float* x0, const float* res, float* out, int Bp, int trips,
                         void* stream) {
  if (Bp < 0 || trips < 0) return cudaErrorInvalidValue;
  if (Bp == 0) return cudaSuccess;
  carry<<<blocks(Bp), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(x0, res, out, Bp, trips);
  return status();
}

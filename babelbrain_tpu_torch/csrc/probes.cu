// Roofline and gather probes for NVIDIA Hopper (sm_90a): what the card's
// memory, FP32 units and shared-memory table gathers deliver to kernels
// written like the port's FDTD kernels.
//
// Replaces (TPU kernels of the JAX package):
//   tools/probe_roofline.py probe_vpu (the pallas_call at :109): 8
//     dependent chains a = a * 1.000001 + x per element on a (256, 512)
//     block, repetitions inside the kernel   -> fma_chain_kernel;
//   tools/probe_roofline.py probe_gather (:264) and tools/probe_gather.py
//     try_case / main (:50, :96): an int32 index expanded to coefficients
//     through a small table (the 1026-entry CT table, the 16-entry label
//     table, P2's (R, C, M) cases and its cost probe) -> table_gather_kernel;
//   and, beside them, the plain-XLA stream probe of probe_roofline.py
//     (:75, y = x + 1)                         -> stream_kernel.
//
// What bounds them: stream_kernel is the HBM bound itself (4 B read and 4 B
// written an element). Each thread moves kStreamVec float4s, 16-byte loads
// and stores at a stride of the block (coalesced), all loads issued before
// the first store, so few threads keep many bytes in flight; the n mod 4
// tail goes element by element. fma_chain_kernel is bound by FP32
// operations: eight independent chains a thread give the FMA pipe enough
// independent work to hide its latency, and __fmaf_rn is written out because
// the library is built with --fmad=false, which would otherwise split
// a * b + c into FMUL + FADD and halve the rate. table_gather_kernel copies
// the (n_coef, M) table into shared memory once a block (as
// visco_velocity_kernel / visco_stress_kernel hold their (6, M) table) and
// then reads one int32 index and writes n_coef floats an element: bound by
// bytes, plus the table copy of each block.
//
// Rounding: stream and gather are exact. The FMA chain rounds once a step,
// as its plain version (a float64 emulation in probes.py) does.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStreamVec = 4;  // float4s a thread
constexpr int kChains = 8;
constexpr float kMul = 1.000001f;

// y = x + 1 over n floats; x and y 16-byte aligned
__global__ void stream_kernel(const float* __restrict__ x,
                              float* __restrict__ y, long long n) {
  const long long n4 = n / 4;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* y4 = reinterpret_cast<float4*>(y);
  const long long e0 =
      (long long)blockIdx.x * kThreads * kStreamVec + threadIdx.x;
  float4 v[kStreamVec];
#pragma unroll
  for (int u = 0; u < kStreamVec; ++u) {
    const long long e = e0 + u * kThreads;
    if (e < n4) v[u] = x4[e];
  }
#pragma unroll
  for (int u = 0; u < kStreamVec; ++u) {
    const long long e = e0 + u * kThreads;
    if (e < n4) {
      y4[e] = make_float4(v[u].x + 1.0f, v[u].y + 1.0f, v[u].z + 1.0f,
                          v[u].w + 1.0f);
    }
  }
  const long long t = 4 * n4 + e0;  // the tail, in block 0
  if (blockIdx.x == 0 && t < n) y[t] = x[t] + 1.0f;
}

// a_j = x * scale[j]; rep times a_j = fma(a_j, 1.000001f, x); out = sum a_j
__global__ void fma_chain_kernel(const float* __restrict__ x,
                                 const float* __restrict__ scale,
                                 float* __restrict__ out, int n, int rep) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float xv = x[i];
  float a[kChains];
#pragma unroll
  for (int j = 0; j < kChains; ++j) a[j] = xv * scale[j];
  for (int r = 0; r < rep; ++r) {
#pragma unroll
    for (int j = 0; j < kChains; ++j) a[j] = __fmaf_rn(a[j], kMul, xv);
  }
  float o = a[0];
#pragma unroll
  for (int j = 1; j < kChains; ++j) o = o + a[j];
  out[i] = o;
}

// out[r, e] = table[r, idx[e]] for r < n_coef; table in shared memory
__global__ void table_gather_kernel(const int* __restrict__ idx,
                                    const float* __restrict__ table,
                                    float* __restrict__ out, int n_coef,
                                    int m, long long n) {
  extern __shared__ float tab[];
  for (int t = threadIdx.x; t < n_coef * m; t += blockDim.x) tab[t] = table[t];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += stride) {
    const int k = idx[e];
    for (int r = 0; r < n_coef; ++r) out[r * n + e] = tab[r * m + k];
  }
}

}  // namespace

extern "C" {

// x, y: 16-byte aligned (the wrapper checks)
int bb_stream(const float* x, float* y, long long n, void* stream) {
  const long long per_block = kThreads * kStreamVec;  // float4s
  const long long nb = (n / 4 + per_block - 1) / per_block;
  stream_kernel<<<(unsigned int)(nb > 0 ? nb : 1), kThreads, 0,
                  (cudaStream_t)stream>>>(x, y, n);
  return (int)cudaGetLastError();
}

// scale: 8 device floats
int bb_fma_chain(const float* x, const float* scale, float* out, int n,
                 int rep, void* stream) {
  const unsigned int nb = (unsigned int)((n + kThreads - 1) / kThreads);
  fma_chain_kernel<<<nb, kThreads, 0, (cudaStream_t)stream>>>(x, scale, out,
                                                              n, rep);
  return (int)cudaGetLastError();
}

// blocks: the grid size (each block copies the table once and strides over
// the elements)
int bb_table_gather(const int* idx, const float* table, float* out,
                    int n_coef, int m, long long n, int blocks,
                    void* stream) {
  table_gather_kernel<<<blocks, kThreads, n_coef * m * sizeof(float),
                        (cudaStream_t)stream>>>(idx, table, out, n_coef, m,
                                                n);
  return (int)cudaGetLastError();
}

}  // extern "C"

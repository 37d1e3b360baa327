// Pennes bio-heat (BHTE) FTCS step with CEM43 dose for NVIDIA Hopper
// (sm_90a).
//
// Replaces (TPU kernel of the JAX package):
//   babelbrain_tpu/ops/bhte_pallas.py build_bhte_fusedK_step (B9), which
//   advances K such steps per streaming sweep. Here one launch is one step;
//   K fused TPU steps are K launches.
//
// What bounds it on this card: device-memory traffic. Per cell and step it
// reads T (+6 neighbours, mostly cache hits), dose, peak, six interface
// conductivities, irc, perf and, in heating segments, Q, and writes T', dose
// and peak: about 16 float volumes per step for ~30 flops per cell, far
// below the card's flop/byte balance.
//
// What the design does about it: one thread per cell, threadIdx.x along z
// (the contiguous axis) so every warp moves contiguous 128-byte lines; the
// six neighbours come from global memory and are shared between nearby
// blocks through L1/L2. T is double-buffered (T -> T_out), dose and peak are
// updated in place. Cooling segments launch without Q and skip its stream.
// Storing the interface conductivities as one conductivity volume and
// computing the harmonic means in the kernel (6 -> 1 volumes) and temporal
// blocking are later work.
//
// Boundaries are edge-replicated (adiabatic), unlike the FDTD's zero
// padding. Rounding: built with --fmad=false and written in the operation
// order of the plain version (ops/bhte_kernels.py bhte_step_ref).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kLog2RHi = -1.0f;  // log2(0.5), at or above 43 C
constexpr float kLog2RLo = -2.0f;  // log2(0.25), below 43 C

template <bool WITH_Q>
__global__ void bhte_step_kernel(
    const float* __restrict__ T, float* __restrict__ T_out,
    float* __restrict__ dose, float* __restrict__ peak,
    const float* __restrict__ kxp, const float* __restrict__ kxm,
    const float* __restrict__ kyp, const float* __restrict__ kym,
    const float* __restrict__ kzp, const float* __restrict__ kzm,
    const float* __restrict__ irc, const float* __restrict__ perf,
    const float* __restrict__ q, float t_art, int n1, int n2, int n3) {
  const long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long sx = (long long)n2 * n3;
  if (c >= sx * n1) return;
  const int k = (int)(c % n3);
  const long long ij = c / n3;
  const int j = (int)(ij % n2);
  const int i = (int)(ij / n2);

  const float tc = T[c];
  const float txp = (i + 1 < n1) ? T[c + sx] : tc;
  const float txm = (i >= 1) ? T[c - sx] : tc;
  const float typ = (j + 1 < n2) ? T[c + n3] : tc;
  const float tym = (j >= 1) ? T[c - n3] : tc;
  const float tzp = (k + 1 < n3) ? T[c + 1] : tc;
  const float tzm = (k >= 1) ? T[c - 1] : tc;
  const float lap = kxp[c] * (txp - tc) + kxm[c] * (txm - tc) +
                    kyp[c] * (typ - tc) + kym[c] * (tym - tc) +
                    kzp[c] * (tzp - tc) + kzm[c] * (tzm - tc);
  const float rc = irc[c];
  float tn = tc + lap * rc + perf[c] * (t_art - tc);
  if (WITH_Q) tn = tn + q[c] * rc;
  const float log2r = (tn >= 43.0f) ? kLog2RHi : kLog2RLo;
  T_out[c] = tn;
  dose[c] = dose[c] + exp2f(log2r * (43.0f - tn));
  peak[c] = fmaxf(peak[c], tn);
}

}  // namespace

extern "C" int bb_bhte_step(const float* T, float* T_out, float* dose,
                            float* peak, const float* kxp, const float* kxm,
                            const float* kyp, const float* kym,
                            const float* kzp, const float* kzm,
                            const float* irc, const float* perf,
                            const float* q, float t_art, int n1, int n2,
                            int n3, void* stream) {
  const long long total = (long long)n1 * n2 * n3;
  const unsigned int nb = (unsigned int)((total + kThreads - 1) / kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  if (q != nullptr) {
    bhte_step_kernel<true><<<nb, kThreads, 0, st>>>(
        T, T_out, dose, peak, kxp, kxm, kyp, kym, kzp, kzm, irc, perf, q,
        t_art, n1, n2, n3);
  } else {
    bhte_step_kernel<false><<<nb, kThreads, 0, st>>>(
        T, T_out, dose, peak, kxp, kxm, kyp, kym, kzp, kzm, irc, perf, q,
        t_art, n1, n2, n3);
  }
  return (int)cudaGetLastError();
}

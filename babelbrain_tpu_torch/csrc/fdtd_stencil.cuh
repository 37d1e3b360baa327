// Stencil helpers shared by the FDTD kernels (fdtd_fluid.cu, fdtd_visco.cu):
// the 4th-order staggered differences and the CPML slab correction, in the
// operation order of the plain PyTorch versions (ops/fdtd_kernels.py d_plus,
// d_minus, _cpml).
#pragma once

namespace bb {

constexpr float kC1 = 1.125f;                 // 9/8
constexpr float kC2 = -0.041666666666666664f;  // -1/24
constexpr int kThreads = 256;

// CPML correction of derivative d at slab position pos along an axis of n
// cells: psi' = b psi + a d; d += psi'. The lo slab is applied before the
// hi slab (they meet only when n < 2 ns), matching the XLA order.
// prof holds [b_lo, a_lo, b_hi, a_hi] x ns for this axis; the psi value of
// slab plane q for this cell sits at base + q * stride.
__device__ __forceinline__ float cpml(float d, int pos, int n, int ns,
                                      const float* __restrict__ prof,
                                      float* __restrict__ psi_lo,
                                      float* __restrict__ psi_hi,
                                      long long base, long long stride) {
  if (pos < ns) {
    const long long s = base + pos * stride;
    const float nw = prof[pos] * psi_lo[s] + prof[ns + pos] * d;
    psi_lo[s] = nw;
    d = d + nw;
  }
  const int q = pos - (n - ns);
  if (q >= 0) {
    const long long s = base + q * stride;
    const float nw = prof[2 * ns + q] * psi_hi[s] + prof[3 * ns + q] * d;
    psi_hi[s] = nw;
    d = d + nw;
  }
  return d;
}

// forward 4th-order staggered difference at i+1/2, zero outside [0, n)
__device__ __forceinline__ float d_plus(const float* __restrict__ f,
                                        long long c, int pos, int n,
                                        long long stride, float fc) {
  const float f1 = (pos + 1 < n) ? f[c + stride] : 0.0f;
  const float f2 = (pos + 2 < n) ? f[c + 2 * stride] : 0.0f;
  const float fm = (pos >= 1) ? f[c - stride] : 0.0f;
  return kC1 * (f1 - fc) + kC2 * (f2 - fm);
}

// backward 4th-order staggered difference at i, zero outside [0, n)
__device__ __forceinline__ float d_minus(const float* __restrict__ f,
                                         long long c, int pos, int n,
                                         long long stride, float fc) {
  const float fm1 = (pos >= 1) ? f[c - stride] : 0.0f;
  const float fm2 = (pos >= 2) ? f[c - 2 * stride] : 0.0f;
  const float f1 = (pos + 1 < n) ? f[c + stride] : 0.0f;
  return kC1 * (fc - fm1) + kC2 * (f1 - fm2);
}

inline unsigned int n_blocks(int n1, int n2, int n3) {
  const long long total = (long long)n1 * n2 * n3;
  return (unsigned int)((total + kThreads - 1) / kThreads);
}

}  // namespace bb

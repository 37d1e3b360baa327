// FDTD diagnostics for NVIDIA Hopper (sm_90a): the RMS / peak maps, in
// either FDTD family. (The pressure series at monitor voxels and the raw
// capture are taken by the pressure / stress kernels themselves: their
// MONITOR instantiations, fdtd_fluid.cu / fdtd_visco.cu and Monitor in
// fdtd_stencil.cuh.)
//
// Replaces no TPU kernel: it computes what the JAX package's XLA path
// serves (babelbrain_tpu/ops/fdtd.py _update_extras), the 14 maps
// <Field>_rms / <Field>_peak over Pressure, Vx, Vy, Vz, Sigmaxx, Sigmayy,
// Sigmazz in fluid and viscoelastic media, after each step a run takes on
// the pair: the 14-map runs, the viscoelastic ones, and the tail steps of a
// fluid run whose window goes through the fused sweep. B4's own with_p2
// accumulator (build_fluid_fusedK_step, babelbrain_tpu/ops/fdtd_pallas.py
// :2288-2303) is ported inside that sweep (fdtd_fluid_fused.cu, EXTRAS),
// which rounds p^2 as this pass does.
//
// extras_accumulate_kernel<VISCO>: one pass after the pressure / stress
// kernel at each step of the sensor window. A bitmask says which of the 14
// accumulators are held (bit 2f: <Field f>_rms, bit 2f+1: <Field f>_peak);
// rms adds v*v, peak keeps fmaxf(acc, |v|) (the convention of the DFT peak in
// fdtd_fluid.cu). Fluid reads p, vx, vy, vz (Sigma_ii = -p); visco reads sxx,
// syy, szz, vx, vy, vz, with Pressure = -(sxx+syy+szz) * (float)(1/3) in the
// operation order of visco_stress_kernel.
//
// What bounds it on this card: device-memory traffic. The pass reads the
// fields it needs and reads and writes each held accumulator: with all 14
// maps a fluid cell moves 16 B of fields and 8 accumulators (the
// wrapper holds one accumulator for Pressure and the three Sigma maps of a
// fluid run, which are equal bit for bit), 80 B; a visco cell 24 B of fields
// and 14 accumulators, 136 B. One FLOP or so per 4 bytes: far below the
// card's balance. The design: one thread per cell, threadIdx.x along z (the
// contiguous axis), so every stream is read and written in 128-byte lines;
// the mask branch is uniform across the grid. Fusing the pass into the
// pair's pressure / stress kernel saves the re-read of the fields and is
// later perf work.
//
// Rounding: built with --fmad=false and written in the operation order of
// the plain PyTorch version (ops/fdtd_extras.py extras_accumulate_ref), so
// kernel and plain version round alike.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kThird = (float)(1.0 / 3.0);
constexpr int kFields = 7;  // Pressure, Vx, Vy, Vz, Sigmaxx, Sigmayy, Sigmazz

// fluid: p, vx, vy, vz (the last two unused); visco: sxx, syy, szz, vx, vy, vz
struct Fields { const float* f[6]; };
// the 14 accumulators in sel_maps order; null where not held
struct Accs { float* a[2 * kFields]; };

template <bool VISCO>
__device__ __forceinline__ float pressure_at(const Fields& F, long long c) {
  if (VISCO) return -(F.f[0][c] + F.f[1][c] + F.f[2][c]) * kThird;
  return F.f[0][c];
}

// value of field f (Pressure, Vx, Vy, Vz, Sigmaxx, Sigmayy, Sigmazz) at c
template <bool VISCO>
__device__ __forceinline__ float field_at(const Fields& F, int f,
                                          long long c) {
  if (f == 0) return pressure_at<VISCO>(F, c);
  if (f < 4) return F.f[VISCO ? f + 2 : f][c];
  return VISCO ? F.f[f - 4][c] : -F.f[0][c];
}

template <bool VISCO>
__global__ void extras_accumulate_kernel(Fields F, Accs A, int mask,
                                         long long n) {
  const long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (c >= n) return;
#pragma unroll
  for (int f = 0; f < kFields; ++f) {
    if (!(mask & (3 << (2 * f)))) continue;
    const float v = field_at<VISCO>(F, f, c);
    if (mask & (1 << (2 * f))) {
      float* acc = A.a[2 * f];
      acc[c] = acc[c] + v * v;
    }
    if (mask & (2 << (2 * f))) {
      float* acc = A.a[2 * f + 1];
      acc[c] = fmaxf(acc[c], fabsf(v));
    }
  }
}

Fields fields_of(const float* const* host) {
  Fields F;
  for (int a = 0; a < 6; ++a) F.f[a] = host[a];
  return F;
}

}  // namespace

extern "C" {

// fields: host array of 6 device pointers (see Fields); accs: host array of
// 14 device pointers (see Accs); mask: the held accumulators; n: cells
int bb_extras_accumulate(const float* const* fields, float* const* accs,
                         int mask, int visco, long long n, void* stream) {
  Accs A;
  for (int a = 0; a < 2 * kFields; ++a) A.a[a] = accs[a];
  const unsigned int nb = (unsigned int)((n + kThreads - 1) / kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  if (visco) {
    extras_accumulate_kernel<true><<<nb, kThreads, 0, st>>>(
        fields_of(fields), A, mask, n);
  } else {
    extras_accumulate_kernel<false><<<nb, kThreads, 0, st>>>(
        fields_of(fields), A, mask, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

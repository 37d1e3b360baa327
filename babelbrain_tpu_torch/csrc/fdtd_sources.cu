// Volumetric velocity source (dome transducers) for NVIDIA Hopper (sm_90a).
//
// Replaces (TPU kernels of the JAX package, babelbrain_tpu/ops/fdtd_pallas.py):
//   the in-kernel volumetric drive of build_fluid_fused_step (B2: its six
//   (N1, N2, N3) source operands), build_fluid_fusedK_step (B4),
//   build_visco_fused_step (B6) and build_visco_fusedK_step (B8). The math is
//   the velocity_volume branch of babelbrain_tpu/ops/fdtd.py (_make_step_fn,
//   _make_fluid_step_fn): after the velocity update, where amp > 0,
//     v_i = amp sin(wt + phase) ramp oz o_i
//         = amp (s_sin cos(phase) + s_cos sin(phase)) o_i,
//   with s_sin / s_cos = sin(wt) / cos(wt) times the ramp and oz.
//
// What bounds it on this card: device-memory traffic, and it is small. The
// TPU kernels stream the drive as six dense volumes, six extra reads per
// cell and step (+75% over the fluid velocity kernel's 8). A dome lights up
// ~0.2% of the voxels, so here the drive is a sparse list of its S source
// voxels: one thread per voxel reads its int32 linear index and six floats
// (contiguous, coalesced) and SETS the three velocities at that voxel (three
// scattered 4-byte writes, one 32-byte sector each). It is launched between
// the velocity kernel and the pressure/stress kernel of either family, the
// order of the XLA step.
//
// Rounding: built with --fmad=false and written in the operation order of
// the plain PyTorch version (ops/fdtd_sources.py velocity_volume_source_ref),
// so kernel and plain version round alike.

#include <cuda_runtime.h>

namespace {

constexpr int kSourceThreads = 256;

__global__ void velocity_volume_source_kernel(
    const int* __restrict__ lin, const float* __restrict__ amp,
    const float* __restrict__ cph, const float* __restrict__ sph,
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, float* __restrict__ vx,
    float* __restrict__ vy, float* __restrict__ vz, float s_sin,
    float s_cos, int n_src) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n_src) return;
  const long long c = lin[q];
  const float sv = amp[q] * (s_sin * cph[q] + s_cos * sph[q]);
  vx[c] = sv * ox[q];
  vy[c] = sv * oy[q];
  vz[c] = sv * oz[q];
}

}  // namespace

extern "C" {

int bb_velocity_volume_source(const int* lin, const float* amp,
                              const float* cph, const float* sph,
                              const float* ox, const float* oy,
                              const float* oz, float* vx, float* vy,
                              float* vz, float s_sin, float s_cos, int n_src,
                              void* stream) {
  const unsigned int nb = (n_src + kSourceThreads - 1) / kSourceThreads;
  velocity_volume_source_kernel<<<nb, kSourceThreads, 0,
                                  (cudaStream_t)stream>>>(
      lin, amp, cph, sph, ox, oy, oz, vx, vy, vz, s_sin, s_cos, n_src);
  return (int)cudaGetLastError();
}

}  // extern "C"

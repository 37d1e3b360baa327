// Fluid (shear-free) FDTD leapfrog step for NVIDIA Hopper (sm_90a).
//
// Replaces (TPU kernels of the JAX package):
//   babelbrain_tpu/ops/fdtd_pallas.py build_fluid_pallas_step: vel_kernel
//   and press_kernel (B1), and the velocity / pressure stages of
//   build_fluid_fused2_step (B3) and build_fluid_fusedK_step (B4). B3 and
//   B4 only block B1's update in time; K fused TPU steps are K launches of
//   this pair here.
//
// What bounds it on this card: device-memory traffic. Per cell and step the
// velocity kernel reads p (+4 neighbours, mostly cache hits), rho_inv and the
// three velocities and writes the velocities; the pressure kernel reads the
// velocities (+ neighbours), p, r and three property volumes and writes p
// and r, plus the DFT accumulators and the peak in the sensor window. That is
// about 12 float volumes (quiet step) to 18 (window step) per step against a
// handful of flops per byte: far below the card's flop/byte balance.
//
// What the design does about it: one thread per cell, threadIdx.x along z
// (the contiguous axis) so every warp reads and writes contiguous 128-byte
// lines; neighbours come from global memory and the x/y neighbour planes of
// a block are shared with nearby blocks through L1/L2. State is updated in
// place (no second copy of any volume). The CPML psi memory lives only in
// the boundary slabs (ns = npml + 2 planes per side and axis), as in the XLA
// layout, so its traffic is O(npml / N). The quiet variant (before the DFT
// window opens) skips the accumulator streams. Temporal blocking, shared-
// memory tiling and TMA are later work.
//
// Point source (refocusing): POINT=true SUBTRACTS sval from the new pressure
// of the one cell c == pt before the DFT and the peak read it, the XLA order
// of babelbrain_tpu/ops/fdtd.py:_make_fluid_step_fn (pressure update ->
// injection -> DFT). It replaces the in-kernel injection of B2/B4
// (build_fluid_fused_step, build_fluid_fusedK_step) and the post-kernel
// amendment of the DFT sums (_fluid_point_post), which the TPU needs only
// because its accumulators leave the kernel before the injection.
// POINT=false compiles to the plane-source code.
//
// Rounding: built with --fmad=false and written in the operation order of
// the plain PyTorch versions (ops/fdtd_kernels.py fluid_velocity_ref /
// fluid_pressure_ref), so kernel and plain version round alike.

#include <cuda_runtime.h>

#include "fdtd_stencil.cuh"

namespace {

using bb::cpml;
using bb::d_minus;
using bb::d_plus;
using bb::kThreads;
using bb::n_blocks;

__global__ void fluid_velocity_kernel(
    const float* __restrict__ p, float* __restrict__ vx,
    float* __restrict__ vy, float* __restrict__ vz,
    const float* __restrict__ rho_inv,
    float* __restrict__ psx_lo, float* __restrict__ psx_hi,
    float* __restrict__ psy_lo, float* __restrict__ psy_hi,
    float* __restrict__ psz_lo, float* __restrict__ psz_hi,
    const float* __restrict__ prof,  // (3, 4, ns) "half" profiles
    const float* __restrict__ amp, const float* __restrict__ cph,
    const float* __restrict__ sph,  // (n1, n2) source planes
    float s_sin, float s_cos, float dt_dx,
    int n1, int n2, int n3, int ns, int zsrc) {
  const long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long sx = (long long)n2 * n3;
  if (c >= sx * n1) return;
  const int k = (int)(c % n3);
  const long long ij = c / n3;
  const int j = (int)(ij % n2);
  const int i = (int)(ij / n2);

  const float pc = p[c];
  float dx = d_plus(p, c, i, n1, sx, pc);
  float dy = d_plus(p, c, j, n2, n3, pc);
  float dz = d_plus(p, c, k, n3, 1, pc);
  dx = cpml(dx, i, n1, ns, prof, psx_lo, psx_hi, (long long)j * n3 + k, sx);
  dy = cpml(dy, j, n2, ns, prof + 4 * ns, psy_lo, psy_hi,
            (long long)i * ns * n3 + k, n3);
  dz = cpml(dz, k, n3, ns, prof + 8 * ns, psz_lo, psz_hi, ij * ns, 1);

  const float ri = rho_inv[c];
  vx[c] = vx[c] - dt_dx * ri * dx;
  vy[c] = vy[c] - dt_dx * ri * dy;
  float vzn = vz[c] - dt_dx * ri * dz;
  if (k == zsrc) {
    // CW plane source SETS vz where the plane amplitude is positive:
    // amp sin(wt + phase) ramp oz = amp (sin(wt) cos(ph) + cos(wt) sin(ph))
    const float a = amp[ij];
    if (a > 0.0f) vzn = a * (s_sin * cph[ij] + s_cos * sph[ij]);
  }
  vz[c] = vzn;
}

template <bool VISCOUS, bool WITH_DFT, bool POINT>
__global__ void fluid_pressure_kernel(
    const float* __restrict__ vx, const float* __restrict__ vy,
    const float* __restrict__ vz, float* __restrict__ p,
    float* __restrict__ r, const float* __restrict__ pi_u,
    const float* __restrict__ c_rp, const float* __restrict__ b_r,
    float* __restrict__ acc_c, float* __restrict__ acc_s,
    float* __restrict__ peak,
    float* __restrict__ psx_lo, float* __restrict__ psx_hi,
    float* __restrict__ psy_lo, float* __restrict__ psy_hi,
    float* __restrict__ psz_lo, float* __restrict__ psz_hi,
    const float* __restrict__ prof,  // (3, 4, ns) "int" profiles
    float dt_dx, float inv_dx, float half_dt, float cosw, float sinw,
    int n1, int n2, int n3, int ns, long long pt, float sval) {
  const long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long sx = (long long)n2 * n3;
  if (c >= sx * n1) return;
  const int k = (int)(c % n3);
  const long long ij = c / n3;
  const int j = (int)(ij % n2);
  const int i = (int)(ij / n2);

  float dvx = d_minus(vx, c, i, n1, sx, vx[c]);
  float dvy = d_minus(vy, c, j, n2, n3, vy[c]);
  float dvz = d_minus(vz, c, k, n3, 1, vz[c]);
  dvx = cpml(dvx, i, n1, ns, prof, psx_lo, psx_hi, (long long)j * n3 + k, sx);
  dvy = cpml(dvy, j, n2, ns, prof + 4 * ns, psy_lo, psy_hi,
             (long long)i * ns * n3 + k, n3);
  dvz = cpml(dvz, k, n3, ns, prof + 8 * ns, psz_lo, psz_hi, ij * ns, 1);
  const float theta = dvx + dvy + dvz;

  float pn;
  if (VISCOUS) {
    const float ro = r[c];
    const float rn = b_r[c] * ro - c_rp[c] * theta * inv_dx;
    pn = p[c] - dt_dx * pi_u[c] * theta - half_dt * (rn + ro);
    r[c] = rn;
  } else {
    pn = p[c] - dt_dx * pi_u[c] * theta;
  }
  if (POINT && c == pt) pn = pn - sval;
  p[c] = pn;
  if (WITH_DFT) {
    acc_c[c] = acc_c[c] + pn * cosw;
    acc_s[c] = acc_s[c] + pn * sinw;
    peak[c] = fmaxf(peak[c], fabsf(pn));
  }
}

}  // namespace

extern "C" {

int bb_fluid_velocity(const float* p, float* vx, float* vy, float* vz,
                      const float* rho_inv, float* psx_lo, float* psx_hi,
                      float* psy_lo, float* psy_hi, float* psz_lo,
                      float* psz_hi, const float* prof, const float* amp,
                      const float* cph, const float* sph, float s_sin,
                      float s_cos, float dt_dx, int n1, int n2, int n3,
                      int ns, int zsrc, void* stream) {
  fluid_velocity_kernel<<<n_blocks(n1, n2, n3), kThreads, 0,
                          (cudaStream_t)stream>>>(
      p, vx, vy, vz, rho_inv, psx_lo, psx_hi, psy_lo, psy_hi, psz_lo,
      psz_hi, prof, amp, cph, sph, s_sin, s_cos, dt_dx, n1, n2, n3, ns,
      zsrc);
  return (int)cudaGetLastError();
}

int bb_fluid_pressure(const float* vx, const float* vy, const float* vz,
                      float* p, float* r, const float* pi_u,
                      const float* c_rp, const float* b_r, float* acc_c,
                      float* acc_s, float* peak, float* psx_lo,
                      float* psx_hi, float* psy_lo, float* psy_hi,
                      float* psz_lo, float* psz_hi, const float* prof,
                      float dt_dx, float inv_dx, float half_dt, float cosw,
                      float sinw, int n1, int n2, int n3, int ns,
                      int viscous, int with_dft, int point, long long pt,
                      float sval, void* stream) {
  const unsigned int nb = n_blocks(n1, n2, n3);
  cudaStream_t st = (cudaStream_t)stream;
#define BB_PRESSURE_ARGS                                                   \
  vx, vy, vz, p, r, pi_u, c_rp, b_r, acc_c, acc_s, peak, psx_lo, psx_hi,  \
      psy_lo, psy_hi, psz_lo, psz_hi, prof, dt_dx, inv_dx, half_dt, cosw, \
      sinw, n1, n2, n3, ns, pt, sval
#define BB_GO(V, D, P) \
  fluid_pressure_kernel<V, D, P><<<nb, kThreads, 0, st>>>(BB_PRESSURE_ARGS)
#define BB_GO_POINT(V, D) \
  if (point) BB_GO(V, D, true); else BB_GO(V, D, false)
  if (viscous && with_dft) {
    BB_GO_POINT(true, true);
  } else if (viscous) {
    BB_GO_POINT(true, false);
  } else if (with_dft) {
    BB_GO_POINT(false, true);
  } else {
    BB_GO_POINT(false, false);
  }
#undef BB_GO_POINT
#undef BB_GO
#undef BB_PRESSURE_ARGS
  return (int)cudaGetLastError();
}

}  // extern "C"

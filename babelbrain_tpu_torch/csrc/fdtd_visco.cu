// Viscoelastic (shear) FDTD leapfrog step for NVIDIA Hopper (sm_90a), with
// indexed materials: label mode, where the skull carries shear waves.
//
// Replaces (TPU kernels of the JAX package, babelbrain_tpu/ops/fdtd_pallas.py):
//   build_visco_pallas_step (B5: vel_kernel, stress_kernel), and the one-step
//   update of build_visco_fused_step (B6, plane source), build_visco_fused2_step
//   (B7) and build_visco_fusedK_step (B8, with its int32 index + coefficient
//   table gather). B6-B8 only block B5's update in time; K fused TPU steps are
//   K launches of this pair here. The math is the XLA step of
//   babelbrain_tpu/ops/fdtd.py:_make_step_fn.
//
// What bounds it on this card: device-memory traffic. Per cell and step,
// counted from the code and leaving out the CPML psi slabs: the velocity
// kernel reads 6 stresses, 3 velocities and the material index and writes 3
// velocities (13 float-sized volumes); the stress kernel reads 3 velocities,
// 6 stresses, 6 SLS memories and the index and writes 6 stresses and 6
// memories (28), plus 3 reads and 3 writes of the DFT accumulators and the
// peak inside the sensor window (34). A few flops per byte: far below the
// card's flop/byte balance.
//
// What the design does about it: one thread per cell, threadIdx.x along z
// (the contiguous axis), so every warp reads and writes contiguous 128-byte
// lines; stencil neighbours come from global memory through L1/L2. The five
// material property volumes of the XLA layout are replaced by one int32
// index volume and a (6, M) table that each block copies into shared memory:
// neighbouring voxels hit different rows, which constant memory would
// serialise, while a shared-memory gather is one conflict-free read for
// label mode's few materials. State is updated in place; the CPML psi
// memory lives only in the boundary slabs (ns = npml + 2 planes per side and
// axis), in the XLA layout. Shared-memory tiling and temporal blocking are
// later work.
//
// Point source (refocusing): the stress kernel's POINT=true ADDS sval to
// sxx, syy and szz of the one cell c == pt after their update and before
// p = -(sxx+syy+szz)/3 feeds the DFT and the peak, the XLA order of
// babelbrain_tpu/ops/fdtd.py:_make_step_fn. It replaces the in-kernel point
// injection of B6/B8 (build_visco_fused_step, build_visco_fusedK_step).
// POINT=false compiles to the plane-source code.
//
// Rounding: built with --fmad=false and written in the operation order of
// the plain PyTorch versions (ops/fdtd_visco_kernels.py visco_velocity_ref /
// visco_stress_ref), so kernel and plain version round alike.

#include <cuda_runtime.h>

#include "fdtd_stencil.cuh"

namespace {

using bb::kThreads;
using bb::n_blocks;

constexpr float kThird = (float)(1.0 / 3.0);

struct Ptr3 { float* p[3]; };
struct Ptr6 { float* p[6]; };
struct Ptr18 { float* p[18]; };  // 9 CPML'd derivatives: [lo, hi] each

struct Cell {
  long long c, ij, sx;
  int i, j, k;
};

struct Geo {
  int n1, n2, n3, ns;
};

__device__ __forceinline__ bool locate(Cell& q, const Geo& g) {
  q.c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  q.sx = (long long)g.n2 * g.n3;
  if (q.c >= q.sx * g.n1) return false;
  q.k = (int)(q.c % g.n3);
  q.ij = q.c / g.n3;
  q.j = (int)(q.ij % g.n2);
  q.i = (int)(q.ij / g.n2);
  return true;
}

// CPML'd 4th-order staggered derivative of f along AXIS: forward (d_plus,
// "half" profiles) or backward (d_minus, "int" profiles); fc = f[c]
template <int AXIS, bool PLUS>
__device__ __forceinline__ float deriv(const float* __restrict__ f, float fc,
                                       const Cell& q, const Geo& g,
                                       const float* __restrict__ prof_half,
                                       const float* __restrict__ prof_int,
                                       float* __restrict__ lo,
                                       float* __restrict__ hi) {
  const float* prof = (PLUS ? prof_half : prof_int) + AXIS * 4 * g.ns;
  if constexpr (AXIS == 0) {
    const float d = PLUS ? bb::d_plus(f, q.c, q.i, g.n1, q.sx, fc)
                         : bb::d_minus(f, q.c, q.i, g.n1, q.sx, fc);
    return bb::cpml(d, q.i, g.n1, g.ns, prof, lo, hi,
                    (long long)q.j * g.n3 + q.k, q.sx);
  } else if constexpr (AXIS == 1) {
    const float d = PLUS ? bb::d_plus(f, q.c, q.j, g.n2, g.n3, fc)
                         : bb::d_minus(f, q.c, q.j, g.n2, g.n3, fc);
    return bb::cpml(d, q.j, g.n2, g.ns, prof, lo, hi,
                    (long long)q.i * g.ns * g.n3 + q.k, g.n3);
  } else {
    const float d = PLUS ? bb::d_plus(f, q.c, q.k, g.n3, 1, fc)
                         : bb::d_minus(f, q.c, q.k, g.n3, 1, fc);
    return bb::cpml(d, q.k, g.n3, g.ns, prof, lo, hi, q.ij * g.ns, 1);
  }
}

// CPML'd derivative number Q of the kernel's psi list (both kernels name
// their locals q, g, prof_half, prof_int and psi)
#define BB_D(AX, PL, F, FC, Q) \
  deriv<AX, PL>(F, FC, q, g, prof_half, prof_int, psi.p[2 * (Q)], psi.p[2 * (Q) + 1])

// v_i += dt/dx rho_inv (sum_j D sigma_ij); then the CW plane source SETS vz
// at zsrc where the plane amplitude is positive.
// s: [sxx, syy, szz, sxy, sxz, syz]; v: [vx, vy, vz]; psi: the derivatives
// sxx_x, sxy_y, sxz_z, sxy_x, syy_y, syz_z, sxz_x, syz_y, szz_z.
__global__ void visco_velocity_kernel(
    Ptr6 s, Ptr3 v, const int* __restrict__ idx,
    const float* __restrict__ rho_inv_row, int n_mat, Ptr18 psi,
    const float* __restrict__ prof_half, const float* __restrict__ prof_int,
    const float* __restrict__ amp, const float* __restrict__ cph,
    const float* __restrict__ sph, float s_sin, float s_cos, float dt_dx,
    Geo g, int zsrc) {
  extern __shared__ float tab[];  // rho_inv of every material
  for (int m = threadIdx.x; m < n_mat; m += blockDim.x) tab[m] = rho_inv_row[m];
  __syncthreads();
  Cell q;
  if (!locate(q, g)) return;
  const float* sxx = s.p[0];
  const float* syy = s.p[1];
  const float* szz = s.p[2];
  const float* sxy = s.p[3];
  const float* sxz = s.p[4];
  const float* syz = s.p[5];
  const long long c = q.c;
  const float ri = tab[idx[c]];
  const float sxy_c = sxy[c], sxz_c = sxz[c], syz_c = syz[c];
  const float dsxx_x = BB_D(0, true, sxx, sxx[c], 0);
  const float dsxy_y = BB_D(1, false, sxy, sxy_c, 1);
  const float dsxz_z = BB_D(2, false, sxz, sxz_c, 2);
  v.p[0][c] = v.p[0][c] + dt_dx * ri * (dsxx_x + dsxy_y + dsxz_z);
  const float dsxy_x = BB_D(0, false, sxy, sxy_c, 3);
  const float dsyy_y = BB_D(1, true, syy, syy[c], 4);
  const float dsyz_z = BB_D(2, false, syz, syz_c, 5);
  v.p[1][c] = v.p[1][c] + dt_dx * ri * (dsxy_x + dsyy_y + dsyz_z);
  const float dsxz_x = BB_D(0, false, sxz, sxz_c, 6);
  const float dsyz_y = BB_D(1, false, syz, syz_c, 7);
  const float dszz_z = BB_D(2, true, szz, szz[c], 8);
  float vzn = v.p[2][c] + dt_dx * ri * (dsxz_x + dsyz_y + dszz_z);
  if (q.k == zsrc) {
    // amp sin(wt + phase) ramp oz = amp (sin(wt) cos(ph) + cos(wt) sin(ph))
    const float a = amp[q.ij];
    if (a > 0.0f) vzn = a * (s_sin * cph[q.ij] + s_cos * sph[q.ij]);
  }
  v.p[2][c] = vzn;
}

// Six stresses and six SLS memories from the CPML'd velocity derivatives;
// with POINT the point source added to the normal stresses of cell pt; with
// WITH_DFT the carrier DFT and |p| peak of p = -(sxx+syy+szz)/3.
// v: [vx, vy, vz]; s, r: [xx, yy, zz, xy, xz, yz]; table rows
// [rho_inv, pi_u, mu_u, c_rp, c_rs, b_r] x n_mat; psi: the derivatives
// vx_x, vy_y, vz_z, vx_y, vy_x, vx_z, vz_x, vy_z, vz_y.
template <bool VISCOUS, bool WITH_DFT, bool POINT>
__global__ void visco_stress_kernel(
    Ptr3 v, Ptr6 s, Ptr6 r, const int* __restrict__ idx,
    const float* __restrict__ table, int n_mat, float* __restrict__ acc_c,
    float* __restrict__ acc_s, float* __restrict__ peak, Ptr18 psi,
    const float* __restrict__ prof_half, const float* __restrict__ prof_int,
    float dt_dx, float inv_dx, float half_dt, float cosw, float sinw, Geo g,
    long long pt, float sval) {
  extern __shared__ float tab[];  // rows pi_u, mu_u, c_rp, c_rs, b_r
  for (int m = threadIdx.x; m < 5 * n_mat; m += blockDim.x) {
    tab[m] = table[n_mat + m];
  }
  __syncthreads();
  Cell q;
  if (!locate(q, g)) return;
  const float* vx = v.p[0];
  const float* vy = v.p[1];
  const float* vz = v.p[2];
  const long long c = q.c;
  const int mi = idx[c];
  const float pi_u = tab[mi];
  const float mu_u = tab[n_mat + mi];
  const float c_rp = tab[2 * n_mat + mi];
  const float c_rs = tab[3 * n_mat + mi];
  const float b_r = tab[4 * n_mat + mi];
  const float vx_c = vx[c], vy_c = vy[c], vz_c = vz[c];

  const float dvx_x = BB_D(0, false, vx, vx_c, 0);
  const float dvy_y = BB_D(1, false, vy, vy_c, 1);
  const float dvz_z = BB_D(2, false, vz, vz_c, 2);
  const float theta = dvx_x + dvy_y + dvz_z;
  const float dii[3] = {dvx_x, dvy_y, dvz_z};
  float sn[6];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float so = s.p[a][c];
    const float el = pi_u * theta - 2.0f * mu_u * (theta - dii[a]);
    if (VISCOUS) {
      const float ro = r.p[a][c];
      const float phi = c_rp * theta - 2.0f * c_rs * (theta - dii[a]);
      const float rn = b_r * ro - phi * inv_dx;
      sn[a] = so + dt_dx * el + half_dt * (rn + ro);
      r.p[a][c] = rn;
    } else {
      sn[a] = so + dt_dx * el;
    }
    if (POINT && c == pt) sn[a] = sn[a] + sval;
    s.p[a][c] = sn[a];
  }

  const float dvx_y = BB_D(1, true, vx, vx_c, 3);
  const float dvy_x = BB_D(0, true, vy, vy_c, 4);
  const float dvx_z = BB_D(2, true, vx, vx_c, 5);
  const float dvz_x = BB_D(0, true, vz, vz_c, 6);
  const float dvy_z = BB_D(2, true, vy, vy_c, 7);
  const float dvz_y = BB_D(1, true, vz, vz_c, 8);
  const float e[3] = {dvx_y + dvy_x, dvx_z + dvz_x, dvy_z + dvz_y};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float so = s.p[3 + a][c];
    if (VISCOUS) {
      const float ro = r.p[3 + a][c];
      const float rn = b_r * ro - c_rs * e[a] * inv_dx;
      sn[3 + a] = so + dt_dx * mu_u * e[a] + half_dt * (rn + ro);
      r.p[3 + a][c] = rn;
    } else {
      sn[3 + a] = so + dt_dx * mu_u * e[a];
    }
    s.p[3 + a][c] = sn[3 + a];
  }
  if (WITH_DFT) {
    const float p = -(sn[0] + sn[1] + sn[2]) * kThird;
    acc_c[c] = acc_c[c] + p * cosw;
    acc_s[c] = acc_s[c] + p * sinw;
    peak[c] = fmaxf(peak[c], fabsf(p));
  }
}
#undef BB_D

template <int N, typename T>
T gather(float* const* host) {
  T out;
  for (int a = 0; a < N; ++a) out.p[a] = host[a];
  return out;
}

}  // namespace

extern "C" {

// s6, v3, psi18: host arrays of device pointers (see the kernels)
int bb_visco_velocity(float* const* s6, float* const* v3, const int* idx,
                      const float* table, float* const* psi18,
                      const float* prof_half, const float* prof_int,
                      const float* amp, const float* cph, const float* sph,
                      float s_sin, float s_cos, float dt_dx, int n_mat,
                      int n1, int n2, int n3, int ns, int zsrc,
                      void* stream) {
  const Geo g{n1, n2, n3, ns};
  visco_velocity_kernel<<<n_blocks(n1, n2, n3), kThreads,
                          n_mat * sizeof(float), (cudaStream_t)stream>>>(
      gather<6, Ptr6>(s6), gather<3, Ptr3>(v3), idx, table, n_mat,
      gather<18, Ptr18>(psi18), prof_half, prof_int, amp, cph, sph, s_sin,
      s_cos, dt_dx, g, zsrc);
  return (int)cudaGetLastError();
}

int bb_visco_stress(float* const* v3, float* const* s6, float* const* r6,
                    const int* idx, const float* table, float* acc_c,
                    float* acc_s, float* peak, float* const* psi18,
                    const float* prof_half, const float* prof_int,
                    float dt_dx, float inv_dx, float half_dt, float cosw,
                    float sinw, int n_mat, int n1, int n2, int n3, int ns,
                    int viscous, int with_dft, int point, long long pt,
                    float sval, void* stream) {
  const Geo g{n1, n2, n3, ns};
  const unsigned int nb = n_blocks(n1, n2, n3);
  const size_t smem = 5 * n_mat * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
#define BB_STRESS_ARGS                                                     \
  gather<3, Ptr3>(v3), gather<6, Ptr6>(s6), gather<6, Ptr6>(r6), idx,      \
      table, n_mat, acc_c, acc_s, peak, gather<18, Ptr18>(psi18),          \
      prof_half, prof_int, dt_dx, inv_dx, half_dt, cosw, sinw, g, pt, sval
#define BB_GO(V, D, P) \
  visco_stress_kernel<V, D, P><<<nb, kThreads, smem, st>>>(BB_STRESS_ARGS)
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
#undef BB_STRESS_ARGS
  return (int)cudaGetLastError();
}

}  // extern "C"

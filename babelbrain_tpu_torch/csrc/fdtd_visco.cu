// Viscoelastic (shear) FDTD leapfrog step for NVIDIA Hopper (sm_90a), with
// indexed materials: label mode, where the skull carries shear waves.
//
// Replaces (TPU kernels of the JAX package, babelbrain_tpu/ops/fdtd_pallas.py):
//   build_visco_pallas_step (B5: vel_kernel, stress_kernel), and B6-B8's point
//   injection (build_visco_fused_step, build_visco_fusedK_step). B6-B8 block
//   B5's update in time: their K-step sweeps are fdtd_visco_fused.cu (plane
//   and point sources) and fdtd_visco_halo.cu (a volumetric source), whose
//   runs take this pair for their one-step tails; runs with maps or
//   monitors, and sharded runs other than overlap and discard, take it for
//   every step. The math is the XLA step of
//   babelbrain_tpu/ops/fdtd.py:_make_step_fn.
//
// What bounds it on this card: device-memory traffic. Per cell and step,
// counted from the code and leaving out the CPML psi slabs: the velocity
// kernel reads 6 stresses, 3 velocities and the material index and writes 3
// velocities (13 float-sized volumes); the stress kernel reads 3 velocities,
// 6 stresses, 6 SLS memories and the index and writes 6 stresses and 6
// memories (28), plus 3 reads and 3 writes of the DFT accumulators and the
// peak inside the sensor window (34). A few flops per byte: far below the
// card's flop/byte balance. What keeps a kernel from that bound here is
// latency: a cell needs ~30 loads (nine CPML'd 4th-order derivatives), and
// with 64-80 registers a thread (1024 or 768 threads an SM) too few loads
// are in flight to cover the time its cells take to arrive from memory.
//
// What the design does about it (the tile geometry, difference and CPML
// helpers are fdtd_stencil.cuh's, shared with the fluid pair): a block of
// 32 x 8 threads owns a (y, z)
// tile of columns (threadIdx.x along z, so each warp reads and writes 128
// contiguous bytes) and marches along x over a segment of planes [i0, i1);
// the grid is (z-tiles, y-tiles, x-segments), with segments short enough
// that the grid holds several waves of blocks for the 132 SMs (the sizes
// come from ops/fdtd_visco_kernels.py visco_launch_geometry). Each thread
// walks its (j, k) column:
//   - while it computes plane i it prefetches (into L2) its cells of plane
//     i + 1 of every volume it reads, so their trip from memory overlaps the
//     work of a plane;
//   - the fields with x-derivatives keep their x-window (four planes) in
//     registers and load each value once, as it enters the window;
//   - y/z neighbours come through L1 (a block's warps load each other's rows;
//     shared-memory tiles of them, copied with cp.async a plane ahead, were
//     measured slower: PERF.md);
//   - the x-CPML test (i < xlo, i >= xhi: the slabs this launch owns, Geo)
//     is uniform over the block and the y-test over a warp; all indices
//     are 32-bit in-plane offsets plus a plane offset, formed only for
//     planes inside the grid (the wrapper keeps N1 N2 N3 below 2^31): no
//     division.
// __launch_bounds__ caps the registers so that 1024 (velocity) and 768
// (stress) threads fit on an SM without spilling. The material index
// selects a row of the (6, M) table, which each block copies into shared
// memory: neighbouring voxels hit different rows, which constant memory would
// serialise. State is updated in place: the velocity kernel reads only the
// stresses (and its own cell of v and of its psi slabs), the stress kernel
// only the velocities (and its own cells of s, r and psi). The CPML psi
// memory lives only in the boundary slabs (ns = npml + 2 planes per side and
// axis), in the XLA layout.
//
// Point source (refocusing): the stress kernel's POINT=true ADDS sval to
// sxx, syy and szz of the one cell c == pt after their update and before
// p = -(sxx+syy+szz)/3 feeds the DFT and the peak, the XLA order of
// babelbrain_tpu/ops/fdtd.py:_make_step_fn. It replaces the in-kernel point
// injection of B6/B8 (build_visco_fused_step, build_visco_fusedK_step).
// POINT=false compiles to the plane-source code.
//
// (x, y) decomposition: as the fluid pair (fdtd_fluid.cu), a launch
// applies the x and y CPMLs' lo / hi slabs only where its shard holds that
// global edge (x_lo / x_hi / y_lo / y_hi, Geo; the XALL instantiations for
// a whole grid). It replaces the edge_offset and xcoef_scale of B6
// (build_visco_fused_step, fdtd_pallas.py:3439,3491) and B8
// (build_visco_fusedK_step, :4844,4945) and the y masks of the XLA step
// (edge_masks_y, babelbrain_tpu/ops/fdtd.py:523).
//
// Rounding: built with --fmad=false and written in the operation order of
// the plain PyTorch versions (ops/fdtd_visco_kernels.py visco_velocity_ref /
// visco_stress_ref), so kernel and plain version round alike.

#include <cuda_runtime.h>

#include "fdtd_stencil.cuh"

namespace {

using namespace bb;

constexpr float kThird = (float)(1.0 / 3.0);
constexpr int kVelocityMinBlocks = 4;  // 1024 threads an SM: 64 registers
constexpr int kStressMinBlocks = 3;    // 768 threads an SM: 80 registers

// v_i += dt/dx rho_inv (sum_j D sigma_ij); then the CW plane source SETS vz
// at zsrc where the plane amplitude is positive.
// s: [sxx, syy, szz, sxy, sxz, syz]; v: [vx, vy, vz]; psi: the derivatives
// sxx_x, sxy_y, sxz_z, sxy_x, syy_y, syz_z, sxz_x, syz_y, szz_z.
template <bool XALL>
__global__ void __launch_bounds__(kThreads, kVelocityMinBlocks)
    visco_velocity_kernel(Ptr6 s, Ptr3 v, const int* __restrict__ idx,
                          const float* __restrict__ rho_inv_row, int n_mat,
                          Ptr18 psi, const float* __restrict__ prof_half,
                          const float* __restrict__ prof_int,
                          const float* __restrict__ amp,
                          const float* __restrict__ cph,
                          const float* __restrict__ sph, float s_sin,
                          float s_cos, float dt_dx, Geo g, int zsrc) {
  extern __shared__ float tab[];  // rho_inv of every material
  for (int m = threadIdx.y * kTileZ + threadIdx.x; m < n_mat; m += kThreads) {
    tab[m] = rho_inv_row[m];
  }
  __syncthreads();
  Col q;
  if (!column(q, g)) return;
  const float* sxx = s.p[0];
  const float* syy = s.p[1];
  const float* szz = s.p[2];
  const float* sxy = s.p[3];
  const float* sxz = s.p[4];
  const float* syz = s.p[5];
  XWin<-1> wxx;  // sxx: forward along x
  XWin<-2> wxy;  // sxy, sxz: backward along x
  XWin<-2> wxz;
  wxx.start(sxx, q, g.n1);
  wxy.start(sxy, q, g.n1);
  wxz.start(sxz, q, g.n1);
  for (int i = q.i0; i < q.i1; ++i) {
    // the next plane's cells (the windows' next entries) set off now
    prefetch(sxx, i + 3, q, g.n1);
    prefetch(sxy, i + 2, q, g.n1);
    prefetch(sxz, i + 2, q, g.n1);
    prefetch(syy, i + 1, q, g.n1);
    prefetch(szz, i + 1, q, g.n1);
    prefetch(syz, i + 1, q, g.n1);
    prefetch(idx, i + 1, q, g.n1);
#pragma unroll
    for (int m = 0; m < 3; ++m) prefetch(v.p[m], i + 1, q, g.n1);
    wxx.advance(sxx, i, q, g.n1);
    wxy.advance(sxy, i, q, g.n1);
    wxz.advance(sxz, i, q, g.n1);
    const int c = i * q.plane + q.jk;
    const float ri = tab[__ldg(idx + c)];
    // the velocities first: nothing below writes them
    const float vx = v.p[0][c], vy = v.p[1][c], vz = v.p[2][c];
    const auto at = [&](const float* f) {
      return Plane{f, c, q.j, q.k, g.n2, g.n3};
    };
    // every difference before the first psi store, so that all loads of
    // the plane can be in flight together
    const float dsxy_y = diff_yz<1, false>(at(sxy));
    const float dsxz_z = diff_yz<2, false>(at(sxz));
    const float dsyy_y = diff_yz<1, true>(at(syy));
    const float dsyz_z = diff_yz<2, false>(at(syz));
    const float dsyz_y = diff_yz<1, false>(at(syz));
    const float dszz_z = diff_yz<2, true>(at(szz));
    const Cpml<Ptr18, XALL> cp{psi, prof_half, prof_int, g, q, i};
    const float d0 = cp.template apply<0, true, 0>(wxx.diff());
    const float d1 = cp.template apply<1, false, 1>(dsxy_y);
    const float d2 = cp.template apply<2, false, 2>(dsxz_z);
    const float d3 = cp.template apply<0, false, 3>(wxy.diff());
    const float d4 = cp.template apply<1, true, 4>(dsyy_y);
    const float d5 = cp.template apply<2, false, 5>(dsyz_z);
    const float d6 = cp.template apply<0, false, 6>(wxz.diff());
    const float d7 = cp.template apply<1, false, 7>(dsyz_y);
    const float d8 = cp.template apply<2, true, 8>(dszz_z);
    float vzn = vz + dt_dx * ri * (d6 + d7 + d8);
    if (q.k == zsrc) {
      // amp sin(wt + phase) ramp oz = amp (sin(wt) cos(ph) + cos(wt) sin(ph))
      const int ij = i * g.n2 + q.j;
      const float a = __ldg(amp + ij);
      if (a > 0.0f) {
        vzn = a * (s_sin * __ldg(cph + ij) + s_cos * __ldg(sph + ij));
      }
    }
    v.p[0][c] = vx + dt_dx * ri * (d0 + d1 + d2);
    v.p[1][c] = vy + dt_dx * ri * (d3 + d4 + d5);
    v.p[2][c] = vzn;
  }
}

// Six stresses and six SLS memories from the CPML'd velocity derivatives;
// with POINT the point source added to the normal stresses of cell pt; with
// WITH_DFT the carrier DFT and |p| peak of p = -(sxx+syy+szz)/3; with
// MONITOR (kMonitorListed, kMonitorEvery) that p sampled into the series
// row mon.out (Monitor, fdtd_stencil.cuh).
// v: [vx, vy, vz]; s, r: [xx, yy, zz, xy, xz, yz]; table rows
// [rho_inv, pi_u, mu_u, c_rp, c_rs, b_r] x n_mat; psi: the derivatives
// vx_x, vy_y, vz_z, vx_y, vy_x, vx_z, vz_x, vy_z, vz_y.
template <bool VISCOUS, bool WITH_DFT, bool POINT, int MONITOR, bool XALL>
__global__ void __launch_bounds__(kThreads, kStressMinBlocks)
    visco_stress_kernel(Ptr3 v, Ptr6 s, Ptr6 r, const int* __restrict__ idx,
                        const float* __restrict__ table, int n_mat,
                        float* __restrict__ acc_c, float* __restrict__ acc_s,
                        float* __restrict__ peak, Ptr18 psi,
                        const float* __restrict__ prof_half,
                        const float* __restrict__ prof_int, float dt_dx,
                        float inv_dx, float half_dt, float cosw, float sinw,
                        Geo g, int pt, float sval, Monitor mon) {
  extern __shared__ float tab[];  // rows pi_u, mu_u, c_rp, c_rs, b_r
  for (int m = threadIdx.y * kTileZ + threadIdx.x; m < 5 * n_mat;
       m += kThreads) {
    tab[m] = table[n_mat + m];
  }
  __syncthreads();
  Col q;
  if (!column(q, g)) return;
  constexpr bool kListed = MONITOR == kMonitorListed;
  if constexpr (kListed) fetch_range(mon);
  const float* vx = v.p[0];
  const float* vy = v.p[1];
  const float* vz = v.p[2];
  XWin<-2> wvx;  // vx: backward along x
  XWin<-1> wvy;  // vy, vz: forward along x
  XWin<-1> wvz;
  wvx.start(vx, q, g.n1);
  wvy.start(vy, q, g.n1);
  wvz.start(vz, q, g.n1);
  for (int i = q.i0; i < q.i1; ++i) {
    // the next plane's cells (the windows' next entries) set off now
    prefetch(vx, i + 2, q, g.n1);
    prefetch(vy, i + 3, q, g.n1);
    prefetch(vz, i + 3, q, g.n1);
    prefetch(idx, i + 1, q, g.n1);
#pragma unroll
    for (int m = 0; m < 6; ++m) {
      prefetch(s.p[m], i + 1, q, g.n1);
      if (VISCOUS) prefetch(r.p[m], i + 1, q, g.n1);
    }
    if (WITH_DFT) {
      prefetch(acc_c, i + 1, q, g.n1);
      prefetch(acc_s, i + 1, q, g.n1);
      prefetch(peak, i + 1, q, g.n1);
    }
    wvx.advance(vx, i, q, g.n1);
    wvy.advance(vy, i, q, g.n1);
    wvz.advance(vz, i, q, g.n1);
    const int c = i * q.plane + q.jk;
    const int mi = __ldg(idx + c);
    const float pi_u = tab[mi];
    const float mu_u = tab[n_mat + mi];
    const float c_rp = tab[2 * n_mat + mi];
    const float c_rs = tab[3 * n_mat + mi];
    const float b_r = tab[4 * n_mat + mi];
    // every load of the plane before the first store, so that they can be
    // in flight together: the old state, then the differences
    float so[6], ro[6], ac = 0.0f, as = 0.0f, pk = 0.0f;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      so[a] = s.p[a][c];
      if (VISCOUS) ro[a] = r.p[a][c];
    }
    if (WITH_DFT) {
      ac = acc_c[c];
      as = acc_s[c];
      pk = peak[c];
    }
    const auto at = [&](const float* f) {
      return Plane{f, c, q.j, q.k, g.n2, g.n3};
    };
    const float dvy_y = diff_yz<1, false>(at(vy));
    const float dvz_z = diff_yz<2, false>(at(vz));
    const float dvx_y = diff_yz<1, true>(at(vx));
    const float dvx_z = diff_yz<2, true>(at(vx));
    const float dvy_z = diff_yz<2, true>(at(vy));
    const float dvz_y = diff_yz<1, true>(at(vz));
    const Cpml<Ptr18, XALL> cp{psi, prof_half, prof_int, g, q, i};
    const float dii[3] = {cp.template apply<0, false, 0>(wvx.diff()),
                          cp.template apply<1, false, 1>(dvy_y),
                          cp.template apply<2, false, 2>(dvz_z)};
    // shear strains: exy, exz, eyz
    const float e[3] = {cp.template apply<1, true, 3>(dvx_y) +
                            cp.template apply<0, true, 4>(wvy.diff()),
                        cp.template apply<2, true, 5>(dvx_z) +
                            cp.template apply<0, true, 6>(wvz.diff()),
                        cp.template apply<2, true, 7>(dvy_z) +
                            cp.template apply<1, true, 8>(dvz_y)};
    const float theta = dii[0] + dii[1] + dii[2];
    float sn[6];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float el = pi_u * theta - 2.0f * mu_u * (theta - dii[a]);
      if (VISCOUS) {
        const float phi = c_rp * theta - 2.0f * c_rs * (theta - dii[a]);
        const float rn = b_r * ro[a] - phi * inv_dx;
        sn[a] = so[a] + dt_dx * el + half_dt * (rn + ro[a]);
        r.p[a][c] = rn;
      } else {
        sn[a] = so[a] + dt_dx * el;
      }
      if (POINT && c == pt) sn[a] = sn[a] + sval;
      s.p[a][c] = sn[a];
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      if (VISCOUS) {
        const float rn = b_r * ro[3 + a] - c_rs * e[a] * inv_dx;
        sn[3 + a] =
            so[3 + a] + dt_dx * mu_u * e[a] + half_dt * (rn + ro[3 + a]);
        r.p[3 + a][c] = rn;
      } else {
        sn[3 + a] = so[3 + a] + dt_dx * mu_u * e[a];
      }
      s.p[3 + a][c] = sn[3 + a];
    }
    if (WITH_DFT || MONITOR == kMonitorEvery) {
      const float p = -(sn[0] + sn[1] + sn[2]) * kThird;
      if constexpr (MONITOR == kMonitorEvery) mon.out[c] = p;
      if (WITH_DFT) {
        acc_c[c] = ac + p * cosw;
        acc_s[c] = as + p * sinw;
        peak[c] = fmaxf(pk, fabsf(p));
      }
    }
  }
  if constexpr (kListed) {
    // in the operation order of ops/fdtd_extras.py monitor_gather_ref
    copy_listed(mon, min(kTileZ, g.n3 - (int)blockIdx.x * kTileZ),
                [&s](int c) {
      return -(s.p[0][c] + s.p[1][c] + s.p[2][c]) * kThird;
    });
  }
}

}  // namespace

extern "C" {

// s6, v3, psi18: host arrays of device pointers (see the kernels); x_lo,
// x_hi, y_lo, y_hi: whether this launch applies the x / y CPML's lo / hi
// slab (all four for a whole grid, which takes the XALL instantiation; see
// Geo); tile_y, seg and the grid (gz, gy, gx) blocks along
// (z, y, x): the launch geometry (ops/fdtd_visco_kernels.py
// visco_launch_geometry; tile_y must be the compiled 8)
int bb_visco_velocity(float* const* s6, float* const* v3, const int* idx,
                      const float* table, float* const* psi18,
                      const float* prof_half, const float* prof_int,
                      const float* amp, const float* cph, const float* sph,
                      float s_sin, float s_cos, float dt_dx, int n_mat,
                      int n1, int n2, int n3, int ns, int x_lo, int x_hi,
                      int y_lo, int y_hi, int zsrc, int tile_y, int seg,
                      int gz, int gy, int gx, void* stream) {
  const Geo g = make_geo(n1, n2, n3, ns, seg, x_lo, x_hi, y_lo, y_hi);
  dim3 grid;
  if (!launch_grid(g, tile_y, gz, gy, gx, grid)) {
    return (int)cudaErrorInvalidValue;
  }
#define BB_VELOCITY(X)                                                      \
  visco_velocity_kernel<X><<<grid, dim3(kTileZ, kTileY),                  \
                             n_mat * sizeof(float), (cudaStream_t)stream>>>( \
      gather<6, Ptr6>(s6), gather<3, Ptr3>(v3), idx, table, n_mat,        \
      gather<18, Ptr18>(psi18), prof_half, prof_int, amp, cph, sph, s_sin, \
      s_cos, dt_dx, g, zsrc)
  if (x_lo && x_hi && y_lo && y_hi) {
    BB_VELOCITY(true);
  } else {
    BB_VELOCITY(false);
  }
#undef BB_VELOCITY
  return (int)cudaGetLastError();
}

// monitor (kNoMonitor, kMonitorListed, kMonitorEvery): the new pressure
// sampled into mon_out (a series row) at the listed voxels (mon_start,
// mon_cell, mon_slot: see Monitor) or at every voxel
int bb_visco_stress(float* const* v3, float* const* s6, float* const* r6,
                    const int* idx, const float* table, float* acc_c,
                    float* acc_s, float* peak, float* const* psi18,
                    const float* prof_half, const float* prof_int,
                    float dt_dx, float inv_dx, float half_dt, float cosw,
                    float sinw, int n_mat, int n1, int n2, int n3, int ns,
                    int x_lo, int x_hi, int y_lo, int y_hi, int viscous,
                    int with_dft, int point, long long pt, float sval,
                    const int* mon_start, const int* mon_cell,
                    const int* mon_slot, float* mon_out, int monitor,
                    int tile_y, int seg, int gz, int gy, int gx,
                    void* stream) {
  const Geo g = make_geo(n1, n2, n3, ns, seg, x_lo, x_hi, y_lo, y_hi);
  dim3 grid;
  if (!launch_grid(g, tile_y, gz, gy, gx, grid) ||
      !monitor_args_valid(monitor, mon_start, mon_cell, mon_slot, mon_out)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 block(kTileZ, kTileY);
  const size_t smem = 5 * n_mat * sizeof(float);
  const Monitor mon{mon_start, mon_cell, mon_slot, mon_out};
  cudaStream_t st = (cudaStream_t)stream;
#define BB_STRESS_ARGS                                                     \
  gather<3, Ptr3>(v3), gather<6, Ptr6>(s6), gather<6, Ptr6>(r6), idx,      \
      table, n_mat, acc_c, acc_s, peak, gather<18, Ptr18>(psi18),          \
      prof_half, prof_int, dt_dx, inv_dx, half_dt, cosw, sinw, g, (int)pt, \
      sval, mon
#define BB_GO(V, D, P, M)                                                   \
  do {                                                                      \
    if (x_lo && x_hi && y_lo && y_hi) {                                     \
      visco_stress_kernel<V, D, P, M, true>                                 \
          <<<grid, block, smem, st>>>(BB_STRESS_ARGS);                      \
    } else {                                                                \
      visco_stress_kernel<V, D, P, M, false>                                \
          <<<grid, block, smem, st>>>(BB_STRESS_ARGS);                      \
    }                                                                       \
  } while (0)
#define BB_GO_MONITOR(V, D, P)               \
  do {                                       \
    if (monitor == kMonitorListed) {         \
      BB_GO(V, D, P, kMonitorListed);        \
    } else if (monitor == kMonitorEvery) {   \
      BB_GO(V, D, P, kMonitorEvery);         \
    } else {                                 \
      BB_GO(V, D, P, kNoMonitor);            \
    }                                        \
  } while (0)
#define BB_GO_POINT(V, D)          \
  do {                             \
    if (point) {                   \
      BB_GO_MONITOR(V, D, true);   \
    } else {                       \
      BB_GO_MONITOR(V, D, false);  \
    }                              \
  } while (0)
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
#undef BB_GO_MONITOR
#undef BB_GO
#undef BB_STRESS_ARGS
  return (int)cudaGetLastError();
}

}  // extern "C"

// Fluid (shear-free) FDTD leapfrog step for NVIDIA Hopper (sm_90a), with
// indexed materials: CT mode.
//
// Replaces (TPU kernels of the JAX package):
//   babelbrain_tpu/ops/fdtd_pallas.py build_fluid_pallas_step: vel_kernel
//   and press_kernel (B1). The K-step sweeps of build_fluid_fused_step (B2),
//   build_fluid_fused2_step (B3) and build_fluid_fusedK_step (B4) are
//   fdtd_fluid_fused.cu, with this pair's per-cell arithmetic; this pair
//   takes the steps a fused run leaves (the schedule's one-step tail) and
//   every run that keeps it (volumetric sources, maps, monitors, capture).
//   The math is the XLA step of babelbrain_tpu/ops/fdtd.py
//   :_make_fluid_step_fn.
//
// What bounds it on this card: device-memory traffic. Per cell and step,
// counted from the code and leaving out the CPML psi slabs: the velocity
// kernel reads p, the int32 material index and the three velocities and
// writes the velocities (8 float-sized volumes); the pressure kernel reads
// the velocities, the index, p and the SLS memory r and writes p and r (8),
// plus 3 reads and 3 writes of the DFT accumulators and the peak inside the
// sensor window (14). A handful of flops per byte: far below the card's
// flop/byte balance.
//
// What the design does about it (the visco pair's, with the helpers of
// fdtd_stencil.cuh): a block of 32 x 8 threads owns a (y, z) tile of
// columns and marches along x over a segment of two planes (the card's
// choice: PERF.md); the grid is (z-tiles, y-tiles, x-segments) from
// ops/fdtd_kernels.py fluid_launch_geometry. Each thread walks its (j, k)
// column:
//   - its own cells of plane i + 1 (index, velocities or p, r and the
//     accumulators) and the x-window's next entry are loaded into registers
//     while it computes plane i, before any store of plane i: latency
//     rather than bytes held the first version of this design (the visco
//     pair's, with an L2 prefetch of plane i + 1 instead) to 55% of its
//     bound; an L2 prefetch on top of the register loads was measured
//     slower at two-plane segments and is left out;
//   - p (velocity kernel, forward) and vx (pressure kernel, backward) keep
//     their x-window of four planes in registers; y/z neighbours come
//     through L1; read-only fields through __ldg;
//   - 32-bit in-plane offsets plus a plane offset; no division.
// __launch_bounds__ caps the registers at 40 (1536 threads an SM; the
// inviscid pressure kernels 32, with the DFT 48) without spills; 64 (1024
// threads) was slower, 32 spills the viscous DFT variants.
// z-neighbours from warp shuffles instead of L1 loads were slower too.
//
// Materials: the int32 index selects a column of the (6, M) table [rho_inv,
// pi_u, mu_u, c_rp, c_rs, b_r] (reflector twins included), read through
// __ldg (L1): the velocity kernel reads rho_inv, the pressure kernel pi_u
// (and c_rp, b_r when viscous). Any table size the JAX path runs is taken.
// A copy of those rows into shared memory at the start of each block was
// measured slower at every register cap and segment length tried
// (PERF.md): the copy per block and the L1 it takes cost more than the
// gathers from L1 save.
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
// (x, y) decomposition (ops/fdtd.py run_fdtd(mesh=)): a launch on one
// shard's block applies the x and y CPMLs' lo and hi slabs only where the
// shard holds that global edge (x_lo / x_hi / y_lo / y_hi,
// fdtd_stencil.cuh Geo). It replaces the x-CPML shift edge_offset and its
// xcoef_scale mask of B2 (build_fluid_fused_step, fdtd_pallas.py:530,598)
// and B4 (build_fluid_fusedK_step, :1755,1850), and the y masks of the XLA
// step (edge_masks_y, babelbrain_tpu/ops/fdtd.py:792): the TPU's shards
// carry their ghost planes on both sides, so a shard's slab sits at an
// offset and is masked where the shard owns no edge; here the first shard
// along an axis carries no ghost planes below it and the last none above,
// so an edge shard's slab sits at its array's end and four flags say which
// slabs apply. Every kernel is instantiated twice: XALL (all four slabs, at
// the array's ends: a whole grid, or a mesh of one shard) compiles the code
// an unsharded launch ran before, and the shards' twin reads the slabs'
// planes from Geo (xlo, xhi, ylo, yhi). Reading them from Geo in the one
// instantiation cost the viscous pressure kernel 8% at its 40-register cap
// (and 10.7% as two predicates), on an H100 (scripts/ab_fdtd_kernels.py,
// PERF.md).
//
// Rounding: built with --fmad=false and written in the operation order of
// the plain PyTorch versions (ops/fdtd_kernels.py fluid_velocity_ref /
// fluid_pressure_ref), so kernel and plain version round alike.

#include <cuda_runtime.h>

#include "fdtd_stencil.cuh"

namespace {

using namespace bb;

constexpr int kMinBlocks = 6;  // 1536 threads an SM: 40 registers
// the inviscid pressure kernels: without the DFT 2048 threads an SM (32
// registers, no spills; faster than 40), with it 1280 (48: at 40 they
// spill 16 bytes, the viscous ones do not)
constexpr int kMinBlocksInviscid = 8;
constexpr int kMinBlocksInviscidDft = 5;
// the full-capture (kMonitorEvery) instantiations, and the viscous one with
// the DFT and listed monitors: 1280 threads (48 registers; at 40 these
// spilled 80-116 bytes and ran slower on an H100, PERF.md)
constexpr int kMinBlocksMonitor = 5;

// table rows (ops/fdtd.py _build_indexed_materials)
constexpr int kRhoInv = 0, kPiU = 1, kCRp = 3, kBR = 5;

// v_i -= dt/dx rho_inv (D+_i p + psi); then the CW plane source SETS vz at
// zsrc where the plane amplitude is positive.
// v: [vx, vy, vz]; psi: [lo, hi] of the derivatives p_x, p_y, p_z.
template <bool XALL>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    fluid_velocity_kernel(const float* __restrict__ p, Ptr3 v,
                          const int* __restrict__ idx,
                          const float* __restrict__ table, int n_mat,
                          Ptr6 psi, const float* __restrict__ prof_half,
                          const float* __restrict__ amp,
                          const float* __restrict__ cph,
                          const float* __restrict__ sph, float s_sin,
                          float s_cos, float dt_dx, Geo g, int zsrc) {
  Col q;
  if (!column(q, g)) return;
  XWinAhead<-1> wp;  // p: forward along x
  wp.start(p, q, g.n1);
  // this column's own inputs of the next plane, loaded a plane ahead
  int c = q.i0 * q.plane + q.jk;
  int mi_n = __ldg(idx + c);
  float vx_n = v.p[0][c], vy_n = v.p[1][c], vz_n = v.p[2][c];
  for (int i = q.i0; i < q.i1; ++i) {
    c = i * q.plane + q.jk;
    const int mi = mi_n;
    const float vx = vx_n, vy = vy_n, vz = vz_n;
    if (i + 1 < q.i1) {  // every load of plane i + 1 before the stores of i
      const int cn = c + q.plane;
      mi_n = __ldg(idx + cn);
      vx_n = v.p[0][cn];
      vy_n = v.p[1][cn];
      vz_n = v.p[2][cn];
    }
    wp.advance(p, i, q, g.n1);
    const Plane pp{p, c, q.j, q.k, g.n2, g.n3};
    const float dpy = diff_yz<1, true>(pp);
    const float dpz = diff_yz<2, true>(pp);
    const float ri = __ldg(table + kRhoInv * n_mat + mi);
    const Cpml<Ptr6, XALL> cp{psi, prof_half, nullptr, g, q, i};
    const float dx = cp.template apply<0, true, 0>(wp.diff());
    const float dy = cp.template apply<1, true, 1>(dpy);
    const float dz = cp.template apply<2, true, 2>(dpz);
    float vzn = vz - dt_dx * ri * dz;
    if (q.k == zsrc) {
      // amp sin(wt + phase) ramp oz = amp (sin(wt) cos(ph) + cos(wt) sin(ph))
      const int ij = i * g.n2 + q.j;
      const float a = __ldg(amp + ij);
      if (a > 0.0f) {
        vzn = a * (s_sin * __ldg(cph + ij) + s_cos * __ldg(sph + ij));
      }
    }
    v.p[0][c] = vx - dt_dx * ri * dx;
    v.p[1][c] = vy - dt_dx * ri * dy;
    v.p[2][c] = vzn;
  }
}

// the pressure kernel's inputs at one cell of a column, besides the
// velocities: material index, p, r and the accumulators (as used)
struct Own {
  int mi;
  float po, ro, ac, as, pk;
  template <bool VISCOUS, bool WITH_DFT>
  __device__ __forceinline__ void load(int c, const int* __restrict__ idx,
                                       const float* p, const float* r,
                                       const float* acc_c, const float* acc_s,
                                       const float* peak) {
    mi = __ldg(idx + c);
    po = p[c];
    ro = VISCOUS ? r[c] : 0.0f;
    ac = WITH_DFT ? acc_c[c] : 0.0f;
    as = WITH_DFT ? acc_s[c] : 0.0f;
    pk = WITH_DFT ? peak[c] : 0.0f;
  }
};

// theta = sum of the CPML'd D-_i v_i; the SLS memory r (VISCOUS) and
// p -= dt/dx pi_u theta + dt (r' + r)/2; with POINT the point source
// subtracted from p at cell pt; with WITH_DFT the carrier DFT and |p| peak;
// with MONITOR (kMonitorListed, kMonitorEvery) the new p sampled into the
// series row mon.out (Monitor, fdtd_stencil.cuh).
// v: [vx, vy, vz]; psi: [lo, hi] of the derivatives vx_x, vy_y, vz_z.
template <bool VISCOUS, bool WITH_DFT, bool POINT, int MONITOR, bool XALL>
__global__ void __launch_bounds__(
    kThreads, (MONITOR == kMonitorEvery ||
               (MONITOR == kMonitorListed && VISCOUS && WITH_DFT))
                  ? kMinBlocksMonitor
              : VISCOUS  ? kMinBlocks
              : WITH_DFT ? kMinBlocksInviscidDft
                         : kMinBlocksInviscid)
    fluid_pressure_kernel(Ptr3 v, float* __restrict__ p,
                          float* __restrict__ r, const int* __restrict__ idx,
                          const float* __restrict__ table, int n_mat,
                          float* __restrict__ acc_c, float* __restrict__ acc_s,
                          float* __restrict__ peak, Ptr6 psi,
                          const float* __restrict__ prof_int, float dt_dx,
                          float inv_dx, float half_dt, float cosw, float sinw,
                          Geo g, int pt, float sval, Monitor mon) {
  Col q;
  if (!column(q, g)) return;
  constexpr bool kListed = MONITOR == kMonitorListed;
  if constexpr (kListed) fetch_range(mon);
  const float* vx = v.p[0];
  const float* vy = v.p[1];
  const float* vz = v.p[2];
  XWinAhead<-2> wvx;  // vx: backward along x
  wvx.start(vx, q, g.n1);
  // this column's own state of the next plane, loaded a plane ahead
  Own nxt;
  nxt.load<VISCOUS, WITH_DFT>(q.i0 * q.plane + q.jk, idx, p, r, acc_c, acc_s,
                              peak);
  for (int i = q.i0; i < q.i1; ++i) {
    const int c = i * q.plane + q.jk;
    const Own cur = nxt;
    if (i + 1 < q.i1) {  // every load of plane i + 1 before the stores of i
      nxt.load<VISCOUS, WITH_DFT>(c + q.plane, idx, p, r, acc_c, acc_s,
                                  peak);
    }
    wvx.advance(vx, i, q, g.n1);
    const float dvy = diff_yz<1, false>(Plane{vy, c, q.j, q.k, g.n2, g.n3});
    const float dvz = diff_yz<2, false>(Plane{vz, c, q.j, q.k, g.n2, g.n3});
    const int mi = cur.mi;
    const float pi_u = __ldg(table + kPiU * n_mat + mi);
    const Cpml<Ptr6, XALL> cp{psi, nullptr, prof_int, g, q, i};
    const float dx = cp.template apply<0, false, 0>(wvx.diff());
    const float dy = cp.template apply<1, false, 1>(dvy);
    const float dz = cp.template apply<2, false, 2>(dvz);
    const float theta = dx + dy + dz;
    float pn;
    if (VISCOUS) {
      const float c_rp = __ldg(table + kCRp * n_mat + mi);
      const float b_r = __ldg(table + kBR * n_mat + mi);
      const float rn = b_r * cur.ro - c_rp * theta * inv_dx;
      pn = cur.po - dt_dx * pi_u * theta - half_dt * (rn + cur.ro);
      r[c] = rn;
    } else {
      pn = cur.po - dt_dx * pi_u * theta;
    }
    if (POINT && c == pt) pn = pn - sval;
    p[c] = pn;
    if constexpr (MONITOR == kMonitorEvery) mon.out[c] = pn;
    if (WITH_DFT) {
      acc_c[c] = cur.ac + pn * cosw;
      acc_s[c] = cur.as + pn * sinw;
      peak[c] = fmaxf(cur.pk, fabsf(pn));
    }
  }
  if constexpr (kListed) {
    copy_listed(mon, min(kTileZ, g.n3 - (int)blockIdx.x * kTileZ),
                [p](int c) { return p[c]; });
  }
}

}  // namespace

extern "C" {

// v3, psi6: host arrays of device pointers (see the kernels); x_lo, x_hi,
// y_lo, y_hi: whether this launch applies the x / y CPML's lo / hi slab
// (all four for a whole grid, which takes the XALL instantiation; see
// Geo); tile_y, seg and the grid (gz, gy, gx) blocks along
// (z, y, x): the launch geometry (ops/fdtd_kernels.py
// fluid_launch_geometry; tile_y must be the compiled 8)
int bb_fluid_velocity(const float* p, float* const* v3, const int* idx,
                      const float* table, float* const* psi6,
                      const float* prof_half, const float* amp,
                      const float* cph, const float* sph, float s_sin,
                      float s_cos, float dt_dx, int n_mat, int n1, int n2,
                      int n3, int ns, int x_lo, int x_hi, int y_lo,
                      int y_hi, int zsrc,
                      int tile_y, int seg, int gz, int gy, int gx,
                      void* stream) {
  const Geo g = make_geo(n1, n2, n3, ns, seg, x_lo, x_hi, y_lo, y_hi);
  dim3 grid;
  if (!launch_grid(g, tile_y, gz, gy, gx, grid)) {
    return (int)cudaErrorInvalidValue;
  }
#define BB_VELOCITY(X)                                                       \
  fluid_velocity_kernel<X><<<grid, dim3(kTileZ, kTileY), 0,                \
                             (cudaStream_t)stream>>>(                      \
      p, gather<3, Ptr3>(v3), idx, table, n_mat, gather<6, Ptr6>(psi6),    \
      prof_half, amp, cph, sph, s_sin, s_cos, dt_dx, g, zsrc)
  if (x_lo && x_hi && y_lo && y_hi) {
    BB_VELOCITY(true);
  } else {
    BB_VELOCITY(false);
  }
#undef BB_VELOCITY
  return (int)cudaGetLastError();
}

// as bb_fluid_velocity; the table rows pi_u (and c_rp, b_r when viscous);
// monitor (kNoMonitor, kMonitorListed, kMonitorEvery): the new pressure
// sampled into mon_out (a series row) at the listed voxels (mon_start,
// mon_cell, mon_slot: see Monitor) or at every voxel
int bb_fluid_pressure(float* const* v3, float* p, float* r, const int* idx,
                      const float* table, float* acc_c, float* acc_s,
                      float* peak, float* const* psi6, const float* prof_int,
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
  const Monitor mon{mon_start, mon_cell, mon_slot, mon_out};
  cudaStream_t st = (cudaStream_t)stream;
#define BB_PRESSURE_ARGS                                                   \
  gather<3, Ptr3>(v3), p, r, idx, table, n_mat, acc_c, acc_s, peak,        \
      gather<6, Ptr6>(psi6), prof_int, dt_dx, inv_dx, half_dt, cosw, sinw, \
      g, (int)pt, sval, mon
#define BB_GO(V, D, P, M)                                                   \
  do {                                                                      \
    if (x_lo && x_hi && y_lo && y_hi) {                                     \
      fluid_pressure_kernel<V, D, P, M, true>                               \
          <<<grid, block, 0, st>>>(BB_PRESSURE_ARGS);                       \
    } else {                                                                \
      fluid_pressure_kernel<V, D, P, M, false>                              \
          <<<grid, block, 0, st>>>(BB_PRESSURE_ARGS);                       \
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
#undef BB_PRESSURE_ARGS
  return (int)cudaGetLastError();
}

}  // extern "C"

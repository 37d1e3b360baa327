// Fluid (shear-free) FDTD: K leapfrog steps in one launch, one march over x,
// for NVIDIA Hopper (sm_90a). CT mode, indexed materials.
//
// Replaces (TPU kernels of the JAX package in
// babelbrain_tpu/ops/fdtd_pallas.py):
//   build_fluid_fused_step (B2, K = 1), build_fluid_fused2_step (B3, K = 2)
//   and build_fluid_fusedK_step (B4, K >= 3): the velocity and the pressure
//   half-steps of K steps in one sweep, with the CPML, the SLS memory, the
//   plane or point source, and the carrier DFT and |p| peak of every step;
//   in the EXTRAS instantiations also B4's with_p2 accumulator (acc_p2,
//   :1924 / :1957, summed :2288-2303: p^2 of every window step, the
//   Pressure_rms map) and the monitor capture of its driver
//   simulate_fluid_pallas (:2840-2943: the pressure at listed voxels, here
//   at every sampled step of the sweep, not once a sweep). Their volumetric
//   (dome) drive is not here: it runs in the halo sweep
//   (fdtd_fluid_halo.cu). Each cell's arithmetic is the pair's, in the
//   pair's order (fdtd_stencil.cuh's helpers and their L2-loading twins),
//   and the p^2 sum is extras_accumulate_kernel's (fdtd_extras.cu), so K
//   steps of this kernel equal K steps of the pair (with the maps' pass and
//   the MONITOR sample) bit for bit.
//
// What bounds it on this card: the pair is bound by device-memory traffic
// (16 float volumes a step, 22 inside the sensor window). A sweep reads p,
// vx, vy, vz, r, the index (and the DFT sums) once and writes them once: 11
// volumes (17) a sweep, 11/K (17/K) a step, if the planes in flight stay in
// the 50 MB L2 between the stages that touch them (K stages x 4 planes x the
// five state fields: 11 MB at 216x216 planes and K = 4).
//
// Design (the card's, not the TPU's): the TPU keeps whole (N2, N3) planes
// in VMEM rings and recomputes nothing. A Hopper block holds 227 KB of shared
// memory, not the rings of several 35 MB volumes, and a (y, z) tile that
// marched alone would have to recompute a halo that widens by 3 cells a side
// every step (d_plus reads -1..+2, d_minus -2..+1): 32x8 owned cells are
// 56x32 cells to compute at K = 4, with their own copies of r and the y/z
// psi slabs. Here nothing is recomputed: the whole grid marches along x in
// lockstep.
//   - The launch is cooperative: blocks (z-tile, y-tile, stage s), all
//     resident at once. Stage s's threads own the same columns as the pair's
//     (32x8 tiles, ops/fdtd_fused_kernels.py fused_launch_geometry) and do
//     step s of the sweep: at march step t the velocity of plane
//     i = t - kLag s and the pressure of plane i - 1.
//   - After each march step a grid-wide barrier (cooperative_groups
//     grid.sync). Stage s + 1 runs kLag = 4 planes behind stage s, so every
//     value a thread reads from another thread was written at an earlier
//     march step and is overwritten only at a later one: the y/z neighbours
//     of p (velocity) and of vy, vz (pressure) of the same or the previous
//     stage, and the previous stage's own-cell p, v, r, psi and DFT sums.
//     Three planes would make stage s + 1's velocity read the pressure stage s
//     writes in the same march step. ops/fdtd_fused_kernels.py march()
//     mirrors this schedule; tests/test_torch_fused.py checks every read
//     against it.
//   - The state is updated in place in device memory: one copy of every
//     field, no halo, no scratch. Each thread keeps its column's x-windows in
//     registers (p for the velocity, the new vx for the pressure), loading
//     the window's newest plane each march step. Values another block wrote
//     in this launch are loaded with ld.global.cg (L2), never through L1 or
//     the read-only path (the L2 helpers of fdtd_stencil.cuh); the index,
//     table, profiles and source planes through __ldg.
//   - Per-step scalars: the K rows (s_sin, s_cos, cosw, sinw, s_point) of
//     ops/fdtd.py step_scalars, passed by value as float32, the values the
//     pair takes as arguments.
// The price: a grid-wide barrier every march step (N1 + 4 (K - 1) + 1 of
// them a sweep), and only K N2 N3 threads in flight, each walking its
// column through all N1 planes. The depth is bounded by co-residency: K x
// tiles blocks must fit on the card at once (bb_fluid_fused_capacity: 792
// blocks of this kernel on an H100, so K <= 4 at 192x192 and 216x216
// planes); ops/fdtd_fused_kernels.py admitted_depth takes the deepest K
// that fits, and ops/fdtd.py fused_plan caps it at the depth measured
// fastest (PERF.md).
// Measured on an H100 (PERF.md): slower than the pair at every K. What
// holds it is each thread's chain of dependent L2 loads, one plane after
// the other, not the barrier (a variant marching up to 16 planes between
// barriers was no faster than the pair either) and not device memory; a
// variant loading the pressure's inputs ahead of the velocity's stores
// spilled at 40 registers and was slower. More independent loads in
// flight per thread, point-to-point flags between neighbouring blocks
// instead of the grid barrier, and thread-block clusters sharing halos in
// distributed shared memory are later work.
//
// EXTRAS (only with WITH_DFT and XALL: JAX sends sharded extras runs to its
// XLA path, and the port's sharded diagnostic runs keep the pair): where the
// stage writes a cell's new pressure it also adds pn * pn to acc_p2 (a load,
// an add, a store; nothing live across the march), and samples pn at the
// listed monitor voxels into its step's row of the series (rows.mon_row[s],
// -1: not sampled, no store). The sample is taken from the register at the
// write: stage s + 1 overwrites the plane kLag march steps later, so a read
// of p after the march (the pair's copy_listed) would see only the last
// stage's value. The voxels are sorted by the warp that writes them, keyed
// by (z-tile, y-tile, row) whatever the stage, and within a warp by cell
// (ops/fdtd_extras.py sweep_csr); each stage walks its warp's entries plane
// by plane with one cursor (e, e_end: two registers), every lane of the warp
// through the same entries, the lane that owns the cell storing it. A warp
// with no listed voxel does one compare a plane. A null acc_p2 or monitor
// list skips its part (uniform across the grid), so one instantiation
// serves maps, monitors or both.
//
// Stateful cells: r, the psi slabs (x, y, z) and the DFT sums are per-cell
// state; at each stage only the thread that owns the cell reads and writes
// them, so nothing is held twice. x decomposition: the x_lo / x_hi
// flags of Geo (fdtd_stencil.cuh), with an XALL twin that compiles the
// whole-grid code, as the pair has; ops/fdtd.py runs a shard's extended slab
// through this kernel (overlap and discard).
//
// Rounding: built with --fmad=false; the operation order of the pair and of
// the plain PyTorch versions (ops/fdtd_kernels.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fdtd_stencil.cuh"

namespace {

using namespace bb;
namespace cg = cooperative_groups;

constexpr int kLag = 4;       // planes between stage s and s + 1
constexpr int kMaxSteps = 8;  // rows a launch takes (K_CAP in Python)
// 1536 threads an SM (40 registers): the co-resident blocks bound K
constexpr int kMinBlocksFused = 6;

// table rows (ops/fdtd.py _build_indexed_materials)
constexpr int kRhoInv = 0, kPiU = 1, kCRp = 3, kBR = 5;

// the per-step scalars of a launch (ops/fdtd.py step_scalars), row s for
// stage s, and the series row each step samples (EXTRAS; -1: none)
struct Rows {
  float s_sin[kMaxSteps], s_cos[kMaxSteps], cosw[kMaxSteps], sinw[kMaxSteps],
      s_pt[kMaxSteps];
  int mon_row[kMaxSteps];
};

// the listed monitor voxels of an EXTRAS sweep (ops/fdtd_extras.py
// sweep_csr): warp w's entries are [start[w], start[w + 1]) of (cell[e],
// slot[e]), sorted by cell; the series is (n_samples, n_mon); cell null:
// no monitor
struct SweepMon {
  const int* start;
  const int* cell;
  const int* slot;
  float* series;
  int n_mon;
};

// K steps of fluid_velocity_kernel then fluid_pressure_kernel (fdtd_fluid.cu)
// in one march; psi_p / psi_v: [lo, hi] of p_x, p_y, p_z / vx_x, vy_y, vz_z;
// EXTRAS: with acc_p2 and the monitor list (see above)
template <bool VISCOUS, bool WITH_DFT, bool POINT, bool XALL, bool EXTRAS>
__global__ void __launch_bounds__(kThreads, kMinBlocksFused)
    fluid_fused_kernel(float* __restrict__ p, Ptr3 v, float* __restrict__ r,
                       const int* __restrict__ idx,
                       const float* __restrict__ table, int n_mat,
                       float* __restrict__ acc_c, float* __restrict__ acc_s,
                       float* __restrict__ peak, Ptr6 psi_p, Ptr6 psi_v,
                       const float* __restrict__ prof_half,
                       const float* __restrict__ prof_int,
                       const float* __restrict__ amp,
                       const float* __restrict__ cph,
                       const float* __restrict__ sph, float dt_dx,
                       float inv_dx, float half_dt, Geo g, int zsrc, int pt,
                       Rows rows, float* __restrict__ acc_p2, SweepMon mon) {
  static_assert(!EXTRAS || (WITH_DFT && XALL),
                "the extras sweep runs in the sensor window on whole grids");
  cg::grid_group grid = cg::this_grid();
  const int s = blockIdx.z;  // this block's step of the sweep
  Col q;
  q.k = blockIdx.x * kTileZ + threadIdx.x;
  q.j = blockIdx.y * kTileY + threadIdx.y;
  q.jk = q.j * g.n3 + q.k;
  q.plane = g.n2 * g.n3;
  q.i0 = 0;
  q.i1 = g.n1;
  // threads off the volume march too: every thread meets every barrier
  const bool inside = q.j < g.n2 && q.k < g.n3;
  const float s_sin = rows.s_sin[s], s_cos = rows.s_cos[s];
  const float cosw = rows.cosw[s], sinw = rows.sinw[s], sval = rows.s_pt[s];
  float* vx = v.p[0];
  float* vy = v.p[1];
  float* vz = v.p[2];
  // x-windows: p at planes i-1..i+2 (velocity, forward), the new vx at
  // planes i-3..i (pressure of plane i-1, backward)
  float wp0 = 0.0f, wp1 = 0.0f, wp2 = 0.0f, wp3 = 0.0f;
  float wv0 = 0.0f, wv1 = 0.0f, wv2 = 0.0f, wv3 = 0.0f;
  // EXTRAS: the cursor over this warp's listed voxels, keyed by its
  // (z-tile, y-tile, row), the same for every stage
  int e = 0, e_end = 0;
  if (EXTRAS && mon.cell != nullptr && inside) {
    const int w = (blockIdx.x + gridDim.x * blockIdx.y) * kTileY + threadIdx.y;
    e = __ldg(mon.start + w);
    e_end = __ldg(mon.start + w + 1);
  }
  const int n_march = g.n1 + kLag * ((int)gridDim.z - 1) + 1;
  for (int t = 0; t < n_march; ++t) {
    const int i = t - kLag * s;  // this stage's velocity plane
    if (inside && i >= 0 && i <= g.n1) {
      // --- velocity of plane i (fluid_velocity_kernel) ---
      float vxn = 0.0f;
      if (i < g.n1) {
        const int c = i * q.plane + q.jk;
        if (i == 0) {
          wp0 = 0.0f;
          wp1 = at_x2(p, 0, q, g.n1);
          wp2 = at_x2(p, 1, q, g.n1);
          wp3 = at_x2(p, 2, q, g.n1);
        } else {
          wp0 = wp1;
          wp1 = wp2;
          wp2 = wp3;
          wp3 = at_x2(p, i + 2, q, g.n1);
        }
        const int mi = __ldg(idx + c);
        const float vxo = ld2(vx, c), vyo = ld2(vy, c), vzo = ld2(vz, c);
        const PlaneL2 pp{p, c, q.j, q.k, g.n2, g.n3};
        const float dpy = diff_yz2<1, true>(pp);
        const float dpz = diff_yz2<2, true>(pp);
        const float ri = __ldg(table + kRhoInv * n_mat + mi);
        const CpmlL2<Ptr6, XALL> cp{psi_p, prof_half, nullptr, g, q, i};
        const float dx = cp.template apply<0, true, 0>(
            stencil(wp0, wp1, wp2, wp3));
        const float dy = cp.template apply<1, true, 1>(dpy);
        const float dz = cp.template apply<2, true, 2>(dpz);
        float vzn = vzo - dt_dx * ri * dz;
        if (q.k == zsrc) {
          const int ij = i * g.n2 + q.j;
          const float a = __ldg(amp + ij);
          if (a > 0.0f) {
            vzn = a * (s_sin * __ldg(cph + ij) + s_cos * __ldg(sph + ij));
          }
        }
        vxn = vxo - dt_dx * ri * dx;
        vx[c] = vxn;
        vy[c] = vyo - dt_dx * ri * dy;
        vz[c] = vzn;
      }
      wv0 = wv1;
      wv1 = wv2;
      wv2 = wv3;
      wv3 = vxn;  // 0 past the last plane
      // --- pressure of plane i - 1 (fluid_pressure_kernel) ---
      const int ip = i - 1;
      if (ip >= 0) {
        const int c = ip * q.plane + q.jk;
        const int mi = __ldg(idx + c);
        const float po = ld2(p, c);
        const float ro = VISCOUS ? ld2(r, c) : 0.0f;
        const float dvy = diff_yz2<1, false>(PlaneL2{vy, c, q.j, q.k, g.n2,
                                                    g.n3});
        const float dvz = diff_yz2<2, false>(PlaneL2{vz, c, q.j, q.k, g.n2,
                                                    g.n3});
        const float pi_u = __ldg(table + kPiU * n_mat + mi);
        const CpmlL2<Ptr6, XALL> cp{psi_v, nullptr, prof_int, g, q, ip};
        const float dx = cp.template apply<0, false, 0>(
            stencil(wv0, wv1, wv2, wv3));
        const float dy = cp.template apply<1, false, 1>(dvy);
        const float dz = cp.template apply<2, false, 2>(dvz);
        const float theta = dx + dy + dz;
        float pn;
        if (VISCOUS) {
          const float c_rp = __ldg(table + kCRp * n_mat + mi);
          const float b_r = __ldg(table + kBR * n_mat + mi);
          const float rn = b_r * ro - c_rp * theta * inv_dx;
          pn = po - dt_dx * pi_u * theta - half_dt * (rn + ro);
          r[c] = rn;
        } else {
          pn = po - dt_dx * pi_u * theta;
        }
        if (POINT && c == pt) pn = pn - sval;
        p[c] = pn;
        if (WITH_DFT) {
          acc_c[c] = ld2(acc_c, c) + pn * cosw;
          acc_s[c] = ld2(acc_s, c) + pn * sinw;
          peak[c] = fmaxf(ld2(peak, c), fabsf(pn));
        }
        if (EXTRAS) {
          // extras_accumulate_kernel's Pressure_rms sum, in its order
          if (acc_p2 != nullptr) acc_p2[c] = ld2(acc_p2, c) + pn * pn;
          // the warp's listed voxels in plane ip (uniform across the warp)
          const int end = (ip + 1) * q.plane;
          for (; e < e_end; ++e) {
            const int cell = __ldg(mon.cell + e);
            if (cell >= end) break;
            const int row = rows.mon_row[s];
            if (cell == c && row >= 0) {
              mon.series[(long long)row * mon.n_mon + __ldg(mon.slot + e)] =
                  pn;
            }
          }
        }
      }
    }
    if (t + 1 < n_march) grid.sync();
  }
}

// the instantiation of (viscous, with_dft, point, xall), as a launchable
// function pointer
template <int I>
const void* fused_at() {
  return reinterpret_cast<const void*>(
      &fluid_fused_kernel<bool(I & 8), bool(I & 4), bool(I & 2), bool(I & 1),
                          false>);
}

// the EXTRAS instantiation of (viscous, point): with the DFT, whole grids
template <int I>
const void* extras_at() {
  return reinterpret_cast<const void*>(
      &fluid_fused_kernel<bool(I & 2), true, bool(I & 1), true, true>);
}

// null for an EXTRAS request outside the window or on a shard
const void* fused_kernel(int viscous, int with_dft, int point, int xall,
                         int extras) {
  static const void* const kernels[16] = {
      fused_at<0>(),  fused_at<1>(),  fused_at<2>(),  fused_at<3>(),
      fused_at<4>(),  fused_at<5>(),  fused_at<6>(),  fused_at<7>(),
      fused_at<8>(),  fused_at<9>(),  fused_at<10>(), fused_at<11>(),
      fused_at<12>(), fused_at<13>(), fused_at<14>(), fused_at<15>()};
  static const void* const with_extras[4] = {extras_at<0>(), extras_at<1>(),
                                             extras_at<2>(), extras_at<3>()};
  if (extras) {
    if (!with_dft || !xall) return nullptr;
    return with_extras[(viscous ? 2 : 0) | (point ? 1 : 0)];
  }
  return kernels[(viscous ? 8 : 0) | (with_dft ? 4 : 0) | (point ? 2 : 0) |
                 (xall ? 1 : 0)];
}

}  // namespace

extern "C" {

// *blocks: how many blocks of the (viscous, with_dft, point, xall, extras)
// instantiation the current device holds at once (a cooperative launch may
// not exceed it)
int bb_fluid_fused_capacity(int viscous, int with_dft, int point, int xall,
                            int extras, int* blocks) {
  const void* kernel = fused_kernel(viscous, with_dft, point, xall, extras);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return (int)cooperative_capacity(kernel, blocks);
}

// K = k_steps steps in one cooperative launch. v3, psi_p6, psi_v6: host
// arrays of device pointers (as bb_fluid_velocity / bb_fluid_pressure);
// rows: host array of k_steps x (s_sin, s_cos, cosw, sinw, s_point); pt:
// the point source's cell (point); gz, gy: the (z, y) tiles of
// ops/fdtd_fused_kernels.py fused_launch_geometry (the grid's third
// dimension is k_steps); extras: the EXTRAS instantiation (with_dft and a
// whole grid only), with acc_p2 (null: no p^2 sum) and the monitor list
// mon_start / mon_cell / mon_slot of ops/fdtd_extras.py sweep_csr (mon_cell
// null: no monitor) sampling into series (n_samples, n_mon) at the host
// array mon_rows of k_steps rows (-1: step not sampled)
int bb_fluid_fused(float* p, float* const* v3, float* r, const int* idx,
                   const float* table, float* acc_c, float* acc_s, float* peak,
                   float* const* psi_p6, float* const* psi_v6,
                   const float* prof_half, const float* prof_int,
                   const float* amp, const float* cph, const float* sph,
                   const float* rows, int k_steps, float dt_dx, float inv_dx,
                   float half_dt, int n_mat, int n1, int n2, int n3, int ns,
                   int x_lo, int x_hi, int zsrc, int viscous, int with_dft,
                   int point, long long pt, int gz, int gy, int extras,
                   float* acc_p2, const int* mon_start, const int* mon_cell,
                   const int* mon_slot, float* series, int n_mon,
                   const int* mon_rows, void* stream) {
  const void* kernel =
      fused_kernel(viscous, with_dft, point, x_lo && x_hi, extras);
  if (kernel == nullptr || k_steps < 1 || k_steps > kMaxSteps ||
      (long long)n1 * n2 * n3 >= (1LL << 31) || !covers(gz, kTileZ, n3) ||
      !covers(gy, kTileY, n2) ||
      (extras && mon_cell != nullptr &&
       (mon_start == nullptr || mon_slot == nullptr || series == nullptr ||
        mon_rows == nullptr || n_mon < 1))) {
    return (int)cudaErrorInvalidValue;
  }
  Geo g = make_geo(n1, n2, n3, ns, n1, x_lo, x_hi);
  Rows rw{};
  for (int s = 0; s < k_steps; ++s) {
    rw.s_sin[s] = rows[5 * s];
    rw.s_cos[s] = rows[5 * s + 1];
    rw.cosw[s] = rows[5 * s + 2];
    rw.sinw[s] = rows[5 * s + 3];
    rw.s_pt[s] = rows[5 * s + 4];
    rw.mon_row[s] = extras && mon_cell != nullptr ? mon_rows[s] : -1;
  }
  SweepMon mon{mon_start, extras ? mon_cell : nullptr, mon_slot, series,
               n_mon};
  float* p2 = extras ? acc_p2 : nullptr;
  Ptr3 v = gather<3, Ptr3>(v3);
  Ptr6 pp = gather<6, Ptr6>(psi_p6);
  Ptr6 pv = gather<6, Ptr6>(psi_v6);
  int pti = (int)pt;
  void* args[] = {&p,        &v,         &r,      &idx,     &table,
                  &n_mat,    &acc_c,     &acc_s,  &peak,    &pp,
                  &pv,       &prof_half, &prof_int, &amp,   &cph,
                  &sph,      &dt_dx,     &inv_dx, &half_dt, &g,
                  &zsrc,     &pti,       &rw,     &p2,      &mon};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      kernel, dim3(gz, gy, k_steps), dim3(kTileZ, kTileY), args, 0,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"

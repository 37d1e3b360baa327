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
// the 50 MB L2 between the stages that touch them.
//
// Design (the card's, not the TPU's): the TPU keeps whole (N2, N3) planes
// in VMEM rings and recomputes nothing. A Hopper block holds 227 KB of
// shared memory, not the rings of several 35 MB volumes, and a (y, z) tile
// that marched alone would have to recompute a halo that widens by 3 cells
// a side every step. Here nothing is recomputed: the whole grid marches
// along x in lockstep.
//   - The launch is cooperative: blocks (z-tile, y-tile, stage s), all
//     resident at once. A block's 32x8 threads own a tile of 32 (z) x 16
//     (y) columns, kCells = 2 cells a thread kTileY rows apart (their work
//     is independent, so one thread keeps two chains in flight, and half as
//     many blocks meet at the barrier), and do step s of the sweep: at
//     march step t the velocity of plane i = t - kLead - kLag s and the
//     pressure of plane i - kPLag. After each march step a grid-wide
//     barrier (cooperative_groups grid.sync).
//   - The loads come off the dependency chain: every value a thread reads
//     at march step t + 1 was written at march step t - 1 or before, and no
//     thread writes it at step t or t + 1 (but a cell's owner, which waits
//     for the copies first). So each block stages all of step t + 1's loads
//     during step t as asynchronous copies into shared memory, completed on
//     the mbarrier of t + 1: at the start of step t the (y, z) ring of p's
//     plane i + 1 the velocity's y/z differences read (rows -1..+2, columns
//     -1..+2 around the tile) and the rings of vy and vz of plane i - 1 the
//     pressure's differences read, into the other half of a double buffer;
//     after step t's arithmetic (the slots are single) each cell's own
//     values: p of plane i + 3 (the newest of its x-window), the old vx,
//     vy, vz, r, the DFT sums, the peak, the p^2 sum, the material index
//     and the psi value of each derivative's CPML slab; the table is
//     gathered through __ldg at use. The stencils then read shared memory,
//     not eight L2 loads a derivative. That needs the pressure kPLag = 2
//     planes behind its velocity (its vy, vz rings written at t - 2) and
//     stage s + 1 kLag = 6 planes behind stage s (the newest plane of its
//     p window, p of plane i + 2 at step t, is written by stage s at step
//     t + 4 - kLag).
//     ops/fdtd_fused_kernels.py march() mirrors the schedule, the staged
//     loads included; tests/test_torch_fused.py checks every read against
//     it (kLag = 5, or a copy issued a step earlier, fail).
//   - Where N3 is a multiple of 4 and every staged field starts on 16
//     bytes (the VEC instantiations, which bb_fluid_fused picks: the main
//     path's grids) the copies move whole 16-byte
//     chunks of z (the rings span z0 - 4 .. z0 + 35, a cell's slot is in
//     its row's chunk, one copy serves four cells: ~7 copies a thread a
//     step) through L2 only (cp.async.cg), and each step waits for its
//     copies at its top: they are in flight across the grid barrier. Else
//     the copies move 4 bytes (cp.async.ca, through L1), and each thread
//     waits for its block's copies before the barrier: a copy still in
//     flight at the barrier could fill an L1 line after the barrier's fence
//     dropped the stale ones, and a line that straddles two planes would
//     then carry a value another SM writes in the next step. The psi values
//     (4 bytes, only the CPML shell's) are written by their owner alone and
//     read again kLag steps later, past a barrier's fence either way.
//     The cells' own x-windows stay in registers (p at planes i - 2..i + 2,
//     the new vx at i - 4..i - 1): p of the pressure's plane is the
//     window's oldest entry.
//   - The state is updated in place in device memory: one copy of every
//     field, no halo, no scratch. Per-step scalars: the K rows (s_sin,
//     s_cos, cosw, sinw, s_point) of ops/fdtd.py step_scalars, passed by
//     value as float32, the values the pair takes as arguments.
// The depth is bounded by co-residency: K x tiles blocks must fit on the
// card at once (bb_fluid_fused_capacity: 3 blocks an SM, kSmem = 49.7 KB of
// shared memory and at most 80 registers a thread, 396 blocks on an H100,
// so K <= 4 on 192x192x240 and 216x216x224 grids); ops/fdtd_fused_kernels.py
// admitted_depth takes the deepest K that fits, and ops/fdtd.py fused_plan
// caps it at the depth measured fastest (PERF.md).
//
// EXTRAS (only with WITH_DFT and XALL: JAX sends sharded extras runs to its
// XLA path, and the port's sharded diagnostic runs keep the pair): where the
// stage writes a cell's new pressure it also adds pn * pn to acc_p2 (its old
// value staged like the DFT sums), and samples pn at the listed monitor
// voxels into its step's row of the series (rows.mon_row[s], -1: not
// sampled, no store). The sample is taken from the register at the write:
// stage s + 1 overwrites the plane kLag march steps later, so a read of p
// after the march (the pair's copy_listed) would see only the last stage's
// value. The voxels are sorted by the tile row that writes them, keyed by
// (z-tile, y-tile, row of the 16) whatever the stage, and within a row by
// cell (ops/fdtd_extras.py sweep_csr); each stage walks a cell's row's
// entries plane by plane with one cursor (a register a cell; the rows'
// ends in shared memory), every lane of the warp through the same
// entries, the lane that owns the cell storing it. A row with no listed
// voxel does one compare a plane. A null acc_p2 or monitor list skips its
// part (uniform across the grid), so one instantiation serves maps,
// monitors or both.
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

#include <initializer_list>

#include "fdtd_stencil.cuh"

namespace {

using namespace bb;
namespace cg = cooperative_groups;

constexpr int kLag = 6;       // planes between stage s and s + 1
constexpr int kPLag = 2;      // planes the pressure runs behind its velocity
constexpr int kLead = 2;      // steps a stage loads its x-window before
                              // its first velocity plane
constexpr int kMaxSteps = 8;  // rows a launch takes (K_CAP in Python)
constexpr int kCells = 2;     // cells a thread, kTileY rows apart
constexpr int kRows = kTileY * kCells;  // rows of a block's tile
// 768 threads an SM (80 registers, 3 x kSmem of shared memory): the
// co-resident blocks bound K
constexpr int kMinBlocksFused = 3;

// the staged rings a ring buffer holds, in whole 16-byte chunks of z: p of
// the velocity's plane, rows y0 - 1 .. y0 + kRows + 1 x columns z0 - 4 ..
// z0 + kTileZ + 3 (kZ0: the column of z0); vy of the pressure's plane,
// rows y0 - 2 .. y0 + kRows, the tile's columns; vz of the pressure's
// plane, the tile's rows, columns z0 - 4 .. z0 + kTileZ + 3
constexpr int kZ0 = 4;
constexpr int kPW = kTileZ + 2 * kZ0, kPH = kRows + 3, kPRing = kPH * kPW;
constexpr int kVYH = kRows + 3, kVYRing = kVYH * kTileZ;
constexpr int kVZW = kTileZ + 2 * kZ0, kVZRing = kRows * kVZW;
constexpr int kRing = kPRing + kVYRing + kVZRing;
// each cell's staged own values, a slot of kBlockCells floats each, the
// cells in the tile's row-major order (row * kTileZ + column)
enum Slot {
  kPn,      // p of plane i + 2, the newest of the x-window
  kVx,      // the old velocity of plane i
  kVy,
  kVz,
  kIdxV,    // the material index of plane i (int)
  kR,       // the pressure's plane i - 2: the SLS memory
  kAccC,    // the DFT sums and the peak
  kAccS,
  kPeak,
  kP2,      // EXTRAS: the p^2 sum
  kIdxP,    // the material index of plane i - 2 (int)
  kPsiP,    // kPsiP + axis: the velocity's psi value of its CPML slab
  kPsiV = kPsiP + 3,  // kPsiV + axis: the pressure's
  kSlots = kPsiV + 3
};
constexpr int kBlockCells = kThreads * kCells;
// dynamic shared memory: two mbarriers, two ring buffers (the next step's
// rings land in one while the step reads the other), one set of own slots
constexpr int kSmem =
    16 + (2 * kRing + kSlots * kBlockCells) * (int)sizeof(float);

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
// sweep_csr): row w's entries are [start[w], start[w + 1]) of (cell[e],
// slot[e]), sorted by cell; the series is (n_samples, n_mon); cell null:
// no monitor
struct SweepMon {
  const int* start;
  const int* cell;
  const int* slot;
  float* series;
  int n_mon;
};

// stage the psi values of the three derivatives of one half-step at cell
// (i, j, k) into slots slot0 + axis (prof-free: only where a slab applies)
template <bool XALL>
__device__ __forceinline__ void stage_psi(const Ptr6& psi, const Geo& g,
                                          int i, int j, int k, int jk,
                                          int plane, float* slot0) {
  const Slab b0 = slab<0, XALL>(g, i, j, k, jk, plane);
  const Slab b1 = slab<1, XALL>(g, i, j, k, jk, plane);
  const Slab b2 = slab<2, XALL>(g, i, j, k, jk, plane);
  const float* s0 = slab_src(b0, psi.p[0], psi.p[1]);
  const float* s1 = slab_src(b1, psi.p[2], psi.p[3]);
  const float* s2 = slab_src(b2, psi.p[4], psi.p[5]);
  if (s0) cp_async4z(slot0, s0, true);
  if (s1) cp_async4z(slot0 + kBlockCells, s1, true);
  if (s2) cp_async4z(slot0 + 2 * kBlockCells, s2, true);
}

// K steps of fluid_velocity_kernel then fluid_pressure_kernel (fdtd_fluid.cu)
// in one march; psi_p / psi_v: [lo, hi] of p_x, p_y, p_z / vx_x, vy_y, vz_z;
// EXTRAS: with acc_p2 and the monitor list (see above)
template <bool VISCOUS, bool WITH_DFT, bool POINT, bool XALL, bool EXTRAS,
          bool VEC>
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
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem);
  float* const rings = reinterpret_cast<float*>(smem + 16);
  float* const slots = rings + 2 * kRing;
  cg::grid_group grid = cg::this_grid();
  const int s = blockIdx.z;  // this block's step of the sweep
  const int tid = threadIdx.y * kTileZ + threadIdx.x;
  const int y0 = blockIdx.y * kRows, z0 = blockIdx.x * kTileZ;
  const int k = z0 + threadIdx.x;
  const int plane = g.n2 * g.n3;
  const float s_sin = rows.s_sin[s], s_cos = rows.s_cos[s];
  const float cosw = rows.cosw[s], sinw = rows.sinw[s], sval = rows.s_pt[s];
  float* vx = v.p[0];
  float* vy = v.p[1];
  float* vz = v.p[2];
  // this thread's cells: rows j[c] of the tile (lr[c] in it)
  int j[kCells], lr[kCells];
  bool in[kCells];
#pragma unroll
  for (int c = 0; c < kCells; ++c) {
    lr[c] = threadIdx.y + c * kTileY;
    j[c] = y0 + lr[c];
    in[c] = j[c] < g.n2 && k < g.n3;
  }
  // x-windows: p at planes i-2..i+2 (velocity, forward: i-1..i+2; the
  // pressure's own p at i-2), the new vx at planes i-4..i-1 (pressure of
  // plane i-2, backward)
  float wpm[kCells], wp0[kCells], wp1[kCells], wp2[kCells], wp3[kCells];
  float wv0[kCells], wv1[kCells], wv2[kCells], wv3[kCells];
  // EXTRAS: the series row of this stage's step; each cell's cursor over
  // its tile row's listed voxels (keyed by (z-tile, y-tile, row), the same
  // for every stage), the rows' ends in shared memory
  const int mon_row = EXTRAS ? rows.mon_row[s] : -1;
  __shared__ int mon_end[EXTRAS ? kRows : 1];
  int e[kCells];
#pragma unroll
  for (int c = 0; c < kCells; ++c) {
    wpm[c] = wp0[c] = wp1[c] = wp2[c] = wp3[c] = 0.0f;
    wv0[c] = wv1[c] = wv2[c] = wv3[c] = 0.0f;
    e[c] = 0;
  }
  if (EXTRAS && mon.cell != nullptr) {
    const int w = (blockIdx.x + gridDim.x * blockIdx.y) * kRows;
    if (tid < kRows) mon_end[tid] = __ldg(mon.start + w + tid + 1);
#pragma unroll
    for (int c = 0; c < kCells; ++c) e[c] = __ldg(mon.start + w + lr[c]);
  }
  if (tid == 0) {
    mbar_init(&bar[0], kThreads);
    mbar_init(&bar[1], kThreads);
  }
  __syncthreads();

  // the rings of march step t1 into ring buffer t1 & 1: 16-byte chunks
  // where the rows are aligned (vec), else float by float
  auto issue_rings = [&](int t1) {
    float* const P = rings + (t1 & 1) * kRing;
    float* const VY = P + kPRing;
    float* const VZ = VY + kVYRing;
    const int i1 = t1 - kLead - kLag * s;
    const int ip1 = i1 - kPLag;
    if (i1 >= 0 && i1 < g.n1) {
      const float* src = p + i1 * plane;
      if (VEC) {
        for (int a = tid; a < kPH * kPW / 4; a += kThreads) {
          const int row = a / (kPW / 4), ch = a % (kPW / 4);
          const int jj = y0 - 1 + row, kk = z0 - kZ0 + 4 * ch;
          const bool ok = (unsigned)jj < (unsigned)g.n2 &&
                          (unsigned)kk < (unsigned)g.n3;
          cp_async16z(P + row * kPW + 4 * ch,
                      ok ? src + (jj * g.n3 + kk) : src, ok);
        }
      } else {
        for (int a = tid; a < kPH * (kTileZ + 3); a += kThreads) {
          const int row = a / (kTileZ + 3), col = a % (kTileZ + 3) + kZ0 - 1;
          const int jj = y0 - 1 + row, kk = z0 - kZ0 + col;
          const bool ok = (unsigned)jj < (unsigned)g.n2 &&
                          (unsigned)kk < (unsigned)g.n3;
          cp_async4z(P + row * kPW + col, ok ? src + (jj * g.n3 + kk) : src,
                     ok);
        }
      }
    }
    if (ip1 >= 0 && ip1 < g.n1) {
      const float* sy = vy + ip1 * plane;
      const float* sz = vz + ip1 * plane;
      if (VEC) {
        for (int a = tid; a < kVYRing / 4; a += kThreads) {
          const int row = a / (kTileZ / 4), ch = a % (kTileZ / 4);
          const int jj = y0 - 2 + row, kk = z0 + 4 * ch;
          const bool ok = (unsigned)jj < (unsigned)g.n2 &&
                          (unsigned)kk < (unsigned)g.n3;
          cp_async16z(VY + row * kTileZ + 4 * ch,
                      ok ? sy + (jj * g.n3 + kk) : sy, ok);
        }
        for (int a = tid; a < kVZRing / 4; a += kThreads) {
          const int row = a / (kVZW / 4), ch = a % (kVZW / 4);
          const int jj = y0 + row, kk = z0 - kZ0 + 4 * ch;
          const bool ok = (unsigned)jj < (unsigned)g.n2 &&
                          (unsigned)kk < (unsigned)g.n3;
          cp_async16z(VZ + row * kVZW + 4 * ch,
                      ok ? sz + (jj * g.n3 + kk) : sz, ok);
        }
      } else {
        for (int a = tid; a < kVYRing; a += kThreads) {
          const int jj = y0 - 2 + a / kTileZ, kk = z0 + a % kTileZ;
          const bool ok = (unsigned)jj < (unsigned)g.n2 &&
                          (unsigned)kk < (unsigned)g.n3;
          cp_async4z(VY + a, ok ? sy + (jj * g.n3 + kk) : sy, ok);
        }
        for (int a = tid; a < kRows * (kTileZ + 3); a += kThreads) {
          const int row = a / (kTileZ + 3), col = a % (kTileZ + 3) + kZ0 - 2;
          const int jj = y0 + row, kk = z0 - kZ0 + col;
          const bool ok = (unsigned)jj < (unsigned)g.n2 &&
                          (unsigned)kk < (unsigned)g.n3;
          cp_async4z(VZ + row * kVZW + col, ok ? sz + (jj * g.n3 + kk) : sz,
                     ok);
        }
      }
    }
  };

  // the cells' own values of march step t1 into the slots (the step before
  // has read them) and their psi values; then this thread's arrival on the
  // mbarrier of t1. vec: half the threads copy the velocity's fields, half
  // the pressure's, a 16-byte chunk of four cells of a row each
  auto issue_own = [&](int t1) {
    const int i1 = t1 - kLead - kLag * s;
    const int ip1 = i1 - kPLag;
    const bool win = i1 >= -kLead && i1 < g.n1 + kPLag;
    const bool vel = i1 >= 0 && i1 < g.n1;
    const bool prs = ip1 >= 0 && ip1 < g.n1;
    if (VEC) {
      constexpr int kChunks = kBlockCells / 4;
      const int ch = tid % kChunks;
      const int row = ch / (kTileZ / 4), col = 4 * (ch % (kTileZ / 4));
      const bool ok = y0 + row < g.n2 && z0 + col < g.n3;
      const int off = (y0 + row) * g.n3 + z0 + col;
      float* const d = slots + row * kTileZ + col;
      if (tid < kChunks) {
        if (win) {
          const bool in_x = i1 + 2 < g.n1;  // 0 past the last plane
          cp_async16z(d + kPn * kBlockCells,
                      p + (ok && in_x ? (i1 + 2) * plane + off : 0),
                      ok && in_x);
        }
        if (vel) {
          const int at = ok ? i1 * plane + off : 0;
          cp_async16z(d + kVx * kBlockCells, vx + at, ok);
          cp_async16z(d + kVy * kBlockCells, vy + at, ok);
          cp_async16z(d + kVz * kBlockCells, vz + at, ok);
          cp_async16z(d + kIdxV * kBlockCells, idx + at, ok);
        }
      } else if (prs) {
        const int at = ok ? ip1 * plane + off : 0;
        if (VISCOUS) cp_async16z(d + kR * kBlockCells, r + at, ok);
        if (WITH_DFT) {
          cp_async16z(d + kAccC * kBlockCells, acc_c + at, ok);
          cp_async16z(d + kAccS * kBlockCells, acc_s + at, ok);
          cp_async16z(d + kPeak * kBlockCells, peak + at, ok);
        }
        if (EXTRAS && acc_p2 != nullptr) {
          cp_async16z(d + kP2 * kBlockCells, acc_p2 + at, ok);
        }
        cp_async16z(d + kIdxP * kBlockCells, idx + at, ok);
      }
    }
#pragma unroll
    for (int c = 0; c < kCells; ++c) {
      if (!in[c]) continue;
      float* const S = slots + lr[c] * kTileZ + threadIdx.x;
      const int jk = j[c] * g.n3 + k;
      if (!VEC && win) {
        const bool in_x = i1 + 2 < g.n1;
        cp_async4z(S + kPn * kBlockCells,
                   p + (in_x ? (i1 + 2) * plane + jk : 0), in_x);
      }
      if (vel) {
        const int at = i1 * plane + jk;
        if (!VEC) {
          cp_async4z(S + kVx * kBlockCells, vx + at, true);
          cp_async4z(S + kVy * kBlockCells, vy + at, true);
          cp_async4z(S + kVz * kBlockCells, vz + at, true);
          cp_async4z(S + kIdxV * kBlockCells, idx + at, true);
        }
        stage_psi<XALL>(psi_p, g, i1, j[c], k, jk, plane,
                        S + kPsiP * kBlockCells);
      }
      if (prs) {
        const int at = ip1 * plane + jk;
        if (!VEC) {
          if (VISCOUS) cp_async4z(S + kR * kBlockCells, r + at, true);
          if (WITH_DFT) {
            cp_async4z(S + kAccC * kBlockCells, acc_c + at, true);
            cp_async4z(S + kAccS * kBlockCells, acc_s + at, true);
            cp_async4z(S + kPeak * kBlockCells, peak + at, true);
          }
          if (EXTRAS && acc_p2 != nullptr) {
            cp_async4z(S + kP2 * kBlockCells, acc_p2 + at, true);
          }
          cp_async4z(S + kIdxP * kBlockCells, idx + at, true);
        }
        stage_psi<XALL>(psi_v, g, ip1, j[c], k, jk, plane,
                        S + kPsiV * kBlockCells);
      }
    }
    cp_async_arrive(&bar[t1 & 1]);
  };

  issue_rings(0);
  issue_own(0);
  mbar_wait(&bar[0], 0);
  const int n_march = g.n1 + kLead + kPLag + kLag * ((int)gridDim.z - 1);
  for (int t = 0; t < n_march; ++t) {
    const int i = t - kLead - kLag * s;  // this stage's velocity plane
    const int ip = i - kPLag;           // and its pressure plane
    // vec: this step's copies were left in flight across the barrier
    if (VEC && t > 0) mbar_wait(&bar[t & 1], (t >> 1) & 1);
    const bool more = t + 1 < n_march;
    if (more) issue_rings(t + 1);
    const float* const P = rings + (t & 1) * kRing;
    const float* const VY = P + kPRing;
    const float* const VZ = VY + kVYRing;
    if (i >= -kLead && i < g.n1 + kPLag) {
#pragma unroll
      for (int c = 0; c < kCells; ++c) {
        if (!in[c]) continue;
        const float* const S = slots + lr[c] * kTileZ + threadIdx.x;
        const int jk = j[c] * g.n3 + k;
        wpm[c] = wp0[c];
        wp0[c] = wp1[c];
        wp1[c] = wp2[c];
        wp2[c] = wp3[c];
        wp3[c] = S[kPn * kBlockCells];
        // --- velocity of plane i (fluid_velocity_kernel) ---
        float vxn = 0.0f;
        if (i >= 0 && i < g.n1) {
          const int c0 = i * plane + jk;
          const int mi = reinterpret_cast<const int*>(S)[kIdxV *
                                                         kBlockCells];
          const float vxo = S[kVx * kBlockCells], vyo = S[kVy * kBlockCells],
                      vzo = S[kVz * kBlockCells];
          const int pc = (lr[c] + 1) * kPW + threadIdx.x + kZ0;
          const float dpy = stencil(P[pc - kPW], P[pc], P[pc + kPW],
                                    P[pc + 2 * kPW]);
          const float dpz = stencil(P[pc - 1], P[pc], P[pc + 1], P[pc + 2]);
          const float ri = __ldg(table + kRhoInv * n_mat + mi);
          const float* ph = prof_half;
          const float dx = cpml_staged(
              stencil(wp0[c], wp1[c], wp2[c], wp3[c]),
              slab<0, XALL>(g, i, j[c], k, jk, plane), g.ns, ph, psi_p.p[0],
              psi_p.p[1], S + kPsiP * kBlockCells);
          const float dy = cpml_staged(
              dpy, slab<1, XALL>(g, i, j[c], k, jk, plane), g.ns,
              ph + 4 * g.ns, psi_p.p[2], psi_p.p[3],
              S + (kPsiP + 1) * kBlockCells);
          const float dz = cpml_staged(
              dpz, slab<2, XALL>(g, i, j[c], k, jk, plane), g.ns,
              ph + 8 * g.ns, psi_p.p[4], psi_p.p[5],
              S + (kPsiP + 2) * kBlockCells);
          float vzn = vzo - dt_dx * ri * dz;
          if (k == zsrc) {
            const int ij = i * g.n2 + j[c];
            const float a = __ldg(amp + ij);
            if (a > 0.0f) {
              vzn = a * (s_sin * __ldg(cph + ij) + s_cos * __ldg(sph + ij));
            }
          }
          vxn = vxo - dt_dx * ri * dx;
          vx[c0] = vxn;
          vy[c0] = vyo - dt_dx * ri * dy;
          vz[c0] = vzn;
        }
        // --- pressure of plane ip (fluid_pressure_kernel) ---
        if (ip >= 0 && ip < g.n1) {
          const int c1 = ip * plane + jk;
          const int mi = reinterpret_cast<const int*>(S)[kIdxP *
                                                         kBlockCells];
          const float po = wpm[c];
          const float ro = VISCOUS ? S[kR * kBlockCells] : 0.0f;
          const int yc = lr[c] * kTileZ + threadIdx.x;
          const float dvy = stencil(VY[yc], VY[yc + kTileZ],
                                    VY[yc + 2 * kTileZ], VY[yc + 3 * kTileZ]);
          const int zc = lr[c] * kVZW + threadIdx.x + kZ0 - 2;
          const float dvz = stencil(VZ[zc], VZ[zc + 1], VZ[zc + 2], VZ[zc + 3]);
          const float pi_u = __ldg(table + kPiU * n_mat + mi);
          const float* pn_ = prof_int;
          const float dx = cpml_staged(
              stencil(wv0[c], wv1[c], wv2[c], wv3[c]),
              slab<0, XALL>(g, ip, j[c], k, jk, plane), g.ns, pn_,
              psi_v.p[0], psi_v.p[1], S + kPsiV * kBlockCells);
          const float dy = cpml_staged(
              dvy, slab<1, XALL>(g, ip, j[c], k, jk, plane), g.ns,
              pn_ + 4 * g.ns, psi_v.p[2], psi_v.p[3],
              S + (kPsiV + 1) * kBlockCells);
          const float dz = cpml_staged(
              dvz, slab<2, XALL>(g, ip, j[c], k, jk, plane), g.ns,
              pn_ + 8 * g.ns, psi_v.p[4], psi_v.p[5],
              S + (kPsiV + 2) * kBlockCells);
          const float theta = dx + dy + dz;
          float pn;
          if (VISCOUS) {
            const float c_rp = __ldg(table + kCRp * n_mat + mi);
            const float b_r = __ldg(table + kBR * n_mat + mi);
            const float rn = b_r * ro - c_rp * theta * inv_dx;
            pn = po - dt_dx * pi_u * theta - half_dt * (rn + ro);
            r[c1] = rn;
          } else {
            pn = po - dt_dx * pi_u * theta;
          }
          if (POINT && c1 == pt) pn = pn - sval;
          p[c1] = pn;
          if (WITH_DFT) {
            acc_c[c1] = S[kAccC * kBlockCells] + pn * cosw;
            acc_s[c1] = S[kAccS * kBlockCells] + pn * sinw;
            peak[c1] = fmaxf(S[kPeak * kBlockCells], fabsf(pn));
          }
          if (EXTRAS) {
            // extras_accumulate_kernel's Pressure_rms sum, in its order
            if (acc_p2 != nullptr) {
              acc_p2[c1] = S[kP2 * kBlockCells] + pn * pn;
            }
            // the row's listed voxels in plane ip (uniform across the warp)
            if (mon.cell != nullptr) {
              const int end = (ip + 1) * plane;
              for (; e[c] < mon_end[lr[c]]; ++e[c]) {
                const int cell = __ldg(mon.cell + e[c]);
                if (cell >= end) break;
                if (cell == c1 && mon_row >= 0) {
                  mon.series[(long long)mon_row * mon.n_mon +
                             __ldg(mon.slot + e[c])] = pn;
                }
              }
            }
          }
        }
        wv0[c] = wv1[c];
        wv1[c] = wv2[c];
        wv2[c] = wv3[c];
        wv3[c] = vxn;  // 0 past the last plane
      }
    }
    if (more) {
      if (VEC) __syncthreads();  // every cell's slots read: the chunks cross
      issue_own(t + 1);
      // float by float, each copy lands before the barrier (see above)
      if (!VEC) mbar_wait(&bar[(t + 1) & 1], ((t + 1) >> 1) & 1);
      grid.sync();
    }
  }
}

// an instantiation as a launchable function pointer, its dynamic shared
// memory limit raised on the current device
template <bool V, bool D, bool P, bool X, bool E, bool VEC>
cudaError_t prepared(const void** kernel) {
  static int allowed[64] = {0};
  auto kern = &fluid_fused_kernel<V, D, P, X, E, VEC>;
  *kernel = reinterpret_cast<const void*>(kern);
  return allow_smem(kern, allowed, kSmem);
}

using Prep = cudaError_t (*)(const void**);

// the instantiation of (vec, viscous, with_dft, point, xall)
template <int I>
constexpr Prep fused_at() {
  return &prepared<bool(I & 8), bool(I & 4), bool(I & 2), bool(I & 1),
                   false, bool(I & 16)>;
}

// the EXTRAS instantiation of (vec, viscous, point): with the DFT, whole
// grids
template <int I>
constexpr Prep extras_at() {
  return &prepared<bool(I & 2), true, bool(I & 1), true, true, bool(I & 4)>;
}

// the instantiation's preparation (vec: 16-byte copies); null for an
// EXTRAS request outside the window or on a shard
Prep fused_kernel(int viscous, int with_dft, int point, int xall, int extras,
                  int vec) {
  static const Prep kernels[32] = {
      fused_at<0>(),  fused_at<1>(),  fused_at<2>(),  fused_at<3>(),
      fused_at<4>(),  fused_at<5>(),  fused_at<6>(),  fused_at<7>(),
      fused_at<8>(),  fused_at<9>(),  fused_at<10>(), fused_at<11>(),
      fused_at<12>(), fused_at<13>(), fused_at<14>(), fused_at<15>(),
      fused_at<16>(), fused_at<17>(), fused_at<18>(), fused_at<19>(),
      fused_at<20>(), fused_at<21>(), fused_at<22>(), fused_at<23>(),
      fused_at<24>(), fused_at<25>(), fused_at<26>(), fused_at<27>(),
      fused_at<28>(), fused_at<29>(), fused_at<30>(), fused_at<31>()};
  static const Prep with_extras[8] = {
      extras_at<0>(), extras_at<1>(), extras_at<2>(), extras_at<3>(),
      extras_at<4>(), extras_at<5>(), extras_at<6>(), extras_at<7>()};
  if (extras) {
    if (!with_dft || !xall) return nullptr;
    return with_extras[(vec ? 4 : 0) | (viscous ? 2 : 0) | (point ? 1 : 0)];
  }
  return kernels[(vec ? 16 : 0) | (viscous ? 8 : 0) | (with_dft ? 4 : 0) |
                 (point ? 2 : 0) | (xall ? 1 : 0)];
}

}  // namespace

extern "C" {

// *blocks: how many blocks of the (viscous, with_dft, point, xall, extras)
// instantiation the current device holds at once (a cooperative launch may
// not exceed it)
int bb_fluid_fused_capacity(int viscous, int with_dft, int point, int xall,
                            int extras, int* blocks) {
  *blocks = 1 << 30;
  for (int vec = 0; vec < 2; ++vec) {
    const Prep prep =
        fused_kernel(viscous, with_dft, point, xall, extras, vec);
    if (prep == nullptr) return (int)cudaErrorInvalidValue;
    const void* kernel = nullptr;
    int n = 0;
    cudaError_t e = prep(&kernel);
    if (e == cudaSuccess) e = cooperative_capacity(kernel, &n, kSmem);
    if (e != cudaSuccess) return (int)e;
    *blocks = n < *blocks ? n : *blocks;
  }
  return 0;
}

// the tile of the launch: threads along z and y, rows a block, dynamic
// shared memory a block (ops/fdtd_fused_kernels.py checks its geometry
// against it)
int bb_fluid_fused_tile(int* tile_z, int* tile_y, int* rows, int* smem) {
  *tile_z = kTileZ;
  *tile_y = kTileY;
  *rows = kRows;
  *smem = kSmem;
  return 0;
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
  float* p2 = extras ? acc_p2 : nullptr;
  // 16-byte copies where every row of every staged field starts on 16 bytes
  int vec = n3 % 4 == 0;
  for (const void* f : {(const void*)p, (const void*)v3[0],
                        (const void*)v3[1], (const void*)v3[2],
                        (const void*)r, (const void*)idx,
                        (const void*)acc_c, (const void*)acc_s,
                        (const void*)peak, (const void*)p2}) {
    if (reinterpret_cast<unsigned long long>(f) % 16 != 0) vec = 0;
  }
  const Prep prep =
      fused_kernel(viscous, with_dft, point, x_lo && x_hi, extras, vec);
  if (prep == nullptr || k_steps < 1 || k_steps > kMaxSteps ||
      (long long)n1 * n2 * n3 >= (1LL << 31) || !covers(gz, kTileZ, n3) ||
      !covers(gy, kRows, n2) ||
      (extras && mon_cell != nullptr &&
       (mon_start == nullptr || mon_slot == nullptr || series == nullptr ||
        mon_rows == nullptr || n_mon < 1))) {
    return (int)cudaErrorInvalidValue;
  }
  Geo g = make_geo(n1, n2, n3, ns, n1, x_lo, x_hi, 1, 1);
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
  Ptr3 v = gather<3, Ptr3>(v3);
  Ptr6 pp = gather<6, Ptr6>(psi_p6);
  Ptr6 pv = gather<6, Ptr6>(psi_v6);
  int pti = (int)pt;
  void* args[] = {&p,        &v,         &r,      &idx,     &table,
                  &n_mat,    &acc_c,     &acc_s,  &peak,    &pp,
                  &pv,       &prof_half, &prof_int, &amp,   &cph,
                  &sph,      &dt_dx,     &inv_dx, &half_dt, &g,
                  &zsrc,     &pti,       &rw,     &p2,      &mon};
  const void* kernel = nullptr;
  const cudaError_t ready = prep(&kernel);
  if (ready != cudaSuccess) return (int)ready;
  const cudaError_t e = cudaLaunchCooperativeKernel(
      kernel, dim3(gz, gy, k_steps), dim3(kTileZ, kTileY), args, kSmem,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"

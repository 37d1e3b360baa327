// Viscoelastic (shear) FDTD: K leapfrog steps in one launch, one march over
// x, for NVIDIA Hopper (sm_90a). Label mode, indexed materials.
//
// Replaces (TPU kernels of the JAX package in
// babelbrain_tpu/ops/fdtd_pallas.py):
//   build_visco_fused_step (B6, K = 1), build_visco_fused2_step (B7, K = 2)
//   and build_visco_fusedK_step (B8, K >= 2 there, K >= 3 here): the
//   velocity and the stress half-steps of K steps in one sweep over the 15
//   fields (v x3, sigma x6, the SLS memories r x6), with the x, y and z
//   CPML, the indexed table, the plane or point source, and the carrier DFT
//   and |p| peak of every step. Their volumetric (dome) drive is the halo
//   sweep's (fdtd_visco_halo.cu): the dome's planes hold more blocks than
//   this cooperative launch may. Each cell's arithmetic is the pair's, in
//   the pair's order (fdtd_stencil.cuh's stencil and CPML), so K steps of
//   this kernel equal K steps of the pair bit for bit.
//
// What bounds it on this card: the pair is bound by device-memory traffic
// (41 float volumes a step, 47 inside the sensor window; fdtd_visco.cu). A
// sweep reads the 15 fields and the index (and the DFT sums) once and writes
// the 15 fields once: 31 volumes (37) a sweep, 31/K (37/K) a step, if the
// planes in flight stay in the 50 MB L2 between the stages that touch them.
//
// Design (for Hopper): the whole grid marches along x in lockstep, nothing
// recomputed, one copy of every field, updated in place.
//   - The launch is cooperative: blocks (z-tile, y-tile, stage s), all
//     resident at once. A block's 32x6 threads own a tile of 32 (z) x 12
//     (y) columns, kCells = 2 cells a thread kTY rows apart (two
//     independent chains a thread), and do step s of the sweep: at march
//     step t the velocity of plane i = t - kLead - kLag s and the stress of
//     plane i - kStressLag. After each march step a grid-wide barrier
//     (cooperative_groups grid.sync). 12 rows, not 16: the depth the card
//     holds is K = 2 on the main path's planes either way, and there 128
//     tiles (192x240) put two blocks on nearly every SM (256 of 264 slots,
//     768 cells an SM a march step), where 96 tiles of 16 rows put two
//     blocks of 512 cells on 60 SMs and one on the rest: the barrier waits
//     for the SMs with 1024.
//   - The stress's y/z differences read the velocities this block has just
//     computed: the velocity half writes its new vx, vy, vz of plane i into
//     a shared (y, z) ring of kStressLag + 1 planes over the tile and 2
//     cells a side, straight from registers, and the stress of plane i - 2
//     takes all six of its differences from there. Only the ring's outer 2
//     rows and columns come from device memory: the cells the neighbouring
//     blocks wrote at march step t - 2, copied in at step t - 1.
//   - The velocity's y/z differences read five stresses of plane i that
//     stage s - 1 (or the launch's input) wrote: their (y, z) rings over the
//     tile and its halo are copied in a march step ahead into the other half
//     of a double buffer, as are each cell's own old values (v, the
//     stresses, the memories, the DFT sums and peak, the material index, the
//     newest plane of each x-window and the psi value of each CPML'd
//     derivative) into single slots after the step's arithmetic. Every load
//     of the step comes off the dependency chain.
//   - The orders that make this legal: every value copied at march step t
//     for step t + 1 was written at step t - 1 or before and is written by
//     nobody at step t or t + 1 (but a cell's owner, which waits for the
//     copies first). So the stress trails its velocity kStressLag = 2
//     planes (its vy, vz x-window reaches plane i, computed by this thread
//     in this step, and the ring's halo of plane i - 2 was written at t - 2)
//     and stage s + 1 trails stage s by kLag = 6 planes (its sxx x-window
//     takes plane i + 2, which stage s writes at march step t + 4 - kLag,
//     at least two steps before the copy's). ops/fdtd_visco_fused_kernels.py
//     march() lists every copy with the step it is issued in;
//     tests/test_torch_visco_fused.py checks every read against it (kLag =
//     5, kStressLag = 1, or a copy issued two steps ahead, fail).
//   - Where N3 is a multiple of 4 and every staged field starts on 16 bytes
//     (the VEC instantiations: the main path's grids) the copies move whole
//     16-byte chunks of z through L2 only (cp.async.cg; the rings span z0 -
//     4 .. z0 + 35) and each step waits for its copies at its top: they are
//     in flight across the grid barrier. Else they move 4 bytes (cp.async.ca,
//     through L1) and each thread waits for its block's copies before the
//     barrier, so that no L1 line filled after the barrier's fence carries a
//     value another SM writes in the next step (fdtd_fluid_fused.cu). The
//     psi values (4 bytes, only the CPML shell's) are written by their
//     owner alone and read again kLag steps later, past a barrier's fence
//     either way.
//   - The cells' own x-windows stay in registers: sxx at planes i - 1..i +
//     2, sxy and sxz at i - 2..i + 1 (each plane's entry staged once), and
//     this thread's new vx at planes i - 4..i, vy and vz at i - 3..i.
//   - Per-step scalars: the K rows (s_sin, s_cos, cosw, sinw, s_point) of
//     ops/fdtd.py step_scalars, passed by value as float32, the values the
//     pair takes as arguments.
// The depth is bounded by co-residency: K x tiles blocks must fit on the
// card at once (bb_visco_fused_capacity: 2 blocks an SM, kSmem = 103.7 KB
// of shared memory and at most 168 registers a thread, 264 blocks on an
// H100, so K <= 2 on 192x192x240 and 216x216x224 grids); ops/
// fdtd_visco_fused_kernels.py admitted_depth takes the deepest K that fits,
// and ops/fdtd.py visco_plan caps it at the depth measured fastest
// (PERF.md).
//
// Stateful cells: the SLS memories, the psi slabs (x, y, z) and the DFT
// sums are per-cell state, read and written only by the thread that owns
// the cell at each stage. x decomposition: the x_lo / x_hi flags of Geo
// (fdtd_stencil.cuh), with an XALL twin that compiles the whole-grid code,
// as the pair has; ops/fdtd.py runs a shard's extended slab through this
// kernel (overlap and discard).
//
// Rounding: built with --fmad=false; the operation order of the pair and of
// the plain PyTorch versions (ops/fdtd_visco_kernels.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fdtd_stencil.cuh"

// Built once a copy width (ops/_build.py: -DBB_VFUSED_VEC=0, 1), the two
// translation units compiling in parallel; each instantiates its width's
// kernels, and the unit of the 16-byte width also holds the entry points.
#ifndef BB_VFUSED_VEC
#error "build with -DBB_VFUSED_VEC=0 or 1 (ops/_build.py)"
#endif

namespace {

using namespace bb;
namespace cg = cooperative_groups;

constexpr int kLag = 6;        // planes between stage s and s + 1
constexpr int kStressLag = 2;  // planes the stress trails its velocity
constexpr int kLead = 2;       // steps a stage loads its x-windows before
                               // its first velocity plane
constexpr int kMaxSteps = 4;   // rows a launch takes (K_CAP in Python)
constexpr int kTY = 6;         // threads along y
constexpr int kBlock = kTileZ * kTY;
constexpr int kCells = 2;      // cells a thread, kTY rows apart
constexpr int kRows = kTY * kCells;  // rows of a block's tile
// 384 threads an SM (168 registers, 2 x kSmem of shared memory): the
// co-resident blocks bound K
constexpr int kMinBlocksFused = 2;
constexpr float kThird = (float)(1.0 / 3.0);

// table rows (ops/fdtd.py _build_indexed_materials)
constexpr int kRhoInv = 0, kPiU = 1, kMuU = 2, kCRp = 3, kCRs = 4, kBR = 5;

// The stress rings of plane i, one buffer (the velocity's y/z differences),
// whole 16-byte chunks along z: sxy rows y0 - 2 .. y0 + kRows (backward
// along y), syy rows y0 - 1 .. y0 + kRows + 1 (forward), both over the
// tile's columns; syz rows y0 - 2 .. y0 + kRows x columns z0 - 4 .. z0 + 35
// (kZ0: the column of z0; backward along both); sxz, szz the tile's rows x
// columns z0 - 4 .. z0 + 35 (backward, forward along z)
constexpr int kZ0 = 4;
constexpr int kW = kTileZ + 2 * kZ0;
constexpr int kYRing = (kRows + 3) * kTileZ;
constexpr int kYZRing = (kRows + 3) * kW;
constexpr int kZRing = kRows * kW;
constexpr int kSxy = 0, kSyy = kYRing, kSyz = 2 * kYRing,
              kSxz = kSyz + kYZRing, kSzz = kSxz + kZRing;
constexpr int kSRing = kSzz + kZRing;
// The velocity ring (the stress's y/z differences): vx, vy, vz of
// kStressLag + 1 planes (plane p in slot p % kVDepth), rows y0 - 2 .. y0 +
// kRows + 1 x columns z0 - 4 .. z0 + 35; the tile's cells written by this
// block, the rest copied in
constexpr int kVDepth = kStressLag + 1;
constexpr int kVPlane = (kRows + 4) * kW;
constexpr int kVRing = 3 * kVDepth * kVPlane;
// each cell's staged own values, a slot of kBlockCells floats each, the
// cells in the tile's row-major order (row * kTileZ + column)
enum Slot {
  kVx,    // the old velocity of plane i
  kVy,
  kVz,
  kIdxV,  // the material index of plane i (int)
  kWxx,   // the newest x-window entries: sxx of plane i + 2,
  kWxy,   // sxy and sxz of plane i + 1
  kWxz,
  kS0,              // kS0 + a: the old stress a of plane i - 2
  kR0 = kS0 + 6,    // kR0 + a: its SLS memory
  kAccC = kR0 + 6,  // the DFT sums and the peak
  kAccS,
  kPeak,
  kIdxS,  // the material index of plane i - 2 (int)
  kPsiS,  // kPsiS + q: the velocity's derivative q's old psi value
  kPsiV = kPsiS + 9,  // kPsiV + q: the stress's
  kSlots = kPsiV + 9
};
constexpr int kBlockCells = kBlock * kCells;
// dynamic shared memory: two mbarriers, two stress ring buffers (the next
// step's rings land in one while the step reads the other), the velocity
// ring, one set of own slots
constexpr int kSmem =
    16 + (2 * kSRing + kVRing + kSlots * kBlockCells) * (int)sizeof(float);

// the per-step scalars of a launch (ops/fdtd.py step_scalars), row s for
// stage s
struct Rows {
  float s_sin[kMaxSteps], s_cos[kMaxSteps], cosw[kMaxSteps], sinw[kMaxSteps],
      s_pt[kMaxSteps];
};

// Copy `rows` rows of a field's plane `src` (global rows row0.., columns
// col0..) into the ring `dst` of `width` columns: whole 16-byte chunks
// (VEC), else the ring's columns c_lo .. c_hi - 1 float by float; 0 outside
// the grid. Every thread of the block takes a share.
template <bool VEC, int ROWS, int WIDTH, int C_LO, int C_HI>
__device__ __forceinline__ void copy_ring(float* dst, const float* src,
                                          int row0, int col0, const Geo& g,
                                          int tid) {
  if (VEC) {
    constexpr int kCh = WIDTH / 4;
    for (int a = tid; a < ROWS * kCh; a += kBlock) {
      const int row = a / kCh, col = 4 * (a % kCh);
      const int jj = row0 + row, kk = col0 + col;
      const bool ok =
          (unsigned)jj < (unsigned)g.n2 && (unsigned)kk < (unsigned)g.n3;
      cp_async16z(dst + row * WIDTH + col, ok ? src + (jj * g.n3 + kk) : src,
                  ok);
    }
  } else {
    constexpr int kN = C_HI - C_LO;
    for (int a = tid; a < ROWS * kN; a += kBlock) {
      const int row = a / kN, col = C_LO + a % kN;
      const int jj = row0 + row, kk = col0 + col;
      const bool ok =
          (unsigned)jj < (unsigned)g.n2 && (unsigned)kk < (unsigned)g.n3;
      cp_async4z(dst + row * WIDTH + col, ok ? src + (jj * g.n3 + kk) : src,
                 ok);
    }
  }
}

// The halo of one velocity field's ring plane: its rows R[0..2] (ring rows,
// the tile's columns) and, on the tile's rows, its columns beside the tile
// (VEC: the chunks z0 - 4 .. z0 - 1 and z0 + 32 .. z0 + 35; else the ring
// columns Z[0..2]); a = the thread's item, of kVHalo (VEC) or kVHalo4
constexpr int kVHalo = 3 * (kTileZ / 4) + 2 * kRows;
constexpr int kVHalo4 = 3 * kTileZ + 3 * kRows;
template <bool VEC>
__device__ __forceinline__ void copy_halo_item(float* ring, const float* src,
                                               int a, int r0, int r1, int r2,
                                               int z0c, int z1c, int z2c,
                                               int y0, int z0, const Geo& g) {
  int row, col;
  if (VEC) {
    if (a < 3 * (kTileZ / 4)) {
      const int m = a / (kTileZ / 4);
      row = m == 0 ? r0 : (m == 1 ? r1 : r2);
      col = kZ0 + 4 * (a % (kTileZ / 4));
    } else {
      a -= 3 * (kTileZ / 4);
      row = 2 + (a >> 1);
      col = (a & 1) ? kZ0 + kTileZ : 0;
    }
  } else {
    if (a < 3 * kTileZ) {
      const int m = a / kTileZ;
      row = m == 0 ? r0 : (m == 1 ? r1 : r2);
      col = kZ0 + a % kTileZ;
    } else {
      a -= 3 * kTileZ;
      const int m = a / kRows;
      row = 2 + a % kRows;
      col = m == 0 ? z0c : (m == 1 ? z1c : z2c);
    }
  }
  const int jj = y0 - 2 + row, kk = z0 - kZ0 + col;
  const bool ok =
      (unsigned)jj < (unsigned)g.n2 && (unsigned)kk < (unsigned)g.n3;
  const float* p = ok ? src + (jj * g.n3 + kk) : src;
  if (VEC) {
    cp_async16z(ring + row * kW + col, p, ok);
  } else {
    cp_async4z(ring + row * kW + col, p, ok);
  }
}

// the axis of derivative q of the velocity's psi list (d sigma / d axis), or
// of the stress's (STRESS: d(vx)/dx, d(vy)/dy, d(vz)/dz, then the shear
// strains' (y, x), (z, x), (z, y) pairs), as StagedCpml::apply takes them
template <bool STRESS>
__device__ __forceinline__ int psi_axis(int q) {
  if (!STRESS) return q % 3;
  return q < 3 ? q : (q == 3 || q == 8 ? 1 : (q == 4 || q == 6 ? 0 : 2));
}

// stage the old psi value of the first slab of each of a half-step's nine
// derivatives that applies at cell (i, j, k) into slots slot0 + q x
// kBlockCells: an axis's three where the cell lies in one of its slabs
template <bool XALL, bool STRESS>
__device__ __forceinline__ void stage_psi(const Ptr18& psi, const Geo& g,
                                          int i, int j, int k, int jk,
                                          int plane, float* slot0) {
  const Slab b[3] = {slab<0, XALL>(g, i, j, k, jk, plane),
                     slab<1, XALL>(g, i, j, k, jk, plane),
                     slab<2, XALL>(g, i, j, k, jk, plane)};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (b[a].pos >= b[a].lo_end && b[a].pos < b[a].hi_start) continue;
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      if (psi_axis<STRESS>(q) != a) continue;
      cp_async4z(slot0 + q * kBlockCells,
                 slab_src(b[a], psi.p[2 * q], psi.p[2 * q + 1]), true);
    }
  }
}

// The CPML'd derivative number Q of a half-step's psi list along AXIS at a
// cell whose slabs are b[axis], its old psi value staged at slot0 + Q x
// kBlockCells: forward differences (PLUS) take the "half" profiles,
// backward ones the "int" profiles (fdtd_stencil.cuh Cpml)
struct StagedCpml {
  const Ptr18& psi;
  const float* prof_half;
  const float* prof_int;
  const Slab* b;
  int ns;
  const float* slot0;
  template <int AXIS, bool PLUS, int Q>
  __device__ __forceinline__ float apply(float d) const {
    const float* prof = (PLUS ? prof_half : prof_int) + AXIS * 4 * ns;
    return cpml_staged(d, b[AXIS], ns, prof, psi.p[2 * Q], psi.p[2 * Q + 1],
                       slot0 + Q * kBlockCells);
  }
};

// K steps of visco_velocity_kernel then visco_stress_kernel (fdtd_visco.cu)
// in one march. s, r: [xx, yy, zz, xy, xz, yz]; psi_s / psi_v: [lo, hi] of
// the velocity's / the stress's nine derivatives (fdtd_visco.cu).
template <bool VISCOUS, bool WITH_DFT, bool POINT, bool XALL, bool VEC>
__global__ void __launch_bounds__(kBlock, kMinBlocksFused)
    visco_fused_kernel(Ptr3 v, Ptr6 s, Ptr6 r, const int* __restrict__ idx,
                       const float* __restrict__ table, int n_mat,
                       float* __restrict__ acc_c, float* __restrict__ acc_s,
                       float* __restrict__ peak, Ptr18 psi_s, Ptr18 psi_v,
                       const float* __restrict__ prof_half,
                       const float* __restrict__ prof_int,
                       const float* __restrict__ amp,
                       const float* __restrict__ cph,
                       const float* __restrict__ sph, float dt_dx,
                       float inv_dx, float half_dt, Geo g, int zsrc, int pt,
                       Rows rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem);
  float* const srings = reinterpret_cast<float*>(smem + 16);
  float* const vring = srings + 2 * kSRing;
  float* const slots = vring + kVRing;
  cg::grid_group grid = cg::this_grid();
  const int st = blockIdx.z;  // this block's step of the sweep
  const int tid = threadIdx.y * kTileZ + threadIdx.x;
  const int y0 = blockIdx.y * kRows, z0 = blockIdx.x * kTileZ;
  const int k = z0 + threadIdx.x;
  const int plane = g.n2 * g.n3;
  const float s_sin = rows.s_sin[st], s_cos = rows.s_cos[st];
  const float cosw = rows.cosw[st], sinw = rows.sinw[st];
  const float sval = rows.s_pt[st];
  // this thread's cells: rows j[c] of the tile (lr[c] in it)
  int j[kCells], lr[kCells];
  bool in[kCells];
#pragma unroll
  for (int c = 0; c < kCells; ++c) {
    lr[c] = threadIdx.y + c * kTY;
    j[c] = y0 + lr[c];
    in[c] = j[c] < g.n2 && k < g.n3;
  }
  // x-windows: sxx at planes i-1..i+2 (forward), sxy and sxz at i-2..i+1
  // (backward); this thread's new vx at planes i-4..i (the stress of plane
  // i-2 reads i-4..i-1, backward), vy and vz at i-3..i (forward); 0 before
  // plane 0 and past the last
  float wxx[kCells][4], wxy[kCells][4], wxz[kCells][4];
  float wvx[kCells][5], wvy[kCells][4], wvz[kCells][4];
#pragma unroll
  for (int c = 0; c < kCells; ++c) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      wxx[c][m] = wxy[c][m] = wxz[c][m] = 0.0f;
      wvx[c][m] = wvy[c][m] = wvz[c][m] = 0.0f;
    }
    wvx[c][4] = 0.0f;
  }
  if (tid == 0) {
    mbar_init(&bar[0], kBlock);
    mbar_init(&bar[1], kBlock);
  }
  __syncthreads();

  // the rings of march step t1: the five stress rings of its velocity plane
  // into buffer t1 & 1, and the halo of its stress plane's velocity ring
  // (written by the neighbouring blocks at step t1 - 2)
  auto issue_rings = [&](int t1) {
    const int i1 = t1 - kLead - kLag * st;
    const int is1 = i1 - kStressLag;
    if (i1 >= 0 && i1 < g.n1) {
      float* const R = srings + (t1 & 1) * kSRing;
      const int o = i1 * plane;
      copy_ring<VEC, kRows + 3, kTileZ, 0, kTileZ>(R + kSxy, s.p[3] + o,
                                                   y0 - 2, z0, g, tid);
      copy_ring<VEC, kRows + 3, kTileZ, 0, kTileZ>(R + kSyy, s.p[1] + o,
                                                   y0 - 1, z0, g, tid);
      copy_ring<VEC, kRows + 3, kW, kZ0 - 2, kZ0 + kTileZ + 2>(
          R + kSyz, s.p[5] + o, y0 - 2, z0 - kZ0, g, tid);
      copy_ring<VEC, kRows, kW, kZ0 - 2, kZ0 + kTileZ + 2>(
          R + kSxz, s.p[4] + o, y0, z0 - kZ0, g, tid);
      copy_ring<VEC, kRows, kW, kZ0 - 1, kZ0 + kTileZ + 3>(
          R + kSzz, s.p[2] + o, y0, z0 - kZ0, g, tid);
    }
    if (is1 >= 0 && is1 < g.n1) {
      float* const VR = vring + (is1 % kVDepth) * kVPlane;
      const int o = is1 * plane;
      constexpr int kN = VEC ? kVHalo : kVHalo4;
      constexpr int kTop = 1, kBot = kRows + 2;  // ring rows of y0-1, y0+R
      for (int a = tid; a < 3 * kN; a += kBlock) {
        const int f = a / kN, b = a % kN;
        // vx: rows -1, +R, +R+1, columns -1, +32, +33 (forward along y and
        // z); vy: rows -2, -1, +R (backward along y), columns as vx; vz:
        // rows as vx, columns -2, -1, +32 (backward along z)
        const float* const src =
            f == 0 ? v.p[0] : (f == 1 ? v.p[1] : v.p[2]);
        copy_halo_item<VEC>(
            VR + f * kVDepth * kVPlane, src + o, b,
            f == 1 ? 0 : kTop, f == 1 ? kTop : kBot, f == 1 ? kBot : kBot + 1,
            f == 2 ? kZ0 - 2 : kZ0 - 1, f == 2 ? kZ0 - 1 : kZ0 + kTileZ,
            f == 2 ? kZ0 + kTileZ : kZ0 + kTileZ + 1, y0, z0, g);
      }
    }
  };

  // the cells' own values of march step t1 into the slots (the step before
  // has read them); then this thread's arrival on the mbarrier of t1. VEC:
  // 16-byte chunks of four cells of a row, a group of threads a list of
  // fields
  auto issue_own = [&](int t1) {
    const int i1 = t1 - kLead - kLag * st;
    const int is1 = i1 - kStressLag;
    const bool win = i1 >= -kLead && i1 < g.n1 + kStressLag;
    const bool vel = i1 >= 0 && i1 < g.n1;
    const bool str = is1 >= 0 && is1 < g.n1;
    const bool wx = i1 + 2 >= 0 && i1 + 2 < g.n1;  // 0 outside the grid
    const bool wy = i1 + 1 >= 0 && i1 + 1 < g.n1;
    if (VEC) {
      constexpr int kChunks = kBlockCells / 4;
      const int ch = tid % kChunks;
      const int row = ch / (kTileZ / 4), col = 4 * (ch % (kTileZ / 4));
      const bool ok = y0 + row < g.n2 && z0 + col < g.n3;
      const int off = (y0 + row) * g.n3 + z0 + col;
      float* const d = slots + row * kTileZ + col;
      const auto cp = [&](int slot, const void* f, int pl, bool valid) {
        cp_async16z(d + slot * kBlockCells,
                    valid ? static_cast<const float*>(f) + (pl * plane + off)
                          : static_cast<const float*>(f),
                    valid);
      };
      // the own fields in four lists, each taken by a group of kChunks
      // threads, or two lists a group where the block has two groups
      constexpr int kGroups = kBlock / kChunks;
      static_assert(kGroups == 2 || kGroups == 4, "copy groups");
      const int grp = tid / kChunks;
      const auto mine = [&](int list) { return grp == list * kGroups / 4; };
      if (mine(0)) {
        if (win) {
          cp(kWxx, s.p[0], i1 + 2, ok && wx);
          cp(kWxy, s.p[3], i1 + 1, ok && wy);
          cp(kWxz, s.p[4], i1 + 1, ok && wy);
        }
        if (vel) {
          cp(kVx, v.p[0], i1, ok);
          cp(kVy, v.p[1], i1, ok);
          cp(kVz, v.p[2], i1, ok);
          cp(kIdxV, idx, i1, ok);
        }
      }
      if (str) {
        if (mine(1)) {
#pragma unroll
          for (int a = 0; a < 6; ++a) cp(kS0 + a, s.p[a], is1, ok);
        }
        if (VISCOUS && mine(2)) {
#pragma unroll
          for (int a = 0; a < 6; ++a) cp(kR0 + a, r.p[a], is1, ok);
        }
        if (mine(3)) {
          if (WITH_DFT) {
            cp(kAccC, acc_c, is1, ok);
            cp(kAccS, acc_s, is1, ok);
            cp(kPeak, peak, is1, ok);
          }
          cp(kIdxS, idx, is1, ok);
        }
      }
    }
    // 4 bytes: each thread its own cells' values; the psi values of the
    // CPML shell's cells always so
#pragma unroll
    for (int c = 0; c < kCells; ++c) {
      if (!in[c]) continue;
      float* const S = slots + lr[c] * kTileZ + threadIdx.x;
      const int jk = j[c] * g.n3 + k;
      if (!VEC) {
        const auto cp = [&](int slot, const void* f, int pl, bool valid) {
          cp_async4z(S + slot * kBlockCells,
                     valid ? static_cast<const float*>(f) + (pl * plane + jk)
                           : static_cast<const float*>(f),
                     valid);
        };
        if (win) {
          cp(kWxx, s.p[0], i1 + 2, wx);
          cp(kWxy, s.p[3], i1 + 1, wy);
          cp(kWxz, s.p[4], i1 + 1, wy);
        }
        if (vel) {
          cp(kVx, v.p[0], i1, true);
          cp(kVy, v.p[1], i1, true);
          cp(kVz, v.p[2], i1, true);
          cp(kIdxV, idx, i1, true);
        }
        if (str) {
#pragma unroll
          for (int a = 0; a < 6; ++a) {
            cp(kS0 + a, s.p[a], is1, true);
            if (VISCOUS) cp(kR0 + a, r.p[a], is1, true);
          }
          if (WITH_DFT) {
            cp(kAccC, acc_c, is1, true);
            cp(kAccS, acc_s, is1, true);
            cp(kPeak, peak, is1, true);
          }
          cp(kIdxS, idx, is1, true);
        }
      }
      if (vel) {
        stage_psi<XALL, false>(psi_s, g, i1, j[c], k, jk, plane,
                               S + kPsiS * kBlockCells);
      }
      if (str) {
        stage_psi<XALL, true>(psi_v, g, is1, j[c], k, jk, plane,
                              S + kPsiV * kBlockCells);
      }
    }
    cp_async_arrive(&bar[t1 & 1]);
  };

  issue_rings(0);
  issue_own(0);
  mbar_wait(&bar[0], 0);
  const int n_march =
      g.n1 + kLead + kStressLag + kLag * ((int)gridDim.z - 1);
  for (int t = 0; t < n_march; ++t) {
    const int i = t - kLead - kLag * st;  // this stage's velocity plane
    const int is = i - kStressLag;        // and its stress plane
    // VEC: this step's copies were left in flight across the barrier
    if (VEC && t > 0) mbar_wait(&bar[t & 1], (t >> 1) & 1);
    const bool more = t + 1 < n_march;
    if (more) issue_rings(t + 1);
    const float* const R = srings + (t & 1) * kSRing;
    if (i >= -kLead && i < g.n1 + kStressLag) {
#pragma unroll
      for (int c = 0; c < kCells; ++c) {
        const float* const S = slots + lr[c] * kTileZ + threadIdx.x;
        const int jk = j[c] * g.n3 + k;
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          wxx[c][m] = wxx[c][m + 1];
          wxy[c][m] = wxy[c][m + 1];
          wxz[c][m] = wxz[c][m + 1];
        }
        wxx[c][3] = S[kWxx * kBlockCells];
        wxy[c][3] = S[kWxy * kBlockCells];
        wxz[c][3] = S[kWxz * kBlockCells];
        // --- velocity of plane i (visco_velocity_kernel) ---
        float vxn = 0.0f, vyn = 0.0f, vzn = 0.0f;
        if (in[c] && i >= 0 && i < g.n1) {
          const int c0 = i * plane + jk;
          const Slab b[3] = {slab<0, XALL>(g, i, j[c], k, jk, plane),
                             slab<1, XALL>(g, i, j[c], k, jk, plane),
                             slab<2, XALL>(g, i, j[c], k, jk, plane)};
          const float* const ps = S + kPsiS * kBlockCells;
          const int mi =
              reinterpret_cast<const int*>(S)[kIdxV * kBlockCells];
          const float ri = __ldg(table + kRhoInv * n_mat + mi);
          const float vx = S[kVx * kBlockCells], vy = S[kVy * kBlockCells],
                      vz = S[kVz * kBlockCells];
          const int yc = (lr[c] + 2) * kTileZ + threadIdx.x;  // sxy
          const int yf = (lr[c] + 1) * kTileZ + threadIdx.x;  // syy
          const int zc = lr[c] * kW + threadIdx.x + kZ0;      // sxz, szz
          const int yz = (lr[c] + 2) * kW + threadIdx.x + kZ0;  // syz
          const float* const Sxy = R + kSxy;
          const float* const Syy = R + kSyy;
          const float* const Syz = R + kSyz;
          const float* const Sxz = R + kSxz;
          const float* const Szz = R + kSzz;
          const float dsxy_y = stencil(Sxy[yc - 2 * kTileZ], Sxy[yc - kTileZ],
                                       Sxy[yc], Sxy[yc + kTileZ]);
          const float dsxz_z =
              stencil(Sxz[zc - 2], Sxz[zc - 1], Sxz[zc], Sxz[zc + 1]);
          const float dsyy_y = stencil(Syy[yf - kTileZ], Syy[yf],
                                       Syy[yf + kTileZ], Syy[yf + 2 * kTileZ]);
          const float dsyz_z =
              stencil(Syz[yz - 2], Syz[yz - 1], Syz[yz], Syz[yz + 1]);
          const float dsyz_y =
              stencil(Syz[yz - 2 * kW], Syz[yz - kW], Syz[yz], Syz[yz + kW]);
          const float dszz_z =
              stencil(Szz[zc - 1], Szz[zc], Szz[zc + 1], Szz[zc + 2]);
          const StagedCpml cp{psi_s, prof_half, prof_int, b, g.ns, ps};
          const float d0 = cp.template apply<0, true, 0>(
              stencil(wxx[c][0], wxx[c][1], wxx[c][2], wxx[c][3]));
          const float d1 = cp.template apply<1, false, 1>(dsxy_y);
          const float d2 = cp.template apply<2, false, 2>(dsxz_z);
          const float d3 = cp.template apply<0, false, 3>(
              stencil(wxy[c][0], wxy[c][1], wxy[c][2], wxy[c][3]));
          const float d4 = cp.template apply<1, true, 4>(dsyy_y);
          const float d5 = cp.template apply<2, false, 5>(dsyz_z);
          const float d6 = cp.template apply<0, false, 6>(
              stencil(wxz[c][0], wxz[c][1], wxz[c][2], wxz[c][3]));
          const float d7 = cp.template apply<1, false, 7>(dsyz_y);
          const float d8 = cp.template apply<2, true, 8>(dszz_z);
          vzn = vz + dt_dx * ri * (d6 + d7 + d8);
          if (k == zsrc) {
            const int ij = i * g.n2 + j[c];
            const float a = __ldg(amp + ij);
            if (a > 0.0f) {
              vzn = a * (s_sin * __ldg(cph + ij) + s_cos * __ldg(sph + ij));
            }
          }
          vxn = vx + dt_dx * ri * (d0 + d1 + d2);
          vyn = vy + dt_dx * ri * (d3 + d4 + d5);
          v.p[0][c0] = vxn;
          v.p[1][c0] = vyn;
          v.p[2][c0] = vzn;
        }
        // the new velocities into this block's ring (0 off the grid)
        if (i >= 0 && i < g.n1) {
          float* const VR = vring + (i % kVDepth) * kVPlane +
                            (lr[c] + 2) * kW + threadIdx.x + kZ0;
          VR[0] = vxn;
          VR[kVDepth * kVPlane] = vyn;
          VR[2 * kVDepth * kVPlane] = vzn;
        }
#pragma unroll
        for (int m = 0; m < 4; ++m) wvx[c][m] = wvx[c][m + 1];
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          wvy[c][m] = wvy[c][m + 1];
          wvz[c][m] = wvz[c][m + 1];
        }
        wvx[c][4] = vxn;  // 0 past the last plane
        wvy[c][3] = vyn;
        wvz[c][3] = vzn;
        // --- stress of plane is (visco_stress_kernel) ---
        if (in[c] && is >= 0 && is < g.n1) {
          const int c1 = is * plane + jk;
          const Slab b[3] = {slab<0, XALL>(g, is, j[c], k, jk, plane),
                             slab<1, XALL>(g, is, j[c], k, jk, plane),
                             slab<2, XALL>(g, is, j[c], k, jk, plane)};
          const float* const pv = S + kPsiV * kBlockCells;
          const int mi =
              reinterpret_cast<const int*>(S)[kIdxS * kBlockCells];
          const float pi_u = __ldg(table + kPiU * n_mat + mi);
          const float mu_u = __ldg(table + kMuU * n_mat + mi);
          const float c_rp = __ldg(table + kCRp * n_mat + mi);
          const float c_rs = __ldg(table + kCRs * n_mat + mi);
          const float b_r = __ldg(table + kBR * n_mat + mi);
          const float* const VX = vring + (is % kVDepth) * kVPlane;
          const float* const VY = VX + kVDepth * kVPlane;
          const float* const VZ = VY + kVDepth * kVPlane;
          const int x = (lr[c] + 2) * kW + threadIdx.x + kZ0;
          const float dvy_y =
              stencil(VY[x - 2 * kW], VY[x - kW], VY[x], VY[x + kW]);
          const float dvz_z = stencil(VZ[x - 2], VZ[x - 1], VZ[x], VZ[x + 1]);
          const float dvx_y =
              stencil(VX[x - kW], VX[x], VX[x + kW], VX[x + 2 * kW]);
          const float dvx_z = stencil(VX[x - 1], VX[x], VX[x + 1], VX[x + 2]);
          const float dvy_z = stencil(VY[x - 1], VY[x], VY[x + 1], VY[x + 2]);
          const float dvz_y =
              stencil(VZ[x - kW], VZ[x], VZ[x + kW], VZ[x + 2 * kW]);
          const StagedCpml cp{psi_v, prof_half, prof_int, b, g.ns, pv};
          const float dii[3] = {
              cp.template apply<0, false, 0>(
                  stencil(wvx[c][0], wvx[c][1], wvx[c][2], wvx[c][3])),
              cp.template apply<1, false, 1>(dvy_y),
              cp.template apply<2, false, 2>(dvz_z)};
          // shear strains: exy, exz, eyz
          const float e[3] = {
              cp.template apply<1, true, 3>(dvx_y) +
                  cp.template apply<0, true, 4>(
                      stencil(wvy[c][0], wvy[c][1], wvy[c][2], wvy[c][3])),
              cp.template apply<2, true, 5>(dvx_z) +
                  cp.template apply<0, true, 6>(
                      stencil(wvz[c][0], wvz[c][1], wvz[c][2], wvz[c][3])),
              cp.template apply<2, true, 7>(dvy_z) +
                  cp.template apply<1, true, 8>(dvz_y)};
          const float theta = dii[0] + dii[1] + dii[2];
          float sn[6];
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            const float so = S[(kS0 + a) * kBlockCells];
            const float el = pi_u * theta - 2.0f * mu_u * (theta - dii[a]);
            if (VISCOUS) {
              const float ro = S[(kR0 + a) * kBlockCells];
              const float phi = c_rp * theta - 2.0f * c_rs * (theta - dii[a]);
              const float rn = b_r * ro - phi * inv_dx;
              sn[a] = so + dt_dx * el + half_dt * (rn + ro);
              r.p[a][c1] = rn;
            } else {
              sn[a] = so + dt_dx * el;
            }
            if (POINT && c1 == pt) sn[a] = sn[a] + sval;
            s.p[a][c1] = sn[a];
          }
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            const float so = S[(kS0 + 3 + a) * kBlockCells];
            if (VISCOUS) {
              const float ro = S[(kR0 + 3 + a) * kBlockCells];
              const float rn = b_r * ro - c_rs * e[a] * inv_dx;
              sn[3 + a] = so + dt_dx * mu_u * e[a] + half_dt * (rn + ro);
              r.p[3 + a][c1] = rn;
            } else {
              sn[3 + a] = so + dt_dx * mu_u * e[a];
            }
            s.p[3 + a][c1] = sn[3 + a];
          }
          if (WITH_DFT) {
            const float p = -(sn[0] + sn[1] + sn[2]) * kThird;
            acc_c[c1] = S[kAccC * kBlockCells] + p * cosw;
            acc_s[c1] = S[kAccS * kBlockCells] + p * sinw;
            peak[c1] = fmaxf(S[kPeak * kBlockCells], fabsf(p));
          }
        }
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
template <bool V, bool D, bool P, bool X, bool VEC>
cudaError_t prepared(const void** kernel) {
  static int allowed[64] = {0};
  auto kern = &visco_fused_kernel<V, D, P, X, VEC>;
  *kernel = reinterpret_cast<const void*>(kern);
  return allow_smem(kern, allowed, kSmem);
}

using Prep = cudaError_t (*)(const void**);

// the instantiation of (viscous, with_dft, point, xall) at this unit's width
template <int I>
constexpr Prep fused_at() {
  return &prepared<bool(I & 8), bool(I & 4), bool(I & 2), bool(I & 1),
                   bool(BB_VFUSED_VEC)>;
}

}  // namespace

#if BB_VFUSED_VEC
#define BB_VFUSED_PREP bb_visco_fused_prep_vec1
#else
#define BB_VFUSED_PREP bb_visco_fused_prep_vec0
#endif

// this unit's instantiation of (viscous, with_dft, point, xall) as a
// launchable function pointer, its dynamic shared memory limit raised
extern "C" int BB_VFUSED_PREP(int viscous, int with_dft, int point, int xall,
                              const void** kernel) {
  static const Prep kernels[16] = {
      fused_at<0>(),  fused_at<1>(),  fused_at<2>(),  fused_at<3>(),
      fused_at<4>(),  fused_at<5>(),  fused_at<6>(),  fused_at<7>(),
      fused_at<8>(),  fused_at<9>(),  fused_at<10>(), fused_at<11>(),
      fused_at<12>(), fused_at<13>(), fused_at<14>(), fused_at<15>()};
  return (int)kernels[(viscous ? 8 : 0) | (with_dft ? 4 : 0) |
                      (point ? 2 : 0) | (xall ? 1 : 0)](kernel);
}

#if BB_VFUSED_VEC

extern "C" int bb_visco_fused_prep_vec0(int viscous, int with_dft, int point,
                                        int xall, const void** kernel);

namespace {

// the instantiation of (viscous, with_dft, point, xall) at the copy width
// vec, prepared
cudaError_t fused_kernel(int viscous, int with_dft, int point, int xall,
                         int vec, const void** kernel) {
  return (cudaError_t)(vec ? bb_visco_fused_prep_vec1
                           : bb_visco_fused_prep_vec0)(viscous, with_dft,
                                                       point, xall, kernel);
}

}  // namespace

extern "C" {

// *blocks: how many blocks of the (viscous, with_dft, point, xall)
// instantiation the current device holds at once, the fewer of its two
// copy widths (a cooperative launch may not exceed it)
int bb_visco_fused_capacity(int viscous, int with_dft, int point, int xall,
                            int* blocks) {
  *blocks = 1 << 30;
  for (int vec = 0; vec < 2; ++vec) {
    const void* kernel = nullptr;
    int n = 0;
    cudaError_t e = fused_kernel(viscous, with_dft, point, xall, vec, &kernel);
    if (e == cudaSuccess) e = cooperative_capacity(kernel, &n, kSmem, kBlock);
    if (e != cudaSuccess) return (int)e;
    *blocks = n < *blocks ? n : *blocks;
  }
  return 0;
}

// the tile of the launch: threads along z and y, rows a block, dynamic
// shared memory a block (ops/fdtd_visco_fused_kernels.py checks its
// geometry against it)
int bb_visco_fused_tile(int* tile_z, int* tile_y, int* rows, int* smem) {
  *tile_z = kTileZ;
  *tile_y = kTY;
  *rows = kRows;
  *smem = kSmem;
  return 0;
}

// K = k_steps steps in one cooperative launch. v3, s6, r6, psi_s18,
// psi_v18: host arrays of device pointers (as bb_visco_velocity /
// bb_visco_stress); rows: host array of k_steps x (s_sin, s_cos, cosw,
// sinw, s_point); pt: the point source's cell (point); gz, gy: the (z, y)
// tiles of ops/fdtd_visco_fused_kernels.py fused_launch_geometry (the
// grid's third dimension is k_steps)
int bb_visco_fused(float* const* v3, float* const* s6, float* const* r6,
                   const int* idx, const float* table, float* acc_c,
                   float* acc_s, float* peak, float* const* psi_s18,
                   float* const* psi_v18, const float* prof_half,
                   const float* prof_int, const float* amp, const float* cph,
                   const float* sph, const float* rows, int k_steps,
                   float dt_dx, float inv_dx, float half_dt, int n_mat, int n1,
                   int n2, int n3, int ns, int x_lo, int x_hi, int zsrc,
                   int viscous, int with_dft, int point, long long pt, int gz,
                   int gy, void* stream) {
  if (k_steps < 1 || k_steps > kMaxSteps ||
      (long long)n1 * n2 * n3 >= (1LL << 31) || !covers(gz, kTileZ, n3) ||
      !covers(gy, kRows, n2)) {
    return (int)cudaErrorInvalidValue;
  }
  // 16-byte copies where every row of every staged field starts on 16 bytes
  int vec = n3 % 4 == 0;
  const void* staged[] = {v3[0], v3[1], v3[2], s6[0], s6[1], s6[2], s6[3],
                          s6[4], s6[5], r6[0], r6[1], r6[2], r6[3], r6[4],
                          r6[5], idx,   acc_c, acc_s, peak};
  for (const void* f : staged) {
    if (reinterpret_cast<unsigned long long>(f) % 16 != 0) vec = 0;
  }
  Geo g = make_geo(n1, n2, n3, ns, n1, x_lo, x_hi, 1, 1);
  Rows rw{};
  for (int s = 0; s < k_steps; ++s) {
    rw.s_sin[s] = rows[5 * s];
    rw.s_cos[s] = rows[5 * s + 1];
    rw.cosw[s] = rows[5 * s + 2];
    rw.sinw[s] = rows[5 * s + 3];
    rw.s_pt[s] = rows[5 * s + 4];
  }
  Ptr3 v = gather<3, Ptr3>(v3);
  Ptr6 s = gather<6, Ptr6>(s6);
  Ptr6 r = gather<6, Ptr6>(r6);
  Ptr18 ps = gather<18, Ptr18>(psi_s18);
  Ptr18 pv = gather<18, Ptr18>(psi_v18);
  int pti = (int)pt;
  void* args[] = {&v,        &s,       &r,        &idx,    &table,
                  &n_mat,    &acc_c,   &acc_s,    &peak,   &ps,
                  &pv,       &prof_half, &prof_int, &amp,  &cph,
                  &sph,      &dt_dx,   &inv_dx,   &half_dt, &g,
                  &zsrc,     &pti,     &rw};
  const void* kernel = nullptr;
  const cudaError_t ready =
      fused_kernel(viscous, with_dft, point, x_lo && x_hi, vec, &kernel);
  if (ready != cudaSuccess) return (int)ready;
  const cudaError_t e = cudaLaunchCooperativeKernel(
      kernel, dim3(gz, gy, k_steps), dim3(kTileZ, kTY), args, kSmem,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"

#endif  // BB_VFUSED_VEC

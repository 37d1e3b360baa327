// Viscoelastic (shear) FDTD with a volumetric (dome) drive: K leapfrog
// steps a launch in thread-block clusters that recompute a halo, for NVIDIA
// Hopper (sm_90a). Label mode, indexed materials.
//
// Replaces (TPU kernel of the JAX package, babelbrain_tpu/ops/fdtd_pallas.py):
//   build_visco_fusedK_step (B8) with its volumetric drive (volume_src,
//   :4905, streamed at :5043-5045, held in rings at :5136-5138 and
//   :5449-5456, stashed at :5645-5650, injected at :5293-5299), and B6's
//   K = 1 form of it (:3666-3675): K velocity and stress half-steps of a
//   dome run over the 15 fields (v x3, sigma x6, the SLS memories r x6) in
//   one launch, with the x, y and z CPML, the indexed table, the drive after
//   the CPML update of every velocity stage, and the carrier DFT and |p|
//   peak of every step. Each cell's arithmetic is the visco pair's
//   (fdtd_visco.cu) and the scatter's (fdtd_sources.cu
//   velocity_volume_source_kernel), in their order, so K steps of this
//   kernel equal K steps of pair + scatter bit for bit.
//
// What bounds it on this card: pair + scatter move 41 float volumes a step
// (47 in the sensor window; fdtd_visco.cu), device-memory bound. A launch
// here reads the 15 fields, the index and the slot volume once and writes
// the 15 fields once (32 volumes, 38 with the DFT sums and the peak), plus
// the halo each cluster reads again (L2 mostly) and recomputes
// (ops/fdtd_halo_kernels.py HaloGeometry.computed). The first design
// (independent blocks of one thread a column recomputing a 3K ring around a
// 128-256 column tile) computed 2.1-4.3 cells per cell owned, issued
// its loads (the cell's own old values, then the index and the table rows
// through it) after each block barrier, sent the 15 fields and 36 psi slabs
// of the step in between through scratch volumes, and spilled at K = 2; it
// lost to pair + scatter at every K. This design answers each cause:
//
//   1. The cluster, not the block, recomputes the halo. A cluster of
//      ViscoHaloTile<K>::C blocks stacked along y owns TZ x TY columns and
//      computes them extended by H = 3K a side (EZ x EY columns, one thread
//      a column); each block computes a slab of BY rows of it. The rows of
//      a neighbour block that the y stencils reach (2 a side) cross
//      through distributed shared memory instead of being recomputed: each
//      thread of a block's two edge rows stores its values of the rings
//      read across y into the neighbour's ghost rows as well, so every
//      stencil read is local. Those stores are st.async, each signalling
//      its 4 bytes on an mbarrier of the receiving block (two, by march
//      step parity), and a step's edge rows wait for the neighbours' bytes
//      of the step before; a block barrier orders the block's own rings.
//      Two other exchanges measured slower (PERF.md) and were dropped, as
//      in fdtd_fluid_halo.cu: one cluster barrier a march step, whose
//      release / acquire compile to a GPU-scope fence and an L1
//      invalidation every step (10% slower at K = 1), and
//      ld.shared::cluster reads of the neighbour's rings (8% slower at
//      K = 1). Only the cluster's outer edge carries the halo; the exactness rule (`exact`) applies there. 1.6 / 1.7 cells
//      computed per cell owned at K = 1 / 2 on the dome's grid, against
//      2.1 / 4.3.
//   2. The march's loads come off the barrier's critical path.
//      After a march step's work each thread issues cp.async copies of what
//      its column needs at the next step (the six stresses of the next
//      plane, the velocities and memories that stage 0 updates, the
//      material index and the slot) into its own shared-memory slots, so
//      that they fly while the block gathers at the step's barrier; the
//      next step waits on the block's mbarrier for them. The index and the
//      slot stay in a per-column ring of D planes for the later stages, so
//      a table row is gathered from an index already in shared memory.
//      Plain loads after the barrier, where the values are used, measured
//      0.8-10% slower at the dome's grid (PERF.md) and were dropped.
//   3. The state of the step in between stays on chip. A cell's own old
//      values of step s >= 1 are step s - 1's results, which the march
//      already holds: its velocities in step s - 1's velocity rings, its
//      stresses in step s's input rings and sxx window (read before the
//      plane four behind is overwritten), its memories in a shared-memory
//      stash of 4 planes a step (6 fields). Stage 0's own old stresses come
//      the same way from its input rings. Only the CPML psi of the step in
//      between goes through device memory (scratch slabs): it exists only
//      in the slabs along the faces, a thin shell whose share of a column
//      is not known until the march reaches it.
//   4. Registers and occupancy: 456 / 352 threads a block (12 / 8 rows)
//      at K = 1 / 2, so the six x-windows a step (27 floats) fit in
//      115-128 registers without spills at one block an SM (the shared
//      memory, 134 / 225 KB a block, allows one); clusters of 2 / 8 blocks,
//      the fastest of the shapes measured at the dome's grid (PERF.md; at
//      K = 2 a cluster of 2 would own 4 rows).
//
// The march. At march step f the thread takes the input stresses of plane f
// (stage 0's input), then for s = 0..K-1 the velocity of step s at plane
// a = f - 2 - 4s and its stress at plane b = a - 2. A velocity reads the
// stresses 2 planes ahead along x (sxx forward), which the previous step's
// stress produced earlier in this march step; a stress reads vy, vz 2 planes
// ahead (forward), which its own step's velocity produced just before.
// x-windows live in registers (sxx, sxy, sxz for the velocity; vx, vy, vz
// for the stress). The y/z neighbours come from shared memory: rings of 4
// planes per step of the velocity's input sxy, sxz, syy, syz, szz and of the
// stress's input vx, vy, vz, each read by the neighbours 2 march steps after
// it was written. Every cross-thread read is of an earlier march step, so
// the step's barrier orders it (the block barrier for the block's own rows,
// the mbarrier wait for the ghost rows), and no slot is rewritten before
// its last read, also by a neighbour a march step ahead, whose rows of
// step f + 1 may land in the ghost slots while this block reads those of
// step f (ops/fdtd_visco_halo_kernels.py march models the schedule, the
// neighbour's early stores included; tests/test_torch_visco_volume.py
// checks every read, and that ghost rows of 3 planes would not do).
// psi of the step in between: written only where this cluster's step is
// exact; every cluster that writes a cell writes the same bits, and a
// thread reads a scratch cell only after it wrote it itself, or where its
// own result is discarded anyway (exactness only shrinks from step to
// step).
// State is out of place: neighbours read this launch's input state of their
// halo cells, so the kernel reads an input copy and writes an output copy
// (which must not alias it). The DFT sums and the peak belong to owned cells
// only and are updated in place.
// Volume drive: every velocity stage applies it, at halo cells too, so that
// a halo evolves as its owner's interior does: after the CPML update, where
// the dense int32 slot volume holds a source, the three velocities are set
// from its six floats (read through __ldg).
// Whole grids only: both x-CPML slabs are applied (sharded shear runs with a
// volumetric drive keep pair + scatter, ops/fdtd.py).
// ops/fdtd_visco_halo_kernels.py visco_halo_launch_geometry takes
// ViscoHaloTile<K> (checked through bb_visco_halo_tile_k<K> before a depth's
// first launch, with the clusters the card holds at once,
// bb_visco_halo_clusters_k<K>) and cuts x into segments. Each depth is a
// translation unit of its own (-DBB_VHALO_K=K, ops/_build.py), compiled in
// parallel.
//
// Rounding: built with --fmad=false; the operation order of the pair, the
// scatter and the plain PyTorch versions (ops/fdtd_visco_kernels.py,
// ops/fdtd_sources.py).

#include <cuda_runtime.h>

#include "fdtd_stencil.cuh"

#ifndef BB_VHALO_K
#error "compile once per depth with -DBB_VHALO_K=<K> (ops/_build.py)"
#endif

#define BB_CAT2(a, b) a##b
#define BB_CAT(a, b) BB_CAT2(a, b)

namespace {

using namespace bb;

constexpr int kMaxSteps = 2;   // VISCO_HALO_K_CAP in Python
constexpr int kReach = 3;      // cells a step reaches (CONTAMINATION)
constexpr int kLag = 4;        // planes between step s's and s + 1's velocity
constexpr int kStressLag = 2;  // planes a step's stress trails its velocity
constexpr int kRing = 4;       // planes a shared-memory ring holds
constexpr int kFar = 1 << 24;  // distance to an edge beyond the grid's
constexpr float kThird = (float)(1.0 / 3.0);

static_assert(BB_VHALO_K >= 1 && BB_VHALO_K <= kMaxSteps, "depth 1..2");

// A stage's state in device memory: the 15 fields, then the velocity's 18
// psi slabs, then the stress's 18 ([lo, hi] of each derivative of
// ops/fdtd_visco_kernels.py VELOCITY_DERIVS / STRESS_DERIVS)
constexpr int kVX = 0, kVY = 1, kVZ = 2;
constexpr int kS = 3;        // sxx, syy, szz, sxy, sxz, syz
constexpr int kR = 9;        // rxx, ryy, rzz, rxy, rxz, ryz
constexpr int kPsiS = 15;
constexpr int kPsiV = 33;
constexpr int kStage = 51;
// the shared-memory rings of a step: its velocity's input stresses (the
// ones read across y or z), then its velocities
constexpr int kSXY = 0, kSXZ = 1, kSYY = 2, kSYZ = 3, kSZZ = 4;
constexpr int kRVX = 5, kRVY = 6, kRVZ = 7;
constexpr int kRings = 8;
// the staged values of a march step: the stresses of plane f, v of plane
// f - 2, the memories of plane f - 4
constexpr int kStS = 0, kStV = 6, kStR = 9;
constexpr int kStaged = 15;

// table rows (ops/fdtd.py _build_indexed_materials)
constexpr int kRhoInv = 0, kPiU = 1, kMuU = 2, kCRp = 3, kCRs = 4, kBR = 5;

// The cluster of a K-step launch: C blocks stacked along y own TZ x TY (z,
// y) columns, computed extended by H = 3K a side (EZ x EY); each block
// computes BY rows of the extended tile, one thread a column. Shared memory
// (words): the mbarrier (4), the rings, the memories' stash (steps
// 0..K-2), the staged values and the index and slot rings of D planes
// (ops/fdtd_visco_halo_kernels.py VISCO_HALO_TILES).
template <int K>
struct ViscoHaloTile {
  static constexpr int TZ = 32;
  static constexpr int BY = (K == 1) ? 12 : 8;
  static constexpr int C = (K == 1) ? 2 : 8;
  static constexpr int H = kReach * K;
  static constexpr int EZ = TZ + 2 * H;
  static constexpr int EY = C * BY;
  static constexpr int TY = EY - 2 * H;
  static constexpr int THREADS = EZ * BY;
  // planes the index and slot rings hold: stage 0's velocity plane down to
  // stage K - 1's stress plane, and the plane staged a step ahead (4K)
  static constexpr int D = 8;
  // a ring plane: the block's rows and two ghost rows below and above
  // that the neighbours store into (those of the cluster's outer edge stay
  // 0), with ZPAD also two zero columns each side (no bounds check a
  // stencil tap: taken at the depth where it measured faster, K = 2)
  static constexpr bool ZPAD = K == 2;
  static constexpr int RW = ZPAD ? EZ + 4 : EZ;
  static constexpr int RP = RW * (BY + 4);
  static constexpr int RINGS = 8;  // after the mbarriers (3 x 8 bytes)
  static constexpr int RINGS_END = RINGS + K * kRings * kRing * RP;
  static constexpr int STASH = RINGS_END;
  static constexpr int STAGED = STASH + (K - 1) * 6 * kRing * THREADS;
  static constexpr int IDX = STAGED + kStaged * THREADS;
  static constexpr int SLOT = IDX + D * THREADS;
  static constexpr int SMEM = (SLOT + D * THREADS) * (int)sizeof(float);
};

// stage s's state (stage 0 the input, stage K the output; the fields of the
// stages in between are not used)
struct Stages {
  float* q[kMaxSteps + 1][kStage];
};
// the per-step scalars (ops/fdtd.py step_scalars), row s for step s
struct Rows {
  float s_sin[kMaxSteps], s_cos[kMaxSteps], cosw[kMaxSteps], sinw[kMaxSteps];
};

// shift v into an x-window (w[N - 1] the newest plane)
template <int N>
__device__ __forceinline__ void push(float (&w)[N], float v) {
#pragma unroll
  for (int m = 0; m + 1 < N; ++m) w[m] = w[m + 1];
  w[N - 1] = v;
}

// K steps of visco_velocity_kernel, velocity_volume_source_kernel and
// visco_stress_kernel in one march of clusters
template <int K, bool VISCOUS, bool WITH_DFT>
__global__ void __launch_bounds__(ViscoHaloTile<K>::THREADS, 1)
    visco_halo_kernel(Stages st, const int* __restrict__ idx,
                      const float* __restrict__ table, int n_mat,
                      float* __restrict__ acc_c, float* __restrict__ acc_s,
                      float* __restrict__ peak,
                      const float* __restrict__ prof_half,
                      const float* __restrict__ prof_int,
                      const float* __restrict__ amp,
                      const float* __restrict__ cph,
                      const float* __restrict__ sph, VolSrc vs, float dt_dx,
                      float inv_dx, float half_dt, Geo g, int zsrc,
                      Rows rows) {
  using T = ViscoHaloTile<K>;
  constexpr int E = T::THREADS;
  extern __shared__ __align__(16) float sm[];
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(sm);
  int* const smi = reinterpret_cast<int*>(sm);
  const int tid = threadIdx.x;
  const int rank = cluster_rank();
  const int ry = tid / T::EZ, ez = tid - ry * T::EZ;
  const int ey = rank * T::BY + ry;  // row of the cluster's extended tile
  const int y0 = (blockIdx.y / T::C) * T::TY - T::H;
  const int z0 = blockIdx.x * T::TZ - T::H;
  const int y = y0 + ey, z = z0 + ez;
  const bool inside = y >= 0 && y < g.n2 && z >= 0 && z < g.n3;
  const bool owned_col = inside && ey >= T::H && ey < T::H + T::TY &&
                         ez >= T::H && ez < T::H + T::TZ;
  const int plane = g.n2 * g.n3;
  const int jk = inside ? y * g.n3 + z : 0;
  // owned planes [x0, x1), marched planes [xs, xe]
  const int x0 = blockIdx.z * g.seg;
  const int x1 = min(g.n1, x0 + g.seg);
  const int xs = max(0, x0 - T::H);
  const int xe = min(g.n1 - 1, x1 - 1 + T::H);
  // distance to the nearest edge of the cluster's extended tile that lies
  // inside the grid, below and above (what lies beyond such an edge is not
  // known here: the values it reaches are discarded); an edge at the grid's
  // is exact
  const int lat_lo = min(y0 <= 0 ? kFar : ey, z0 <= 0 ? kFar : ez);
  const int lat_hi = min(y0 + T::EY >= g.n2 ? kFar : T::EY - 1 - ey,
                         z0 + T::EZ >= g.n3 ? kFar : T::EZ - 1 - ez);
  const int ns = g.ns;
  // this block's shared memory in the windows of the ranks below and above
  const unsigned own_base = smem_u32(sm);
  const unsigned below = rank > 0 ? map_rank(own_base, rank - 1) : 0u;
  const unsigned above = rank + 1 < T::C ? map_rank(own_base, rank + 1) : 0u;
  // the two mbarriers (by step parity) of the ghost rows the
  // neighbours push, here and in the neighbours' windows; the bytes a step
  // brings (each of its 6 * K ring stores that a y stencil reads, from
  // the two edge rows of each neighbour); the rows that read ghost rows
  unsigned long long* const xbar = bar + 1;
  const unsigned xb_below = rank > 0 ? map_rank(smem_u32(xbar), rank - 1) : 0u;
  const unsigned xb_above =
      rank + 1 < T::C ? map_rank(smem_u32(xbar), rank + 1) : 0u;
  const unsigned x_bytes = (6 * K) * 2 * T::EZ * 4 *
                           ((rank > 0 ? 1 : 0) + (rank + 1 < T::C ? 1 : 0));
  const bool edge = ry < 2 || ry >= T::BY - 2;
  unsigned xpar = 0;  // the parity of the current march step

  // word offset of step s's ring r at plane i
  auto ring = [&](int s, int r, int i) -> int {
    return T::RINGS + ((s * kRings + r) * kRing + (i & (kRing - 1))) * T::RP;
  };
  // this thread's word in a ring plane
  const int lw = (ry + 2) * T::RW + ez + (T::ZPAD ? 2 : 0);
  // a y/z neighbour in a ring plane: this block's, a neighbour block's
  // (stored here by it through distributed shared memory) or 0 outside the
  // cluster's extended tile (threads off the grid store 0)
  auto lat = [&](int r, int dy, int dz) -> float {
    const int w = r + lw + dy * T::RW + dz;
    if constexpr (T::ZPAD) {
      return sm[w];  // 0 in the pads and the cluster's outer ghost rows
    } else {
      return (unsigned)(ez + dz) < (unsigned)T::EZ ? sm[w] : 0.0f;
    }
  };
  // this thread's value in a ring plane
  auto mine = [&](int r) -> float& { return sm[r + lw]; };
  // store this thread's value into a ring plane, and into the ghost rows
  // of the neighbour whose stencils reach it
  auto put = [&](int r, float v) {
    sm[r + lw] = v;
    if (ry < 2 && rank > 0) {
      st_async(below + 4u * (r + lw + T::BY * T::RW), v,
               xb_below + 8u * xpar);
    }
    if (ry >= T::BY - 2 && rank + 1 < T::C) {
      st_async(above + 4u * (r + lw - T::BY * T::RW), v,
               xb_above + 8u * xpar);
    }
  };
  // backward (d_minus: -2..+1) and forward (d_plus: -1..+2) differences
  // along y (dy = 1) or z (dz = 1) in a ring plane
  auto back = [&](int r, int dy, int dz) {
    return stencil(lat(r, -2 * dy, -2 * dz), lat(r, -dy, -dz), mine(r),
                   lat(r, dy, dz));
  };
  auto fwd = [&](int r, int dy, int dz) {
    return stencil(lat(r, -dy, -dz), mine(r), lat(r, dy, dz),
                   lat(r, 2 * dy, 2 * dz));
  };
  auto marched = [&](int i) { return inside && i >= xs && i <= xe; };
  auto own = [&](int i) { return owned_col && i >= x0 && i < x1; };
  // a value at plane i is exact when no cut edge lies within d cells: a
  // step's velocity reaches 3s + 2, its stress 3s + 3 (s from 0)
  auto exact = [&](int i, int d) {
    return min(lat_lo, xs == 0 ? kFar : i - xs) >= d &&
           min(lat_hi, xe == g.n1 - 1 ? kFar : xe - i) >= d;
  };
  // the memories' stash of step s at plane i (field m)
  auto stash = [&](int s, int m, int i) -> float& {
    return sm[T::STASH + ((s * 6 + m) * kRing + (i & (kRing - 1))) * E + tid];
  };
  auto idx_of = [&](int i) -> int& {
    return smi[T::IDX + (i & (T::D - 1)) * E + tid];
  };
  auto slot_of = [&](int i) -> int& {
    return smi[T::SLOT + (i & (T::D - 1)) * E + tid];
  };
  // whether this column lies in a y or z CPML slab (else those derivatives
  // pass through unchanged, as cpml_io would leave them)
  const bool in_y = y < ns || y >= g.n2 - ns;
  const bool in_z = z < ns || z >= g.n3 - ns;
  // the CPML'd derivative whose [lo, hi] slabs are fields m, m + 1 of a
  // stage, along x, y or z at plane i, from stage s's psi into stage s + 1's
  auto cpml_x = [&](float d, int s, int m, const float* prof, int i,
                    bool keep) {
    return cpml_io(d, i, g.xlo, g.xhi, ns, prof, st.q[s][m], st.q[s][m + 1],
                   st.q[s + 1][m], st.q[s + 1][m + 1], jk, plane, keep);
  };
  auto cpml_y = [&](float d, int s, int m, const float* prof, int i,
                    bool keep) {
    if (!in_y) return d;
    return cpml_io(d, y, ns, g.n2 - ns, ns, prof + 4 * ns, st.q[s][m],
                   st.q[s][m + 1], st.q[s + 1][m], st.q[s + 1][m + 1],
                   i * ns * g.n3 + z, g.n3, keep);
  };
  auto cpml_z = [&](float d, int s, int m, const float* prof, int i,
                    bool keep) {
    if (!in_z) return d;
    return cpml_io(d, z, ns, g.n3 - ns, ns, prof + 8 * ns, st.q[s][m],
                   st.q[s][m + 1], st.q[s + 1][m], st.q[s + 1][m + 1],
                   (i * g.n2 + y) * ns, 1, keep);
  };
  // the values march step f takes from global memory: the stresses of
  // plane f, v, the index and the slot of plane f - 2, the memories of
  // plane f - 4 (0 off the marched planes), copied a step ahead
  auto stage = [&](int f) {
    const int ci = f * plane + jk, cv = (f - 2) * plane + jk;
    const int cr = (f - 4) * plane + jk;
    const bool mi = marched(f), mv = marched(f - 2), mr = marched(f - 4);
    float* sg = sm + T::STAGED + tid;
#pragma unroll
    for (int m = 0; m < 6; ++m) {
      cp_async4z(sg + (kStS + m) * E, st.q[0][kS + m] + (mi ? ci : 0), mi);
    }
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      cp_async4z(sg + (kStV + m) * E, st.q[0][kVX + m] + (mv ? cv : 0), mv);
    }
    if constexpr (VISCOUS) {
#pragma unroll
      for (int m = 0; m < 6; ++m) {
        cp_async4z(sg + (kStR + m) * E, st.q[0][kR + m] + (mr ? cr : 0), mr);
      }
    }
    cp_async4z(&idx_of(f - 2), idx + (mv ? cv : 0), mv);
    cp_async4z(&slot_of(f - 2), vs.slot + (mv ? cv : 0), mv);
    cp_async_arrive(bar);
  };

  // x-windows of step s: its velocity's sxx at a-1..a+2, sxy and sxz at
  // a-2..a+2 (the newest not read yet); its stress's vx at b-2..b+2, vy and
  // vz at b-1..b+2
  float wxx[K][4], wxy[K][5], wxz[K][5], wvx[K][5], wvy[K][4], wvz[K][4];
#pragma unroll
  for (int s = 0; s < K; ++s) {
#pragma unroll
    for (int m = 0; m < 5; ++m) {
      wxy[s][m] = wxz[s][m] = wvx[s][m] = 0.0f;
      if (m < 4) wxx[s][m] = wvy[s][m] = wvz[s][m] = 0.0f;
    }
  }

  // step s's input stresses of plane i: the x-windows and the rings
  auto take_stress = [&](int s, int i, const float (&sv)[6]) {
    push(wxx[s], sv[0]);
    push(wxy[s], sv[3]);
    push(wxz[s], sv[4]);
    put(ring(s, kSXY, i), sv[3]);
    mine(ring(s, kSXZ, i)) = sv[4];  // read across z only
    put(ring(s, kSYY, i), sv[1]);
    put(ring(s, kSYZ, i), sv[5]);
    mine(ring(s, kSZZ, i)) = sv[2];  // read across z only
  };
  // step s's input stresses of plane i - 4 (the own column's, step s's
  // stress plane when step s takes plane i), read before take_stress(s, i)
  // overwrites them
  auto old_stress = [&](int s, int i, float (&so)[6]) {
    so[0] = wxx[s][0];
    so[1] = mine(ring(s, kSYY, i));
    so[2] = mine(ring(s, kSZZ, i));
    so[3] = mine(ring(s, kSXY, i));
    so[4] = mine(ring(s, kSXZ, i));
    so[5] = mine(ring(s, kSYZ, i));
  };

  if (tid == 0) {
    mbar_init(bar, E);
    mbar_init(xbar, 1);
    mbar_init(xbar + 1, 1);
  }
  // the pads and ghost rows start at 0
  for (int w = tid; w < T::RINGS_END - T::RINGS; w += E) {
    sm[T::RINGS + w] = 0.0f;
  }
  // every block of the cluster has started (its shared memory may be
  // written) and the mbarriers are initialised
  cluster_arrive();
  cluster_wait();
  if (tid == 0) mbar_expect(xbar, x_bytes);  // the first step's
  stage(xs);

  const int f_end = x1 - 1 + kLag * K;  // step K - 1's stress of plane x1 - 1
  for (int f = xs; f <= f_end; ++f) {
    // the ghost rows of the step before have landed; this step's phase
    // expects the neighbours' bytes (its mbarrier's phase two steps back
    // completed: this thread waited on it a step ago)
    const int j = f - xs;
    xpar = (unsigned)j & 1u;
    if (j > 0) {
      if (edge) mbar_wait(xbar + ((j - 1) & 1), ((j - 1) >> 1) & 1);
      if (tid == 0) mbar_expect(xbar + (j & 1), x_bytes);
    }
    mbar_wait(bar, (unsigned)j & 1u);
    const float* sg = sm + T::STAGED + tid;
    float so[6], ro[6], vo[3];  // the own old values of the current step
    {  // stage 0's input: the stresses of plane f
      float sv[6];
#pragma unroll
      for (int m = 0; m < 6; ++m) sv[m] = sg[(kStS + m) * E];
      old_stress(0, f, so);
      take_stress(0, f, sv);
    }
#pragma unroll
    for (int m = 0; m < 3; ++m) vo[m] = sg[(kStV + m) * E];
#pragma unroll
    for (int m = 0; m < 6; ++m) ro[m] = VISCOUS ? sg[(kStR + m) * E] : 0.0f;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const int a = f - 2 - kLag * s;  // velocity plane of step s
      const int b = a - kStressLag;    // stress plane of step s
      // --- velocity of plane a (visco_velocity_kernel, then the scatter) ---
      float vxn = 0.0f, vyn = 0.0f, vzn = 0.0f;
      if (marched(a)) {
        const int c = a * plane + jk;
        const int rxy = ring(s, kSXY, a);
        const int rxz = ring(s, kSXZ, a);
        const int ryy = ring(s, kSYY, a);
        const int ryz = ring(s, kSYZ, a);
        const int rzz = ring(s, kSZZ, a);
        const float dsxy_y = back(rxy, 1, 0);
        const float dsxz_z = back(rxz, 0, 1);
        const float dsyy_y = fwd(ryy, 1, 0);
        const float dsyz_z = back(ryz, 0, 1);
        const float dsyz_y = back(ryz, 1, 0);
        const float dszz_z = fwd(rzz, 0, 1);
        const float ri = __ldg(table + kRhoInv * n_mat + idx_of(a));
        const bool keep =
            (s == K - 1) ? own(a) : exact(a, kReach * s + 2);
        const float d0 = cpml_x(
            stencil(wxx[s][0], wxx[s][1], wxx[s][2], wxx[s][3]), s,
            kPsiS + 0, prof_half, a, keep);
        const float d1 = cpml_y(dsxy_y, s, kPsiS + 2, prof_int, a, keep);
        const float d2 = cpml_z(dsxz_z, s, kPsiS + 4, prof_int, a, keep);
        const float d3 = cpml_x(
            stencil(wxy[s][0], wxy[s][1], wxy[s][2], wxy[s][3]), s,
            kPsiS + 6, prof_int, a, keep);
        const float d4 = cpml_y(dsyy_y, s, kPsiS + 8, prof_half, a, keep);
        const float d5 = cpml_z(dsyz_z, s, kPsiS + 10, prof_int, a, keep);
        const float d6 = cpml_x(
            stencil(wxz[s][0], wxz[s][1], wxz[s][2], wxz[s][3]), s,
            kPsiS + 12, prof_int, a, keep);
        const float d7 = cpml_y(dsyz_y, s, kPsiS + 14, prof_int, a, keep);
        const float d8 = cpml_z(dszz_z, s, kPsiS + 16, prof_half, a, keep);
        vzn = vo[2] + dt_dx * ri * (d6 + d7 + d8);
        if (z == zsrc) {
          const int ij = a * g.n2 + y;
          const float am = __ldg(amp + ij);
          if (am > 0.0f) {
            vzn = am * (rows.s_sin[s] * __ldg(cph + ij) +
                        rows.s_cos[s] * __ldg(sph + ij));
          }
        }
        vxn = vo[0] + dt_dx * ri * (d0 + d1 + d2);
        vyn = vo[1] + dt_dx * ri * (d3 + d4 + d5);
        const int qv = slot_of(a);
        if (qv >= 0) {
          const float sv =
              __ldg(vs.amp + qv) * (rows.s_sin[s] * __ldg(vs.cph + qv) +
                                    rows.s_cos[s] * __ldg(vs.sph + qv));
          vxn = sv * __ldg(vs.ox + qv);
          vyn = sv * __ldg(vs.oy + qv);
          vzn = sv * __ldg(vs.oz + qv);
        }
        if (s == K - 1 && keep) {
          st.q[K][kVX][c] = vxn;
          st.q[K][kVY][c] = vyn;
          st.q[K][kVZ][c] = vzn;
        }
      }
      float vo_next[3];  // step s + 1's own old velocities: plane a - 4
      if (s + 1 < K) {
        vo_next[0] = mine(ring(s, kRVX, a));
        vo_next[1] = mine(ring(s, kRVY, a));
        vo_next[2] = mine(ring(s, kRVZ, a));
      }
      put(ring(s, kRVX, a), vxn);  // 0 off the marched planes
      put(ring(s, kRVY, a), vyn);
      put(ring(s, kRVZ, a), vzn);
      push(wvx[s], vxn);
      push(wvy[s], vyn);
      push(wvz[s], vzn);
      // --- stress of plane b (visco_stress_kernel) ---
      float sn[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      float rn[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (marched(b)) {
        const int c = b * plane + jk;
        const int mi = idx_of(b);
        const float pi_u = __ldg(table + kPiU * n_mat + mi);
        const float mu_u = __ldg(table + kMuU * n_mat + mi);
        const float c_rp = __ldg(table + kCRp * n_mat + mi);
        const float c_rs = __ldg(table + kCRs * n_mat + mi);
        const float b_r = __ldg(table + kBR * n_mat + mi);
        const int rvx = ring(s, kRVX, b);
        const int rvy = ring(s, kRVY, b);
        const int rvz = ring(s, kRVZ, b);
        const float dvy_y = back(rvy, 1, 0);
        const float dvz_z = back(rvz, 0, 1);
        const float dvx_y = fwd(rvx, 1, 0);
        const float dvx_z = fwd(rvx, 0, 1);
        const float dvy_z = fwd(rvy, 0, 1);
        const float dvz_y = fwd(rvz, 1, 0);
        const bool keep =
            (s == K - 1) ? own(b) : exact(b, kReach * s + 3);
        const float dii[3] = {
            cpml_x(stencil(wvx[s][0], wvx[s][1], wvx[s][2], wvx[s][3]), s,
                   kPsiV + 0, prof_int, b, keep),
            cpml_y(dvy_y, s, kPsiV + 2, prof_int, b, keep),
            cpml_z(dvz_z, s, kPsiV + 4, prof_int, b, keep)};
        // shear strains: exy, exz, eyz
        const float e[3] = {
            cpml_y(dvx_y, s, kPsiV + 6, prof_half, b, keep) +
                cpml_x(stencil(wvy[s][0], wvy[s][1], wvy[s][2], wvy[s][3]),
                       s, kPsiV + 8, prof_half, b, keep),
            cpml_z(dvx_z, s, kPsiV + 10, prof_half, b, keep) +
                cpml_x(stencil(wvz[s][0], wvz[s][1], wvz[s][2], wvz[s][3]),
                       s, kPsiV + 12, prof_half, b, keep),
            cpml_z(dvy_z, s, kPsiV + 14, prof_half, b, keep) +
                cpml_y(dvz_y, s, kPsiV + 16, prof_half, b, keep)};
        const float theta = dii[0] + dii[1] + dii[2];
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          const float el = pi_u * theta - 2.0f * mu_u * (theta - dii[m]);
          if (VISCOUS) {
            const float phi = c_rp * theta - 2.0f * c_rs * (theta - dii[m]);
            rn[m] = b_r * ro[m] - phi * inv_dx;
            sn[m] = so[m] + dt_dx * el + half_dt * (rn[m] + ro[m]);
          } else {
            sn[m] = so[m] + dt_dx * el;
          }
        }
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          if (VISCOUS) {
            rn[3 + m] = b_r * ro[3 + m] - c_rs * e[m] * inv_dx;
            sn[3 + m] = so[3 + m] + dt_dx * mu_u * e[m] +
                        half_dt * (rn[3 + m] + ro[3 + m]);
          } else {
            sn[3 + m] = so[3 + m] + dt_dx * mu_u * e[m];
          }
        }
        if (s == K - 1 && keep) {
#pragma unroll
          for (int m = 0; m < 6; ++m) {
            st.q[K][kS + m][c] = sn[m];
            if (VISCOUS) st.q[K][kR + m][c] = rn[m];
          }
        }
        if (WITH_DFT && own(b)) {
          const float p = -(sn[0] + sn[1] + sn[2]) * kThird;
          acc_c[c] = acc_c[c] + p * rows.cosw[s];
          acc_s[c] = acc_s[c] + p * rows.sinw[s];
          peak[c] = fmaxf(peak[c], fabsf(p));
        }
      }
      if (s + 1 < K) {
        // step s + 1's own old values of its stress plane b - 4: the
        // memories from the stash, the stresses from its input rings, each
        // read before this plane's values take the slot
        if constexpr (VISCOUS) {
#pragma unroll
          for (int m = 0; m < 6; ++m) {
            const float r_old = stash(s, m, b);
            stash(s, m, b) = rn[m];
            ro[m] = r_old;
          }
        }
        old_stress(s + 1, b, so);
        take_stress(s + 1, b, sn);  // step s + 1's input
#pragma unroll
        for (int m = 0; m < 3; ++m) vo[m] = vo_next[m];
      }
    }
    // this march step's ring planes written and its reads of earlier ones
    // done: the next step reads the former and rewrites older slots. The
    // next step's copies fly while the block gathers at the barrier.
    if (f < f_end) stage(f + 1);
    __syncthreads();
  }
  // the last step's ghost rows have landed before any block leaves
  const int j = f_end - xs;
  if (edge) mbar_wait(xbar + (j & 1), (j >> 1) & 1);
  cluster_arrive();
  cluster_wait();
}

// the kernel's arguments, as the entry point gathers them
struct Args {
  Stages st;
  const int* idx;
  const float* table;
  int n_mat;
  float *acc_c, *acc_s, *peak;
  const float *prof_half, *prof_int, *amp, *cph, *sph;
  VolSrc vs;
  float dt_dx, inv_dx, half_dt;
  Geo g;
  int zsrc;
  Rows rows;
};

template <bool VISCOUS, bool WITH_DFT>
cudaError_t go(const Args& a, dim3 grid, cudaStream_t stream) {
  constexpr int K = BB_VHALO_K;
  using T = ViscoHaloTile<K>;
  auto kern = &visco_halo_kernel<K, VISCOUS, WITH_DFT>;
  static int allowed[64] = {0};
  const cudaError_t e = allow_smem(kern, allowed, T::SMEM);
  if (e != cudaSuccess) return e;
  const cudaError_t l = launch_cluster(
      kern, grid, T::THREADS, T::SMEM, T::C, stream, a.st, a.idx, a.table,
      a.n_mat, a.acc_c, a.acc_s, a.peak, a.prof_half, a.prof_int, a.amp,
      a.cph, a.sph, a.vs, a.dt_dx, a.inv_dx, a.half_dt, a.g, a.zsrc, a.rows);
  const cudaError_t last = cudaGetLastError();
  return l != cudaSuccess ? l : last;
}

// the clusters of the viscous instantiation the card holds at once
cudaError_t clusters(int* n) {
  constexpr int K = BB_VHALO_K;
  using T = ViscoHaloTile<K>;
  auto kern = &visco_halo_kernel<K, true, false>;
  static int allowed[64] = {0};
  const cudaError_t e = allow_smem(kern, allowed, T::SMEM);
  if (e != cudaSuccess) return e;
  return active_clusters(kern, T::THREADS, T::SMEM, T::C, n);
}

}  // namespace

extern "C" {

// *tz, *by, *cluster: the owned z columns of a cluster, the rows of a block
// and the blocks of a cluster at this depth (ViscoHaloTile<K>), which
// ops/fdtd_visco_halo_kernels.py's launch geometry must match
int BB_CAT(bb_visco_halo_tile_k, BB_VHALO_K)(int* tz, int* by, int* cluster) {
  *tz = ViscoHaloTile<BB_VHALO_K>::TZ;
  *by = ViscoHaloTile<BB_VHALO_K>::BY;
  *cluster = ViscoHaloTile<BB_VHALO_K>::C;
  return 0;
}

// *n: the clusters of this depth's viscous instantiation the current
// device holds at once
int BB_CAT(bb_visco_halo_clusters_k, BB_VHALO_K)(int* n) {
  *n = 0;
  return (int)clusters(n);
}

// K = BB_VHALO_K steps in one launch of a whole grid. q: host array of
// (K + 1) x 51 device pointers, stage s's state (vx, vy, vz, sxx, syy, szz,
// sxy, sxz, syz, rxx, ryy, rzz, rxy, rxz, ryz, the velocity's 18 psi slabs,
// the stress's 18): stage 0 the input, stage K the output, the stages in
// between psi slabs only (their 15 field pointers null), no pointer in two
// stages; acc_c, acc_s, peak in place; slot: the slot volume and src6 a host
// array of the sparse source's amp, cph, sph, ox, oy, oz; rows: host array
// of K x (s_sin, s_cos, cosw, sinw); seg and the grid (gz, gy, gx):
// ops/fdtd_visco_halo_kernels.py visco_halo_launch_geometry (gy: y-tiles of
// clusters times the cluster).
int BB_CAT(bb_visco_halo_k, BB_VHALO_K)(
    float* const* q, const int* idx, const float* table, float* acc_c,
    float* acc_s, float* peak, const float* prof_half, const float* prof_int,
    const float* amp, const float* cph, const float* sph, const int* slot,
    const float* const* src6, const float* rows, int k_steps, float dt_dx,
    float inv_dx, float half_dt, int n_mat, int n1, int n2, int n3, int ns,
    int zsrc, int viscous, int with_dft, int seg, int gz, int gy, int gx,
    void* stream) {
  constexpr int K = BB_VHALO_K;
  using T = ViscoHaloTile<K>;
  if (k_steps != K || seg < 1 || (long long)n1 * n2 * n3 >= (1LL << 31) ||
      gy % T::C != 0 || !covers(gz, T::TZ, n3) ||
      !covers(gy / T::C, T::TY, n2) || !covers(gx, seg, n1) ||
      slot == nullptr || src6 == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{};
  for (int s = 0; s <= K; ++s) {
    for (int m = 0; m < kStage; ++m) {
      a.st.q[s][m] = q[kStage * s + m];
      const bool used = s == 0 || s == K || m >= kPsiS;
      if (used != (a.st.q[s][m] != nullptr)) {
        return (int)cudaErrorInvalidValue;
      }
      if (!used) continue;
      for (int t = 0; t < s; ++t) {
        for (int n = 0; n < kStage; ++n) {
          if (a.st.q[t][n] == a.st.q[s][m]) return (int)cudaErrorInvalidValue;
        }
      }
    }
  }
  a.idx = idx;
  a.table = table;
  a.n_mat = n_mat;
  a.acc_c = acc_c;
  a.acc_s = acc_s;
  a.peak = peak;
  a.prof_half = prof_half;
  a.prof_int = prof_int;
  a.amp = amp;
  a.cph = cph;
  a.sph = sph;
  a.vs = VolSrc{slot, src6[0], src6[1], src6[2], src6[3], src6[4], src6[5]};
  a.dt_dx = dt_dx;
  a.inv_dx = inv_dx;
  a.half_dt = half_dt;
  a.g = make_geo(n1, n2, n3, ns, seg, 1, 1, 1, 1);
  a.zsrc = zsrc;
  for (int s = 0; s < K; ++s) {
    a.rows.s_sin[s] = rows[4 * s];
    a.rows.s_cos[s] = rows[4 * s + 1];
    a.rows.cosw[s] = rows[4 * s + 2];
    a.rows.sinw[s] = rows[4 * s + 3];
  }
  const dim3 grid(gz, gy, gx);
  cudaStream_t st = (cudaStream_t)stream;
  if (viscous && with_dft) return (int)go<true, true>(a, grid, st);
  if (viscous) return (int)go<true, false>(a, grid, st);
  if (with_dft) return (int)go<false, true>(a, grid, st);
  return (int)go<false, false>(a, grid, st);
}

}  // extern "C"

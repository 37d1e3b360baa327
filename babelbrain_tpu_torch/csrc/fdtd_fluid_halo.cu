// Fluid (shear-free) FDTD: K leapfrog steps a launch in thread-block
// clusters that recompute a halo, for NVIDIA Hopper (sm_90a). CT mode,
// indexed materials, a plane or a volumetric (dome) source.
//
// Replaces (TPU kernel of the JAX package, babelbrain_tpu/ops/fdtd_pallas.py):
//   build_fluid_fusedK_step (B4) with its volumetric drive (volume_src,
//   :1815, the injection at :2108-2114 and its rings at :2191-2199), and
//   the volume branch of its sharded driver (:2677-2690): K velocity and
//   pressure half-steps of a dome run in one launch. The plane source is
//   compiled too (B4's plane drive). Each cell's arithmetic is the pair's
//   (fdtd_fluid.cu) and the scatter's (fdtd_sources.cu
//   velocity_volume_source_kernel), in their order, so K steps of this
//   kernel equal K steps of pair + scatter bit for bit.
//
// What bounds it on this card: the pair + scatter move 16 float volumes a
// step (22 in the sensor window), device-memory bound. A launch here reads
// p, v, r, the index and the slot volume once and writes p, v, r once (12
// volumes, 18 with the DFT sums and the peak), K steps for the price of
// one, plus the halo each cluster reads again (L2 mostly) and recomputes
// (ops/fdtd_halo_kernels.py HaloGeometry.computed: cells computed per cell
// owned). The first design (independent blocks of one thread a column
// recomputing a 3K ring around a 256-512 column tile) computed
// 1.7-6.7 cells per cell owned and lost to pair + scatter at every K; time
// followed the cells computed, and the loads each thread issued after each
// block barrier (the index, then the table rows through it) held every
// step. This design answers both:
//
//   1. The cluster, not the block, recomputes the halo. A cluster of
//      HaloTile<K>::C blocks stacked along y owns TZ x TY columns and
//      computes them extended by H = 3K a side (EZ x EY columns, one thread
//      a column); each block computes a slab of BY rows of it. The rows of
//      a neighbour block that the y stencils reach (2 a side) cross
//      through distributed shared memory instead of being recomputed: each
//      thread of a block's two edge rows stores its ring values into the
//      neighbour's two ghost rows as well, so every stencil read is local.
//      Those stores are st.async, each signalling its 4 bytes on an
//      mbarrier of the receiving block (two, by march step parity), and a
//      step's edge rows wait for the neighbours' bytes of the step before;
//      a block barrier orders the block's own rings. Two other exchanges
//      measured slower at the dome's grid (PERF.md) and were dropped: one
//      cluster barrier a march step (barrier.cluster.arrive.release /
//      wait.acquire, 19% / 15% slower at K = 1 / 2: it compiles to
//      MEMBAR.ALL.GPU and an L1 invalidation, CCTL.IVALL, every step), and
//      reading the neighbour's rings with ld.shared::cluster instead of
//      pushing (3-14% slower).
//      Only the cluster's outer edge carries the halo, and the exactness
//      rule (`exact`) applies there. 1.4-2.0 cells computed per cell owned
//      at K = 1..3 on the dome's grid, against 1.7-6.7.
//   2. The march's loads come off the barrier's critical path.
//      After a march step's work each thread issues cp.async copies of what
//      its column needs at the next step (p of the next plane, v and r of
//      the planes stage 0 updates, the material index and the slot) into
//      its own shared-memory slots, so that they fly while the block
//      gathers at the step's barrier; the next step waits on the block's
//      mbarrier for them (fdtd_stencil.cuh cp_async4z, cp_async_arrive,
//      mbar_wait). The index and the slot stay in a per-column ring of D
//      planes for the later stages, so a table row is gathered from an
//      index already in shared memory (the table itself is small and
//      L1-resident). Plain loads after the barrier, where the values are
//      used, measured 1.1-5.8% slower at the dome's grid (0.9% faster only
//      at K = 1 in the quiet phase; PERF.md) and were dropped.
//   3. The in-between state stays on chip: the p, vy, vz rings (shared
//      memory), the x-windows and the r ring (registers), as before. Only
//      the CPML psi of the stages in between goes through device memory
//      (scratch slabs): it exists only in the slabs along the faces, and a
//      column's share of it is not known until the march reaches it.
//   4. Registers and occupancy: the tile is the fastest of the shapes
//      measured at the dome's grid (PERF.md): at K = 1, 2
//      clusters of 2 blocks of 988 / 968 threads (26 / 22 rows), one block
//      an SM and 66 clusters at once (8-block clusters left 12 SMs idle);
//      at K = 3 clusters of 8 blocks of 500 threads. 56-64 registers at
//      K = 1, 2 and 80-111 at K = 3, no spills (ptxas -v).
//
// The march. At march step f a thread takes p of plane f (stage 0's
// input), then for s = 0..K-1 the velocity of step s at plane
// a = f - 2 - 3s and the pressure of step s at plane a - 1. The velocity of
// plane a needs p of plane a + 2 (its x-window), which the previous step's
// pressure produced earlier in this march step; the pressure of plane a - 1
// needs vx of plane a (its x-window), produced just before. x-windows live
// in registers (p for the velocity, the new vx for the pressure). The y/z
// neighbours come from shared memory: rings of 4 planes per step of p
// (written where produced, read 2 march steps later), vy and vz (read by the
// neighbours' pressure 1 march step later, by the own next velocity 3
// later). Every cross-thread read is of an earlier march step, so the
// step's barrier orders it (the block barrier for the block's own rows, the
// mbarrier wait for the ghost rows), and no slot is rewritten before its
// last read. A neighbour waits only for this block's rows of the step
// before its own, so it may run a march step ahead and store its rows of
// step f + 1 into the ghost slots while this block reads those of step f:
// a ring of 4 planes keeps them apart (ops/fdtd_halo_kernels.py march
// models the schedule, the neighbour's early stores included;
// tests/test_torch_fused_volume.py checks every read, and that ghost rows
// of 3 planes would not do).
// Per-cell state between steps: r in a 3-deep register ring per step; the
// own old vx from the previous step's pressure window, vy and vz from the
// rings. The CPML psi values live only in the slabs: step s reads the psi of
// stage s and writes that of stage s + 1 to device memory (stage 0 the
// input state's, stage K the output's, stages 1..K-1 scratch copies of the
// slabs). A scratch value is written only where this cluster's step s is
// exact; every cluster that writes a cell writes the same bits, and a
// thread reads a scratch cell only after it wrote it itself, or where its
// own result is discarded anyway.
// State is out of place. Neighbours read this launch's input p, v, r and psi
// of their halo cells, so the input stays unchanged: the kernel reads an
// input copy and writes an output copy (which must not alias it). The DFT
// sums and the peak belong to owned cells only and are updated in place.
// Volume drive (VOLUME): every velocity stage applies it, at halo cells too,
// so that a halo evolves as its owner's interior does (JAX's sharded rule,
// :2677-2682): after the CPML update, where the dense int32 slot volume
// (ops/fdtd_sources.py VolumeSource.slot_volume) holds a source, the three
// velocities are set from its six floats (read through __ldg).
// x decomposition: the x_lo / x_hi flags of Geo with an XALL twin.
// ops/fdtd_halo_kernels.py halo_launch_geometry takes HaloTile<K> (checked
// through bb_fluid_halo_tile_k<K> before a depth's first launch, with the
// clusters the card holds at once, bb_fluid_halo_clusters_k<K>) and cuts x
// into segments. Each depth is a translation unit of its own
// (-DBB_HALO_K=K, ops/_build.py), compiled in parallel.
//
// Rounding: built with --fmad=false; the operation order of the pair, the
// scatter and the plain PyTorch versions (ops/fdtd_kernels.py,
// ops/fdtd_sources.py).

#include <cuda_runtime.h>

#include "fdtd_stencil.cuh"

#ifndef BB_HALO_K
#error "compile once per depth with -DBB_HALO_K=<K> (ops/_build.py)"
#endif

#define BB_CAT2(a, b) a##b
#define BB_CAT(a, b) BB_CAT2(a, b)

namespace {

using namespace bb;

constexpr int kMaxSteps = 3;  // HALO_K_CAP in Python
constexpr int kReach = 3;     // cells a step reaches (CONTAMINATION)
constexpr int kRing = 4;      // planes a shared-memory ring holds
constexpr int kFar = 1 << 24; // distance to an edge beyond the grid's
// the rings of a step: p (its input), vy and vz (its output)
constexpr int kP = 0, kVY = 1, kVZ = 2;
// the staged values of a march step: p of plane f, v of plane f - 2, r of
// plane f - 3
constexpr int kStP = 0, kStVX = 1, kStVY = 2, kStVZ = 3, kStR = 4;
constexpr int kStaged = 5;

static_assert(BB_HALO_K >= 1 && BB_HALO_K <= kMaxSteps, "depth 1..3");

// table rows (ops/fdtd.py _build_indexed_materials)
constexpr int kRhoInv = 0, kPiU = 1, kCRp = 3, kBR = 5;

// The cluster of a K-step launch: C blocks stacked along y own TZ x TY (z,
// y) columns, computed extended by H = 3K a side (EZ x EY); each block
// computes BY rows of the extended tile, one thread a column. Shared memory
// (words): the mbarrier (4), the rings, the staged values and the index and
// slot rings of D planes (ops/fdtd_halo_kernels.py HALO_TILES).
template <int K>
struct HaloTile {
  static constexpr int TZ = 32;
  static constexpr int BY = (K == 1) ? 26 : (K == 2) ? 22 : 10;
  static constexpr int C = (K <= 2) ? 2 : 8;
  static constexpr int H = kReach * K;
  static constexpr int EZ = TZ + 2 * H;
  static constexpr int EY = C * BY;
  static constexpr int TY = EY - 2 * H;
  static constexpr int THREADS = EZ * BY;
  // planes the index and slot rings hold: stage 0's velocity plane, the
  // planes of the later stages down to stage K - 1's pressure plane, and
  // the plane staged a step ahead (3K, a power of two)
  static constexpr int D = (3 * K <= 8) ? 8 : 16;
  // a ring plane: the block's rows and two ghost rows below and above
  // that the neighbours store into (those of the cluster's outer edge stay
  // 0), with ZPAD also two zero columns each side (no bounds check a
  // stencil tap: taken at the depths where it measured faster, K = 1, 3)
  static constexpr bool ZPAD = K != 2;
  static constexpr int RW = ZPAD ? EZ + 4 : EZ;
  static constexpr int RP = RW * (BY + 4);
  static constexpr int RINGS = 8;  // after the mbarriers (3 x 8 bytes)
  static constexpr int RINGS_END = RINGS + K * 3 * kRing * RP;
  static constexpr int STAGED = RINGS_END;
  static constexpr int IDX = STAGED + kStaged * THREADS;
  static constexpr int SLOT = IDX + D * THREADS;
  static constexpr int SMEM = (SLOT + D * THREADS) * (int)sizeof(float);
};

struct In5 {
  const float *p, *vx, *vy, *vz, *r;
};
struct Out5 {
  float *p, *vx, *vy, *vz, *r;
};
// psi of each stage: q[s][0..5] psi_p, q[s][6..11] psi_v ([lo, hi] of the
// x, y, z derivatives); stage 0 the input, stage K the output
struct PsiStages {
  float* q[kMaxSteps + 1][12];
};
// the per-step scalars (ops/fdtd.py step_scalars), row s for step s
struct HaloRows {
  float s_sin[kMaxSteps], s_cos[kMaxSteps], cosw[kMaxSteps], sinw[kMaxSteps];
};

// K steps of fluid_velocity_kernel, velocity_volume_source_kernel (VOLUME)
// and fluid_pressure_kernel in one march of clusters
template <int K, bool VISCOUS, bool WITH_DFT, bool VOLUME, bool XALL>
__global__ void __launch_bounds__(HaloTile<K>::THREADS, 1)
    fluid_halo_kernel(In5 in, Out5 out, const int* __restrict__ idx,
                      const float* __restrict__ table, int n_mat,
                      float* __restrict__ acc_c, float* __restrict__ acc_s,
                      float* __restrict__ peak, PsiStages psi,
                      const float* __restrict__ prof_half,
                      const float* __restrict__ prof_int,
                      const float* __restrict__ amp,
                      const float* __restrict__ cph,
                      const float* __restrict__ sph, VolSrc vs, float dt_dx,
                      float inv_dx, float half_dt, Geo g, int zsrc,
                      HaloRows rows) {
  using T = HaloTile<K>;
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
  // whether this column lies in a y or z CPML slab (else those derivatives
  // pass through unchanged, as cpml_io would leave them)
  const bool in_y = y < g.ns || y >= g.n2 - g.ns;
  const bool in_z = z < g.ns || z >= g.n3 - g.ns;
  const int lo_x = XALL ? g.ns : g.xlo;
  const int hi_x = XALL ? g.n1 - g.ns : g.xhi;
  const int ns = g.ns;
  // this block's shared memory in the windows of the ranks below and above
  const unsigned own_base = smem_u32(sm);
  const unsigned below = rank > 0 ? map_rank(own_base, rank - 1) : 0u;
  const unsigned above = rank + 1 < T::C ? map_rank(own_base, rank + 1) : 0u;
  // the two mbarriers (by step parity) of the ghost rows the
  // neighbours push, here and in the neighbours' windows; the bytes a step
  // brings (each of its 2 * K ring stores that a y stencil reads, from
  // the two edge rows of each neighbour); the rows that read ghost rows
  unsigned long long* const xbar = bar + 1;
  const unsigned xb_below = rank > 0 ? map_rank(smem_u32(xbar), rank - 1) : 0u;
  const unsigned xb_above =
      rank + 1 < T::C ? map_rank(smem_u32(xbar), rank + 1) : 0u;
  const unsigned x_bytes = (2 * K) * 2 * T::EZ * 4 *
                           ((rank > 0 ? 1 : 0) + (rank + 1 < T::C ? 1 : 0));
  const bool edge = ry < 2 || ry >= T::BY - 2;
  unsigned xpar = 0;  // the parity of the current march step

  // word offset of step s's ring f at plane i
  auto ring = [&](int s, int f, int i) -> int {
    return T::RINGS + ((s * 3 + f) * kRing + (i & (kRing - 1))) * T::RP;
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
  auto marched = [&](int i) { return inside && i >= xs && i <= xe; };
  auto own = [&](int i) { return owned_col && i >= x0 && i < x1; };
  // step s's velocity (pressure) at plane i is exact: the cells it reads
  // are, 3s + 1 (3s + 3) cells from a cut edge below, 3s + 2 (3s + 3) above
  auto exact = [&](int i, int lo, int hi) {
    return min(lat_lo, xs == 0 ? kFar : i - xs) >= lo &&
           min(lat_hi, xe == g.n1 - 1 ? kFar : xe - i) >= hi;
  };
  auto idx_of = [&](int i) -> int& {
    return smi[T::IDX + (i & (T::D - 1)) * E + tid];
  };
  auto slot_of = [&](int i) -> int& {
    return smi[T::SLOT + (i & (T::D - 1)) * E + tid];
  };
  // the values march step f takes from global memory: p of plane f, v, the
  // index and the slot of plane f - 2, r of plane f - 3 (0 off the marched
  // planes), copied a step ahead
  auto stage = [&](int f) {
    const int ci = f * plane + jk, cv = (f - 2) * plane + jk;
    const int cr = (f - 3) * plane + jk;
    const bool mi = marched(f), mv = marched(f - 2), mr = marched(f - 3);
    float* st = sm + T::STAGED + tid;
    cp_async4z(st + kStP * E, in.p + (mi ? ci : 0), mi);
    cp_async4z(st + kStVX * E, in.vx + (mv ? cv : 0), mv);
    cp_async4z(st + kStVY * E, in.vy + (mv ? cv : 0), mv);
    cp_async4z(st + kStVZ * E, in.vz + (mv ? cv : 0), mv);
    if constexpr (VISCOUS) {
      cp_async4z(st + kStR * E, in.r + (mr ? cr : 0), mr);
    }
    cp_async4z(&idx_of(f - 2), idx + (mv ? cv : 0), mv);
    if constexpr (VOLUME) {
      cp_async4z(&slot_of(f - 2), vs.slot + (mv ? cv : 0), mv);
    }
    cp_async_arrive(bar);
  };

  float pw[K][4], vw[K][4];     // x-windows: p at a-1..a+2, vx at b-2..b+1
  float rr[K > 1 ? K - 1 : 1][3];  // step s's r of the last 3 march steps
#pragma unroll
  for (int s = 0; s < K; ++s) {
#pragma unroll
    for (int m = 0; m < 4; ++m) pw[s][m] = vw[s][m] = 0.0f;
  }
#pragma unroll
  for (int s = 0; s < (K > 1 ? K - 1 : 1); ++s) {
    rr[s][0] = rr[s][1] = rr[s][2] = 0.0f;
  }
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

  const int f_end = x1 - 1 + T::H;
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
    const float* st = sm + T::STAGED + tid;
    // stage 0's input: p of plane f
    const float p_f = st[kStP * E];
    put(ring(0, kP, f), p_f);
    pw[0][0] = pw[0][1];
    pw[0][1] = pw[0][2];
    pw[0][2] = pw[0][3];
    pw[0][3] = p_f;
    float r_hand = VISCOUS ? st[kStR * E] : 0.0f;  // step s - 1's r at b
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const int a = f - 2 - kReach * s;  // velocity plane of step s
      const int b = a - 1;               // pressure plane of step s
      // --- velocity of plane a (fluid_velocity_kernel, then the scatter) ---
      float vxn = 0.0f, vyn = 0.0f, vzn = 0.0f;
      if (marched(a)) {
        const int c = a * plane + jk;
        float vxo, vyo, vzo;
        if (s == 0) {
          vxo = st[kStVX * E];
          vyo = st[kStVY * E];
          vzo = st[kStVZ * E];
        } else {  // step s - 1's: its pressure window, its rings
          vxo = vw[s - 1][0];
          vyo = mine(ring(s - 1, kVY, a));
          vzo = mine(ring(s - 1, kVZ, a));
        }
        const int pr = ring(s, kP, a);
        const float dpy = stencil(lat(pr, -1, 0), pw[s][1], lat(pr, 1, 0),
                                  lat(pr, 2, 0));
        const float dpz = stencil(lat(pr, 0, -1), pw[s][1], lat(pr, 0, 1),
                                  lat(pr, 0, 2));
        const int mi = idx_of(a);
        const float ri = __ldg(table + kRhoInv * n_mat + mi);
        const bool keep =
            (s == K - 1) ? own(a) : exact(a, kReach * s + 1, kReach * s + 2);
        const float dx = cpml_io(
            stencil(pw[s][0], pw[s][1], pw[s][2], pw[s][3]), a, lo_x, hi_x,
            ns, prof_half, psi.q[s][0], psi.q[s][1], psi.q[s + 1][0],
            psi.q[s + 1][1], jk, plane, keep);
        const float dy =
            !in_y ? dpy
                  : cpml_io(dpy, y, ns, g.n2 - ns, ns, prof_half + 4 * ns,
                            psi.q[s][2], psi.q[s][3], psi.q[s + 1][2],
                            psi.q[s + 1][3], a * ns * g.n3 + z, g.n3, keep);
        const float dz =
            !in_z ? dpz
                  : cpml_io(dpz, z, ns, g.n3 - ns, ns, prof_half + 8 * ns,
                            psi.q[s][4], psi.q[s][5], psi.q[s + 1][4],
                            psi.q[s + 1][5], (a * g.n2 + y) * ns, 1, keep);
        vzn = vzo - dt_dx * ri * dz;
        if (z == zsrc) {
          const int ij = a * g.n2 + y;
          const float am = __ldg(amp + ij);
          if (am > 0.0f) {
            vzn = am * (rows.s_sin[s] * __ldg(cph + ij) +
                        rows.s_cos[s] * __ldg(sph + ij));
          }
        }
        vxn = vxo - dt_dx * ri * dx;
        vyn = vyo - dt_dx * ri * dy;
        if constexpr (VOLUME) {
          const int qv = slot_of(a);
          if (qv >= 0) {
            const float sv =
                __ldg(vs.amp + qv) * (rows.s_sin[s] * __ldg(vs.cph + qv) +
                                      rows.s_cos[s] * __ldg(vs.sph + qv));
            vxn = sv * __ldg(vs.ox + qv);
            vyn = sv * __ldg(vs.oy + qv);
            vzn = sv * __ldg(vs.oz + qv);
          }
        }
        if (s == K - 1 && own(a)) {
          out.vx[c] = vxn;
          out.vy[c] = vyn;
          out.vz[c] = vzn;
        }
      }
      put(ring(s, kVY, a), vyn);
      mine(ring(s, kVZ, a)) = vzn;  // read across z only
      vw[s][0] = vw[s][1];
      vw[s][1] = vw[s][2];
      vw[s][2] = vw[s][3];
      vw[s][3] = vxn;  // 0 off the marched planes
      // --- pressure of plane b (fluid_pressure_kernel) ---
      const float ro = r_hand;
      float pn = 0.0f, rn = 0.0f;
      if (marched(b)) {
        const int c = b * plane + jk;
        const float po = pw[s][0];
        const int vyr = ring(s, kVY, b);
        const int vzr = ring(s, kVZ, b);
        const float dvy = stencil(lat(vyr, -2, 0), lat(vyr, -1, 0),
                                  mine(vyr), lat(vyr, 1, 0));
        const float dvz = stencil(lat(vzr, 0, -2), lat(vzr, 0, -1),
                                  mine(vzr), lat(vzr, 0, 1));
        const int mi = idx_of(b);
        const float pi_u = __ldg(table + kPiU * n_mat + mi);
        const bool keep =
            (s == K - 1) ? own(b) : exact(b, kReach * s + 3, kReach * s + 3);
        const float dx = cpml_io(
            stencil(vw[s][0], vw[s][1], vw[s][2], vw[s][3]), b, lo_x, hi_x,
            ns, prof_int, psi.q[s][6], psi.q[s][7], psi.q[s + 1][6],
            psi.q[s + 1][7], jk, plane, keep);
        const float dy =
            !in_y ? dvy
                  : cpml_io(dvy, y, ns, g.n2 - ns, ns, prof_int + 4 * ns,
                            psi.q[s][8], psi.q[s][9], psi.q[s + 1][8],
                            psi.q[s + 1][9], b * ns * g.n3 + z, g.n3, keep);
        const float dz =
            !in_z ? dvz
                  : cpml_io(dvz, z, ns, g.n3 - ns, ns, prof_int + 8 * ns,
                            psi.q[s][10], psi.q[s][11], psi.q[s + 1][10],
                            psi.q[s + 1][11], (b * g.n2 + y) * ns, 1, keep);
        const float theta = dx + dy + dz;
        if constexpr (VISCOUS) {
          const float c_rp = __ldg(table + kCRp * n_mat + mi);
          const float b_r = __ldg(table + kBR * n_mat + mi);
          rn = b_r * ro - c_rp * theta * inv_dx;
          pn = po - dt_dx * pi_u * theta - half_dt * (rn + ro);
        } else {
          pn = po - dt_dx * pi_u * theta;
        }
        if (own(b)) {
          if constexpr (WITH_DFT) {
            acc_c[c] = acc_c[c] + pn * rows.cosw[s];
            acc_s[c] = acc_s[c] + pn * rows.sinw[s];
            peak[c] = fmaxf(peak[c], fabsf(pn));
          }
          if (s == K - 1) {
            out.p[c] = pn;
            if constexpr (VISCOUS) out.r[c] = rn;
          }
        }
      }
      if (s + 1 < K) {  // step s + 1's input p, and its r ring
        put(ring(s + 1, kP, b), pn);
        pw[s + 1][0] = pw[s + 1][1];
        pw[s + 1][1] = pw[s + 1][2];
        pw[s + 1][2] = pw[s + 1][3];
        pw[s + 1][3] = pn;
        if constexpr (VISCOUS) {
          r_hand = rr[s][0];
          rr[s][0] = rr[s][1];
          rr[s][1] = rr[s][2];
          rr[s][2] = rn;
        }
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
  In5 in;
  Out5 out;
  const int* idx;
  const float* table;
  int n_mat;
  float *acc_c, *acc_s, *peak;
  PsiStages psi;
  const float *prof_half, *prof_int, *amp, *cph, *sph;
  VolSrc vs;
  float dt_dx, inv_dx, half_dt;
  Geo g;
  int zsrc;
  HaloRows rows;
};

template <int I>
auto kernel_of() {
  return &fluid_halo_kernel<BB_HALO_K, bool(I & 8), bool(I & 4), bool(I & 2),
                            bool(I & 1)>;
}

template <int I>
cudaError_t go(const Args& a, dim3 grid, cudaStream_t st) {
  using T = HaloTile<BB_HALO_K>;
  auto kern = kernel_of<I>();
  static int allowed[64] = {0};
  const cudaError_t e = allow_smem(kern, allowed, T::SMEM);
  if (e != cudaSuccess) return e;
  const cudaError_t l = launch_cluster(
      kern, grid, T::THREADS, T::SMEM, T::C, st, a.in, a.out, a.idx, a.table,
      a.n_mat, a.acc_c, a.acc_s, a.peak, a.psi, a.prof_half, a.prof_int,
      a.amp, a.cph, a.sph, a.vs, a.dt_dx, a.inv_dx, a.half_dt, a.g, a.zsrc,
      a.rows);
  const cudaError_t last = cudaGetLastError();
  return l != cudaSuccess ? l : last;
}

// the clusters of the instantiation (viscous, volume, whole grid) the card
// holds at once
template <int I>
cudaError_t clusters(int* n) {
  using T = HaloTile<BB_HALO_K>;
  auto kern = kernel_of<I>();
  static int allowed[64] = {0};
  const cudaError_t e = allow_smem(kern, allowed, T::SMEM);
  if (e != cudaSuccess) return e;
  return active_clusters(kern, T::THREADS, T::SMEM, T::C, n);
}

using Go = cudaError_t (*)(const Args&, dim3, cudaStream_t);

// the instantiation of (viscous, with_dft, volume, xall)
Go instantiation(int viscous, int with_dft, int volume, int xall) {
  static const Go table[16] = {
      go<0>, go<1>, go<2>,  go<3>,  go<4>,  go<5>,  go<6>,  go<7>,
      go<8>, go<9>, go<10>, go<11>, go<12>, go<13>, go<14>, go<15>};
  return table[(viscous ? 8 : 0) | (with_dft ? 4 : 0) | (volume ? 2 : 0) |
               (xall ? 1 : 0)];
}

}  // namespace

extern "C" {

// *tz, *by, *cluster: the owned z columns of a cluster, the rows of a block
// and the blocks of a cluster at this depth (HaloTile<K>), which
// ops/fdtd_halo_kernels.py's launch geometry must match
int BB_CAT(bb_fluid_halo_tile_k, BB_HALO_K)(int* tz, int* by, int* cluster) {
  *tz = HaloTile<BB_HALO_K>::TZ;
  *by = HaloTile<BB_HALO_K>::BY;
  *cluster = HaloTile<BB_HALO_K>::C;
  return 0;
}

// *n: the clusters of this depth's viscous volumetric whole-grid
// instantiation the current device holds at once
int BB_CAT(bb_fluid_halo_clusters_k, BB_HALO_K)(int* n) {
  *n = 0;
  return (int)clusters<11>(n);
}

// K = BB_HALO_K steps in one launch, from the input state (p, vx, vy, vz,
// r) into the output state (p_o, ..., r_o; no field may alias its input);
// acc_c, acc_s, peak in place. psi: host array of (K + 1) x 12 device
// pointers (stage s's psi_p then psi_v lists; stage 0 the input's, stage K
// the output's, no two stages alike); slot: the slot volume (volume
// sources, else null) and src6 a host array of the sparse source's amp,
// cph, sph, ox, oy, oz; rows: host array of K x (s_sin, s_cos, cosw, sinw);
// seg and the grid (gz, gy, gx): ops/fdtd_halo_kernels.py
// halo_launch_geometry (gy: y-tiles of clusters times the cluster).
int BB_CAT(bb_fluid_halo_k, BB_HALO_K)(
    const float* p, const float* vx, const float* vy, const float* vz,
    const float* r, float* p_o, float* vx_o, float* vy_o, float* vz_o,
    float* r_o, const int* idx, const float* table, float* acc_c,
    float* acc_s, float* peak, float* const* psi, const float* prof_half,
    const float* prof_int, const float* amp, const float* cph,
    const float* sph, const int* slot, const float* const* src6,
    const float* rows, int k_steps, float dt_dx, float inv_dx, float half_dt,
    int n_mat, int n1, int n2, int n3, int ns, int x_lo, int x_hi, int zsrc,
    int viscous, int with_dft, int seg, int gz, int gy, int gx,
    void* stream) {
  constexpr int K = BB_HALO_K;
  using T = HaloTile<K>;
  if (k_steps != K || seg < 1 || (long long)n1 * n2 * n3 >= (1LL << 31) ||
      gy % T::C != 0 || !covers(gz, T::TZ, n3) ||
      !covers(gy / T::C, T::TY, n2) || !covers(gx, seg, n1)) {
    return (int)cudaErrorInvalidValue;
  }
  const void* ins[5] = {p, vx, vy, vz, r};
  const void* outs[5] = {p_o, vx_o, vy_o, vz_o, r_o};
  for (int a = 0; a < 5; ++a) {
    for (int b = 0; b < 5; ++b) {
      if (ins[a] == outs[b] && ((a < 4 && b < 4) || viscous)) {
        return (int)cudaErrorInvalidValue;
      }
    }
  }
  Args a{};
  for (int s = 0; s <= K; ++s) {
    for (int m = 0; m < 12; ++m) {
      a.psi.q[s][m] = psi[12 * s + m];
      for (int t = 0; t < s; ++t) {
        if (a.psi.q[t][m] == a.psi.q[s][m]) {
          return (int)cudaErrorInvalidValue;
        }
      }
    }
  }
  if (slot != nullptr && src6 == nullptr) return (int)cudaErrorInvalidValue;
  const Go fn = instantiation(viscous, with_dft, slot != nullptr,
                              x_lo && x_hi);
  a.in = In5{p, vx, vy, vz, r};
  a.out = Out5{p_o, vx_o, vy_o, vz_o, r_o};
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
  if (slot != nullptr) {
    a.vs = VolSrc{slot, src6[0], src6[1], src6[2], src6[3], src6[4], src6[5]};
  }
  a.dt_dx = dt_dx;
  a.inv_dx = inv_dx;
  a.half_dt = half_dt;
  a.g = make_geo(n1, n2, n3, ns, seg, x_lo, x_hi, 1, 1);
  a.zsrc = zsrc;
  for (int s = 0; s < K; ++s) {
    a.rows.s_sin[s] = rows[4 * s];
    a.rows.s_cos[s] = rows[4 * s + 1];
    a.rows.cosw[s] = rows[4 * s + 2];
    a.rows.sinw[s] = rows[4 * s + 3];
  }
  return (int)fn(a, dim3(gz, gy, gx), (cudaStream_t)stream);
}

}  // extern "C"

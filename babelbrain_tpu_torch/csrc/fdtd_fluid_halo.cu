// Fluid (shear-free) FDTD: K leapfrog steps a launch in independent blocks
// that recompute a halo, for NVIDIA Hopper (sm_90a). CT mode, indexed
// materials, a plane or a volumetric (dome) source.
//
// Replaces (TPU kernel of the JAX package, babelbrain_tpu/ops/fdtd_pallas.py):
//   build_fluid_fusedK_step (B4) with its volumetric drive (volume_src,
//   :1815, the injection at :2108-2114 and its rings at :2191-2199), and
//   the volume branch of its sharded driver (:2677-2690): K velocity and
//   pressure half-steps of a dome run in one launch. The plane source is
//   compiled too (B4's plane drive), for the comparison with the lockstep
//   sweep of fdtd_fluid_fused.cu. Each cell's arithmetic is the pair's
//   (fdtd_fluid.cu) and the scatter's (fdtd_sources.cu
//   velocity_volume_source_kernel), in their order, so K steps of this
//   kernel equal K steps of pair + scatter bit for bit.
//
// What bounds it on this card: the pair + scatter move 16 float volumes a
// step (22 in the sensor window), device-memory bound. A launch here reads
// p, v, r, the index and the slot volume once and writes p, v, r once (12
// volumes, 18 with the DFT sums and the peak), K steps for the price of
// one, plus the halo each block reads again (L2 mostly) and recomputes:
// 1.7-7.7 cells computed per cell owned at K = 1..3 (ops/
// fdtd_halo_kernels.py HaloGeometry.computed). Measured on an H100
// (PERF.md): slower than pair + scatter at every K, 1.7x at K = 1 and
// 2.2x at K = 2 at the dome's grid; the recompute, the shared-memory
// neighbour loads (12 a cell a step) and one ~880-thread block an SM hold
// it, so run_fdtd keeps pair + scatter unless fuse_steps pins K.
//
// Design (the BHTE sweep's, bhte.cu bhte_fused_kernel, carried over to the
// fluid stencil):
//   - No cooperative launch and no grid barrier, so neither K nor the plane
//     size is bounded by how many blocks the card holds at once (the
//     lockstep sweep fits 792 blocks, so K = 1 at the dome's 392x337 planes).
//   - Tiles and halo. A block owns a (y, z) tile of HaloTile<K>::TZ x TY
//     columns and a segment of x-planes [x0, x1). A step reaches 3 cells
//     along each axis (d_plus reads -1..+2, d_minus -2..+1), so the block
//     computes its tile extended by H = 3K cells a side, one thread a
//     column, and marches from H planes below its segment to H above it.
//     Neighbouring blocks recompute each other's halo (overlap and discard);
//     only owned cells reach the output state.
//   - The march. At march step f the thread takes p of plane f (stage 0's
//     input), then for s = 0..K-1 the velocity of step s at plane
//     a = f - 2 - 3s and the pressure of step s at plane a - 1. The
//     velocity of plane a needs p of plane a + 2 (its x-window), which the
//     previous step's pressure produced earlier in this march step; the
//     pressure of plane a - 1 needs vx of plane a (its x-window), produced
//     just before. x-windows live in registers (p for the velocity, the new
//     vx for the pressure). The y/z neighbours come from shared memory:
//     rings of 4 planes per step of p (written where produced, read 2 march
//     steps later), vy and vz (read by the neighbours' pressure 1 march step
//     later, by the own next velocity 3 later). One __syncthreads() a march
//     step: every cross-thread read is of an earlier march step, and no
//     slot is rewritten before its last read (ops/fdtd_halo_kernels.py
//     march models the schedule; tests/test_torch_fused_volume.py checks
//     every read).
//   - Per-cell state between steps: r in a 3-deep register ring per step
//     (produced 3 march steps before the next step's pressure reads it);
//     the own old vx from the previous step's pressure window, vy and vz
//     from the rings. The CPML psi values live only in the slabs: step s
//     reads the psi of stage s and writes that of stage s + 1 to device
//     memory (stage 0 the input state's, stage K the output's, stages
//     1..K-1 scratch copies of the slabs). A scratch value is written only
//     where this block's step s is exact; every block that writes a cell
//     writes the same bits, and a block reads a scratch cell only after it
//     wrote it itself, or where its own result is discarded anyway.
//   - State is out of place. Neighbours read this launch's input p, v, r
//     and psi of their halo cells, so the input stays unchanged: the kernel
//     reads an input copy and writes an output copy (which must not alias
//     it), as bhte_fused_kernel does. The DFT sums and the peak belong to
//     owned cells only and are updated in place, step after step.
//   - Volume drive (VOLUME). Every velocity stage applies it, at halo cells
//     too, so that a halo evolves as its owner's interior does (JAX's
//     sharded rule, :2677-2682): after the CPML update, where the dense
//     int32 slot volume (ops/fdtd_sources.py VolumeSource.slot_volume: -1,
//     or the voxel's index in the sparse list) holds a source, the three
//     velocities are set from its six floats (read through __ldg). The slot
//     of a cell is read once a launch, when the march first reaches its
//     plane, and stays in a register ring for the K steps that use it.
//   - x decomposition: the x_lo / x_hi flags of Geo with an XALL twin, as
//     the other FDTD kernels have.
// Registers, not shared memory, bound the tile: each column keeps two
// 4-plane windows a step, the r ring and the slot ring. Shared memory: 12
// planes a step of the extended tile (dynamic, above 48 KB at K >= 2).
// ops/fdtd_halo_kernels.py halo_launch_geometry takes HaloTile<K> (checked
// through bb_fluid_halo_tile_k<K> before a depth's first launch) and cuts
// x into segments. Each depth is a translation unit of its own
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

static_assert(BB_HALO_K >= 1 && BB_HALO_K <= kMaxSteps, "depth 1..3");

// table rows (ops/fdtd.py _build_indexed_materials)
constexpr int kRhoInv = 0, kPiU = 1, kCRp = 3, kBR = 5;

// The block of a K-step launch: an owned tile of TZ x TY (z, y) columns
// extended by H = 3K a side, one thread a column (at most 1024 threads, and
// as many registers as the SM holds: one block an SM)
template <int K>
struct HaloTile {
  static constexpr int TZ = (K <= 2) ? 32 : 16;
  static constexpr int TY = (K == 1) ? 16 : 8;
  static constexpr int H = kReach * K;
  static constexpr int EZ = TZ + 2 * H;
  static constexpr int EY = TY + 2 * H;
  static constexpr int THREADS = EZ * EY;
  static constexpr int SMEM = K * 3 * kRing * THREADS * (int)sizeof(float);
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
// and fluid_pressure_kernel in one march of independent blocks
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
  constexpr int kSlots = VOLUME ? kReach * (K - 1) + 1 : 1;
  extern __shared__ float sm[];  // [K][3][kRing][E]
  const int tid = threadIdx.x;
  const int ey = tid / T::EZ, ez = tid - ey * T::EZ;
  const int y0 = blockIdx.y * T::TY - T::H, z0 = blockIdx.x * T::TZ - T::H;
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
  // distance to the nearest edge of the extended tile that lies inside the
  // grid, below and above (what lies beyond such an edge is not known here:
  // the values it reaches are discarded); an edge at the grid's is exact
  const int lat_lo = min(y0 <= 0 ? kFar : ey, z0 <= 0 ? kFar : ez);
  const int lat_hi = min(y0 + T::EY >= g.n2 ? kFar : T::EY - 1 - ey,
                         z0 + T::EZ >= g.n3 ? kFar : T::EZ - 1 - ez);
  const int lo_x = XALL ? g.ns : g.xlo;
  const int hi_x = XALL ? g.n1 - g.ns : g.xhi;
  const int ns = g.ns;

  auto ring = [&](int s, int f, int i) -> float* {
    return sm + ((s * 3 + f) * kRing + (i & (kRing - 1))) * E;
  };
  // a y/z neighbour in a ring plane (0 outside the extended tile; threads
  // off the grid store 0)
  auto lat = [&](const float* r, int dy, int dz) -> float {
    return ((unsigned)(ey + dy) < (unsigned)T::EY &&
            (unsigned)(ez + dz) < (unsigned)T::EZ)
               ? r[tid + dy * T::EZ + dz]
               : 0.0f;
  };
  auto marched = [&](int i) { return inside && i >= xs && i <= xe; };
  auto own = [&](int i) { return owned_col && i >= x0 && i < x1; };
  // step s's velocity (pressure) at plane i is exact: the cells it reads
  // are, 3s + 1 (3s + 3) cells from a cut edge below, 3s + 2 (3s + 3) above
  auto exact = [&](int i, int lo, int hi) {
    return min(lat_lo, xs == 0 ? kFar : i - xs) >= lo &&
           min(lat_hi, xe == g.n1 - 1 ? kFar : xe - i) >= hi;
  };

  float pw[K][4], vw[K][4];     // x-windows: p at a-1..a+2, vx at b-2..b+1
  float rr[K > 1 ? K - 1 : 1][3];  // step s's r of the last 3 march steps
  int sl[kSlots];                  // slots of planes a_0, a_0 - 1, ...
#pragma unroll
  for (int s = 0; s < K; ++s) {
#pragma unroll
    for (int m = 0; m < 4; ++m) pw[s][m] = vw[s][m] = 0.0f;
  }
#pragma unroll
  for (int s = 0; s < (K > 1 ? K - 1 : 1); ++s) {
    rr[s][0] = rr[s][1] = rr[s][2] = 0.0f;
  }
#pragma unroll
  for (int m = 0; m < kSlots; ++m) sl[m] = -1;
  // the next march step's input loads: p of plane f + 1, v and the slot of
  // plane f - 1, r of plane f - 2
  float p_nx = marched(xs) ? in.p[xs * plane + jk] : 0.0f;
  float vx_nx = 0.0f, vy_nx = 0.0f, vz_nx = 0.0f, r_nx = 0.0f;
  int sl_nx = -1;

  const int f_end = x1 - 1 + T::H;
  for (int f = xs; f <= f_end; ++f) {
    const float p_f = p_nx;
    const float vx0 = vx_nx, vy0 = vy_nx, vz0 = vz_nx, r0 = r_nx;
    if constexpr (VOLUME) {
#pragma unroll
      for (int m = kSlots - 1; m >= 1; --m) sl[m] = sl[m - 1];
      sl[0] = sl_nx;
    }
    // the loads of the next march step, before this one's work
    p_nx = marched(f + 1) ? in.p[(f + 1) * plane + jk] : 0.0f;
    if (marched(f - 1)) {
      const int c = (f - 1) * plane + jk;
      vx_nx = in.vx[c];
      vy_nx = in.vy[c];
      vz_nx = in.vz[c];
      if constexpr (VOLUME) sl_nx = __ldg(vs.slot + c);
    } else {
      vx_nx = vy_nx = vz_nx = 0.0f;
      sl_nx = -1;
    }
    if constexpr (VISCOUS) {
      r_nx = marched(f - 2) ? in.r[(f - 2) * plane + jk] : 0.0f;
    }
    // stage 0's input: p of plane f
    ring(0, kP, f)[tid] = p_f;
    pw[0][0] = pw[0][1];
    pw[0][1] = pw[0][2];
    pw[0][2] = pw[0][3];
    pw[0][3] = p_f;
    float r_hand = r0;  // r of step s - 1 at step s's pressure plane
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
          vxo = vx0;
          vyo = vy0;
          vzo = vz0;
        } else {  // step s - 1's: its pressure window, its rings
          vxo = vw[s - 1][0];
          vyo = ring(s - 1, kVY, a)[tid];
          vzo = ring(s - 1, kVZ, a)[tid];
        }
        const float* pr = ring(s, kP, a);
        const float dpy =
            stencil(lat(pr, -1, 0), pw[s][1], lat(pr, 1, 0), lat(pr, 2, 0));
        const float dpz =
            stencil(lat(pr, 0, -1), pw[s][1], lat(pr, 0, 1), lat(pr, 0, 2));
        const int mi = __ldg(idx + c);
        const float ri = __ldg(table + kRhoInv * n_mat + mi);
        const bool keep =
            (s == K - 1) ? own(a) : exact(a, kReach * s + 1, kReach * s + 2);
        const float dx = cpml_io(
            stencil(pw[s][0], pw[s][1], pw[s][2], pw[s][3]), a, lo_x, hi_x,
            ns, prof_half, psi.q[s][0], psi.q[s][1], psi.q[s + 1][0],
            psi.q[s + 1][1], jk, plane, keep);
        const float dy =
            cpml_io(dpy, y, ns, g.n2 - ns, ns, prof_half + 4 * ns,
                    psi.q[s][2], psi.q[s][3], psi.q[s + 1][2],
                    psi.q[s + 1][3], a * ns * g.n3 + z, g.n3, keep);
        const float dz =
            cpml_io(dpz, z, ns, g.n3 - ns, ns, prof_half + 8 * ns,
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
          const int qv = sl[kReach * s];
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
      ring(s, kVY, a)[tid] = vyn;
      ring(s, kVZ, a)[tid] = vzn;
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
        const float* vyr = ring(s, kVY, b);
        const float* vzr = ring(s, kVZ, b);
        const float dvy =
            stencil(lat(vyr, -2, 0), lat(vyr, -1, 0), vyr[tid], lat(vyr, 1, 0));
        const float dvz =
            stencil(lat(vzr, 0, -2), lat(vzr, 0, -1), vzr[tid], lat(vzr, 0, 1));
        const int mi = __ldg(idx + c);
        const float pi_u = __ldg(table + kPiU * n_mat + mi);
        const bool keep =
            (s == K - 1) ? own(b) : exact(b, kReach * s + 3, kReach * s + 3);
        const float dx = cpml_io(
            stencil(vw[s][0], vw[s][1], vw[s][2], vw[s][3]), b, lo_x, hi_x,
            ns, prof_int, psi.q[s][6], psi.q[s][7], psi.q[s + 1][6],
            psi.q[s + 1][7], jk, plane, keep);
        const float dy =
            cpml_io(dvy, y, ns, g.n2 - ns, ns, prof_int + 4 * ns,
                    psi.q[s][8], psi.q[s][9], psi.q[s + 1][8],
                    psi.q[s + 1][9], b * ns * g.n3 + z, g.n3, keep);
        const float dz =
            cpml_io(dvz, z, ns, g.n3 - ns, ns, prof_int + 8 * ns,
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
        ring(s + 1, kP, b)[tid] = pn;
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
    // done: the next step reads the former and rewrites older slots
    __syncthreads();
  }
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
cudaError_t go(const Args& a, dim3 grid, cudaStream_t st) {
  constexpr int K = BB_HALO_K;
  using T = HaloTile<K>;
  auto kern = &fluid_halo_kernel<K, bool(I & 8), bool(I & 4), bool(I & 2),
                                 bool(I & 1)>;
  static int allowed[64] = {0};
  const cudaError_t e = allow_smem(kern, allowed, T::SMEM);
  if (e != cudaSuccess) return e;
  kern<<<grid, T::THREADS, T::SMEM, st>>>(
      a.in, a.out, a.idx, a.table, a.n_mat, a.acc_c, a.acc_s, a.peak, a.psi,
      a.prof_half, a.prof_int, a.amp, a.cph, a.sph, a.vs, a.dt_dx, a.inv_dx,
      a.half_dt, a.g, a.zsrc, a.rows);
  return cudaGetLastError();
}

using Go = cudaError_t (*)(const Args&, dim3, cudaStream_t);

// the instantiation of (viscous, with_dft, volume, xall)
Go instantiation(int viscous, int with_dft, int volume, int xall) {
  static const Go table[16] = {go<0>,  go<1>,  go<2>,  go<3>, go<4>,  go<5>,
                               go<6>,  go<7>,  go<8>,  go<9>, go<10>, go<11>,
                               go<12>, go<13>, go<14>, go<15>};
  return table[(viscous ? 8 : 0) | (with_dft ? 4 : 0) | (volume ? 2 : 0) |
               (xall ? 1 : 0)];
}

}  // namespace

extern "C" {

// *tz, *ty: the owned (z, y) tile of this depth (HaloTile<K>), which
// ops/fdtd_halo_kernels.py's launch geometry must match
int BB_CAT(bb_fluid_halo_tile_k, BB_HALO_K)(int* tz, int* ty) {
  *tz = HaloTile<BB_HALO_K>::TZ;
  *ty = HaloTile<BB_HALO_K>::TY;
  return 0;
}

// K = BB_HALO_K steps in one launch, from the input state (p, vx, vy, vz,
// r) into the output state (p_o, ..., r_o; no field may alias its input);
// acc_c, acc_s, peak in place. psi: host array of (K + 1) x 12 device
// pointers (stage s's psi_p then psi_v lists; stage 0 the input's, stage K
// the output's, no two stages alike); slot: the slot volume (volume
// sources, else null) and src6 a host array of the sparse source's amp,
// cph, sph, ox, oy, oz; rows: host array of K x (s_sin, s_cos, cosw, sinw);
// seg and the grid (gz, gy, gx): ops/fdtd_halo_kernels.py
// halo_launch_geometry.
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
      !covers(gz, T::TZ, n3) || !covers(gy, T::TY, n2) ||
      !covers(gx, seg, n1)) {
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
  a.g = make_geo(n1, n2, n3, ns, seg, x_lo, x_hi);
  a.zsrc = zsrc;
  for (int s = 0; s < K; ++s) {
    a.rows.s_sin[s] = rows[4 * s];
    a.rows.s_cos[s] = rows[4 * s + 1];
    a.rows.cosw[s] = rows[4 * s + 2];
    a.rows.sinw[s] = rows[4 * s + 3];
  }
  return (int)instantiation(viscous, with_dft, slot != nullptr,
                            x_lo && x_hi)(a, dim3(gz, gy, gx),
                                          (cudaStream_t)stream);
}

}  // extern "C"

// Viscoelastic (shear) FDTD with a volumetric (dome) drive: K leapfrog
// steps a launch in independent blocks that recompute a halo, for NVIDIA
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
// what it recomputes: the halo each block reads again (L2 mostly), and the
// state of the steps in between, which goes through scratch volumes (below).
//
// Design (the fluid halo sweep's, fdtd_fluid_halo.cu, for a stencil whose
// every half-step reads both ways along x):
//   - No cooperative launch and no grid barrier, so neither K nor the plane
//     size is bounded by how many blocks the card holds at once (the
//     lockstep visco sweep, fdtd_visco_fused.cu, fits 396 blocks: not even
//     K = 1 at the dome's 392x337 planes).
//   - Tiles and halo. A block owns a (y, z) tile of ViscoHaloTile<K>::TZ x
//     TY columns and a segment of x-planes [x0, x1). What a cut edge
//     contaminates reaches 3 cells a step along each axis (the chains of
//     fields alternate forward and backward differences), so the block
//     computes its tile extended by H = 3K cells a side, one thread a
//     column, and marches from H planes below its segment to H above it.
//     Only owned cells reach the output state.
//   - The march. At march step f the thread takes the input stresses of
//     plane f (stage 0's input), then for s = 0..K-1 the velocity of step s
//     at plane a = f - 2 - 4s and its stress at plane b = a - 2. A velocity
//     reads the stresses 2 planes ahead along x (sxx forward), which the
//     previous step's stress produced earlier in this march step; a stress
//     reads vy, vz 2 planes ahead (forward), which its own step's velocity
//     produced just before. x-windows live in registers (sxx, sxy, sxz for
//     the velocity; vx, vy, vz for the stress). The y/z neighbours come
//     from shared memory: rings of 4 planes per step of the velocity's
//     input sxy, sxz, syy, syz, szz and of the stress's input vx, vy, vz,
//     each read by the neighbours 2 march steps after it was written. One
//     __syncthreads() a march step: every cross-thread read is of an
//     earlier march step, and no slot is rewritten before its last read
//     (ops/fdtd_visco_halo_kernels.py march models the schedule;
//     tests/test_torch_visco_volume.py checks every read).
//   - State between steps. A cell's own old values (v for the velocity, the
//     stresses and r for the stress) come from the stage's state in device
//     memory: stage 0 the input, stage K the output, stages 1..K-1 scratch
//     copies of the 15 fields and the 36 psi slabs, written by the step
//     before, 4 march steps earlier, by this thread. A scratch value is
//     written only where this block's step is exact; every block that
//     writes a cell writes the same bits, and a block reads a scratch cell
//     only after it wrote it itself, or where its own result is discarded
//     anyway (exactness only shrinks from step to step). This keeps the
//     registers to the x-windows: a column's r alone would take 24 a step
//     boundary held 4 march steps.
//   - State is out of place. Neighbours read this launch's input state of
//     their halo cells, so the input stays unchanged: the kernel reads an
//     input copy and writes an output copy (which must not alias it). The
//     DFT sums and the peak belong to owned cells only and are updated in
//     place, step after step.
//   - Volume drive. Every velocity stage applies it, at halo cells too, so
//     that a halo evolves as its owner's interior does: after the CPML
//     update, where the dense int32 slot volume holds a source, the three
//     velocities are set from its six floats (read through __ldg). The slot
//     of a cell is read once a launch, when the march first reaches its
//     plane, and stays in a register ring for the K steps that use it.
//   - Whole grids only: both x-CPML slabs are applied (sharded shear runs
//     with a volumetric drive keep pair + scatter, ops/fdtd.py).
// Registers bound the tile: each column keeps six x-windows a step (27
// floats) and the slot ring, at one block an SM. Shared memory: 32 planes a
// step of the extended tile (dynamic, above 48 KB). ops/
// fdtd_visco_halo_kernels.py visco_halo_launch_geometry takes
// ViscoHaloTile<K> (checked through bb_visco_halo_tile_k<K> before a
// depth's first launch) and cuts x into segments. Each depth is a
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

// table rows (ops/fdtd.py _build_indexed_materials)
constexpr int kRhoInv = 0, kPiU = 1, kMuU = 2, kCRp = 3, kCRs = 4, kBR = 5;

// The block of a K-step launch: an owned tile of TZ x TY (z, y) columns
// extended by H = 3K a side, one thread a column (one block an SM: at most
// 65536 / THREADS registers a thread)
template <int K>
struct ViscoHaloTile {
  static constexpr int TZ = (K == 1) ? 32 : 16;
  static constexpr int TY = 8;
  static constexpr int H = kReach * K;
  static constexpr int EZ = TZ + 2 * H;
  static constexpr int EY = TY + 2 * H;
  static constexpr int THREADS = EZ * EY;
  static constexpr int SMEM =
      K * kRings * kRing * THREADS * (int)sizeof(float);
};

// stage s's state (stage 0 the input, stage K the output)
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
// visco_stress_kernel in one march of independent blocks
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
  constexpr int kSlots = kLag * (K - 1) + 1;
  extern __shared__ float sm[];  // [K][kRings][kRing][E]
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
  const int ns = g.ns;

  auto ring = [&](int s, int r, int i) -> float* {
    return sm + ((s * kRings + r) * kRing + (i & (kRing - 1))) * E;
  };
  // a y/z neighbour in a ring plane (0 outside the extended tile; threads
  // off the grid store 0)
  auto lat = [&](const float* r, int dy, int dz) -> float {
    return ((unsigned)(ey + dy) < (unsigned)T::EY &&
            (unsigned)(ez + dz) < (unsigned)T::EZ)
               ? r[tid + dy * T::EZ + dz]
               : 0.0f;
  };
  // backward (d_minus: -2..+1) and forward (d_plus: -1..+2) differences
  // along y (dy = 1) or z (dz = 1) in a ring plane
  auto back = [&](const float* r, int dy, int dz) {
    return stencil(lat(r, -2 * dy, -2 * dz), lat(r, -dy, -dz), r[tid],
                   lat(r, dy, dz));
  };
  auto fwd = [&](const float* r, int dy, int dz) {
    return stencil(lat(r, -dy, -dz), r[tid], lat(r, dy, dz),
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
  // field m of stage s at cell c: the input (read-only in this launch)
  // through __ldg, a scratch stage as plain loads of what this thread wrote
  auto ld = [&](int s, int m, int c) -> float {
    return s == 0 ? __ldg(st.q[0][m] + c) : st.q[s][m][c];
  };
  // the CPML'd derivative whose [lo, hi] slabs are fields m, m + 1 of a
  // stage, along x, y or z at plane i, from stage s's psi into stage s + 1's
  auto cpml_x = [&](float d, int s, int m, const float* prof, int i,
                    bool keep) {
    return cpml_io(d, i, g.xlo, g.xhi, ns, prof, st.q[s][m], st.q[s][m + 1],
                   st.q[s + 1][m], st.q[s + 1][m + 1], jk, plane, keep);
  };
  auto cpml_y = [&](float d, int s, int m, const float* prof, int i,
                    bool keep) {
    return cpml_io(d, y, ns, g.n2 - ns, ns, prof + 4 * ns, st.q[s][m],
                   st.q[s][m + 1], st.q[s + 1][m], st.q[s + 1][m + 1],
                   i * ns * g.n3 + z, g.n3, keep);
  };
  auto cpml_z = [&](float d, int s, int m, const float* prof, int i,
                    bool keep) {
    return cpml_io(d, z, ns, g.n3 - ns, ns, prof + 8 * ns, st.q[s][m],
                   st.q[s][m + 1], st.q[s + 1][m], st.q[s + 1][m + 1],
                   (i * g.n2 + y) * ns, 1, keep);
  };

  // x-windows of step s: its velocity's sxx at a-1..a+2, sxy and sxz at
  // a-2..a+2 (the newest not read yet); its stress's vx at b-2..b+2, vy and
  // vz at b-1..b+2
  float wxx[K][4], wxy[K][5], wxz[K][5], wvx[K][5], wvy[K][4], wvz[K][4];
  int sl[kSlots];  // slots of planes a_0, a_0 - 1, ...
#pragma unroll
  for (int s = 0; s < K; ++s) {
#pragma unroll
    for (int m = 0; m < 5; ++m) {
      wxy[s][m] = wxz[s][m] = wvx[s][m] = 0.0f;
      if (m < 4) wxx[s][m] = wvy[s][m] = wvz[s][m] = 0.0f;
    }
  }
#pragma unroll
  for (int m = 0; m < kSlots; ++m) sl[m] = -1;

  // step s's input stresses of plane i: the x-windows and the rings
  auto take_stress = [&](int s, int i, const float (&sv)[6]) {
    push(wxx[s], sv[0]);
    push(wxy[s], sv[3]);
    push(wxz[s], sv[4]);
    ring(s, kSXY, i)[tid] = sv[3];
    ring(s, kSXZ, i)[tid] = sv[4];
    ring(s, kSYY, i)[tid] = sv[1];
    ring(s, kSYZ, i)[tid] = sv[5];
    ring(s, kSZZ, i)[tid] = sv[2];
  };

  const int f_end = x1 - 1 + kLag * K;  // step K - 1's stress of plane x1 - 1
  for (int f = xs; f <= f_end; ++f) {
    {  // stage 0's input: the stresses of plane f
      float sv[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (marched(f)) {
        const int c = f * plane + jk;
#pragma unroll
        for (int m = 0; m < 6; ++m) sv[m] = ld(0, kS + m, c);
      }
      take_stress(0, f, sv);
    }
#pragma unroll
    for (int m = kSlots - 1; m >= 1; --m) sl[m] = sl[m - 1];
    sl[0] = marched(f - 2) ? __ldg(vs.slot + (f - 2) * plane + jk) : -1;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const int a = f - 2 - kLag * s;  // velocity plane of step s
      const int b = a - kStressLag;    // stress plane of step s
      // --- velocity of plane a (visco_velocity_kernel, then the scatter) ---
      float vxn = 0.0f, vyn = 0.0f, vzn = 0.0f;
      if (marched(a)) {
        const int c = a * plane + jk;
        const float vxo = ld(s, kVX, c), vyo = ld(s, kVY, c),
                    vzo = ld(s, kVZ, c);
        const float* rxy = ring(s, kSXY, a);
        const float* rxz = ring(s, kSXZ, a);
        const float* ryy = ring(s, kSYY, a);
        const float* ryz = ring(s, kSYZ, a);
        const float* rzz = ring(s, kSZZ, a);
        const float dsxy_y = back(rxy, 1, 0);
        const float dsxz_z = back(rxz, 0, 1);
        const float dsyy_y = fwd(ryy, 1, 0);
        const float dsyz_z = back(ryz, 0, 1);
        const float dsyz_y = back(ryz, 1, 0);
        const float dszz_z = fwd(rzz, 0, 1);
        const float ri = __ldg(table + kRhoInv * n_mat + __ldg(idx + c));
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
        vzn = vzo + dt_dx * ri * (d6 + d7 + d8);
        if (z == zsrc) {
          const int ij = a * g.n2 + y;
          const float am = __ldg(amp + ij);
          if (am > 0.0f) {
            vzn = am * (rows.s_sin[s] * __ldg(cph + ij) +
                        rows.s_cos[s] * __ldg(sph + ij));
          }
        }
        vxn = vxo + dt_dx * ri * (d0 + d1 + d2);
        vyn = vyo + dt_dx * ri * (d3 + d4 + d5);
        const int qv = sl[kLag * s];
        if (qv >= 0) {
          const float sv =
              __ldg(vs.amp + qv) * (rows.s_sin[s] * __ldg(vs.cph + qv) +
                                    rows.s_cos[s] * __ldg(vs.sph + qv));
          vxn = sv * __ldg(vs.ox + qv);
          vyn = sv * __ldg(vs.oy + qv);
          vzn = sv * __ldg(vs.oz + qv);
        }
        if (keep) {
          st.q[s + 1][kVX][c] = vxn;
          st.q[s + 1][kVY][c] = vyn;
          st.q[s + 1][kVZ][c] = vzn;
        }
      }
      ring(s, kRVX, a)[tid] = vxn;  // 0 off the marched planes
      ring(s, kRVY, a)[tid] = vyn;
      ring(s, kRVZ, a)[tid] = vzn;
      push(wvx[s], vxn);
      push(wvy[s], vyn);
      push(wvz[s], vzn);
      // --- stress of plane b (visco_stress_kernel) ---
      float sn[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (marched(b)) {
        const int c = b * plane + jk;
        const int mi = __ldg(idx + c);
        const float pi_u = __ldg(table + kPiU * n_mat + mi);
        const float mu_u = __ldg(table + kMuU * n_mat + mi);
        const float c_rp = __ldg(table + kCRp * n_mat + mi);
        const float c_rs = __ldg(table + kCRs * n_mat + mi);
        const float b_r = __ldg(table + kBR * n_mat + mi);
        float so[6], ro[6];
#pragma unroll
        for (int m = 0; m < 6; ++m) {
          so[m] = ld(s, kS + m, c);
          ro[m] = VISCOUS ? ld(s, kR + m, c) : 0.0f;
        }
        const float* rvx = ring(s, kRVX, b);
        const float* rvy = ring(s, kRVY, b);
        const float* rvz = ring(s, kRVZ, b);
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
        float rn[6];
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
        if (keep) {
#pragma unroll
          for (int m = 0; m < 6; ++m) {
            st.q[s + 1][kS + m][c] = sn[m];
            if (VISCOUS) st.q[s + 1][kR + m][c] = rn[m];
          }
        }
        if (WITH_DFT && own(b)) {
          const float p = -(sn[0] + sn[1] + sn[2]) * kThird;
          acc_c[c] = acc_c[c] + p * rows.cosw[s];
          acc_s[c] = acc_s[c] + p * rows.sinw[s];
          peak[c] = fmaxf(peak[c], fabsf(p));
        }
      }
      if (s + 1 < K) take_stress(s + 1, b, sn);  // step s + 1's input
    }
    // this march step's ring planes written and its reads of earlier ones
    // done: the next step reads the former and rewrites older slots
    __syncthreads();
  }
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
  kern<<<grid, T::THREADS, T::SMEM, stream>>>(
      a.st, a.idx, a.table, a.n_mat, a.acc_c, a.acc_s, a.peak, a.prof_half,
      a.prof_int, a.amp, a.cph, a.sph, a.vs, a.dt_dx, a.inv_dx, a.half_dt,
      a.g, a.zsrc, a.rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// *tz, *ty: the owned (z, y) tile of this depth (ViscoHaloTile<K>), which
// ops/fdtd_visco_halo_kernels.py's launch geometry must match
int BB_CAT(bb_visco_halo_tile_k, BB_VHALO_K)(int* tz, int* ty) {
  *tz = ViscoHaloTile<BB_VHALO_K>::TZ;
  *ty = ViscoHaloTile<BB_VHALO_K>::TY;
  return 0;
}

// K = BB_VHALO_K steps in one launch of a whole grid. q: host array of
// (K + 1) x 51 device pointers, stage s's state (vx, vy, vz, sxx, syy, szz,
// sxy, sxz, syz, rxx, ryy, rzz, rxy, rxz, ryz, the velocity's 18 psi slabs,
// the stress's 18): stage 0 the input, stage K the output, no pointer in two
// stages; acc_c, acc_s, peak in place; slot: the slot volume and src6 a host
// array of the sparse source's amp, cph, sph, ox, oy, oz; rows: host array
// of K x (s_sin, s_cos, cosw, sinw); seg and the grid (gz, gy, gx):
// ops/fdtd_visco_halo_kernels.py visco_halo_launch_geometry.
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
      !covers(gz, T::TZ, n3) || !covers(gy, T::TY, n2) ||
      !covers(gx, seg, n1) || slot == nullptr || src6 == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{};
  for (int s = 0; s <= K; ++s) {
    for (int m = 0; m < kStage; ++m) {
      a.st.q[s][m] = q[kStage * s + m];
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
  a.g = make_geo(n1, n2, n3, ns, seg, 1, 1);
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

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
//   this cooperative launch may. Each cell's
//   arithmetic is the pair's, in the pair's order (fdtd_stencil.cuh's
//   helpers and their L2-loading twins), so K steps of this kernel equal K
//   steps of the pair bit for bit.
//
// What bounds it on this card: the pair is bound by device-memory traffic
// (41 float volumes a step, 47 inside the sensor window; fdtd_visco.cu). A
// sweep reads the 15 fields and the index (and the DFT sums) once and writes
// the 15 fields once: 31 volumes (37) a sweep, 31/K (37/K) a step, if the
// planes in flight stay in the 50 MB L2 between the stages that touch them.
//
// Design: the lockstep march of fdtd_fluid_fused.cu, for a stencil that
// reads both ways along x. A (y, z) tile that marched alone would recompute
// a halo that widens by 4 cells a side every step and hold 15 fields a
// column; here nothing is recomputed and every field has one copy.
//   - The launch is cooperative: blocks (z-tile, y-tile, stage s), all
//     resident at once, 32x8 columns a block as the pair's
//     (ops/fdtd_visco_fused_kernels.py fused_launch_geometry). Stage s does
//     step s of the sweep: at march step t the velocity of plane
//     i = t - kLag s and the stress of plane i - kStressLag.
//   - Both half-steps read +-2 planes along x (d_plus reads -1..+2, d_minus
//     -2..+1, and each half-step has both), so the stress trails its own
//     stage's velocity by kStressLag = 2 planes: the newest velocity it
//     reads along x (vy, vz at i + 2) is the one this thread has just
//     computed, its y/z neighbours were written two barriers earlier.
//   - Stage s + 1 runs kLag = 5 planes behind stage s: its velocity reads
//     sxx up to 2 planes ahead, which stage s's stress writes kStressLag
//     planes behind its own velocity, so 2 + 2 + 1. Every value a thread
//     reads from another thread was written at an earlier march step and is
//     overwritten only at a later one (ops/fdtd_visco_fused_kernels.py
//     march mirrors the schedule; tests/test_torch_visco_fused.py checks
//     every read against it, and that kLag = 4 fails).
//   - After each march step a grid-wide barrier (cooperative_groups
//     grid.sync). The state is updated in place: each thread keeps its
//     column's x-windows in registers, loading each plane once as it enters
//     (sxx, sxy, sxz for the velocity, from the previous stage; vx, vy, vz
//     for the stress, this thread's own new values, passed from the
//     velocity half in registers). Values another block wrote in this
//     launch are loaded through L2 (ld.global.cg), the index, the table and
//     the source planes through __ldg.
//   - Per-step scalars: the K rows (s_sin, s_cos, cosw, sinw, s_point) of
//     ops/fdtd.py step_scalars, passed by value as float32, the values the
//     pair takes as arguments.
// The price: a grid barrier every march step (N1 + 2 + 5 (K - 1) a sweep),
// only K N2 N3 threads in flight, and registers: a thread holds both
// half-steps' windows. __launch_bounds__ caps it at 80 registers (768
// threads an SM, the pair's stress kernel's), so K x tiles blocks fit on the
// card for K = 2 at 192x192 and 216x216 planes (bb_visco_fused_capacity;
// ops/fdtd_visco_fused_kernels.py admitted_depth).
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

namespace {

using namespace bb;
namespace cg = cooperative_groups;

constexpr int kLag = 5;        // planes between stage s and s + 1
constexpr int kStressLag = 2;  // planes the stress trails its velocity
constexpr int kMaxSteps = 4;   // rows a launch takes (K_CAP in Python)
// 768 threads an SM (80 registers): the co-resident blocks bound K
constexpr int kMinBlocksFused = 3;
constexpr float kThird = (float)(1.0 / 3.0);

// table rows (ops/fdtd.py _build_indexed_materials)
constexpr int kRhoInv = 0, kPiU = 1, kMuU = 2, kCRp = 3, kCRs = 4, kBR = 5;

// the per-step scalars of a launch (ops/fdtd.py step_scalars), row s for
// stage s
struct Rows {
  float s_sin[kMaxSteps], s_cos[kMaxSteps], cosw[kMaxSteps], sinw[kMaxSteps],
      s_pt[kMaxSteps];
};

// K steps of visco_velocity_kernel then visco_stress_kernel (fdtd_visco.cu)
// in one march. s, r: [xx, yy, zz, xy, xz, yz]; psi_s / psi_v: [lo, hi] of
// the velocity's / the stress's nine derivatives (fdtd_visco.cu).
template <bool VISCOUS, bool WITH_DFT, bool POINT, bool XALL>
__global__ void __launch_bounds__(kThreads, kMinBlocksFused)
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
  cg::grid_group grid = cg::this_grid();
  const int st = blockIdx.z;  // this block's step of the sweep
  Col q;
  q.k = blockIdx.x * kTileZ + threadIdx.x;
  q.j = blockIdx.y * kTileY + threadIdx.y;
  q.jk = q.j * g.n3 + q.k;
  q.plane = g.n2 * g.n3;
  q.i0 = 0;
  q.i1 = g.n1;
  // threads off the volume march too: every thread meets every barrier
  const bool inside = q.j < g.n2 && q.k < g.n3;
  const float s_sin = rows.s_sin[st], s_cos = rows.s_cos[st];
  const float cosw = rows.cosw[st], sinw = rows.sinw[st];
  const float sval = rows.s_pt[st];
  const float* sxx = s.p[0];
  const float* syy = s.p[1];
  const float* szz = s.p[2];
  const float* sxy = s.p[3];
  const float* sxz = s.p[4];
  const float* syz = s.p[5];
  // the velocity's x-windows: sxx at planes i-1..i+2 (forward), sxy and sxz
  // at i-2..i+1 (backward)
  float wxx[4] = {}, wxy[4] = {}, wxz[4] = {};
  // the stress's, this thread's new velocities: vx at planes i-4..i (the
  // stress of plane i-2 reads i-4..i-1, backward), vy and vz at i-3..i
  // (forward: i-3..i); 0 before plane 0 and past the last
  float wvx[5] = {}, wvy[4] = {}, wvz[4] = {};
  const int n_march = g.n1 + kStressLag + kLag * ((int)gridDim.z - 1);
  for (int t = 0; t < n_march; ++t) {
    const int i = t - kLag * st;  // this stage's velocity plane
    if (inside && i >= 0 && i < g.n1 + kStressLag) {
      // --- velocity of plane i (visco_velocity_kernel) ---
      float vxn = 0.0f, vyn = 0.0f, vzn = 0.0f;
      if (i < g.n1) {
        if (i == 0) {
          wxx[0] = 0.0f;
          wxx[1] = at_x2(sxx, 0, q, g.n1);
          wxx[2] = at_x2(sxx, 1, q, g.n1);
          wxx[3] = at_x2(sxx, 2, q, g.n1);
          wxy[0] = wxy[1] = wxz[0] = wxz[1] = 0.0f;
          wxy[2] = at_x2(sxy, 0, q, g.n1);
          wxy[3] = at_x2(sxy, 1, q, g.n1);
          wxz[2] = at_x2(sxz, 0, q, g.n1);
          wxz[3] = at_x2(sxz, 1, q, g.n1);
        } else {
#pragma unroll
          for (int m = 0; m < 3; ++m) {
            wxx[m] = wxx[m + 1];
            wxy[m] = wxy[m + 1];
            wxz[m] = wxz[m + 1];
          }
          wxx[3] = at_x2(sxx, i + 2, q, g.n1);
          wxy[3] = at_x2(sxy, i + 1, q, g.n1);
          wxz[3] = at_x2(sxz, i + 1, q, g.n1);
        }
        const int c = i * q.plane + q.jk;
        const float ri = __ldg(table + kRhoInv * n_mat + __ldg(idx + c));
        const float vx = ld2(v.p[0], c), vy = ld2(v.p[1], c),
                    vz = ld2(v.p[2], c);
        const auto at = [&](const float* f) {
          return PlaneL2{f, c, q.j, q.k, g.n2, g.n3};
        };
        const float dsxy_y = diff_yz2<1, false>(at(sxy));
        const float dsxz_z = diff_yz2<2, false>(at(sxz));
        const float dsyy_y = diff_yz2<1, true>(at(syy));
        const float dsyz_z = diff_yz2<2, false>(at(syz));
        const float dsyz_y = diff_yz2<1, false>(at(syz));
        const float dszz_z = diff_yz2<2, true>(at(szz));
        const CpmlL2<Ptr18, XALL> cp{psi_s, prof_half, prof_int, g, q, i};
        const float d0 = cp.template apply<0, true, 0>(
            stencil(wxx[0], wxx[1], wxx[2], wxx[3]));
        const float d1 = cp.template apply<1, false, 1>(dsxy_y);
        const float d2 = cp.template apply<2, false, 2>(dsxz_z);
        const float d3 = cp.template apply<0, false, 3>(
            stencil(wxy[0], wxy[1], wxy[2], wxy[3]));
        const float d4 = cp.template apply<1, true, 4>(dsyy_y);
        const float d5 = cp.template apply<2, false, 5>(dsyz_z);
        const float d6 = cp.template apply<0, false, 6>(
            stencil(wxz[0], wxz[1], wxz[2], wxz[3]));
        const float d7 = cp.template apply<1, false, 7>(dsyz_y);
        const float d8 = cp.template apply<2, true, 8>(dszz_z);
        vzn = vz + dt_dx * ri * (d6 + d7 + d8);
        if (q.k == zsrc) {
          const int ij = i * g.n2 + q.j;
          const float a = __ldg(amp + ij);
          if (a > 0.0f) {
            vzn = a * (s_sin * __ldg(cph + ij) + s_cos * __ldg(sph + ij));
          }
        }
        vxn = vx + dt_dx * ri * (d0 + d1 + d2);
        vyn = vy + dt_dx * ri * (d3 + d4 + d5);
        v.p[0][c] = vxn;
        v.p[1][c] = vyn;
        v.p[2][c] = vzn;
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) wvx[m] = wvx[m + 1];
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        wvy[m] = wvy[m + 1];
        wvz[m] = wvz[m + 1];
      }
      wvx[4] = vxn;  // 0 past the last plane
      wvy[3] = vyn;
      wvz[3] = vzn;
      // --- stress of plane i - 2 (visco_stress_kernel) ---
      const int is = i - kStressLag;
      if (is >= 0) {
        const int c = is * q.plane + q.jk;
        const int mi = __ldg(idx + c);
        const float pi_u = __ldg(table + kPiU * n_mat + mi);
        const float mu_u = __ldg(table + kMuU * n_mat + mi);
        const float c_rp = __ldg(table + kCRp * n_mat + mi);
        const float c_rs = __ldg(table + kCRs * n_mat + mi);
        const float b_r = __ldg(table + kBR * n_mat + mi);
        float so[6], ro[6], ac = 0.0f, as = 0.0f, pk = 0.0f;
#pragma unroll
        for (int a = 0; a < 6; ++a) {
          so[a] = ld2(s.p[a], c);
          if (VISCOUS) ro[a] = ld2(r.p[a], c);
        }
        if (WITH_DFT) {
          ac = ld2(acc_c, c);
          as = ld2(acc_s, c);
          pk = ld2(peak, c);
        }
        const auto at = [&](const float* f) {
          return PlaneL2{f, c, q.j, q.k, g.n2, g.n3};
        };
        const float dvy_y = diff_yz2<1, false>(at(v.p[1]));
        const float dvz_z = diff_yz2<2, false>(at(v.p[2]));
        const float dvx_y = diff_yz2<1, true>(at(v.p[0]));
        const float dvx_z = diff_yz2<2, true>(at(v.p[0]));
        const float dvy_z = diff_yz2<2, true>(at(v.p[1]));
        const float dvz_y = diff_yz2<1, true>(at(v.p[2]));
        const CpmlL2<Ptr18, XALL> cp{psi_v, prof_half, prof_int, g, q, is};
        const float dii[3] = {
            cp.template apply<0, false, 0>(
                stencil(wvx[0], wvx[1], wvx[2], wvx[3])),
            cp.template apply<1, false, 1>(dvy_y),
            cp.template apply<2, false, 2>(dvz_z)};
        // shear strains: exy, exz, eyz
        const float e[3] = {
            cp.template apply<1, true, 3>(dvx_y) +
                cp.template apply<0, true, 4>(
                    stencil(wvy[0], wvy[1], wvy[2], wvy[3])),
            cp.template apply<2, true, 5>(dvx_z) +
                cp.template apply<0, true, 6>(
                    stencil(wvz[0], wvz[1], wvz[2], wvz[3])),
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
        if (WITH_DFT) {
          const float p = -(sn[0] + sn[1] + sn[2]) * kThird;
          acc_c[c] = ac + p * cosw;
          acc_s[c] = as + p * sinw;
          peak[c] = fmaxf(pk, fabsf(p));
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
      &visco_fused_kernel<bool(I & 8), bool(I & 4), bool(I & 2),
                          bool(I & 1)>);
}

const void* fused_kernel(int viscous, int with_dft, int point, int xall) {
  static const void* const kernels[16] = {
      fused_at<0>(),  fused_at<1>(),  fused_at<2>(),  fused_at<3>(),
      fused_at<4>(),  fused_at<5>(),  fused_at<6>(),  fused_at<7>(),
      fused_at<8>(),  fused_at<9>(),  fused_at<10>(), fused_at<11>(),
      fused_at<12>(), fused_at<13>(), fused_at<14>(), fused_at<15>()};
  return kernels[(viscous ? 8 : 0) | (with_dft ? 4 : 0) | (point ? 2 : 0) |
                 (xall ? 1 : 0)];
}

}  // namespace

extern "C" {

// *blocks: how many blocks of the (viscous, with_dft, point, xall)
// instantiation the current device holds at once (a cooperative launch may
// not exceed it)
int bb_visco_fused_capacity(int viscous, int with_dft, int point, int xall,
                            int* blocks) {
  return (int)cooperative_capacity(
      fused_kernel(viscous, with_dft, point, xall), blocks);
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
      !covers(gy, kTileY, n2)) {
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
  const cudaError_t e = cudaLaunchCooperativeKernel(
      fused_kernel(viscous, with_dft, point, x_lo && x_hi),
      dim3(gz, gy, k_steps), dim3(kTileZ, kTileY), args, 0,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"

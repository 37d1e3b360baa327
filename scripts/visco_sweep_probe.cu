// The skeleton of the first design of the visco lockstep sweep
// (csrc/fdtd_visco_fused.cu before its redesign for Hopper: every load
// through L2), for scripts/visco_sweep_probe.py: the same
// cooperative launch (blocks of 32x8 threads, one cell a thread, K stages
// kLag = 5 planes apart, the stress kStressLag = 2 planes behind its
// velocity, a grid barrier after each march step, __launch_bounds__(256,
// 3)), doing either
//   mode 0: nothing but the march steps' grid barriers, or
//   mode 1: the barriers and every load the sweep issues at a cell-stage
//     (through L2, ld.global.cg, as the sweep's ld2): the velocity's three
//     x-window entries, old vx, vy, vz, index and rho_inv, the 24
//     neighbours of its six y/z differences and the psi value of each of
//     its CPML'd derivatives; the stress's index and five table entries,
//     six stresses, six memories (with VISCOUS), the DFT sums and peak
//     (with WITH_DFT), the 24 neighbours of its six y/z differences and
//     its psi values. The loads are summed in a register and one float a
//     thread is written after the march, so no load is dropped; no field
//     is written.
// The arithmetic and the 15-18 stores a cell-stage are what the sweep
// adds to mode 1.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fdtd_stencil.cuh"

namespace {

using namespace bb;
namespace cg = cooperative_groups;

constexpr int kLag = 5;
constexpr int kStressLag = 2;

// f at plane i of column q through L2, 0 outside [0, n1)
__device__ __forceinline__ float at_x2(const float* f, int i, const Col& q,
                                       int n1) {
  return (unsigned)i < (unsigned)n1 ? ld2(f, i * q.plane + q.jk) : 0.0f;
}

// a field around cell c in its plane through L2 (0 outside the grid)
struct PlaneL2 {
  const float* f;
  int c, j, k, n2, n3;
  __device__ __forceinline__ float operator()(int dy, int dz) const {
    return ((unsigned)(j + dy) < (unsigned)n2 &&
            (unsigned)(k + dz) < (unsigned)n3)
               ? ld2(f, c + dy * n3 + dz)
               : 0.0f;
  }
};

// the psi value a CPML'd derivative along an axis reads at position pos
// (lo slab, then hi slab), 0 outside both
__device__ __forceinline__ float psi_at(const float* lo, const float* hi,
                                        int pos, int ns, int n, int base,
                                        int stride) {
  float a = 0.0f;
  if (pos < ns) a += ld2(lo, base + pos * stride);
  if (pos >= n - ns) a += ld2(hi, base + (pos - (n - ns)) * stride);
  return a;
}

// the y/z neighbours of the four-point difference along AXIS
template <int AXIS, bool PLUS>
__device__ __forceinline__ float nb(const PlaneL2& f) {
  constexpr int lo = PLUS ? -1 : -2;
  constexpr int dy = AXIS == 1 ? 1 : 0;
  constexpr int dz = AXIS == 2 ? 1 : 0;
  return f(lo * dy, lo * dz) + f((lo + 1) * dy, (lo + 1) * dz) +
         f((lo + 2) * dy, (lo + 2) * dz) + f((lo + 3) * dy, (lo + 3) * dz);
}

template <int MODE, bool VISCOUS, bool WITH_DFT>
__global__ void __launch_bounds__(kThreads, 3)
    probe_kernel(Ptr3 v, Ptr6 s, Ptr6 r, const int* __restrict__ idx,
                 const float* __restrict__ table, int n_mat,
                 const float* __restrict__ acc_c,
                 const float* __restrict__ acc_s,
                 const float* __restrict__ peak, Ptr18 psi_s, Ptr18 psi_v,
                 Geo g, float* __restrict__ sink) {
  cg::grid_group grid = cg::this_grid();
  const int st = blockIdx.z;
  Col q;
  q.k = blockIdx.x * kTileZ + threadIdx.x;
  q.j = blockIdx.y * kTileY + threadIdx.y;
  q.jk = q.j * g.n3 + q.k;
  q.plane = g.n2 * g.n3;
  q.i0 = 0;
  q.i1 = g.n1;
  const bool inside = q.j < g.n2 && q.k < g.n3;
  float acc = 0.0f;
  const int n_march = g.n1 + kStressLag + kLag * ((int)gridDim.z - 1);
  for (int t = 0; t < n_march; ++t) {
    const int i = t - kLag * st;
    if (MODE == 1 && inside && i >= 0 && i < g.n1 + kStressLag) {
      if (i < g.n1) {
        acc += at_x2(s.p[0], i + 2, q, g.n1) + at_x2(s.p[3], i + 1, q, g.n1) +
               at_x2(s.p[4], i + 1, q, g.n1);
        const int c = i * q.plane + q.jk;
        acc += __ldg(table + __ldg(idx + c));
        acc += ld2(v.p[0], c) + ld2(v.p[1], c) + ld2(v.p[2], c);
        const auto at = [&](const float* f) {
          return PlaneL2{f, c, q.j, q.k, g.n2, g.n3};
        };
        acc += nb<1, false>(at(s.p[3])) + nb<2, false>(at(s.p[4])) +
               nb<1, true>(at(s.p[1])) + nb<2, false>(at(s.p[5])) +
               nb<1, false>(at(s.p[5])) + nb<2, true>(at(s.p[2]));
        for (int d = 0; d < 9; ++d) {
          const int ax = d % 3;
          acc += ax == 0   ? psi_at(psi_s.p[2 * d], psi_s.p[2 * d + 1], i,
                                    g.ns, g.n1, q.jk, q.plane)
                 : ax == 1 ? psi_at(psi_s.p[2 * d], psi_s.p[2 * d + 1], q.j,
                                    g.ns, g.n2, i * g.ns * g.n3 + q.k, g.n3)
                           : psi_at(psi_s.p[2 * d], psi_s.p[2 * d + 1], q.k,
                                    g.ns, g.n3, (i * g.n2 + q.j) * g.ns, 1);
        }
      }
      const int is = i - kStressLag;
      if (is >= 0) {
        const int c = is * q.plane + q.jk;
        const int mi = __ldg(idx + c);
        for (int a = 1; a < 6; ++a) acc += __ldg(table + a * n_mat + mi);
        for (int a = 0; a < 6; ++a) {
          acc += ld2(s.p[a], c);
          if (VISCOUS) acc += ld2(r.p[a], c);
        }
        if (WITH_DFT) acc += ld2(acc_c, c) + ld2(acc_s, c) + ld2(peak, c);
        const auto at = [&](const float* f) {
          return PlaneL2{f, c, q.j, q.k, g.n2, g.n3};
        };
        acc += nb<1, false>(at(v.p[1])) + nb<2, false>(at(v.p[2])) +
               nb<1, true>(at(v.p[0])) + nb<2, true>(at(v.p[0])) +
               nb<2, true>(at(v.p[1])) + nb<1, true>(at(v.p[2]));
        for (int d = 0; d < 9; ++d) {
          const int ax = d < 3 ? d : (d == 3 || d == 8 ? 1 : (d == 7 ? 2
                                      : (d == 4 || d == 6 ? 0 : 2)));
          acc += ax == 0   ? psi_at(psi_v.p[2 * d], psi_v.p[2 * d + 1], is,
                                    g.ns, g.n1, q.jk, q.plane)
                 : ax == 1 ? psi_at(psi_v.p[2 * d], psi_v.p[2 * d + 1], q.j,
                                    g.ns, g.n2, is * g.ns * g.n3 + q.k, g.n3)
                           : psi_at(psi_v.p[2 * d], psi_v.p[2 * d + 1], q.k,
                                    g.ns, g.n3, (is * g.n2 + q.j) * g.ns, 1);
        }
      }
    }
    if (t + 1 < n_march) grid.sync();
  }
  if (inside) sink[(st * g.n2 + q.j) * g.n3 + q.k] = acc;
}

template <int M, bool V, bool D>
const void* kern() {
  return reinterpret_cast<const void*>(&probe_kernel<M, V, D>);
}

const void* pick(int mode, int viscous, int dft) {
  static const void* const k[8] = {kern<0, false, false>(),
                                   kern<0, false, true>(),
                                   kern<0, true, false>(),
                                   kern<0, true, true>(),
                                   kern<1, false, false>(),
                                   kern<1, false, true>(),
                                   kern<1, true, false>(),
                                   kern<1, true, true>()};
  return k[(mode ? 4 : 0) | (viscous ? 2 : 0) | (dft ? 1 : 0)];
}

}  // namespace

extern "C" {

// mode 0 (barriers) or 1 (barriers and loads) of K = k_steps stages over
// the (n1, n2, n3) grid (pointers as bb_visco_fused's); sink: k_steps x n2
// x n3 floats
int bb_visco_probe(int mode, float* const* v3, float* const* s6,
                   float* const* r6, const int* idx, const float* table,
                   int n_mat, const float* acc_c, const float* acc_s,
                   const float* peak, float* const* psi_s18,
                   float* const* psi_v18, int n1, int n2, int n3, int ns,
                   int viscous, int dft, int k_steps, float* sink,
                   void* stream) {
  Geo g = make_geo(n1, n2, n3, ns, n1, 1, 1);
  Ptr3 v = gather<3, Ptr3>(v3);
  Ptr6 s = gather<6, Ptr6>(s6);
  Ptr6 r = gather<6, Ptr6>(r6);
  Ptr18 ps = gather<18, Ptr18>(psi_s18);
  Ptr18 pv = gather<18, Ptr18>(psi_v18);
  void* args[] = {&v,  &s,  &r,  &idx, &table, &n_mat, &acc_c,
                  &acc_s, &peak, &ps, &pv, &g, &sink};
  const int gz = (n3 + kTileZ - 1) / kTileZ, gy = (n2 + kTileY - 1) / kTileY;
  const cudaError_t e = cudaLaunchCooperativeKernel(
      pick(mode, viscous, dft), dim3(gz, gy, k_steps), dim3(kTileZ, kTileY),
      args, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"

// Device helpers shared by the FDTD kernels (fdtd_fluid.cu, fdtd_visco.cu,
// the fused sweeps fdtd_fluid_fused.cu, fdtd_visco_fused.cu and the halo
// sweeps fdtd_fluid_halo.cu, fdtd_visco_halo.cu): the
// x-marching tile geometry, the 4th-order staggered differences from
// register windows (x) and L1 loads (y, z), the CPML slab correction, the
// halo and lockstep sweeps' staged loads, the halo sweeps' cluster exchange
// and cluster launch, and the check of the launch
// grid the wrapper chose. Everything is written in
// the operation order of the plain PyTorch versions (ops/fdtd_kernels.py
// d_plus, d_minus, _cpml), so kernel and plain version round alike.
//
// Geometry: a block of kTileZ x kTileY threads owns a (y, z) tile of
// columns (threadIdx.x along z, so each warp reads and writes 128
// contiguous bytes) and marches along x over a segment of planes [i0, i1);
// the grid is (z-tiles, y-tiles, x-segments), chosen by ops/fdtd_kernels.py
// launch_geometry. Cells are addressed by 32-bit in-plane offsets plus a
// plane offset, formed only for planes inside the grid (the wrappers keep
// N1 N2 N3 below 2^31): no division.
#pragma once

#include <cuda_runtime.h>

namespace bb {

constexpr float kC1 = 1.125f;                 // 9/8
constexpr float kC2 = -0.041666666666666664f;  // -1/24
constexpr int kTileZ = 32;  // threads along z: a warp covers 32 floats
constexpr int kTileY = 8;   // threads along y
constexpr int kThreads = kTileZ * kTileY;

struct Ptr3 { float* p[3]; };
struct Ptr6 { float* p[6]; };
struct Ptr18 { float* p[18]; };  // 9 CPML'd derivatives: [lo, hi] each

// a pointer list from a host array of device pointers
template <int N, typename T>
T gather(float* const* host) {
  T out;
  for (int a = 0; a < N; ++a) out.p[a] = host[a];
  return out;
}

// The grid, the CPML slab depth, the x-segment length, and where this
// launch applies the x CPML: its lo slab at planes [0, xlo) and its hi slab
// at [xhi, n1), and the y CPML: rows [0, ylo) and [yhi, n2). A whole grid
// applies all four (xlo = ns, xhi = n1 - ns, ylo = ns, yhi = n2 - ns); a
// shard of an (x, y) decomposition applies a slab only where it holds that
// global edge (xlo = 0, xhi = n1, ylo = 0 or yhi = n2 otherwise:
// ops/fdtd.py, parallel/halo.py). Only the pairs' shards' instantiations
// read ylo / yhi (Cpml, XALL = false); the sweeps, which decompose x only,
// pass y flags of both slabs and apply both y slabs (slab below).
struct Geo {
  int n1, n2, n3, ns, seg, xlo, xhi, ylo, yhi;
};

// the Geo of a launch; x_lo / x_hi / y_lo / y_hi: whether it applies the
// x / y lo / hi slab
inline Geo make_geo(int n1, int n2, int n3, int ns, int seg, int x_lo,
                    int x_hi, int y_lo, int y_hi) {
  return Geo{n1, n2, n3, ns, seg, x_lo ? ns : 0, x_hi ? n1 - ns : n1,
             y_lo ? ns : 0, y_hi ? n2 - ns : n2};
}

// This thread's column (j, k) and the x-planes [i0, i1) of its block
struct Col {
  int j, k, jk, plane, i0, i1;
};

// the column of this thread; false outside the grid
__device__ __forceinline__ bool column(Col& q, const Geo& g) {
  q.k = blockIdx.x * kTileZ + threadIdx.x;
  q.j = blockIdx.y * kTileY + threadIdx.y;
  q.jk = q.j * g.n3 + q.k;
  q.plane = g.n2 * g.n3;
  q.i0 = blockIdx.z * g.seg;
  q.i1 = min(q.i0 + g.seg, g.n1);
  return q.j < g.n2 && q.k < g.n3;
}

// start f at plane i of column q (if inside the grid) on its way to L2
__device__ __forceinline__ void prefetch(const void* f, int i, const Col& q,
                                         int n1) {
  if (i < n1) {
    const float* p = static_cast<const float*>(f) + (i * q.plane + q.jk);
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
  }
}

// the 4th-order staggered difference from four consecutive samples
// f0..f3: forward at i+1/2 from f(i-1..i+2), backward at i from f(i-2..i+1)
// (the plain versions' d_plus / d_minus, zero outside the grid)
__device__ __forceinline__ float stencil(float f0, float f1, float f2,
                                         float f3) {
  return kC1 * (f2 - f1) + kC2 * (f3 - f0);
}

// f at plane i of column q, 0 outside [0, n1) (a read-only field)
__device__ __forceinline__ float at_x(const float* f, int i, const Col& q,
                                      int n1) {
  return (unsigned)i < (unsigned)n1 ? __ldg(f + (i * q.plane + q.jk)) : 0.0f;
}

// A read-only field's x-window at planes i+LO .. i+LO+3 of a column (LO =
// -1 for a forward difference, -2 for a backward one), in registers: each
// plane is loaded once, as it enters.
template <int LO>
struct XWin {
  float w[4];
  __device__ __forceinline__ void start(const float* f, const Col& q, int n1) {
#pragma unroll
    for (int m = 1; m < 4; ++m) w[m] = at_x(f, q.i0 + LO + m - 1, q, n1);
  }
  __device__ __forceinline__ void advance(const float* f, int i, const Col& q,
                                          int n1) {
    w[0] = w[1];
    w[1] = w[2];
    w[2] = w[3];
    w[3] = at_x(f, i + LO + 3, q, n1);
  }
  __device__ __forceinline__ float diff() const {
    return stencil(w[0], w[1], w[2], w[3]);
  }
};

// XWin with its next entry loaded a plane early: advance() at plane i
// shifts in the value loaded at plane i - 1 and issues the load of the
// entry plane i + 1 needs
template <int LO>
struct XWinAhead : XWin<LO> {
  float ahead;
  __device__ __forceinline__ void start(const float* f, const Col& q, int n1) {
    XWin<LO>::start(f, q, n1);
    ahead = at_x(f, q.i0 + LO + 3, q, n1);
  }
  __device__ __forceinline__ void advance(const float* f, int i, const Col& q,
                                          int n1) {
    this->w[0] = this->w[1];
    this->w[1] = this->w[2];
    this->w[2] = this->w[3];
    this->w[3] = ahead;
    ahead = at_x(f, i + LO + 4, q, n1);
  }
};

// a read-only field around cell c in its plane, for the y/z neighbours
// (through L1; 0 outside the grid)
struct Plane {
  const float* f;
  int c, j, k, n2, n3;
  __device__ __forceinline__ float operator()(int dy, int dz) const {
    return ((unsigned)(j + dy) < (unsigned)n2 &&
            (unsigned)(k + dz) < (unsigned)n3)
               ? __ldg(f + (c + dy * n3 + dz))
               : 0.0f;
  }
};

// the difference along y (AXIS 1) or z (AXIS 2): forward (PLUS) or backward
template <int AXIS, bool PLUS>
__device__ __forceinline__ float diff_yz(const Plane& f) {
  constexpr int lo = PLUS ? -1 : -2;
  constexpr int dy = AXIS == 1 ? 1 : 0;
  constexpr int dz = AXIS == 2 ? 1 : 0;
  return stencil(f(lo * dy, lo * dz), f((lo + 1) * dy, (lo + 1) * dz),
                 f((lo + 2) * dy, (lo + 2) * dz),
                 f((lo + 3) * dy, (lo + 3) * dz));
}

// CPML correction of derivative d at position pos along an axis: psi' =
// b psi + a d; d += psi', in the lo slab at pos < lo_end and in the hi slab
// at pos >= hi_start (its plane pos - hi_start). The lo slab is applied
// before the hi slab (they meet only when n < 2 ns), matching the XLA order.
// prof holds [b_lo, a_lo, b_hi, a_hi] x ns for this axis; the psi value of
// slab plane q for this cell sits at base + q * stride.
__device__ __forceinline__ float cpml(float d, int pos, int lo_end,
                                      int hi_start, int ns,
                                      const float* __restrict__ prof,
                                      float* __restrict__ psi_lo,
                                      float* __restrict__ psi_hi, int base,
                                      int stride) {
  if (pos < lo_end) {
    const int s = base + pos * stride;
    const float nw = prof[pos] * psi_lo[s] + prof[ns + pos] * d;
    psi_lo[s] = nw;
    d = d + nw;
  }
  const int q = pos - hi_start;
  if (q >= 0) {
    const int s = base + q * stride;
    const float nw = prof[2 * ns + q] * psi_hi[s] + prof[3 * ns + q] * d;
    psi_hi[s] = nw;
    d = d + nw;
  }
  return d;
}

// The CPML'd derivative number Q of a kernel's psi list (PSI: Ptr6 or
// Ptr18, slabs [lo, hi] of each derivative in turn), along AXIS at cell
// (i, q.j, q.k): psi slabs (ns, N2, N3), (N1, ns, N3) or (N1, N2, ns).
// Forward differences take the "half" profiles, backward ones the "int"
// profiles (a kernel without one of the two passes nullptr for it). Along
// z both slabs; along x and y both at the array's ends with XALL (a whole
// grid: the code of an unsharded launch), else the slabs this launch owns
// (Geo xlo, xhi, ylo, yhi).
template <typename PSI, bool XALL>
struct Cpml {
  const PSI& psi;
  const float* prof_half;  // forward differences
  const float* prof_int;   // backward differences
  const Geo& g;
  const Col& q;
  int i;
  template <int AXIS, bool PLUS, int Q>
  __device__ __forceinline__ float apply(float d) const {
    const float* prof = (PLUS ? prof_half : prof_int) + AXIS * 4 * g.ns;
    float* lo = psi.p[2 * Q];
    float* hi = psi.p[2 * Q + 1];
    if constexpr (AXIS == 0) {
      if constexpr (XALL) {
        return cpml(d, i, g.ns, g.n1 - g.ns, g.ns, prof, lo, hi, q.jk,
                    q.plane);
      } else {
        return cpml(d, i, g.xlo, g.xhi, g.ns, prof, lo, hi, q.jk, q.plane);
      }
    } else if constexpr (AXIS == 1) {
      if constexpr (XALL) {
        return cpml(d, q.j, g.ns, g.n2 - g.ns, g.ns, prof, lo, hi,
                    i * g.ns * g.n3 + q.k, g.n3);
      } else {
        return cpml(d, q.j, g.ylo, g.yhi, g.ns, prof, lo, hi,
                    i * g.ns * g.n3 + q.k, g.n3);
      }
    } else {
      return cpml(d, q.k, g.ns, g.n3 - g.ns, g.ns, prof, lo, hi,
                  (i * g.n2 + q.j) * g.ns, 1);
    }
  }
};

// A field another block of the same launch may have written (the lockstep
// sweeps' second CPML slab, cpml_staged below): loaded through L2
// (ld.global.cg), since another SM may have written the cell since this
// SM's L1 cached its line.
__device__ __forceinline__ float ld2(const float* f, int c) {
  return __ldcg(f + c);
}

// The halo sweeps (fdtd_fluid_halo.cu, fdtd_visco_halo.cu): their
// out-of-place CPML, the volumetric drive they read, and their dynamic
// shared memory.

// cpml reading psi from `in` and writing the new value to `out` (where
// `keep`): the same arithmetic, out of place
__device__ __forceinline__ float cpml_io(float d, int pos, int lo_end,
                                         int hi_start, int ns,
                                         const float* __restrict__ prof,
                                         const float* in_lo,
                                         const float* in_hi, float* out_lo,
                                         float* out_hi, int base, int stride,
                                         bool keep) {
  if (pos < lo_end) {
    const int s = base + pos * stride;
    const float nw = prof[pos] * in_lo[s] + prof[ns + pos] * d;
    if (keep) out_lo[s] = nw;
    d = d + nw;
  }
  const int q = pos - hi_start;
  if (q >= 0) {
    const int s = base + q * stride;
    const float nw = prof[2 * ns + q] * in_hi[s] + prof[3 * ns + q] * d;
    if (keep) out_hi[s] = nw;
    d = d + nw;
  }
  return d;
}

// the volumetric drive: the dense slot volume (ops/fdtd_sources.py
// VolumeSource.slot_volume: -1, or the voxel's index in the sparse list)
// and the six floats of each source voxel
struct VolSrc {
  const int* slot;
  const float *amp, *cph, *sph, *ox, *oy, *oz;
};

// The halo sweeps' clusters (Hopper thread-block clusters, launched by
// launch_cluster below): the blocks of a cluster are stacked along y, each
// computing a slab of rows of the cluster's extended tile, and exchange the
// rows their neighbours' stencils reach (ranks rank - 1 and rank + 1)
// through distributed shared memory: an address of this block's shared
// window is mapped onto another rank's with mapa, then stored to with
// st_async, signalled on the receiving block's mbarrier, which the receiver
// waits on. The cluster barrier (cluster_arrive / cluster_wait) only
// brackets a launch: every block has started before any stores into it,
// and none leaves while others may still store into it. A cluster barrier
// a march step instead measured slower: its release and acquire compile to
// a GPU-scope fence and an L1 invalidation (sm_90a).

// this block's rank in its cluster
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}

// the shared-memory (shared::cta) address of p
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// address `a` of this block's shared memory, in the window of cluster rank r
__device__ __forceinline__ unsigned map_rank(unsigned a, int r) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(a), "r"(r));
  return out;
}

// store a float into another block of the cluster (address `a` from
// map_rank) and signal its 4 bytes on that block's mbarrier (`bar`, an
// address from map_rank too: complete_tx); the writer does not wait
__device__ __forceinline__ void st_async(unsigned a, float v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(a),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

// this thread's arrival on bar, expecting `bytes` more to land in the phase
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// the cluster barrier, split: arrive releases this thread's earlier shared
// memory writes to the cluster, wait acquires everyone's
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// The halo sweeps' staged loads: each thread copies the global values its
// own column needs at the next march step into its own shared-memory slots
// with cp.async (4 bytes, zero-filled where `valid` is false: "0 outside
// the grid"), and one mbarrier of the block, initialised with a count of
// the block's threads, completes a phase when every thread's copies of that
// step have landed (cp.async.mbarrier.arrive.noinc: the arrival is the
// copies' completion). No thread reads another's slots, so the mbarrier
// wait, not a block barrier, is what a step waits on.

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// copy 4 bytes from src (global) to dst (this block's shared memory), or
// store 0 there if !valid (src is then not read)
__device__ __forceinline__ void cp_async4z(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// this thread's arrival on bar: when all its cp.async copies so far land
__device__ __forceinline__ void cp_async_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait until bar's phase of the given parity has completed; a phase that
// never completes (a miscounted exchange) traps after ~2^26 tries instead
// of hanging the card
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned a = smem_u32(bar);
  unsigned done = 0;
  for (unsigned tries = 0;; ++tries) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > (1u << 26)) __trap();
  }
}

// The lockstep sweeps' staged CPML (fdtd_fluid_fused.cu,
// fdtd_visco_fused.cu): the old psi value of a derivative's first slab is
// loaded ahead of its use, the second (both apply only on an axis shorter
// than 2 ns) at use.

// Where the CPML of a derivative along AXIS applies at cell (i, j, k):
// its position pos along the axis, the lo slab below lo_end, the hi slab
// from hi_start, the psi value of slab plane q at base + q * stride (the
// indexing of Cpml above)
struct Slab {
  int pos, lo_end, hi_start, base, stride;
};

template <int AXIS, bool XALL>
__device__ __forceinline__ Slab slab(const Geo& g, int i, int j, int k,
                                     int jk, int plane) {
  if (AXIS == 0) {
    return XALL ? Slab{i, g.ns, g.n1 - g.ns, jk, plane}
                : Slab{i, g.xlo, g.xhi, jk, plane};
  }
  // along y both slabs: the sweeps decompose x only (reading Geo's y flags
  // here changed the registers and spills of their shards' twins on an
  // H100, PERF.md)
  if (AXIS == 1) return Slab{j, g.ns, g.n2 - g.ns, i * g.ns * g.n3 + k, g.n3};
  return Slab{k, g.ns, g.n3 - g.ns, (i * g.n2 + j) * g.ns, 1};
}

// the psi value the first slab that applies holds (lo, then hi; null: none)
__device__ __forceinline__ const float* slab_src(const Slab& b,
                                                 const float* lo,
                                                 const float* hi) {
  if (b.pos < b.lo_end) return lo + (b.base + b.pos * b.stride);
  if (b.pos >= b.hi_start) {
    return hi + (b.base + (b.pos - b.hi_start) * b.stride);
  }
  return nullptr;
}

// cpml with the old psi value of the first slab that applies staged at
// *staged; the second (both apply only when the axis is shorter than 2 ns)
// is loaded here, through L2
__device__ __forceinline__ float cpml_staged(float d, const Slab& b, int ns,
                                             const float* prof, float* lo,
                                             float* hi, const float* staged) {
  bool first = true;
  if (b.pos < b.lo_end) {
    const int s = b.base + b.pos * b.stride;
    const float nw = prof[b.pos] * *staged + prof[ns + b.pos] * d;
    lo[s] = nw;
    d = d + nw;
    first = false;
  }
  const int q = b.pos - b.hi_start;
  if (q >= 0) {
    const int s = b.base + q * b.stride;
    const float old = first ? *staged : ld2(hi, s);
    const float nw = prof[2 * ns + q] * old + prof[3 * ns + q] * d;
    hi[s] = nw;
    d = d + nw;
  }
  return d;
}

// copy 16 bytes from src (global, through L2 only: cp.async.cg) to dst
// (this block's shared memory), or store 16 zero bytes there if !valid
__device__ __forceinline__ void cp_async16z(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// The launch of a halo sweep: grid (z-tiles, y-tiles x cluster, x
// segments) in clusters of (1, cluster, 1) blocks, through
// cudaLaunchKernelEx (a shape the card cannot schedule is refused there and
// reported by the caller's cudaGetLastError check)
template <typename Kern, typename... Args>
cudaError_t launch_cluster(Kern kern, dim3 grid, int threads, int smem,
                           int cluster, cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, args...);
}

// the clusters of that shape the current device holds at once (0: none fit)
template <typename Kern>
cudaError_t active_clusters(Kern kern, int threads, int smem, int cluster,
                            int* n) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, cluster, 1);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(n, kern, &cfg);
}

// raise an instantiation's dynamic shared memory limit once per device
template <typename Kern>
cudaError_t allow_smem(Kern kern, int* allowed, int bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (allowed[dev] >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(reinterpret_cast<const void*>(kern),
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) allowed[dev] = bytes;
  return e;
}

// the co-resident blocks of a cooperative kernel on the current device, with
// `smem` bytes of dynamic shared memory a block of `threads` threads
inline cudaError_t cooperative_capacity(const void* kernel, int* blocks,
                                        int smem = 0, int threads = kThreads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  }
  *blocks = per_sm * sms;
  return e;
}

// A pressure sample taken by the pressure / stress kernel of a step (their
// MONITOR instantiations), the port of the monitor capture of B4's host loop
// (babelbrain_tpu/ops/fdtd_pallas.py simulate_fluid_pallas): the voxels'
// new pressure written into `out`, a row of the (n_samples, K) series.
//   kMonitorEvery: every voxel (out[c], the raw capture); each thread
//     stores its cells as it writes them, one more store stream.
//   kMonitorListed: K voxels, sorted by the warp that writes them
//     (ops/fdtd_extras.py monitor_csr, from the launch geometry: warp
//     threadIdx.y of block b is key b * kTileY + threadIdx.y): a warp's
//     entries are [start[w], start[w + 1]) of (cell[e], slot[e]), almost
//     always none. Lane 0 starts an asynchronous copy of the two offsets
//     into shared memory before the march (fetch_range: no register is held
//     and no thread waits on it); after the march, lane 0 waits for it, a
//     __syncwarp makes it and the warp's own stores visible to all its
//     lanes, and they copy out[slot] = pressure(cell): values the warp has
//     just stored. No block barrier, so the kernel keeps its early return
//     for threads off the volume and its twin's loop. (Plain loads of the
//     offsets after the march, or a warp shuffle of lane 0's copy, were
//     measured slower in the instantiations the main path samples with,
//     PERF.md.) The list moves (n_warps + 1 + 2K) ints and K floats
//     a sample, instead of a launch of its own; a per-column table read by
//     every x-segment would move one int per column and segment.
constexpr int kNoMonitor = 0, kMonitorListed = 1, kMonitorEvery = 2;

struct Monitor {
  const int* start;
  const int* cell;
  const int* slot;
  float* out;
};

// the two offsets of each warp's entries, in shared memory (a kernel that
// never calls this holds none)
__device__ __forceinline__ int* monitor_range() {
  __shared__ int range[2 * kTileY];
  return range + 2 * threadIdx.y;
}

__device__ __forceinline__ void cp_async4(int* smem, const int* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// kMonitorListed, before the march, by every thread inside the volume:
// lane 0 of each warp starts the copy of the warp's offsets
__device__ __forceinline__ void fetch_range(const Monitor& mon) {
  if (threadIdx.x == 0) {
    const int w =
        (blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)) *
            kTileY + threadIdx.y;
    cp_async4(monitor_range(), mon.start + w);
    cp_async4(monitor_range() + 1, mon.start + w + 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
}

// kMonitorListed, after the march, by every lane of the warp that is inside
// the volume (lanes 0 .. n_lanes - 1): the listed voxels the warp has
// written, from at(cell)
template <typename At>
__device__ __forceinline__ void copy_listed(const Monitor& mon, int n_lanes,
                                            At at) {
  const unsigned lanes =
      n_lanes >= kTileZ ? 0xffffffffu : (1u << n_lanes) - 1u;
  if (threadIdx.x == 0) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp(lanes);  // lane 0's copy and the warp's own stores, for all
  const int e0 = monitor_range()[0], e1 = monitor_range()[1];
  for (int e = e0 + threadIdx.x; e < e1; e += n_lanes) {
    mon.out[mon.slot[e]] = at(mon.cell[e]);
  }
}

// the C entry points' monitor arguments: a known mode and its pointers
inline bool monitor_args_valid(int monitor, const int* start, const int* cell,
                               const int* slot, const float* out) {
  if (monitor == kNoMonitor) return true;
  if (monitor == kMonitorEvery) return out != nullptr;
  return monitor == kMonitorListed && start && cell && slot && out;
}

// true if `blocks` tiles of `tile` cells cover [0, n) and each holds a cell
inline bool covers(int blocks, int tile, int n) {
  return blocks >= 1 && (long long)blocks * tile >= n &&
         (long long)(blocks - 1) * tile < n;
}

// the launch grid (z-tiles, y-tiles, x-segments) the wrapper chose, or false
// if it does not cover the grid once with the compiled tile or the grid
// holds too many cells for 32-bit offsets
inline bool launch_grid(const Geo& g, int tile_y, int gz, int gy, int gx,
                        dim3& grid) {
  if ((long long)g.n1 * g.n2 * g.n3 >= (1LL << 31)) return false;
  if (tile_y != kTileY || g.seg < 1 || !covers(gz, kTileZ, g.n3) ||
      !covers(gy, kTileY, g.n2) || !covers(gx, g.seg, g.n1)) {
    return false;
  }
  grid = dim3(gz, gy, gx);
  return true;
}

}  // namespace bb

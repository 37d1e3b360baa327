// Pennes bio-heat (BHTE) FTCS steps with CEM43 dose for NVIDIA Hopper
// (sm_90a): one step a launch (bhte_step_kernel) and K steps a launch
// (bhte_fused_kernel).
//
// Replaces (TPU kernel of the JAX package):
//   babelbrain_tpu/ops/bhte_pallas.py build_bhte_fusedK_step (B9), which
//   advances K such steps per streaming sweep. bhte_fused_kernel is that
//   sweep; bhte_step_kernel is one step, which ops/bhte.py runs for the
//   tail of a schedule segment shorter than K (JAX's K = 1 sweeps) and for
//   every step when fuse_steps=1.
//
// What bounds it on this card: device-memory traffic. Per cell and step
// the one-step kernel reads T (+6 neighbours, mostly cache hits), dose,
// peak, six interface conductivities, irc, perf and, in heating segments,
// Q, and writes T', dose and peak: 15 float volumes a step (14 while
// cooling) for ~30 flops a cell, far below the card's flop/byte balance.
// The K-step sweep moves the same 15 volumes once a launch, 15/K a step.
//
// bhte_step_kernel: one thread per cell, threadIdx.x along z (the
// contiguous axis) so every warp moves contiguous 128-byte lines; the six
// neighbours come from global memory and are shared between nearby blocks
// through L1/L2. T is double-buffered (T -> T_out), dose and peak are
// updated in place. Cooling segments launch without Q and skip its stream.
//
// bhte_fused_kernel<K> (the card's design, not the TPU's: the TPU keeps
// whole (N2, N3) slabs in VMEM rings and recomputes nothing):
//   - Each block owns a (y, z) tile of FusedTile<K>::TY x TZ cells (32 x 16
//     up to K = 3) and a segment of x-planes, and holds the tile extended by
//     K cells a side in y and z, one thread per extended column. The
//     stencil reaches one cell a step, so a column K - k cells from the
//     extended tile's edge is right through stage k (step k of the sweep):
//     neighbouring blocks recompute each other's halo (overlap and
//     discard). Likewise in x, the block marches from K planes below its
//     segment to K planes above it. Nothing is exchanged between blocks: no
//     grid barrier, no cooperative launch.
//   - The march: at march step m a thread takes plane pl = xs + m of T
//     (stage 0), then stage k = 1..K updates plane pl - k of its column from
//     stage k - 1's planes pl - k - 1, pl - k, pl - k + 1 of the column (its
//     registers: each stage's last three planes) and stage k - 1's plane
//     pl - k at the four lateral neighbours (shared memory: each stage's
//     last two planes by parity, written in the last march step). So every
//     cross-thread read is of the last march step, and one __syncthreads() a
//     march step orders them.
//   - Each column's loads are issued a march step ahead, into registers:
//     T of the next plane, and the coefficients (k6, irc, perf, Q), dose and
//     peak of stage 1's next plane. The coefficients stay in registers for
//     the K stages that use them (K + 1 planes in flight): each is read from
//     device memory once a launch, the halo's from L2.
//   - dose and peak: only owned cells. Stage 1 takes them from the loads,
//     the partial sums move from stage to stage in registers and stage K
//     writes them, so each cell accumulates ((d + e1) + e2) + ... in step
//     order, as K in-place launches of bhte_step_kernel do. Only stage K's
//     owned cells reach device memory (T_out, dose, peak).
//   - Edge replication (adiabatic) at the domain's edges, at every stage; at
//     a tile's or a segment's edge the halo does the work.
// T_in and T_out must not alias (neighbouring blocks read T_in's halo);
// dose and peak are updated in place. Registers, not shared memory, bound
// the depth: 9 (K + 1) coefficients a thread. K = 1..4 spill at most a few
// bytes; K = 5..8 spill more and run slower than K = 3 (they are correct,
// and not on the main path). Shared memory: 2 K extended
// tiles (61 KB at K = 8, dynamic above 48 KB). ops/bhte_kernels.py
// fused_launch_geometry picks the segment length (several waves of blocks
// over the SMs) and BHTE_FUSE_BEST the depth measured fastest (PERF.md);
// its tile (FUSED_TILE_Z x fused_tile_y) is checked against FusedTile<K>
// through bb_bhte_fused_tile before a depth's first launch.
//   - K = 1 is built as a check of the march (one stage, every halo path)
//     and is off the main path: ops/bhte.py runs single steps, the tails
//     and fuse_steps=1, through bhte_step_kernel, which is faster.

// Both kernels: boundaries are edge-replicated (adiabatic), unlike the
// FDTD's zero padding. Rounding: built with --fmad=false and written in the
// operation order of the plain version (ops/bhte_kernels.py
// bhte_step_ref), so K steps of the sweep equal K launches of
// bhte_step_kernel bit for bit. bhte_fused_kernel computes 32-bit offsets
// and refuses grids of 2^31 cells or more.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kLog2RHi = -1.0f;  // log2(0.5), at or above 43 C
constexpr float kLog2RLo = -2.0f;  // log2(0.25), below 43 C

template <bool WITH_Q>
__global__ void bhte_step_kernel(
    const float* __restrict__ T, float* __restrict__ T_out,
    float* __restrict__ dose, float* __restrict__ peak,
    const float* __restrict__ kxp, const float* __restrict__ kxm,
    const float* __restrict__ kyp, const float* __restrict__ kym,
    const float* __restrict__ kzp, const float* __restrict__ kzm,
    const float* __restrict__ irc, const float* __restrict__ perf,
    const float* __restrict__ q, float t_art, int n1, int n2, int n3) {
  const long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long sx = (long long)n2 * n3;
  if (c >= sx * n1) return;
  const int k = (int)(c % n3);
  const long long ij = c / n3;
  const int j = (int)(ij % n2);
  const int i = (int)(ij / n2);

  const float tc = T[c];
  const float txp = (i + 1 < n1) ? T[c + sx] : tc;
  const float txm = (i >= 1) ? T[c - sx] : tc;
  const float typ = (j + 1 < n2) ? T[c + n3] : tc;
  const float tym = (j >= 1) ? T[c - n3] : tc;
  const float tzp = (k + 1 < n3) ? T[c + 1] : tc;
  const float tzm = (k >= 1) ? T[c - 1] : tc;
  const float lap = kxp[c] * (txp - tc) + kxm[c] * (txm - tc) +
                    kyp[c] * (typ - tc) + kym[c] * (tym - tc) +
                    kzp[c] * (tzp - tc) + kzm[c] * (tzm - tc);
  const float rc = irc[c];
  float tn = tc + lap * rc + perf[c] * (t_art - tc);
  if (WITH_Q) tn = tn + q[c] * rc;
  const float log2r = (tn >= 43.0f) ? kLog2RHi : kLog2RLo;
  T_out[c] = tn;
  dose[c] = dose[c] + exp2f(log2r * (43.0f - tn));
  peak[c] = fmaxf(peak[c], tn);
}

// The block of bhte_fused_kernel<K>: an owned tile of TZ x TY (z, y) cells
// extended by K cells a side, one thread per extended column, at most 1024
// threads and as many registers as the SM holds without spilling much (the
// wider the tile, the smaller the share of recomputed halo)
template <int K>
struct FusedTile {
  static constexpr int TZ = 32;
  static constexpr int TY = (K <= 3) ? 16 : (K <= 7) ? 8 : 4;
  static constexpr int EZ = TZ + 2 * K;
  static constexpr int EY = TY + 2 * K;
  static constexpr int THREADS = EZ * EY;
};

template <int K, bool WITH_Q>
__global__ void __launch_bounds__(FusedTile<K>::THREADS) bhte_fused_kernel(
    const float* __restrict__ T, float* __restrict__ T_out,
    float* __restrict__ dose, float* __restrict__ peak,
    const float* __restrict__ kxp, const float* __restrict__ kxm,
    const float* __restrict__ kyp, const float* __restrict__ kym,
    const float* __restrict__ kzp, const float* __restrict__ kzm,
    const float* __restrict__ irc, const float* __restrict__ perf,
    const float* __restrict__ q, float t_art, int n1, int n2, int n3,
    int seg) {
  using G = FusedTile<K>;
  constexpr int NC = WITH_Q ? 9 : 8;  // coefficient volumes
  // stage s's (0..K-1) last two planes of the extended tile, by parity
  extern __shared__ float lat[];  // [K][2][THREADS]
  const float* const cv[9] = {kxp, kxm, kyp, kym, kzp, kzm, irc, perf, q};
  const int tid = threadIdx.x;
  const int ey = tid / G::EZ, ez = tid - ey * G::EZ;
  const int y = blockIdx.y * G::TY - K + ey;
  const int z = blockIdx.x * G::TZ - K + ez;
  const bool inside = y >= 0 && y < n2 && z >= 0 && z < n3;
  const bool owned_col = inside && ey >= K && ey < K + G::TY && ez >= K &&
                         ez < K + G::TZ;
  const int sx = n2 * n3;
  const int col = inside ? y * n3 + z : 0;
  // owned planes [x0, x1), loaded planes [xs, xe]
  const int x0 = blockIdx.z * seg;
  const int x1 = min(n1, x0 + seg);
  const int xs = max(0, x0 - K);
  const int xe = min(n1 - 1, x1 - 1 + K);
  // lateral neighbours inside both the grid and the extended tile (a halo
  // column's outer neighbour is missing: its value is wrong and discarded)
  const bool has_yp = y + 1 < n2 && ey + 1 < G::EY;
  const bool has_ym = y >= 1 && ey >= 1;
  const bool has_zp = z + 1 < n3 && ez + 1 < G::EZ;
  const bool has_zm = z >= 1 && ez >= 1;

  // registers of this column: stage s's last three planes (w[s][2] newest),
  // the coefficients of the K + 1 planes in flight (cf[k]: stage k's plane,
  // cf[0]: the next one's, loading), and dose's / peak's partial sums after
  // stage k of its plane
  float w[K][3];
  float cf[K + 1][NC];
  float dp[K], pp[K];
  float t_next = 0.0f, d_next = 0.0f, p_next = 0.0f;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    w[s][0] = w[s][1] = w[s][2] = 0.0f;
    dp[s] = pp[s] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k <= K; ++k) {
#pragma unroll
    for (int v = 0; v < NC; ++v) cf[k][v] = 0.0f;
  }
  if (inside) t_next = T[xs * sx + col];

  for (int m = 0; m <= x1 - 1 - xs + K; ++m) {
    // stage 0: plane xs + m of T (loaded a march step ago)
    const int pl = xs + m;
    w[0][0] = w[0][1];
    w[0][1] = w[0][2];
    w[0][2] = t_next;
    lat[(pl & 1) * G::THREADS + tid] = t_next;
    // what the next march step reads: T of plane pl + 1; stage 1's
    // coefficients, dose and peak of plane pl
#pragma unroll
    for (int k = K; k >= 1; --k) {
#pragma unroll
      for (int v = 0; v < NC; ++v) cf[k][v] = cf[k - 1][v];
    }
    const float d1 = d_next, p1 = p_next;
    if (inside) {
      if (pl + 1 <= xe) t_next = T[(pl + 1) * sx + col];
      if (pl <= xe) {
#pragma unroll
        for (int v = 0; v < NC; ++v) cf[0][v] = __ldg(cv[v] + pl * sx + col);
      }
      if (owned_col && pl >= x0 && pl < x1) {
        d_next = dose[pl * sx + col];
        p_next = peak[pl * sx + col];
      }
    }
    float cd = d1, cpk = p1;  // dose / peak before stage k of its plane
#pragma unroll
    for (int k = 1; k <= K; ++k) {
      // stage k: plane p from stage k - 1's planes p - 1, p, p + 1 (this
      // column's registers) and its plane p at the four lateral neighbours
      // (shared memory, written in the last march step); stage k is right
      // on [xs + k, xe - k] and, at a domain edge, up to it
      const int p = pl - k;
      const bool live = inside && p >= ((xs == 0) ? 0 : xs + k) &&
                        p <= ((xe == n1 - 1) ? n1 - 1 : xe - k);
      const float tc = w[k - 1][1];
      float tn = tc;
      if (live) {
        const float* L = lat + ((k - 1) * 2 + (p & 1)) * G::THREADS + tid;
        const float txp = (p + 1 < n1) ? w[k - 1][2] : tc;
        const float txm = (p >= 1) ? w[k - 1][0] : tc;
        const float typ = has_yp ? L[G::EZ] : tc;
        const float tym = has_ym ? L[-G::EZ] : tc;
        const float tzp = has_zp ? L[1] : tc;
        const float tzm = has_zm ? L[-1] : tc;
        const float* c = cf[k];
        const float lap = c[0] * (txp - tc) + c[1] * (txm - tc) +
                          c[2] * (typ - tc) + c[3] * (tym - tc) +
                          c[4] * (tzp - tc) + c[5] * (tzm - tc);
        const float rc = c[6];
        tn = tc + lap * rc + c[7] * (t_art - tc);
        if (WITH_Q) tn = tn + c[NC - 1] * rc;
      }
      float d = cd, pk = cpk;
      if (owned_col) {
        const float log2r = (tn >= 43.0f) ? kLog2RHi : kLog2RLo;
        d = cd + exp2f(log2r * (43.0f - tn));
        pk = fmaxf(cpk, tn);
      }
      if (k < K) {
        w[k][0] = w[k][1];
        w[k][1] = w[k][2];
        w[k][2] = tn;
        lat[(k * 2 + (p & 1)) * G::THREADS + tid] = tn;
        cd = dp[k];  // stage k + 1's plane, after stage k a march step ago
        cpk = pp[k];
        dp[k] = d;
        pp[k] = pk;
      } else if (live && owned_col && p >= x0 && p < x1) {
        const int g = p * sx + col;
        T_out[g] = tn;
        dose[g] = d;
        peak[g] = pk;
      }
    }
    // this march step's planes written, and its reads of the last one's
    // done: the next step reads the former and overwrites the latter
    __syncthreads();
  }
}

bool covers(long long blocks, long long per_block, long long n) {
  return blocks >= 1 && (blocks - 1) * per_block < n && blocks * per_block >= n;
}

// raise an instantiation's dynamic shared memory limit once per device
template <int K, bool WITH_Q>
cudaError_t allow_smem(int bytes) {
  static int allowed[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (bytes <= allowed[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(&bhte_fused_kernel<K, WITH_Q>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) allowed[dev] = bytes;
  return e;
}

template <int K, bool WITH_Q>
int launch_fused(const float* T, float* T_out, float* dose, float* peak,
                 const float* const* c, const float* q, float t_art, int n1,
                 int n2, int n3, int seg, int gz, int gy, int gx,
                 cudaStream_t st) {
  using G = FusedTile<K>;
  if (!covers(gz, G::TZ, n3) || !covers(gy, G::TY, n2) || !covers(gx, seg, n1))
    return (int)cudaErrorInvalidValue;
  const int bytes = 2 * K * G::THREADS * (int)sizeof(float);
  const cudaError_t e = allow_smem<K, WITH_Q>(bytes);
  if (e != cudaSuccess) return (int)e;
  bhte_fused_kernel<K, WITH_Q><<<dim3(gz, gy, gx), G::THREADS, bytes, st>>>(
      T, T_out, dose, peak, c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], q,
      t_art, n1, n2, n3, seg);
  return (int)cudaGetLastError();
}

template <int K>
int launch_fused_k(const float* T, float* T_out, float* dose, float* peak,
                   const float* const* c, const float* q, float t_art, int n1,
                   int n2, int n3, int seg, int gz, int gy, int gx,
                   cudaStream_t st) {
  return q != nullptr
             ? launch_fused<K, true>(T, T_out, dose, peak, c, q, t_art, n1, n2,
                                     n3, seg, gz, gy, gx, st)
             : launch_fused<K, false>(T, T_out, dose, peak, c, q, t_art, n1,
                                      n2, n3, seg, gz, gy, gx, st);
}

}  // namespace

extern "C" int bb_bhte_step(const float* T, float* T_out, float* dose,
                            float* peak, const float* kxp, const float* kxm,
                            const float* kyp, const float* kym,
                            const float* kzp, const float* kzm,
                            const float* irc, const float* perf,
                            const float* q, float t_art, int n1, int n2,
                            int n3, void* stream) {
  const long long total = (long long)n1 * n2 * n3;
  const unsigned int nb = (unsigned int)((total + kThreads - 1) / kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  if (q != nullptr) {
    bhte_step_kernel<true><<<nb, kThreads, 0, st>>>(
        T, T_out, dose, peak, kxp, kxm, kyp, kym, kzp, kzm, irc, perf, q,
        t_art, n1, n2, n3);
  } else {
    bhte_step_kernel<false><<<nb, kThreads, 0, st>>>(
        T, T_out, dose, peak, kxp, kxm, kyp, kym, kzp, kzm, irc, perf, q,
        t_art, n1, n2, n3);
  }
  return (int)cudaGetLastError();
}

// *tz, *ty: the owned (z, y) tile of bhte_fused_kernel<k_steps>
// (FusedTile<K>::TZ, ::TY), which ops/bhte_kernels.py's launch geometry must
// match
extern "C" int bb_bhte_fused_tile(int k_steps, int* tz, int* ty) {
  switch (k_steps) {
#define BB_TILE_CASE(K)     \
  case K:                   \
    *tz = FusedTile<K>::TZ; \
    *ty = FusedTile<K>::TY; \
    return 0;
    BB_TILE_CASE(1)
    BB_TILE_CASE(2)
    BB_TILE_CASE(3)
    BB_TILE_CASE(4)
    BB_TILE_CASE(5)
    BB_TILE_CASE(6)
    BB_TILE_CASE(7)
    BB_TILE_CASE(8)
#undef BB_TILE_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K = k_steps steps in one launch. gz, gy, gx: the (z-tile, y-tile,
// x-segment) grid of ops/bhte_kernels.py fused_launch_geometry, seg its
// planes a segment; T_out must not alias T; q null while cooling.
extern "C" int bb_bhte_fused(const float* T, float* T_out, float* dose,
                             float* peak, const float* kxp, const float* kxm,
                             const float* kyp, const float* kym,
                             const float* kzp, const float* kzm,
                             const float* irc, const float* perf,
                             const float* q, float t_art, int k_steps, int n1,
                             int n2, int n3, int seg, int gz, int gy, int gx,
                             void* stream) {
  if (seg < 1 || T == T_out || (long long)n1 * n2 * n3 >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const float* c[8] = {kxp, kxm, kyp, kym, kzp, kzm, irc, perf};
  cudaStream_t st = (cudaStream_t)stream;
  switch (k_steps) {
#define BB_FUSED_CASE(K)                                                   \
  case K:                                                                  \
    return launch_fused_k<K>(T, T_out, dose, peak, c, q, t_art, n1, n2, n3, \
                             seg, gz, gy, gx, st);
    BB_FUSED_CASE(1)
    BB_FUSED_CASE(2)
    BB_FUSED_CASE(3)
    BB_FUSED_CASE(4)
    BB_FUSED_CASE(5)
    BB_FUSED_CASE(6)
    BB_FUSED_CASE(7)
    BB_FUSED_CASE(8)
#undef BB_FUSED_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

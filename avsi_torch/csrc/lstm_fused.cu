// Fused bidirectional LSTM layer (input projection + recurrence) for Hopper.
//
// Replaces two Pallas TPU kernels of avsi/ops/pallas_lstm.py:
//   K1  bilstm_fused_proj  (_kernel_fused,  :180-229)  first layer, input x (T,B,D)
//   K2  bilstm_fused_proj2 (_kernel_fused2, :800-847)  later layers, input = the
//       previous layer's forward and backward streams (T,B,Hin) each
//
// What it computes, per direction d and step (the TPU kernel's function):
//   xw    = round_cd(x_t . wx[d] + b[d])          the parity cast: the f32 projection
//                                                 (+bias) rounded to the compute dtype
//   gates = xw + round_cd(h) . wh[d]              f32 accumulation
//   c     = sig(f) * c + sig(i) * tanh(g);  h = sig(o) * tanh(c)   gates, h, c in f32
// Gate order i, f, g, o along the 4H axis.  Direction 0 walks t = 0..T-1 and
// direction 1 walks t = T-1..0, both from zero state; both outputs are written
// in original time order.  For K2 the projection row is af_t . wxa[d] +
// ab_t . wxb[d] + b[d], summed in f32 before the cast.
//
// What bounds it on an H100 SXM: the multiply-adds.  K1 at T=250, B=8 in f32
// is 2 x 250 x 8 x 2 x (593 + 250) x 1000 operations, 0.1007 ms at 67 TFLOP/s;
// the bytes (x, the weights, the outputs) take less.  The projection is 70% of
// those operations and is independent across steps; the recurrent product is
// 30%, but it is a chain of T dependent steps.
//
// Design: each wrapper call makes two launches.
//
// 1. proj_gemm_*: the projection for all T*B rows and both directions at once,
//    as a tiled GEMM over the whole card, written to a scratch xw in the compute
//    dtype (which holds the parity-cast value exactly).  The TPU kernel fused
//    it into the recurrence to spare a 131 MB xw round trip at B=128; at the
//    port's batches xw is 16-64 MB and mostly stays in the 50 MB L2, and the
//    fusion put 593 + 250 dependent reads per gate column on every step of the
//    chain.  xw's gate columns are stored unit-major (column u*4 + gate), so
//    the four gates of a run of units are one contiguous run of memory.
//    f32: a 128 x 128 block tile, 8 x 8 outputs per thread from shared memory
//    (no TF32: it keeps about three digits and breaks the 1e-4 parity).  bf16:
//    mma.sync.m16n8k16 on the tensor cores, f32 accumulation, fragments by
//    ldmatrix.  Tiles are staged through registers, double-buffered (the next
//    tile's global loads are in flight during the current tile's products): a
//    593-wide row of x is not 16-byte aligned, which rules out cp.async of
//    whole runs, and TMA needs 16-byte strides.
//
// 2. rec_cluster: the recurrence, one thread-block cluster of N CTAs per
//    (direction, batch tile).  The cluster splits the H hidden units; each CTA
//    owns all four gates of U units (U*4 gate columns), so its cell is local.
//    Today's costs and what this does about each:
//    - wh was re-read from L2 by every block on every step (~3 MB a step): each
//      CTA now loads its (H x 4U) slice of wh[d] into shared memory once and
//      keeps it for all T steps (128 KB f32, 64 KB bf16 at H=250, N=8).
//    - one block per batch row, weights never shared between rows: a CTA
//      serves a whole batch tile (8 or 16 rows) from one read of its slice.
//    - 16 of 132 SMs busy at B=8: N=16 CTAs per cluster there (32 SMs, half
//      the product per CTA), N=8 at larger batches; clusters x N <= SMs.
//    - the product ran on the FMA pipes one column at a time: in bf16 it is
//      mma.sync.m16n8k16 with A = the slice transposed (stored in the mma's
//      fragment order, one 16-byte shared load per fragment) and B = h^T
//      (N = 8 batch rows); in f32 a thread owns four gate columns and the
//      tile's rows in registers and reads each wh element once per step.  The
//      depth is split over thread groups and summed in shared memory.
//    - each step re-staged x: the step's xw rows for the next step arrive in a
//      two-stage ring by cp.async while this step's product runs.
//    Per step: product, cell (c stays in the CTA), round_cd(h) of the CTA's
//    units written into every peer's h buffer through distributed shared memory
//    (double-buffered by step parity), one cluster barrier (arrive.release,
//    then h written out, then wait.acquire).  No trip through global memory.
//    The launch plan (N, U, batch tile, depth split) comes from
//    avsi_torch/ops/lstm_fused.py:launch_plan; the launcher lays out the shared
//    memory (rec_layout, which the plan mirrors to choose a layout that fits),
//    checks the plan with cudaOccupancyMaxActiveClusters and returns the CUDA
//    error of a plan that cannot be scheduled.

#include <cooperative_groups.h>

#include <cstdint>
#include <mutex>
#include <set>
#include <tuple>

#include "lstm_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRecThreadsMax = 512;  // bf16; f32 takes at most 256 (more registers)
template <typename T>
constexpr int rec_threads_max() { return sizeof(T) == 2 ? kRecThreadsMax : kRecThreadsMax / 2; }
constexpr int kRecItemsMax = 4;  // (row, unit) cells per thread: U * BT <= 4 * threads
constexpr int kWarp = 32;

// ------------------------------------------------------------ small helpers

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D += A . B for one m16n8k16 tile: bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src),
               "n"(kBytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {  // all but the newest group
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Four consecutive values (16-byte aligned f32, 8-byte aligned bf16) as f32.
__device__ __forceinline__ void load4(float (&v)[4], const float* p) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}
__device__ __forceinline__ void load4(float (&v)[4], const __nv_bfloat16* p) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
  v[0] = __low2float(lo), v[1] = __high2float(lo), v[2] = __low2float(hi), v[3] = __high2float(hi);
}

// ------------------------------------------------------------ projection GEMM
//
// xw[d][m][perm(n)] = round_cd(sum_k A[m][k] W_d[k][n] + bias[d][n]) for the
// M = T*B rows m, the N = 4H gate columns n, and K = da (+ db for K2) where
// the A row is xa[m] (| xb[m]) and W_d is wxa[d] (stacked on wxb[d]).
// perm(n) = (n % H) * 4 + n / H: unit-major gate columns.

struct ProjArgs {
  const void* xa;
  const void* xb;
  const void* wxa;
  const void* wxb;
  const float* bias;
  void* xw;
  int m_rows, da, db, hidden;
};

template <typename T>
__device__ __forceinline__ T load_a(const ProjArgs& p, int m, int k) {
  if (m >= p.m_rows || k >= p.da + p.db) return from_f32<T>(0.0f);
  if (k < p.da) return static_cast<const T*>(p.xa)[(size_t)m * p.da + k];
  return static_cast<const T*>(p.xb)[(size_t)m * p.db + (k - p.da)];
}

template <typename T>
__device__ __forceinline__ T load_w(const ProjArgs& p, int dir, int k, int n) {
  const int g4 = 4 * p.hidden;
  if (n >= g4 || k >= p.da + p.db) return from_f32<T>(0.0f);
  if (k < p.da) return static_cast<const T*>(p.wxa)[((size_t)dir * p.da + k) * g4 + n];
  return static_cast<const T*>(p.wxb)[((size_t)dir * p.db + (k - p.da)) * g4 + n];
}

template <typename T>
__device__ __forceinline__ void store_xw(const ProjArgs& p, int dir, int m, int n, float acc) {
  const int g4 = 4 * p.hidden;
  if (m >= p.m_rows || n >= g4) return;
  const int col = (n % p.hidden) * 4 + n / p.hidden;
  static_cast<T*>(p.xw)[((size_t)dir * p.m_rows + m) * g4 + col] =
      from_f32<T>(acc + p.bias[dir * g4 + n]);
}

// f32: 128 x 128 block tile, depth 8, 256 threads of 8 x 8 outputs each (rows
// ty*4 and 64+ty*4, columns tx*4 and 64+tx*4: conflict-free float4 reads).
constexpr int kFm = 128, kFn = 128, kFk = 8, kFThreads = 256;

__global__ void __launch_bounds__(kFThreads, 2) proj_gemm_f32(ProjArgs p) {
  __shared__ __align__(16) float as[2][kFk][kFm];
  __shared__ __align__(16) float ws[2][kFk][kFn];
  const int dir = blockIdx.z, m0 = blockIdx.y * kFm, n0 = blockIdx.x * kFn;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k_len = p.da + p.db;
  float ra[4], rw[4];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = tid + e * kFThreads;
      ra[e] = load_a<float>(p, m0 + i / kFk, k0 + i % kFk);
      rw[e] = load_w<float>(p, dir, k0 + i / kFn, n0 + i % kFn);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = tid + e * kFThreads;
      as[buf][i % kFk][i / kFk] = ra[e];
      ws[buf][i / kFn][i % kFn] = rw[e];
    }
  };
  float acc[8][8] = {};
  fetch(0);
  stash(0);
  __syncthreads();
  const int n_tiles = (k_len + kFk - 1) / kFk;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_tiles) fetch((kt + 1) * kFk);
#pragma unroll
    for (int k = 0; k < kFk; ++k) {
      float a[8], w[8];
      *reinterpret_cast<float4*>(a) = *reinterpret_cast<const float4*>(&as[buf][k][ty * 4]);
      *reinterpret_cast<float4*>(a + 4) =
          *reinterpret_cast<const float4*>(&as[buf][k][64 + ty * 4]);
      *reinterpret_cast<float4*>(w) = *reinterpret_cast<const float4*>(&ws[buf][k][tx * 4]);
      *reinterpret_cast<float4*>(w + 4) =
          *reinterpret_cast<const float4*>(&ws[buf][k][64 + tx * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
    }
    if (kt + 1 < n_tiles) stash(buf ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      store_xw<float>(p, dir, m, n, acc[i][j]);
    }
  }
}

// bf16: 128 x 128 block tile, depth 32, 8 warps as 2 (rows) x 4 (columns),
// each warp 64 x 32 = 4 x 4 mma tiles.  Both tiles are staged as runs of 8
// consecutive bf16: W's rows are 16-byte aligned when 4H is a multiple of 8
// (one 16-byte load); x's rows (593 wide for K1) are not, so a run is read as
// 32-bit words and realigned with a funnel shift.  Runs at a ragged edge or
// across the two streams of K2 are read element by element.  In shared memory A is
// (m, k) and W (k, n), rows padded by 8 so that ldmatrix (W through .trans)
// reads conflict-free.
constexpr int kBm = 128, kBn = 128, kBk = 32, kBThreads = 256;
constexpr int kAPad = kBk + 8, kWPad = kBn + 8;

union Run8 {  // 8 bf16
  uint4 v;
  uint32_t w[4];
  __nv_bfloat16 h[8];
};

// The 8 bf16 at `at`: one 16-byte load, four 32-bit loads, or five realigned
// ones (the first word's low half precedes `at` in the same word; the last
// word's high half follows the run, which the caller checks is readable).
__device__ __forceinline__ uint4 load_run8(const __nv_bfloat16* at) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(at);
  if ((addr & 15) == 0) return *reinterpret_cast<const uint4*>(at);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(addr & ~(uintptr_t)3);
  Run8 r;
  if ((addr & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) r.w[i] = w[i];
  } else {  // the run is the high half of w[0] .. the low half of w[4]
    uint32_t x[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) x[i] = w[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) r.w[i] = __funnelshift_r(x[i], x[i + 1], 16);
  }
  return r.v;
}

// The run A[m][k..k+7] (xa | xb), zeros past the edges.
__device__ __forceinline__ uint4 load_a8(const ProjArgs& p, int m, int k) {
  const int k_len = p.da + p.db;
  if (m < p.m_rows && (k + 8 <= p.da || (k >= p.da && k + 8 <= k_len))) {
    const bool a = k < p.da;
    const size_t e = a ? (size_t)m * p.da + k : (size_t)m * p.db + (k - p.da);
    const size_t end = (size_t)p.m_rows * (a ? p.da : p.db);
    const auto* at = static_cast<const __nv_bfloat16*>(a ? p.xa : p.xb) + e;
    // a five-word read touches element e + 8: only inside the stream
    if ((reinterpret_cast<uintptr_t>(at) & 3) == 0 || e + 8 < end) return load_run8(at);
  }
  Run8 r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.h[i] = load_a<__nv_bfloat16>(p, m, k + i);
  return r.v;
}

// The run W_d[k][n..n+7], zeros past the edges.
__device__ __forceinline__ uint4 load_w8(const ProjArgs& p, int dir, int k, int n) {
  const int g4 = 4 * p.hidden;
  if (n + 8 <= g4 && k < p.da + p.db) {
    const bool a = k < p.da;
    const auto* at = static_cast<const __nv_bfloat16*>(a ? p.wxa : p.wxb) +
                     ((size_t)dir * (a ? p.da : p.db) + (a ? k : k - p.da)) * g4 + n;
    if ((reinterpret_cast<uintptr_t>(at) & 15) == 0) return *reinterpret_cast<const uint4*>(at);
  }
  Run8 r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.h[i] = load_w<__nv_bfloat16>(p, dir, k, n + i);
  return r.v;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem, bool trans) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if (trans) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
  }
}

__global__ void __launch_bounds__(kBThreads, 2) proj_gemm_bf16(ProjArgs p) {
  __shared__ __align__(16) __nv_bfloat16 as[2][kBm][kAPad];
  __shared__ __align__(16) __nv_bfloat16 ws[2][kBk][kWPad];
  const int dir = blockIdx.z, m0 = blockIdx.y * kBm, n0 = blockIdx.x * kBn;
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int wm = warp / 4, wn = warp % 4, g = lane / 4, tg = lane % 4;
  const int k_len = p.da + p.db;
  // per tile and thread: 2 runs of A (row i / 4, k 8 * (i % 4)) and 2 of W
  // (k i / 16, n 8 * (i % 16)), i = tid + e * 256
  uint4 ra[2], rw[2];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = tid + e * kBThreads;
      ra[e] = load_a8(p, m0 + i / 4, k0 + 8 * (i % 4));
      rw[e] = load_w8(p, dir, k0 + i / 16, n0 + 8 * (i % 16));
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = tid + e * kBThreads;
      *reinterpret_cast<uint4*>(&as[buf][i / 4][8 * (i % 4)]) = ra[e];
      *reinterpret_cast<uint4*>(&ws[buf][i / 16][8 * (i % 16)]) = rw[e];
    }
  };
  float acc[4][4][4] = {};
  fetch(0);
  stash(0);
  __syncthreads();
  const int n_tiles = (k_len + kBk - 1) / kBk;
  // ldmatrix row addresses: lane l feeds row l % 8 of matrix l / 8
  const int lr = lane % 8 + ((lane / 8) % 2) * 8, lc = (lane / 16) * 8;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_tiles) fetch((kt + 1) * kBk);
#pragma unroll
    for (int ks = 0; ks < kBk; ks += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        ldmatrix_x4(a[mi], &as[buf][wm * 64 + mi * 16 + lr][ks + lc], false);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {  // two n-tiles of 8 per x4.trans
        uint32_t r[4];
        ldmatrix_x4(r, &ws[buf][ks + lr][wn * 32 + nj * 16 + lc], true);
        b[2 * nj][0] = r[0], b[2 * nj][1] = r[1], b[2 * nj + 1][0] = r[2], b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
      }
    }
    if (kt + 1 < n_tiles) stash(buf ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int m = m0 + wm * 64 + mi * 16 + g, n = n0 + wn * 32 + ni * 8 + 2 * tg;
      store_xw<__nv_bfloat16>(p, dir, m, n, acc[mi][ni][0]);
      store_xw<__nv_bfloat16>(p, dir, m, n + 1, acc[mi][ni][1]);
      store_xw<__nv_bfloat16>(p, dir, m + 8, n, acc[mi][ni][2]);
      store_xw<__nv_bfloat16>(p, dir, m + 8, n + 1, acc[mi][ni][3]);
    }
  }
}

// ------------------------------------------------------------ cluster recurrence

struct RecArgs {
  const void* xw;  // (2, T*B, 4H) compute dtype, unit-major gate columns
  const void* wh;  // (2, H, 4H) compute dtype
  void* out_f;
  void* out_b;
  int t_len, batch, hidden, units, ksplit;
};

// Byte offsets of the recurrence's shared buffers (16-byte aligned each);
// avsi_torch/ops/lstm_fused.py:rec_smem_bytes mirrors the total for the plan.
struct RecLayout {
  size_t wh, hs, ring, gs, cs, total;
};

__host__ __device__ inline size_t align16(size_t v) { return (v + 15) & ~(size_t)15; }
__host__ __device__ inline int padded_depth(int hidden) { return (hidden + 15) / 16 * 16; }

template <typename T>
__host__ __device__ inline RecLayout rec_layout(int hidden, int units, int bt, int ksplit) {
  const size_t g = 4 * (size_t)units;
  const size_t kp = padded_depth(hidden);
  RecLayout l;
  l.wh = 0;  // f32: [kp][4U]; bf16: mma A fragments of [4U][kp]; zero past H
  l.hs = l.wh + align16(g * kp * sizeof(T));
  // two parity buffers of round_cd(h) for the whole layer, [bt][kp + 8] each
  l.ring = l.hs + align16(2 * bt * (kp + 8) * sizeof(T));
  l.gs = l.ring + align16(2 * bt * g * sizeof(T));  // xw ring [2][bt][4U]
  l.cs = l.gs + align16((size_t)ksplit * bt * g * 4);  // partial gates [ksplit][bt][4U]
  l.total = l.cs + align16((size_t)bt * units * 4);    // c [bt][U]
  return l;
}

// One CTA of the cluster for (direction blockIdx.y, batch tile blockIdx.x / N):
// gate columns of units [rank*U, rank*U + nu), rows [b0, b0 + BT) of the batch.
template <typename T, typename O, int BT>
__global__ void __launch_bounds__(rec_threads_max<T>()) rec_cluster(RecArgs p) {
  constexpr bool kBf16 = sizeof(T) == 2;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_cta = (int)cluster.dim_blocks().x, rank = (int)cluster.block_rank();
  const int dir = blockIdx.y, b0 = (blockIdx.x / n_cta) * BT;
  const int H = p.hidden, U = p.units, G = 4 * U, u0 = rank * U;
  const int nu = max(0, min(U, H - u0));
  const int kp = padded_depth(H), ksteps = kp / 16, mt_n = G / 16;
  const int hrow = kp + 8, h_buf = BT * hrow;  // h row stride; elements per parity buffer
  const size_t g4 = 4 * (size_t)H;
  const RecLayout lay = rec_layout<T>(H, U, BT, p.ksplit);
  extern __shared__ __align__(16) unsigned char smem[];
  T* whs = reinterpret_cast<T*>(smem + lay.wh);
  T* hs = reinterpret_cast<T*>(smem + lay.hs);
  T* ring = reinterpret_cast<T*>(smem + lay.ring);
  float* gs = reinterpret_cast<float*>(smem + lay.gs);
  float* cs = reinterpret_cast<float*>(smem + lay.cs);
  const T* wh = static_cast<const T*>(p.wh) + (size_t)dir * H * g4;
  const T* xw = static_cast<const T*>(p.xw) + (size_t)dir * p.t_len * p.batch * g4;
  O* out = static_cast<O*>(dir == 0 ? p.out_f : p.out_b);
  const int tid = threadIdx.x, nthr = blockDim.x, items = U * BT;

  // the slice of wh[d], column c = lu * 4 + gate <- wh[d][k][gate * H + u0 + lu]
  auto wh_at = [&](int c, int k) -> T {
    const int lu = c / 4;
    return (lu < nu && k < H) ? wh[(size_t)k * g4 + (c % 4) * H + u0 + lu] : from_f32<T>(0.0f);
  };
  if constexpr (kBf16) {  // fragment (mt, kstep, lane) of A = slice^T, one uint4 each
    uint4* frag = reinterpret_cast<uint4*>(whs);
    for (int i = tid; i < mt_n * ksteps * kWarp; i += nthr) {
      const int lane = i % kWarp, ks = (i / kWarp) % ksteps, mt = i / kWarp / ksteps;
      const int r = mt * 16 + lane / 4, k = ks * 16 + 2 * (lane % 4);
      frag[i] = make_uint4(pack_bf16(wh_at(r, k), wh_at(r, k + 1)),
                           pack_bf16(wh_at(r + 8, k), wh_at(r + 8, k + 1)),
                           pack_bf16(wh_at(r, k + 8), wh_at(r, k + 9)),
                           pack_bf16(wh_at(r + 8, k + 8), wh_at(r + 8, k + 9)));
    }
  } else {
    for (int i = tid; i < kp * G; i += nthr) whs[i] = wh_at(i % G, i / G);
  }
  for (int i = tid; i < 2 * h_buf; i += nthr) hs[i] = from_f32<T>(0.0f);  // h0 = 0, pads 0
  for (int i = tid; i < items; i += nthr) cs[i] = 0.0f;

  // item i = (row r = i / U, unit lu = i % U): its four gates of xw are one
  // 16-byte (f32) or 8-byte (bf16) run; the thread that copies it reads it.
  auto prefetch = [&](int s) {
    const int t = dir == 0 ? s : p.t_len - 1 - s;
    T* stage = ring + (s & 1) * BT * G;
    for (int i = tid; i < items; i += nthr) {
      const int lu = i % U, r = i / U;
      if (lu < nu && b0 + r < p.batch) {
        cp_async<4 * sizeof(T)>(stage + r * G + lu * 4,
                                xw + ((size_t)t * p.batch + b0 + r) * g4 + (size_t)(u0 + lu) * 4);
      }
    }
    cp_async_commit();
  };
  prefetch(0);
  cluster.sync();  // every CTA runs and has zeroed its h buffers before any peer writes

  for (int s = 0; s < p.t_len; ++s) {
    const int t = dir == 0 ? s : p.t_len - 1 - s;
    if (s + 1 < p.t_len) {
      prefetch(s + 1);
    } else {
      cp_async_commit();
    }
    const T* h_cur = hs + (s & 1) * h_buf;
    T* h_next = hs + ((s + 1) & 1) * h_buf;

    // (b) partial gates over depth slice ks: gs[ks][r][c] = sum_k round_cd(h)[r][k] wh[k][c]
    if constexpr (kBf16) {
      const int lane = tid % kWarp, g = lane / 4, tg = lane % 4;
      const uint4* frag = reinterpret_cast<const uint4*>(whs);
      for (int w = tid / kWarp; w < mt_n * p.ksplit; w += nthr / kWarp) {
        const int mt = w % mt_n, ks = w / mt_n;
        float acc[BT / 8][4] = {};
        for (int kk = ks; kk < ksteps; kk += p.ksplit) {
          const uint4 f = frag[(mt * ksteps + kk) * kWarp + lane];
          const uint32_t a[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
          for (int nt = 0; nt < BT / 8; ++nt) {
            const T* hr = h_cur + (nt * 8 + g) * hrow + kk * 16 + 2 * tg;
            mma_bf16(acc[nt], a, ld_u32(hr), ld_u32(hr + 8));
          }
        }
#pragma unroll
        for (int nt = 0; nt < BT / 8; ++nt) {
          float* o = gs + (ks * BT + nt * 8 + 2 * tg) * G + mt * 16 + g;
          o[0] = acc[nt][0];
          o[G] = acc[nt][1];
          o[8] = acc[nt][2];
          o[G + 8] = acc[nt][3];
        }
      }
    } else {
      // thread (column quad cq, depth slice ks): 4 columns x BT rows in
      // registers; per 4 k one float4 of wh per k and one broadcast float4 of
      // h per row, so each h read feeds 16 multiply-adds
      const int k_chunk = (kp / 4 + p.ksplit - 1) / p.ksplit * 4;  // whole float4s
      for (int w = tid; w < U * p.ksplit; w += nthr) {
        const int cq = w % U, ks = w / U, k_hi = min(kp, (ks + 1) * k_chunk);
        float acc[BT][4] = {};
        for (int k = ks * k_chunk; k < k_hi; k += 4) {
          float wv[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) load4(wv[kk], whs + (k + kk) * G + cq * 4);
#pragma unroll
          for (int r = 0; r < BT; ++r) {
            float hv[4];
            load4(hv, h_cur + r * hrow + k);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[r][j] = fmaf(hv[3], wv[3][j], fmaf(hv[2], wv[2][j],
                          fmaf(hv[1], wv[1][j], fmaf(hv[0], wv[0][j], acc[r][j]))));
            }
          }
        }
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          *reinterpret_cast<float4*>(gs + (ks * BT + r) * G + cq * 4) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        }
      }
    }
    cp_async_wait_one();  // (a) this step's xw rows have landed
    __syncthreads();      // every partial gate is in gs

    // (c) the cell in f32, (d) round_cd(h) into every peer; a warp's lanes
    // are consecutive units of one row, so its DSMEM stores are contiguous
    float h_out[kRecItemsMax];
#pragma unroll
    for (int j = 0; j < kRecItemsMax; ++j) {
      const int i = tid + j * nthr, lu = i % U, r = i / U, b = b0 + r;
      if (i >= items || lu >= nu) continue;
      float h = 0.0f;  // rows past the batch carry h = 0
      if (b < p.batch) {
        float gate[4], prod[4];
        load4(gate, ring + (s & 1) * BT * G + r * G + lu * 4);  // xw, parity-cast
        for (int ks = 0; ks < p.ksplit; ++ks) {
          float part[4];
          load4(part, gs + (ks * BT + r) * G + lu * 4);
#pragma unroll
          for (int q = 0; q < 4; ++q) prod[q] = ks == 0 ? part[q] : prod[q] + part[q];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) gate[q] += prod[q];
        const float c = sigmoid(gate[1]) * cs[r * U + lu] + sigmoid(gate[0]) * tanhf(gate[2]);
        h = sigmoid(gate[3]) * tanhf(c);
        cs[r * U + lu] = c;
      }
      h_out[j] = h;
      const T hv = from_f32<T>(h);
      for (int q = 0; q < n_cta; ++q) cluster.map_shared_rank(h_next, q)[r * hrow + u0 + lu] = hv;
    }
    // (f) one cluster barrier per step: arrive releases the DSMEM stores; the
    // peers' h is visible, and nobody reads this step's buffers, after wait.
    // (e) h goes out to global memory between the two, off the release.
    // After the last step the barrier is the cluster sync before exit: no
    // peer writes into this CTA's shared memory after it.
    cluster_arrive();
#pragma unroll
    for (int j = 0; j < kRecItemsMax; ++j) {
      const int i = tid + j * nthr, lu = i % U, b = b0 + i / U;
      if (i < items && lu < nu && b < p.batch) {
        out[((size_t)t * p.batch + b) * H + u0 + lu] = from_f32<O>(h_out[j]);
      }
    }
    cluster_wait();
  }
}

// ------------------------------------------------------------ launchers

template <typename T, typename O, int BT>
int launch_rec(const RecArgs& p, int cluster, cudaStream_t stream) {
  auto kernel = rec_cluster<T, O, BT>;
  const int threads = (sizeof(T) == 2 ? 8 : 1) * p.units * p.ksplit;
  if (cluster < 1 || cluster > 16 || p.units % 4 != 0 || p.ksplit < 1 ||
      threads > rec_threads_max<T>() || p.units * BT > kRecItemsMax * threads ||
      (sizeof(T) == 4 && 4 * p.ksplit > padded_depth(p.hidden)) ||
      (long)cluster * p.units < p.hidden) {
    return (int)cudaErrorInvalidValue;  // not a plan of launch_plan's
  }
  const size_t smem = rec_layout<T>(p.hidden, p.units, BT, p.ksplit).total;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * ((p.batch + BT - 1) / BT), 2, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // Once per device: opt the kernel in to the card's largest dynamic shared
  // memory (an upper bound, so every plan's size fits under it) and to
  // clusters of 16.  Once per (device, plan): check that one cluster of the
  // plan fits the card.  The occupancy query costs more host time than the
  // launch, and the serving loop is host-bound.
  static std::mutex mutex;
  static std::set<int> ready;
  static std::set<std::tuple<int, int, int, size_t>> checked;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  const auto key = std::make_tuple(device, cluster, threads, smem);
  {
    std::lock_guard<std::mutex> lock(mutex);
    if (!ready.count(device)) {
      int optin = 0;
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
      if (err == cudaSuccess) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
      }
      if (err == cudaSuccess) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      }
      if (err != cudaSuccess) return (int)err;
      ready.insert(device);
    }
    if (!checked.count(key)) {
      int active = 0;
      err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
      if (err != cudaSuccess) return (int)err;
      if (active < 1) return (int)cudaErrorLaunchOutOfResources;  // no cluster of this plan fits
      checked.insert(key);
    }
  }
  return (int)cudaLaunchKernelEx(&cfg, kernel, p);
}

struct Plan {
  int cluster, units, btile, ksplit;
};

template <typename T, typename O>
int launch_layer(const ProjArgs& proj, const RecArgs& rec, const Plan& plan, cudaStream_t s) {
  if (rec.t_len == 0 || rec.batch == 0) return 0;
  const int g4 = 4 * rec.hidden;
  if constexpr (sizeof(T) == 4) {
    dim3 grid((g4 + kFn - 1) / kFn, (proj.m_rows + kFm - 1) / kFm, 2);
    proj_gemm_f32<<<grid, kFThreads, 0, s>>>(proj);
  } else {
    dim3 grid((g4 + kBn - 1) / kBn, (proj.m_rows + kBm - 1) / kBm, 2);
    proj_gemm_bf16<<<grid, kBThreads, 0, s>>>(proj);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (plan.btile == 8) return launch_rec<T, O, 8>(rec, plan.cluster, s);
  if (plan.btile == 16) return launch_rec<T, O, 16>(rec, plan.cluster, s);
  return (int)cudaErrorInvalidValue;
}

int dispatch(const ProjArgs& proj, RecArgs rec, const Plan& plan, int in_bf16, int out_bf16,
             void* stream) {
  rec.units = plan.units;
  rec.ksplit = plan.ksplit;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!in_bf16 && !out_bf16) return launch_layer<float, float>(proj, rec, plan, s);
  if (in_bf16 && out_bf16) return launch_layer<__nv_bfloat16, __nv_bfloat16>(proj, rec, plan, s);
  if (in_bf16) return launch_layer<__nv_bfloat16, float>(proj, rec, plan, s);
  return (int)cudaErrorInvalidValue;  // f32 inputs with bf16 outputs: not a use
}

}  // namespace

extern "C" {

// K1: x (T,B,D); wx (2,D,4H); b (2,4H) f32; wh (2,H,4H); xw scratch (2,T,B,4H)
// at the compute dtype; outs (T,B,H) each; the plan of launch_plan (cluster,
// units, batch tile, depth split; the shared bytes follow from rec_layout).
// Returns the first CUDA error of the two launches (0 on success).
int avsi_bilstm_fused_proj(const void* x, const void* wx, const float* b, const void* wh,
                           void* xw, void* out_f, void* out_b, int t_len, int batch,
                           int d_in, int hidden, int in_bf16, int out_bf16, int cluster,
                           int units, int btile, int ksplit, void* stream) {
  const ProjArgs proj{x, nullptr, wx, nullptr, b, xw, t_len * batch, d_in, 0, hidden};
  const RecArgs rec{xw, wh, out_f, out_b, t_len, batch, hidden, 0, 0};
  return dispatch(proj, rec, Plan{cluster, units, btile, ksplit}, in_bf16, out_bf16, stream);
}

// K2: af, ab (T,B,Hin); wxa, wxb (2,Hin,4H); b (2,4H) f32; wh (2,H,4H); the rest as K1.
int avsi_bilstm_fused_proj2(const void* af, const void* ab, const void* wxa, const void* wxb,
                            const float* b, const void* wh, void* xw, void* out_f,
                            void* out_b, int t_len, int batch, int h_in, int hidden,
                            int in_bf16, int out_bf16, int cluster, int units, int btile,
                            int ksplit, void* stream) {
  const ProjArgs proj{af, ab, wxa, wxb, b, xw, t_len * batch, h_in, h_in, hidden};
  const RecArgs rec{xw, wh, out_f, out_b, t_len, batch, hidden, 0, 0};
  return dispatch(proj, rec, Plan{cluster, units, btile, ksplit}, in_bf16, out_bf16, stream);
}

}  // extern "C"

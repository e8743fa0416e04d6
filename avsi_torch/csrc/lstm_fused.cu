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
// 2. rec_cluster (lstm_cluster.cuh, shared with K3/K5/K6): the recurrence,
//    one thread-block cluster of N CTAs per (direction, batch tile), reading
//    the scratch above (XwLayout::kUnitMajor).  The first design's costs (a
//    block per direction and batch row) and what the cluster does about each:
//    - wh was re-read from L2 by every block on every step (~3 MB a step): each
//      CTA now loads its (H x 4U) slice of wh[d] into shared memory once and
//      keeps it for all T steps.
//    - one block per batch row, weights never shared between rows: a CTA
//      serves a whole batch tile (8 or 16 rows) from one read of its slice.
//    - 16 of 132 SMs busy at B=8: N=16 CTAs per cluster there (32 SMs, half
//      the product per CTA), N=8 at larger batches; clusters x N <= SMs.
//    - the product ran on the FMA pipes one column at a time: mma.sync in
//      bf16, four gate columns x the tile's rows per thread in f32.
//    - each step re-staged x: the step's xw rows for the next step arrive in a
//      two-stage ring by cp.async while this step's product runs.
//    h crosses SMs through distributed shared memory (st.async on each
//    receiver's mbarriers, no cluster barrier a step); no trip through
//    global memory.

#include <cstdint>

#include "lstm_cluster.cuh"

namespace {

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

// ------------------------------------------------------------ launchers

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
  return launch_rec_plan<T, O, XwLayout::kUnitMajor>(rec, plan, s);
}

int dispatch(const ProjArgs& proj, const RecArgs& rec, const Plan& plan, int in_bf16,
             int out_bf16, void* stream) {
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
// units, batch tile, depth split, resident depth rows; the shared bytes follow
// from rec_layout).
// Returns the first CUDA error of the two launches (0 on success).
int avsi_bilstm_fused_proj(const void* x, const void* wx, const float* b, const void* wh,
                           void* xw, void* out_f, void* out_b, int t_len, int batch,
                           int d_in, int hidden, int in_bf16, int out_bf16, int cluster,
                           int units, int btile, int ksplit, int resident,
                           void* stream) {
  const ProjArgs proj{x, nullptr, wx, nullptr, b, xw, t_len * batch, d_in, 0, hidden};
  const RecArgs rec{xw,      wh,    nullptr, out_f,  out_b, nullptr, nullptr,
                    nullptr, t_len, batch,   hidden, 0,     0,       0};
  const Plan plan{cluster, units, btile, ksplit, resident};
  return dispatch(proj, rec, plan, in_bf16, out_bf16, stream);
}

// K2: af, ab (T,B,Hin); wxa, wxb (2,Hin,4H); b (2,4H) f32; wh (2,H,4H); the rest as K1.
int avsi_bilstm_fused_proj2(const void* af, const void* ab, const void* wxa, const void* wxb,
                            const float* b, const void* wh, void* xw, void* out_f,
                            void* out_b, int t_len, int batch, int h_in, int hidden,
                            int in_bf16, int out_bf16, int cluster, int units, int btile,
                            int ksplit, int resident, void* stream) {
  const ProjArgs proj{af, ab, wxa, wxb, b, xw, t_len * batch, h_in, h_in, hidden};
  const RecArgs rec{xw,      wh,    nullptr, out_f,  out_b, nullptr, nullptr,
                    nullptr, t_len, batch,   hidden, 0,     0,       0};
  const Plan plan{cluster, units, btile, ksplit, resident};
  return dispatch(proj, rec, plan, in_bf16, out_bf16, stream);
}

}  // extern "C"

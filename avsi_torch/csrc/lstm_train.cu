// Bidirectional LSTM recurrence over a precomputed gate input, forward and
// backward, for Hopper.
//
// Replaces four Pallas TPU kernels of avsi/ops/pallas_lstm.py.  The pair under
// the custom VJP of `_layer` (:1236-1326):
//   K3  bilstm_recurrence_train (_kernel_train, :148-173): the recurrence over a
//       precomputed gate input xw, writing the h streams, the f32 cell-state
//       streams and the f32 gate sums (the residual of the backward);
//   K4  bilstm_recurrence_bwd   (_bwd_kernel :599-656, _bwd_dir :563-596): the
//       reverse walk that writes dgates as dxw and accumulates dWh.
// And two more instances of K3's body (compile-time switches: read initial
// carries, write the c streams):
//   K5  bilstm_recurrence_carry (_kernel_carry, :423-448): K3 with initial
//       carries hc0 (2=h|c, 2=dir, B, H) f32, the LC-BLSTM window of live
//       streaming (W = C + L frames; the window layer passes the previous
//       window's forward state and zeros for the backward direction);
//   K6  bilstm_recurrence       (_kernel, :121-145): K3 without the c streams.
//
// Layouts (the TPU kernels'): xw and dxw are (T, 2, B, 4H) in kernel time, so
// direction 1 is time-reversed there, gate-major (column gate*H + u); h, c
// and dout are (T, B, H) per direction in ORIGINAL time order.  K3's gate
// sums are (T, 2, B, H, 4) f32 in kernel time, unit-major (a cell's four
// gates side by side), which the TPU kernels do not keep.  At kernel
// step s, direction 0 is at original time s and direction 1 at T-1-s; the
// previous step (s-1) is at original time s-1 for direction 0 and T-s for
// direction 1 (zero state at s = 0).
//
// Numerics (the TPU kernels' function):
//   K3:  gates = xw_s + round_cd(h_prev) . wh   (f32 sums)
//        c = sig(f) c + sig(i) tanh(g);  h = sig(o) tanh(c)     all f32
//   K4:  the gates are K3's saved sums (the TPU kernel recomputes them;
//        these are the same bits), then with dh = dout_s + dh_rec and the
//        f32 carries dc, dh_rec:
//        do = dh tanh(c) o(1-o);  dc += dh o (1 - tanh(c)^2)
//        di = dc g i(1-i);  df = dc c_prev f(1-f);  dg = dc i (1-g^2)
//        dxw_s = round_cd(dgates);  dh_rec = dxw_s . wh^T;  dc = dc f
//        dwh[d] = sum over (s, b) of round_cd(h_prev)^T . dxw_s    (f32)
//
// K3, K5, K6: the cluster recurrence of K1/K2 (`rec_cluster`,
// lstm_cluster.cuh), reading xw in this layout (XwLayout::kGateMajor), under
// the plan of avsi_torch/ops/lstm_fused.py:launch_plan at the call's batch:
// a cluster of 8 or 16 CTAs per (direction, batch tile of 8 or 16 rows)
// splits H, each CTA keeps its slice of wh in shared memory for the whole
// walk, and h crosses SMs through distributed shared memory by st.async on
// each receiver's mbarriers (no cluster barrier in the step loop).  One
// launch per call.  Its limits are the plan's: a CTA's
// slice of wh fits 227 KB whole up to f32 H = 416 and bf16 H = 624; wider,
// the plan keeps its first depth rows in shared memory and the product reads
// the rest from L2 every step, up to f32 H = 2048 and bf16 H = 1024 (beyond,
// no plan: the wrappers raise).  K5 fills its h buffers with round_cd(h0),
// as the TPU kernel rounds h_prev inside the product (`_cell` :108-110), and
// its c with the f32 c0 as is.  K3, K5 and K6 are one body and take one plan
// at one batch, so where their functions coincide (zero carries; the h
// streams) their outputs are bit for bit equal, and equal to K1's recurrence
// given K1's parity-cast projection as xw.
//
// K4 is three launches, counted as one: the TPU body carries its (2, H, 4H)
// f32 dWh accumulator (2 MB) across the sequential grid in VMEM, which has
// no Hopper counterpart (an SM has 227 KB; atomics would make the sums'
// order change from run to run).
//   K4a, the walk: rec_cluster_bwd (lstm_cluster.cuh) on the cluster and the
//        resident wh slices of K3, under avsi_torch/ops/lstm_train.py:bwd_plan
//        (K3's plan, with fewer resident depth rows where the walk's buffers
//        need the room).  Each CTA reads its units' gates from K3's saved
//        sums, runs their cell backward, and sends its partial dh_rec =
//        dgates . slice^T for every unit to the unit's owner through DSMEM,
//        on the owner's mbarriers as K3's h; no read of the whole wh from L2.
//        The first design (one 1,024-thread block per direction and batch
//        row) read all of wh from L2 twice a step; the second recomputed
//        the gates with K3's product every step.
//   K4b, dWh: a split-K product.  The depth of T x B rows is cut into
//        `nsplit` chunks (bilstm_recurrence_bwd's `dwh_splits`, so that the
//        grid fills the SMs several times over); each CTA writes the
//        product of one 64 x 128 tile of dWh over one chunk to an f32 scratch
//        (f32: SIMT, 8 x 4 outputs per thread, no TF32; bf16: mma.sync with
//        ldmatrix.trans), and dwh_sum adds the chunks in order, so dWh is
//        the same from run to run.
//
// What bounds them: not the work.  The bound (bytes once at 3.35 TB/s, or the
// products at peak) is far below a chain of 250 dependent steps: K3 and K4a
// are set by their per-step latency (a product, the cell, the DSMEM
// exchange and its wait).  K4b is a plain product, bound by the f32 FMA rate
// or, in bf16, by staging its operands.

#include <algorithm>

#include "lstm_cluster.cuh"

namespace {

// ------------------------------------------------------------------ K4b

// dWh[d] = A^T . B over the depth of all (s, b) rows, row = s * B + b:
// A[row][k] = round_cd(h_prev) (K3's h stream at kernel step s - 1, zero at
// s = 0), B[row][j] = dxw[s][d][b][j].  Launch 1 writes the partial product
// of each chunk of `rows_per` rows into part[chunk][d] (H x 4H, f32); launch
// 2 sums the chunks in order 0 .. nsplit-1.
struct DwhArgs {
  const float* h_f;
  const float* h_b;
  const void* dxw;
  float* part;  // (nsplit, 2, H, 4H) f32
  int t_len, batch, hidden, rows_per;
};

// Depth row `row` = s * B + b of a chunk ending at row_end: its h_prev row
// in K3's h stream (null at s = 0: zero) and its dxw row (null past the
// chunk), found once per row and stage.
template <typename T>
struct DwhRow {
  const float* a;
  const T* b;
};

template <typename T>
__device__ __forceinline__ DwhRow<T> dwh_row(const DwhArgs& p, int dir, int row, int row_end) {
  DwhRow<T> r{nullptr, nullptr};
  if (row < row_end) {
    const int s = row / p.batch, b = row - s * p.batch;
    r.b = static_cast<const T*>(p.dxw) + (((size_t)s * 2 + dir) * p.batch + b) * 4 * p.hidden;
    if (s > 0) {
      const size_t tp = dir == 0 ? s - 1 : p.t_len - s;
      r.a = (dir == 0 ? p.h_f : p.h_b) + (tp * p.batch + b) * p.hidden;
    }
  }
  return r;
}

// f32: a 64 (k) x 128 (j) tile, 8 x 4 outputs per thread, 16 rows per stage,
// staged through registers and double-buffered; no TF32.
constexpr int kDm = 64, kDn = 128, kDk = 16, kDThreads = 256;
// bf16: the same tile on mma.sync.m16n8k16, 32 rows per stage, fragments by
// ldmatrix.trans (both operands are stored row-major by depth row); 8 warps
// of 32 x 32 outputs.  Rows padded by 8 so that ldmatrix reads conflict-free.
constexpr int kEk = 32;

__device__ __forceinline__ void dwh_bounds(const DwhArgs& p, int& r_lo, int& r_hi) {
  r_lo = (blockIdx.z / 2) * p.rows_per;
  r_hi = min(p.t_len * p.batch, r_lo + p.rows_per);
}

__device__ __forceinline__ void dwh_store(const DwhArgs& p, int dir, int k, int j, float v) {
  if (k < p.hidden && j < 4 * p.hidden) {
    p.part[(((size_t)(blockIdx.z / 2) * 2 + dir) * p.hidden + k) * 4 * p.hidden + j] = v;
  }
}

__global__ void __launch_bounds__(kDThreads, 2) dwh_partial_f32(DwhArgs p) {
  __shared__ __align__(16) float as[2][kDk][kDm];
  __shared__ __align__(16) float bs[2][kDk][kDn];
  const int dir = blockIdx.z % 2, k0 = blockIdx.y * kDm, j0 = blockIdx.x * kDn;
  const int tid = threadIdx.x, ty = tid / kWarp, tx = tid % kWarp, g4 = 4 * p.hidden;
  int r_lo, r_hi;
  dwh_bounds(p, r_lo, r_hi);
  // per stage and thread: row r0 + tid / 16, 4 k of A from k0 + 4 (tid % 16)
  // and 8 j of B from j0 + 8 (tid % 16) (two float4s: g4 is a multiple of 4)
  const int ka = 4 * (tid % 16), jb = 8 * (tid % 16);
  float ra[4], rb[8];
  auto fetch = [&](int r0) {
    const DwhRow<float> row = dwh_row<float>(p, dir, r0 + tid / 16, r_hi);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ra[e] = row.a && k0 + ka + e < p.hidden ? row.a[k0 + ka + e] : 0.0f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (row.b && j0 + jb + 4 * h < g4) v = *reinterpret_cast<const float4*>(row.b + j0 + jb + 4 * h);
      rb[4 * h] = v.x, rb[4 * h + 1] = v.y, rb[4 * h + 2] = v.z, rb[4 * h + 3] = v.w;
    }
  };
  auto stash = [&](int buf) {
    *reinterpret_cast<float4*>(&as[buf][tid / 16][ka]) = make_float4(ra[0], ra[1], ra[2], ra[3]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<float4*>(&bs[buf][tid / 16][jb + 4 * h]) =
          make_float4(rb[4 * h], rb[4 * h + 1], rb[4 * h + 2], rb[4 * h + 3]);
    }
  };
  float acc[8][4] = {};
  fetch(r_lo);
  stash(0);
  __syncthreads();
  for (int r0 = r_lo, buf = 0; r0 < r_hi; r0 += kDk, buf ^= 1) {
    const bool more = r0 + kDk < r_hi;
    if (more) fetch(r0 + kDk);
#pragma unroll
    for (int kk = 0; kk < kDk; ++kk) {
      float a[8], b[4];
      load4(*reinterpret_cast<float(*)[4]>(a), &as[buf][kk][ty * 8]);
      load4(*reinterpret_cast<float(*)[4]>(a + 4), &as[buf][kk][ty * 8 + 4]);
      load4(b, &bs[buf][kk][tx * 4]);
#pragma unroll
      for (int m = 0; m < 8; ++m) {
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[m][n] = fmaf(a[m], b[n], acc[m][n]);
      }
    }
    if (more) stash(buf ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < 8; ++m) {
#pragma unroll
    for (int n = 0; n < 4; ++n) dwh_store(p, dir, k0 + ty * 8 + m, j0 + tx * 4 + n, acc[m][n]);
  }
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

__global__ void __launch_bounds__(kDThreads) dwh_partial_bf16(DwhArgs p) {
  using bf16 = __nv_bfloat16;
  __shared__ __align__(16) bf16 as[2][kEk][kDm + 8];  // [row][k]
  __shared__ __align__(16) bf16 bs[2][kEk][kDn + 8];  // [row][j]
  const int dir = blockIdx.z % 2, k0 = blockIdx.y * kDm, j0 = blockIdx.x * kDn;
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp, g4 = 4 * p.hidden;
  const int wm = warp / 4, wn = warp % 4, g = lane / 4, tg = lane % 4;
  int r_lo, r_hi;
  dwh_bounds(p, r_lo, r_hi);
  // per stage and thread: row r0 + tid / 8, a run of 8 k of A from k0 +
  // 8 (tid % 8) and two runs of 8 j of B from j0 + 16 (tid % 8)
  const int ka = 8 * (tid % 8), jb = 16 * (tid % 8);
  union Run8 {
    uint4 v;
    bf16 h[8];
  };
  Run8 ra, rb[2];
  auto fetch = [&](int r0) {
    const DwhRow<bf16> row = dwh_row<bf16>(p, dir, r0 + tid / 8, r_hi);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int k = k0 + ka + q;
      ra.h[q] = __float2bfloat16(row.a && k < p.hidden ? row.a[k] : 0.0f);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = j0 + jb + 8 * e;
      const bf16* at = row.b ? row.b + j : nullptr;
      if (at && j + 8 <= g4 && (reinterpret_cast<uintptr_t>(at) & 15) == 0) {
        rb[e].v = *reinterpret_cast<const uint4*>(at);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) rb[e].h[q] = (at && j + q < g4) ? at[q] : __float2bfloat16(0.0f);
      }
    }
  };
  auto stash = [&](int buf) {
    *reinterpret_cast<uint4*>(&as[buf][tid / 8][ka]) = ra.v;
#pragma unroll
    for (int e = 0; e < 2; ++e) *reinterpret_cast<uint4*>(&bs[buf][tid / 8][jb + 8 * e]) = rb[e].v;
  };
  float acc[2][4][4] = {};
  fetch(r_lo);
  stash(0);
  __syncthreads();
  // ldmatrix row addresses (lane l feeds row l % 8 of matrix l / 8): A's
  // matrices in the order (rows 0-7, k 0-7), (rows 0-7, k 8-15), (rows 8-15,
  // k 0-7), (rows 8-15, k 8-15) give a0..a3 of A = h_prev^T; B's (rows 0-7,
  // j 0-7), (rows 8-15, j 0-7), (rows 0-7, j 8-15), (rows 8-15, j 8-15) give
  // b0, b1 of two n-tiles
  const int ar = lane % 8 + (lane / 16) * 8, ac = ((lane / 8) % 2) * 8;
  const int br = lane % 8 + ((lane / 8) % 2) * 8, bc = (lane / 16) * 8;
  for (int r0 = r_lo, buf = 0; r0 < r_hi; r0 += kEk, buf ^= 1) {
    const bool more = r0 + kEk < r_hi;
    if (more) fetch(r0 + kEk);
#pragma unroll
    for (int ks = 0; ks < kEk; ks += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) ldmatrix_x4_trans(a[mi], &as[buf][ks + ar][wm * 32 + mi * 16 + ac]);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &bs[buf][ks + br][wn * 32 + nj * 16 + bc]);
        b[2 * nj][0] = r[0], b[2 * nj][1] = r[1], b[2 * nj + 1][0] = r[2], b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
      }
    }
    if (more) stash(buf ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int k = k0 + wm * 32 + mi * 16 + g, j = j0 + wn * 32 + ni * 8 + 2 * tg;
      dwh_store(p, dir, k, j, acc[mi][ni][0]);
      dwh_store(p, dir, k, j + 1, acc[mi][ni][1]);
      dwh_store(p, dir, k + 8, j, acc[mi][ni][2]);
      dwh_store(p, dir, k + 8, j + 1, acc[mi][ni][3]);
    }
  }
}

// dwh = sum over the chunks of part, in chunk order (n4 float4s per chunk).
__global__ void __launch_bounds__(256) dwh_sum(const float4* __restrict__ part,
                                               float4* __restrict__ dwh, size_t n4, int nsplit) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 v = part[i];
    for (int c = 1; c < nsplit; ++c) {
      const float4 w = part[c * n4 + i];
      v.x += w.x, v.y += w.y, v.z += w.z, v.w += w.w;
    }
    dwh[i] = v;
  }
}

// ------------------------------------------------------------------ launchers

// K3, K5, K6: the cluster recurrence over the TPU layout of xw; outputs f32.
template <bool kCarry, bool kCellOut, bool kGatesOut = false>
int recurrence(int in_bf16, const RecArgs& p, const Plan& plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    return launch_rec_plan<__nv_bfloat16, float, XwLayout::kGateMajor, kCarry, kCellOut,
                           kGatesOut>(p, plan, s);
  }
  return launch_rec_plan<float, float, XwLayout::kGateMajor, kCarry, kCellOut, kGatesOut>(p, plan,
                                                                                       s);
}

// K4: the walk (rec_cluster_bwd), then dWh's partial products and their sum.
template <typename T>
int launch_bwd(const BwdArgs& walk, const Plan& plan, float* dwh, float* part, int nsplit,
               int rows_per, cudaStream_t stream) {
  const size_t n4 = 2 * (size_t)walk.hidden * walk.hidden;  // (2, H, 4H) f32 in float4s
  if (walk.t_len == 0 || walk.batch == 0) return (int)cudaMemsetAsync(dwh, 0, 16 * n4, stream);
  if (nsplit < 1 || rows_per < 1 || rows_per % kEk != 0 ||
      (long)nsplit * rows_per < (long)walk.t_len * walk.batch) {
    return (int)cudaErrorInvalidValue;
  }
  int err = launch_bwd_walk_plan<T>(walk, plan, stream);
  if (err != 0) return err;
  const DwhArgs p{walk.h_f, walk.h_b, walk.dxw, part, walk.t_len, walk.batch, walk.hidden,
                  rows_per};
  const dim3 grid((4 * walk.hidden + kDn - 1) / kDn, (walk.hidden + kDm - 1) / kDm, 2 * nsplit);
  if constexpr (sizeof(T) == 2) {
    dwh_partial_bf16<<<grid, kDThreads, 0, stream>>>(p);
  } else {
    dwh_partial_f32<<<grid, kDThreads, 0, stream>>>(p);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int blocks = (int)std::min<size_t>((n4 + 255) / 256, 4096);
  dwh_sum<<<blocks, 256, 0, stream>>>(reinterpret_cast<const float4*>(part),
                                     reinterpret_cast<float4*>(dwh), n4, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K3: xw (T,2,B,4H) and wh (2,H,4H) at the compute dtype; out_f/out_b and
// c_f/c_b (T,B,H) f32; gates (T,2,B,H,4) f32; the plan of launch_plan
// (cluster, units, batch tile, depth split, resident depth rows).  Returns
// the launch's CUDA error.
int avsi_bilstm_recurrence_train(const void* xw, const void* wh, float* out_f,
                                 float* out_b, float* c_f, float* c_b, float* gates,
                                 int t_len, int batch, int hidden, int in_bf16, int cluster,
                                 int units, int btile, int ksplit, int resident, void* stream) {
  const RecArgs p{xw, wh, nullptr, out_f, out_b, c_f, c_b, gates, t_len, batch, hidden, 0, 0, 0};
  const Plan plan{cluster, units, btile, ksplit, resident};
  return recurrence<false, true, true>(in_bf16, p, plan, stream);
}

// K5: K3 from the initial carries hc0 (2, 2, B, H) f32 ([h|c][dir]).
int avsi_bilstm_recurrence_carry(const void* xw, const void* wh, const float* hc0,
                                 float* out_f, float* out_b, float* c_f, float* c_b,
                                 int t_len, int batch, int hidden, int in_bf16, int cluster,
                                 int units, int btile, int ksplit, int resident, void* stream) {
  const RecArgs p{xw, wh, hc0, out_f, out_b, c_f, c_b, nullptr, t_len, batch, hidden, 0, 0, 0};
  const Plan plan{cluster, units, btile, ksplit, resident};
  return recurrence<true, true>(in_bf16, p, plan, stream);
}

// K6: K3 without the c streams; out_f/out_b (T,B,H) f32.
int avsi_bilstm_recurrence(const void* xw, const void* wh, float* out_f, float* out_b,
                           int t_len, int batch, int hidden, int in_bf16, int cluster,
                           int units, int btile, int ksplit, int resident, void* stream) {
  const RecArgs p{xw,      wh,    nullptr, out_f,  out_b, nullptr, nullptr,
                  nullptr, t_len, batch,   hidden, 0,     0,       0};
  const Plan plan{cluster, units, btile, ksplit, resident};
  return recurrence<false, false>(in_bf16, p, plan, stream);
}

// K4: wh, dout_f/dout_b and dxw at the compute dtype; gates, out_f/out_b and
// c_f/c_b f32 (K3's outputs); dwh (2,H,4H) f32; part (nsplit,2,H,4H) f32
// scratch; the walk's plan of bwd_plan (cluster, units, batch tile, depth
// split, resident depth rows); dWh's depth chunks (nsplit of rows_per rows).
int avsi_bilstm_recurrence_bwd(const float* gates, const void* wh, const float* out_f,
                               const float* out_b, const float* c_f, const float* c_b,
                               const void* dout_f, const void* dout_b, void* dxw, float* dwh,
                               float* part, int t_len, int batch, int hidden, int in_bf16,
                               int cluster, int units, int btile, int ksplit, int resident,
                               int nsplit, int rows_per, void* stream) {
  const BwdArgs p{gates, wh, out_f, out_b, c_f, c_b, dout_f, dout_b, dxw,
                  t_len, batch, hidden, 0, 0, 0};
  const Plan plan{cluster, units, btile, ksplit, resident};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) return launch_bwd<__nv_bfloat16>(p, plan, dwh, part, nsplit, rows_per, s);
  return launch_bwd<float>(p, plan, dwh, part, nsplit, rows_per, s);
}

}  // extern "C"

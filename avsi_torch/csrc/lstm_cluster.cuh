// The bidirectional LSTM recurrence on thread-block clusters, for Hopper:
// one body for K1/K2 (lstm_fused.cu, after their projection GEMM) and for
// K3, K5 and K6 (lstm_train.cu, over a precomputed gate input).
//
// What it computes, per direction d and step s (the TPU kernels' `_cell`,
// avsi/ops/pallas_lstm.py:100-118):
//   gates = xw_s + round_cd(h) . wh[d]                  f32 accumulation
//   c     = sig(f) * c + sig(i) * tanh(g);  h = sig(o) * tanh(c)   all f32
// Gate order i, f, g, o along the 4H axis.  Direction 0 walks t = 0..T-1
// and direction 1 walks t = T-1..0; h (and c) are written in original time.
//
// rec_cluster: one thread-block cluster of N CTAs per (direction, batch
// tile).  The cluster splits the H hidden units; each CTA owns all four gates
// of U units (U*4 gate columns), so its cell is local.
// - Each CTA loads its (H x 4U) slice of wh[d] into shared memory once and
//   keeps it for all T steps (128 KB f32, 64 KB bf16 at H=250, N=8), and
//   serves a whole batch tile (8 or 16 rows) from it.  Where the slice does
//   not fit (f32 H > 416, bf16 H > 624), the plan keeps its first
//   `resident` depth rows there and the product reads the rest from wh in
//   global memory (through L2) every step, in the same order, so the sums
//   do not change.
// - The product: in bf16 mma.sync.m16n8k16 with A = the slice transposed
//   (stored in the mma's fragment order, one 16-byte shared load per
//   fragment) and B = h^T (N = 8 batch rows); in f32 a thread owns four gate
//   columns and the tile's rows in registers and reads each wh element once
//   per step.  The depth is split over thread groups and summed in shared
//   memory, in a fixed order.
// - Per step: product, cell (c stays in the CTA), round_cd(h) of the CTA's
//   units written into every peer's h buffer through distributed shared
//   memory (double-buffered by step parity), one cluster barrier
//   (arrive.release, then h and c written out, then wait.acquire).
// The launch plan (N, U, batch tile, depth split) comes from
// avsi_torch/ops/lstm_fused.py:launch_plan; the launcher lays out the shared
// memory (rec_layout, which the plan mirrors to choose a layout that fits),
// checks the plan with cudaOccupancyMaxActiveClusters and returns the CUDA
// error of a plan that cannot be scheduled.  Beyond the widths one cluster
// of 16 can hold a layer's h and serve at all (f32 H > 2048, bf16 H > 1024:
// threads, cells per thread, the h buffers) there is no plan, and the
// wrappers raise.
//
// Compile-time switches:
// - XwLayout: where the gate input comes from.
//   kUnitMajor: K1/K2's GEMM scratch, (2, T*B, 4H), column u*4 + gate, so
//     a unit's four gates are one 16-byte (f32) or 8-byte (bf16) run,
//     direction 1 in original time (read at t = T-1-s).  Staged by cp.async
//     into a two-step ring in shared memory, one step ahead.
//   kGateMajor: the TPU layout of K3/K5/K6, (T, 2, B, 4H), column gate*H + u,
//     direction 1 already in walk order (read at s).  A unit's four gates
//     lie H apart, and in bf16 a 2-byte element is below cp.async's 4-byte
//     minimum, so each thread loads the gates of its own cells into
//     registers: one step ahead, issued after the cell has read the current
//     ones, so the loads fly during the barrier and the next product.
//     Consecutive threads take consecutive units: the loads coalesce.  No
//     ring in shared memory (rec_layout leaves it out).
// - kCarry: start from hc0 (2=h|c, 2=dir, B, H) f32 (K5).  Every CTA fills
//   parity buffer 0 of h with round_cd(h0) for all H units of its rows,
//   straight from global memory, and c with c0 of its own units; rows past
//   the batch keep h = c = 0.  Without it both start at zero.
// - kCellOut: write the f32 c streams beside h (K3, K5).
// - kSpill: the plan keeps only the slice's first `resident` depth rows in
//   shared memory (tiles of 8 only); the product reads the rest from wh.
//   Its own instances, so that whole plans run the single resident loop
//   (a runtime switch in that loop cost K3 f32 ~10% in registers spilled).
// The product and the cell are the same code in every instance, so outputs
// coincide bit for bit wherever the functions and the plan coincide (K3, K5
// from zero carries, K6, and K1/K2 given the same xw).

#pragma once

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

// ------------------------------------------------------------ the recurrence

enum class XwLayout { kUnitMajor, kGateMajor };

struct RecArgs {
  const void* xw;     // compute dtype, laid out as XwLayout says
  const void* wh;     // (2, H, 4H) compute dtype
  const float* hc0;   // kCarry: (2=h|c, 2=dir, B, H) f32
  void* out_f;        // h streams (T, B, H), original time order
  void* out_b;
  float* c_f;         // kCellOut: f32 c streams (T, B, H), original time order
  float* c_b;
  int t_len, batch, hidden, units, ksplit, resident;
};

// What avsi_torch/ops/lstm_fused.py:LaunchPlan.c_args hands the launchers.
struct Plan {
  int cluster, units, btile, ksplit, resident;
};

// Byte offsets of the recurrence's shared buffers (16-byte aligned each);
// avsi_torch/ops/lstm_fused.py:rec_smem_bytes mirrors the total for the plan.
struct RecLayout {
  size_t wh, hs, ring, gs, cs, total;
};

__host__ __device__ inline size_t align16(size_t v) { return (v + 15) & ~(size_t)15; }
__host__ __device__ inline int padded_depth(int hidden) { return (hidden + 15) / 16 * 16; }

// `resident`: depth rows of the wh slice held here (a multiple of 16);
// `ring`: the xw ring of kUnitMajor.
template <typename T>
__host__ __device__ inline RecLayout rec_layout(int hidden, int units, int bt, int ksplit,
                                                int resident, bool ring) {
  const size_t g = 4 * (size_t)units;
  const size_t kp = padded_depth(hidden);
  RecLayout l;
  l.wh = 0;  // f32: [resident][4U]; bf16: mma A fragments of [4U][resident]; zero past H
  l.hs = l.wh + align16(g * resident * sizeof(T));
  // two parity buffers of round_cd(h) for the whole layer, [bt][kp + 8] each
  l.ring = l.hs + align16(2 * bt * (kp + 8) * sizeof(T));
  l.gs = l.ring + (ring ? align16(2 * bt * g * sizeof(T)) : 0);  // xw ring [2][bt][4U]
  l.cs = l.gs + align16((size_t)ksplit * bt * g * 4);  // partial gates [ksplit][bt][4U]
  l.total = l.cs + align16((size_t)bt * units * 4);    // c [bt][U]
  return l;
}

// One CTA of the cluster for (direction blockIdx.y, batch tile blockIdx.x / N):
// gate columns of units [rank*U, rank*U + nu), rows [b0, b0 + BT) of the batch.
template <typename T, typename O, int BT, XwLayout kXw, bool kCarry, bool kCellOut, bool kSpill>
__global__ void __launch_bounds__(rec_threads_max<T>()) rec_cluster(RecArgs p) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr bool kGateMajor = kXw == XwLayout::kGateMajor;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_cta = (int)cluster.dim_blocks().x, rank = (int)cluster.block_rank();
  const int dir = blockIdx.y, b0 = (blockIdx.x / n_cta) * BT;
  const int H = p.hidden, U = p.units, G = 4 * U, u0 = rank * U;
  const int nu = max(0, min(U, H - u0));
  const int kp = padded_depth(H), ksteps = kp / 16, mt_n = G / 16;
  const int kres = p.resident, ks_res = kres / 16;  // depth rows (k-steps) held in whs
  const int hrow = kp + 8, h_buf = BT * hrow;  // h row stride; elements per parity buffer
  const size_t g4 = 4 * (size_t)H;
  const RecLayout lay = rec_layout<T>(H, U, BT, p.ksplit, kres, !kGateMajor);
  extern __shared__ __align__(16) unsigned char rec_smem[];
  T* whs = reinterpret_cast<T*>(rec_smem + lay.wh);
  T* hs = reinterpret_cast<T*>(rec_smem + lay.hs);
  T* ring = reinterpret_cast<T*>(rec_smem + lay.ring);
  float* gs = reinterpret_cast<float*>(rec_smem + lay.gs);
  float* cs = reinterpret_cast<float*>(rec_smem + lay.cs);
  const T* wh = static_cast<const T*>(p.wh) + (size_t)dir * H * g4;
  // kUnitMajor: rows (t, b) of direction dir; kGateMajor: rows (s, dir, b)
  const T* xw = static_cast<const T*>(p.xw) +
                (size_t)dir * (kGateMajor ? 1 : p.t_len) * p.batch * g4;
  O* out = static_cast<O*>(dir == 0 ? p.out_f : p.out_b);
  float* c_out = dir == 0 ? p.c_f : p.c_b;
  const int tid = threadIdx.x, nthr = blockDim.x, items = U * BT;

  // the slice of wh[d], column c = lu * 4 + gate <- wh[d][k][gate * H + u0 + lu]
  auto wh_at = [&](int c, int k) -> T {
    const int lu = c / 4;
    return (lu < nu && k < H) ? wh[(size_t)k * g4 + (c % 4) * H + u0 + lu] : from_f32<T>(0.0f);
  };
  // the mma A fragment (m-tile mt, k-step ks) of this lane: A = slice^T
  auto frag_at = [&](auto mt, int ks, int lane) -> uint4 {  // generic: bf16 only
    const int r = mt * 16 + lane / 4, k = ks * 16 + 2 * (lane % 4);
    return make_uint4(pack_bf16(wh_at(r, k), wh_at(r, k + 1)),
                      pack_bf16(wh_at(r + 8, k), wh_at(r + 8, k + 1)),
                      pack_bf16(wh_at(r, k + 8), wh_at(r, k + 9)),
                      pack_bf16(wh_at(r + 8, k + 8), wh_at(r + 8, k + 9)));
  };
  if constexpr (kBf16) {  // fragment (mt, kstep, lane), one uint4 each
    uint4* frag = reinterpret_cast<uint4*>(whs);
    for (int i = tid; i < mt_n * ks_res * kWarp; i += nthr) {
      frag[i] = frag_at(i / kWarp / ks_res, (i / kWarp) % ks_res, i % kWarp);
    }
  } else {
    for (int i = tid; i < kres * G; i += nthr) whs[i] = wh_at(i % G, i / G);
  }
  // h: buffer 0 holds h0 (round_cd(h0) with kCarry, else 0), pads and rows
  // past the batch 0; buffer 1 is 0 until the first step writes it
  for (int i = tid; i < 2 * h_buf; i += nthr) {
    T v = from_f32<T>(0.0f);
    if constexpr (kCarry) {
      const int k = i % hrow, b = b0 + i / hrow;
      if (i < h_buf && k < H && b < p.batch) {
        v = from_f32<T>(p.hc0[((size_t)dir * p.batch + b) * H + k]);
      }
    }
    hs[i] = v;
  }
  for (int i = tid; i < items; i += nthr) {  // c of this CTA's units
    float c = 0.0f;
    if constexpr (kCarry) {
      const int lu = i % U, b = b0 + i / U;
      if (lu < nu && b < p.batch) {
        c = p.hc0[((size_t)(2 + dir) * p.batch + b) * H + u0 + lu];
      }
    }
    cs[i] = c;
  }

  // kUnitMajor: item i = (row r = i / U, unit lu = i % U): its four gates of
  // xw are one 16-byte (f32) or 8-byte (bf16) run, copied into the ring.
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
  // kGateMajor: the four gates of this thread's cells j, into registers
  T xg[kRecItemsMax][4];
  auto fetch = [&](int s) {
    const T* row = xw + (size_t)s * 2 * p.batch * g4;
#pragma unroll
    for (int j = 0; j < kRecItemsMax; ++j) {
      const int i = tid + j * nthr, lu = i % U, b = b0 + i / U;
      if (i < items && lu < nu && b < p.batch) {
        const T* x = row + (size_t)b * g4 + u0 + lu;
#pragma unroll
        for (int q = 0; q < 4; ++q) xg[j][q] = x[(size_t)q * H];
      }
    }
  };
  if constexpr (kGateMajor) {
    if (p.t_len > 0) fetch(0);
  } else {
    prefetch(0);
  }
  cluster.sync();  // every CTA runs and has filled its h buffers before any peer writes

  for (int s = 0; s < p.t_len; ++s) {
    const int t = dir == 0 ? s : p.t_len - 1 - s;
    if constexpr (!kGateMajor) {
      if (s + 1 < p.t_len) {
        prefetch(s + 1);
      } else {
        cp_async_commit();
      }
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
        auto mma_step = [&](const uint4& f, int kk) {
          const uint32_t a[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
          for (int nt = 0; nt < BT / 8; ++nt) {
            const T* hr = h_cur + (nt * 8 + g) * hrow + kk * 16 + 2 * tg;
            mma_bf16(acc[nt], a, ld_u32(hr), ld_u32(hr + 8));
          }
        };
        if constexpr (kSpill) {  // k-steps in order: the resident ones, then those from wh
          int kk = ks;
          for (; kk < ks_res; kk += p.ksplit) mma_step(frag[(mt * ks_res + kk) * kWarp + lane], kk);
          for (; kk < ksteps; kk += p.ksplit) mma_step(frag_at(mt, kk, lane), kk);
        } else {
          for (int kk = ks; kk < ksteps; kk += p.ksplit) {
            mma_step(frag[(mt * ksteps + kk) * kWarp + lane], kk);
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
        auto fma_rows = [&](const float (&wv)[4][4], int k) {
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
        };
        // depth rows in order: the resident ones, then (kSpill) those read
        // from wh, unit cq's four gates H apart there
        int k = ks * k_chunk;
        for (; k < (kSpill ? min(k_hi, kres) : k_hi); k += 4) {
          float wv[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) load4(wv[kk], whs + (k + kk) * G + cq * 4);
          fma_rows(wv, k);
        }
        for (; kSpill && k < k_hi; k += 4) {
          float wv[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
            for (int j = 0; j < 4; ++j) wv[kk][j] = to_f32<T>(wh_at(cq * 4 + j, k + kk));
          }
          fma_rows(wv, k);
        }
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          *reinterpret_cast<float4*>(gs + (ks * BT + r) * G + cq * 4) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        }
      }
    }
    if constexpr (!kGateMajor) cp_async_wait_one();  // (a) this step's xw rows have landed
    __syncthreads();  // every partial gate is in gs

    // (c) the cell in f32, (d) round_cd(h) into every peer; a warp's lanes
    // are consecutive units of one row, so its DSMEM stores are contiguous
    float h_out[kRecItemsMax], c_new[kRecItemsMax];
#pragma unroll
    for (int j = 0; j < kRecItemsMax; ++j) {
      const int i = tid + j * nthr, lu = i % U, r = i / U, b = b0 + r;
      if (i >= items || lu >= nu) continue;
      float h = 0.0f;  // rows past the batch carry h = 0
      if (b < p.batch) {
        float gate[4], prod[4];
        if constexpr (kGateMajor) {
#pragma unroll
          for (int q = 0; q < 4; ++q) gate[q] = to_f32<T>(xg[j][q]);
        } else {
          load4(gate, ring + (s & 1) * BT * G + r * G + lu * 4);  // xw, parity-cast
        }
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
        c_new[j] = c;
      }
      h_out[j] = h;
      const T hv = from_f32<T>(h);
      for (int q = 0; q < n_cta; ++q) cluster.map_shared_rank(h_next, q)[r * hrow + u0 + lu] = hv;
    }
    // the next step's gate input is read now that the cell is done with
    // this one's: its loads are in flight during the barrier and the product
    if constexpr (kGateMajor) {
      if (s + 1 < p.t_len) fetch(s + 1);
    }
    // (f) one cluster barrier per step: arrive releases the DSMEM stores; the
    // peers' h is visible, and nobody reads this step's buffers, after wait.
    // (e) h (and c) go out to global memory between the two, off the release.
    // After the last step the barrier is the cluster sync before exit: no
    // peer writes into this CTA's shared memory after it.
    cluster_arrive();
#pragma unroll
    for (int j = 0; j < kRecItemsMax; ++j) {
      const int i = tid + j * nthr, lu = i % U, b = b0 + i / U;
      if (i < items && lu < nu && b < p.batch) {
        const size_t at = ((size_t)t * p.batch + b) * H + u0 + lu;
        out[at] = from_f32<O>(h_out[j]);
        if constexpr (kCellOut) c_out[at] = c_new[j];
      }
    }
    cluster_wait();
  }
}

// ------------------------------------------------------------ launchers

template <typename T, typename O, int BT, XwLayout kXw, bool kCarry, bool kCellOut, bool kSpill>
int launch_rec(const RecArgs& p, int cluster, cudaStream_t stream) {
  auto kernel = rec_cluster<T, O, BT, kXw, kCarry, kCellOut, kSpill>;
  const int threads = (sizeof(T) == 2 ? 8 : 1) * p.units * p.ksplit;
  if (cluster < 1 || cluster > 16 || p.units % 4 != 0 || p.ksplit < 1 ||
      threads > rec_threads_max<T>() || p.units * BT > kRecItemsMax * threads ||
      (sizeof(T) == 4 && 4 * p.ksplit > padded_depth(p.hidden)) ||
      (long)cluster * p.units < p.hidden || p.resident < 0 || p.resident % 16 != 0 ||
      (p.resident < padded_depth(p.hidden)) != kSpill || p.resident > padded_depth(p.hidden)) {
    return (int)cudaErrorInvalidValue;  // not a plan of launch_plan's
  }
  const size_t smem =
      rec_layout<T>(p.hidden, p.units, BT, p.ksplit, p.resident, kXw == XwLayout::kUnitMajor)
          .total;
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
  // Once per device and instance (the statics are per template instance):
  // opt the kernel in to the card's largest dynamic shared memory (an upper
  // bound, so every plan's size fits under it) and to clusters of 16.  Once
  // per (device, plan): check that one cluster of the plan fits the card.
  // The occupancy query costs more host time than the launch, and the
  // serving loop is host-bound.
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

// The recurrence under a plan of launch_plan's (the batch tile and the resident depth pick the
// instance).  Nothing to do at T = 0 or B = 0.
template <typename T, typename O, XwLayout kXw, bool kCarry = false, bool kCellOut = false>
int launch_rec_plan(RecArgs p, const Plan& plan, cudaStream_t s) {
  if (p.t_len == 0 || p.batch == 0) return 0;
  p.units = plan.units;
  p.ksplit = plan.ksplit;
  p.resident = plan.resident;
  if (plan.resident < padded_depth(p.hidden)) {  // a wide layer: launch_plan spills on tiles of 8
    if (plan.btile != 8) return (int)cudaErrorInvalidValue;
    return launch_rec<T, O, 8, kXw, kCarry, kCellOut, true>(p, plan.cluster, s);
  }
  const int n = plan.cluster;
  if (plan.btile == 8) return launch_rec<T, O, 8, kXw, kCarry, kCellOut, false>(p, n, s);
  if (plan.btile == 16) return launch_rec<T, O, 16, kXw, kCarry, kCellOut, false>(p, n, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

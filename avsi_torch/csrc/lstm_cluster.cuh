// The bidirectional LSTM recurrence on thread-block clusters, for Hopper:
// one body for K1/K2 (lstm_fused.cu, after their projection GEMM) and for
// K3, K5 and K6 (lstm_train.cu, over a precomputed gate input), and K4's
// reverse walk on the same clusters and slices over K3's saved gate sums
// (rec_cluster_bwd, below).
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
// - Per step: wait for the h buffer of this step's parity, product, cell
//   (c stays in the CTA), round_cd(h) of the CTA's units written into every
//   peer's buffer of the next parity through distributed shared memory by
//   st.async, which completes the peer's mbarrier of that buffer (the
//   exchange, below: no cluster barrier in the step loop), then h and c
//   written out and one block barrier.
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
//     ones, so the loads fly during the wait and the next product.
//     Consecutive threads take consecutive units: the loads coalesce.  No
//     ring in shared memory (rec_layout leaves it out).
// - kCarry: start from hc0 (2=h|c, 2=dir, B, H) f32 (K5).  Every CTA fills
//   parity buffer 0 of h with round_cd(h0) for all H units of its rows,
//   straight from global memory, and c with c0 of its own units; rows past
//   the batch keep h = c = 0.  Without it both start at zero.
// - kCellOut: write the f32 c streams beside h (K3, K5).
// - kGatesOut: write the f32 gate sums, xw + the partial products in the
//   cell's order (K3 in training: K4's walk reads them back in place of
//   recomputing them), (T, 2, B, H, 4) in kernel time, unit-major: a cell's
//   four gates are one 16-byte store, and consecutive threads write
//   consecutive units.  The cell leaves its sums in its own columns of the
//   partial gates' plane 0 as soon as it has made them, so no register
//   lives on across the cell, and they go out with h and c after the
//   exchange (stored before a cluster barrier's release, they made K3 bf16
//   up to 35% slower on the H100), read before the step's closing block
//   barrier, after which the next product overwrites the plane.
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
#include <utility>

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

// ------------------------------------------------------------ the exchange
//
// Each step ends with the CTA's results written into its peers' shared
// memory (K3: round_cd(h); the walk: dh_rec partials) by st.async, which
// completes `bytes` of the transaction count of the receiving CTA's
// mbarrier for that parity buffer.  The receiver's one local arrival per
// phase (mbarrier.arrive.expect_tx, the bytes the step brings) may come
// before or after the peers' stores: the phase completes when both have,
// and every reading thread waits on it with try_wait.parity.  No cluster
// barrier in the step loop: see the reuse argument at rec_cluster.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// The shared::cluster address of the same location in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t peer_addr(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
// Both parity barriers with one arrival a phase, visible to the cluster
// after its next barrier.
__device__ __forceinline__ void mbar_init_pair(uint32_t bar) {
  asm volatile(
      "mbarrier.init.shared::cta.b64 [%0], 1;\n"
      "mbarrier.init.shared::cta.b64 [%1], 1;\n"
      "fence.mbarrier_init.release.cluster;\n" ::"r"(bar), "r"(bar + 8)
      : "memory");
}
// The local arrival of a phase, which then waits for `bytes` of stores.
__device__ __forceinline__ void mbar_arm(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Until the phase of parity `parity` has completed; the peers' stores are
// then visible to this thread.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// 16, 4 or 8 (bf16, packed pairs) bytes into a peer's shared memory at
// `dst`, completing that many bytes on the peer's barrier `bar`.
__device__ __forceinline__ void st_async(uint32_t dst, uint32_t bar, const float (&v)[4]) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n"
      ::"r"(dst), "r"(__float_as_uint(v[0])), "r"(__float_as_uint(v[1])),
      "r"(__float_as_uint(v[2])), "r"(__float_as_uint(v[3])), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async(uint32_t dst, uint32_t bar, float v) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               ::"r"(dst), "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}
__device__ __forceinline__ void st_async(uint32_t dst, uint32_t bar, uint32_t lo, uint32_t hi) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];\n"
      ::"r"(dst), "r"(lo), "r"(hi), "r"(bar)
      : "memory");
}
// The phase parity of the parity buffer read at step s >= 1 (buffer s & 1),
// filled at step s - 1: its ((s - 1) >> 1)-th fill.
__device__ __forceinline__ uint32_t fill_parity(int s) { return ((s - 1) >> 1) & 1; }

// The four lanes m = 0..3 of a group (m's bits at lane bits 3 and 2, the
// other lane bits alike) each hold row m of a 4 x 4 matrix M; afterwards
// lane m holds column m: a[j] = M[j][m].  Two exchange stages, two
// shuffles each; the whole warp takes part.
__device__ __forceinline__ void transpose4(float (&a)[4], int lane) {
  constexpr int hi = 8, lo = 4;
  constexpr unsigned mask = 0xFFFFFFFFu;
  const bool up = lane & hi, right = lane & lo;
#pragma unroll
  for (int j = 0; j < 2; ++j) {  // across bit 1: trade columns {2,3} of m < 2 for {0,1} of m >= 2
    const float got = __shfl_xor_sync(mask, up ? a[j] : a[j + 2], hi);
    if (up) {
      a[j] = got;
    } else {
      a[j + 2] = got;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; j += 2) {  // across bit 0: the odd column of even m for the even of odd
    const float got = __shfl_xor_sync(mask, right ? a[j] : a[j + 1], lo);
    if (right) {
      a[j] = got;
    } else {
      a[j + 1] = got;
    }
  }
}

__device__ __forceinline__ void cluster_sync_exit() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
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
  float* gates;       // kGatesOut: f32 gate sums (T, 2, B, H, 4), kernel time
  int t_len, batch, hidden, units, ksplit, resident;
};

// What avsi_torch/ops/lstm_fused.py:LaunchPlan.c_args hands the launchers.
struct Plan {
  int cluster, units, btile, ksplit, resident;
};

// Byte offsets of the recurrence's shared buffers (16-byte aligned each);
// avsi_torch/ops/lstm_fused.py:rec_smem_bytes mirrors the total for the plan.
struct RecLayout {
  size_t wh, hs, ring, gs, cs, bar, total;
};

constexpr size_t kBarBytes = 16;  // the two parity buffers' mbarriers, 8 bytes each

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
  l.bar = l.cs + align16((size_t)bt * units * 4);      // c [bt][U]
  l.total = l.bar + kBarBytes;                         // an mbarrier per h buffer
  return l;
}

// What avsi_torch/ops/lstm_train.py:bilstm_recurrence_bwd hands the walk.
struct BwdArgs {
  const float* gates;  // K3's f32 gate sums (T, 2, B, H, 4), kernel time, unit-major
  const void* wh;      // (2, H, 4H) compute dtype
  const float* h_f;    // K3's h streams (T, B, H) f32, original time order (dWh's)
  const float* h_b;
  const float* c_f;    // K3's c streams
  const float* c_b;
  const void* dout_f;  // upstream h gradients (T, B, H), compute dtype
  const void* dout_b;
  void* dxw;           // (T, 2, B, 4H) compute dtype, gate-major, direction 1 in walk order
  int t_len, batch, hidden, units, ksplit, resident;
};

// Row stride of the walk's f32 slice (4U columns and 4 floats of pad, so
// that the dh_rec product's threads, one per depth row, fall in different
// banks); bf16 keeps fragments and has no rows.
template <typename T>
__host__ __device__ inline int bwd_slice_stride(int units) {
  return sizeof(T) == 2 ? 0 : 4 * units + 4;
}

// Byte offsets of the walk's shared buffers (16-byte aligned each);
// avsi_torch/ops/lstm_train.py:bwd_smem_bytes mirrors the total.
struct BwdLayout {
  size_t wh, dg, recv, bar, total;
};

template <typename T>
__host__ __device__ inline BwdLayout bwd_layout(int units, int cluster, int bt, int resident) {
  const size_t g = 4 * (size_t)units;
  const bool bf16 = sizeof(T) == 2;
  BwdLayout l;
  l.wh = 0;  // f32: [resident][4U + 4]; bf16: mma A fragments of [4U][resident]
  l.dg = l.wh + align16((bf16 ? g : (size_t)bwd_slice_stride<T>(units)) * resident * sizeof(T));
  l.recv = l.dg + align16(bf16 ? bt * (g + 8) * 2 : bt * g * 4);  // dgates: bf16 rows padded by 8
  l.bar = l.recv + align16(2 * (size_t)cluster * bt * units * 4);  // [2][N][bt][U] f32
  l.total = l.bar + kBarBytes;  // an mbarrier per slot plane
  return l;
}

// The transpose of an 8 x 8 bf16 matrix held in the mma fragment layout.
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

// The CTA's slice of wh[d] in global memory: column c = lu * 4 + gate <-
// wh[d][k][gate * H + u0 + lu], zero past the CTA's units and past depth H.
template <typename T>
struct Slice {
  const T* wh;  // wh[d], (H, 4H)
  int hidden, u0, nu;

  __device__ __forceinline__ T at(int c, int k) const {
    const int lu = c / 4;
    return (lu < nu && k < hidden)
               ? wh[(size_t)k * 4 * hidden + (c % 4) * hidden + u0 + lu]
               : from_f32<T>(0.0f);
  }
  // bf16: the mma A fragment (m-tile mt, k-step ks) of this lane for A =
  // slice^T (m = gate column, k = depth)
  __device__ __forceinline__ uint4 frag(int mt, int ks, int lane) const {
    const int r = mt * 16 + lane / 4, k = ks * 16 + 2 * (lane % 4);
    return make_uint4(pack_bf16(at(r, k), at(r, k + 1)), pack_bf16(at(r + 8, k), at(r + 8, k + 1)),
                      pack_bf16(at(r, k + 8), at(r, k + 9)),
                      pack_bf16(at(r + 8, k + 8), at(r + 8, k + 9)));
  }
  // bf16: the fragment (m-tile mk, k-step mc) for A = the slice itself (m =
  // depth, k = gate column), the transpose of frag(mc, mk, lane)
  __device__ __forceinline__ uint4 frag_t(int mk, int mc, int lane) const {
    const int k = mk * 16 + lane / 4, c = mc * 16 + 2 * (lane % 4);
    return make_uint4(pack_bf16(at(c, k), at(c + 1, k)), pack_bf16(at(c, k + 8), at(c + 1, k + 8)),
                      pack_bf16(at(c + 8, k), at(c + 9, k)),
                      pack_bf16(at(c + 8, k + 8), at(c + 9, k + 8)));
  }
};

// The slice's first `kres` depth rows into shared memory: f32 rows of G
// columns at a stride of `ws`; bf16 mma A fragments of slice^T, (m-tile,
// k-step, lane), one uint4 each.
template <typename T>
__device__ __forceinline__ void load_slice(T* whs, int ws, const Slice<T>& sl, int G, int kres,
                                           int tid, int nthr) {
  if constexpr (sizeof(T) == 2) {
    uint4* frag = reinterpret_cast<uint4*>(whs);
    const int ks_res = kres / 16;
    for (int i = tid; i < G / 16 * ks_res * kWarp; i += nthr) {
      frag[i] = sl.frag(i / kWarp / ks_res, (i / kWarp) % ks_res, i % kWarp);
    }
  } else {
    for (int i = tid; i < kres * G; i += nthr) whs[(i / G) * ws + i % G] = sl.at(i % G, i / G);
  }
}

// The recurrent product's partial gates over depth slice ks:
// gs[ks][r][c] = sum_k round_cd(h)[r][k] slice[k][c], h rows at a stride of
// `hrow`, the f32 slice's rows at G, depth rows past `kres` (kSpill) read from global memory in the
// same order.  Every instance of rec_cluster runs this one code, so at one
// depth split their gates are equal bit for bit.
template <typename T, int BT, bool kSpill>
__device__ __forceinline__ void partial_gates(const T* whs, const Slice<T>& sl, const T* h_cur,
                                              int hrow, float* gs, int G, int ksplit, int kres,
                                              int tid, int nthr) {
  const int kp = padded_depth(sl.hidden);
  if constexpr (sizeof(T) == 2) {
    const int ksteps = kp / 16, ks_res = kres / 16, mt_n = G / 16;
    const int lane = tid % kWarp, g = lane / 4, tg = lane % 4;
    const uint4* frag = reinterpret_cast<const uint4*>(whs);
    for (int w = tid / kWarp; w < mt_n * ksplit; w += nthr / kWarp) {
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
        for (; kk < ks_res; kk += ksplit) mma_step(frag[(mt * ks_res + kk) * kWarp + lane], kk);
        for (; kk < ksteps; kk += ksplit) mma_step(sl.frag(mt, kk, lane), kk);
      } else {
        for (int kk = ks; kk < ksteps; kk += ksplit) {
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
    const int U = G / 4;
    const int k_chunk = (kp / 4 + ksplit - 1) / ksplit * 4;  // whole float4s
    for (int w = tid; w < U * ksplit; w += nthr) {
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
          for (int j = 0; j < 4; ++j) wv[kk][j] = to_f32<T>(sl.at(cq * 4 + j, k + kk));
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
}

// One CTA of the cluster for (direction blockIdx.y, batch tile blockIdx.x / N):
// gate columns of units [rank*U, rank*U + nu), rows [b0, b0 + BT) of the batch.
template <typename T, typename O, int BT, XwLayout kXw, bool kCarry, bool kCellOut,
          bool kGatesOut, bool kSpill>
__global__ void __launch_bounds__(rec_threads_max<T>()) rec_cluster(RecArgs p) {
  constexpr bool kGateMajor = kXw == XwLayout::kGateMajor;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_cta = (int)cluster.dim_blocks().x, rank = (int)cluster.block_rank();
  const int dir = blockIdx.y, b0 = (blockIdx.x / n_cta) * BT;
  const int H = p.hidden, U = p.units, G = 4 * U, u0 = rank * U;
  const int nu = max(0, min(U, H - u0));
  const int kp = padded_depth(H), kres = p.resident;  // kres: depth rows held in whs
  const int hrow = kp + 8, h_buf = BT * hrow;  // h row stride; elements per parity buffer
  const size_t g4 = 4 * (size_t)H;
  const RecLayout lay = rec_layout<T>(H, U, BT, p.ksplit, kres, !kGateMajor);
  extern __shared__ __align__(16) unsigned char rec_smem[];
  T* whs = reinterpret_cast<T*>(rec_smem + lay.wh);
  T* hs = reinterpret_cast<T*>(rec_smem + lay.hs);
  T* ring = reinterpret_cast<T*>(rec_smem + lay.ring);
  float* gs = reinterpret_cast<float*>(rec_smem + lay.gs);
  float* cs = reinterpret_cast<float*>(rec_smem + lay.cs);
  const uint32_t bar0 = smem_addr(rec_smem + lay.bar);  // buffer b's barrier at bar0 + 8 b
  const Slice<T> sl{static_cast<const T*>(p.wh) + (size_t)dir * H * g4, H, u0, nu};
  // kUnitMajor: rows (t, b) of direction dir; kGateMajor: rows (s, dir, b)
  const T* xw = static_cast<const T*>(p.xw) +
                (size_t)dir * (kGateMajor ? 1 : p.t_len) * p.batch * g4;
  O* out = static_cast<O*>(dir == 0 ? p.out_f : p.out_b);
  float* c_out = dir == 0 ? p.c_f : p.c_b;
  const int tid = threadIdx.x, nthr = blockDim.x, items = U * BT;

  load_slice<T>(whs, G, sl, G, kres, tid, nthr);
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
  // The exchange writes h for H units and the pad to the last group of
  // four (zeros), in every row of the tile: the bytes each buffer's fill
  // brings, from all CTAs together.
  const int h4 = (H + 3) & ~3;
  const uint32_t fill_bytes = (uint32_t)(BT * h4 * sizeof(T));
  if (tid == 0) {
    mbar_init_pair(bar0);
    if (p.t_len > 1) mbar_arm(bar0 + 8, fill_bytes);  // buffer 1's first fill, read at step 1
    if (p.t_len > 2) mbar_arm(bar0, fill_bytes);      // buffer 0's, read at step 2
  }
  if constexpr (kGateMajor) {
    if (p.t_len > 0) fetch(0);
  } else {
    prefetch(0);
  }
  cluster.sync();  // every CTA runs, has filled its h buffers and set up its barriers

  // Reuse of a parity buffer without a cluster barrier: a peer writes
  // buffer b for step s + 2 in its step s + 1, after its own wait there,
  // which needs this CTA's h of step s; this CTA sends that only after the
  // block barrier that ends its product of step s, the last read of buffer
  // b's previous fill.  The st.async's completion is a release at cluster
  // scope, and the wait an acquire, so those reads come before the
  // peer's writes.  The same holds for the barrier's phases: the next
  // fill's bytes cannot arrive before this CTA's wait on the last one.
  const int lane = tid % kWarp;
  const unsigned quad = 0xFu << (lane & 28);  // the four lanes of one group of units
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
    if (s > 0) {  // (a) the peers' h of step s - 1 has landed in buffer s & 1
      const uint32_t bar = bar0 + 8 * (s & 1);
      mbar_wait(bar, fill_parity(s));
      if (tid == 0 && s + 2 < p.t_len) mbar_arm(bar, fill_bytes);  // its next fill
    }

    // (b) partial gates over depth slice ks
    partial_gates<T, BT, kSpill>(whs, sl, h_cur, hrow, gs, G, p.ksplit, kres, tid, nthr);
    if constexpr (!kGateMajor) cp_async_wait_one();  // (a) this step's xw rows have landed
    __syncthreads();  // every partial gate is in gs, and buffer s & 1 is read

    // (c) the cell in f32, (d) round_cd(h) into every peer's buffer of the
    // next parity: the four lanes of a group of four units (one row; items
    // and threads are multiples of 4) gather the group's h by shuffles, and
    // each sends it, one 16-byte (bf16: 8-byte) st.async, to a quarter of
    // the peers (a 4-byte store a peer from every lane ran f32 K3 6-8%
    // slower on the H100).  The last step's h is read by no step: not sent.
    const bool send = s + 1 < p.t_len;
    const uint32_t h_next = smem_addr(hs + ((s + 1) & 1) * h_buf);
    const uint32_t bar_next = bar0 + 8 * ((s + 1) & 1);
    float h_out[kRecItemsMax], c_new[kRecItemsMax];
#pragma unroll
    for (int j = 0; j < kRecItemsMax; ++j) {
      const int i = tid + j * nthr, lu = i % U, r = i / U, b = b0 + r;
      if (i >= items) continue;  // the whole group of four
      float h = 0.0f;  // rows past the batch, and units past H, carry h = 0
      if (lu < nu && b < p.batch) {
        float gate[4], prod[4];
        if constexpr (kGateMajor) {
#pragma unroll
          for (int q = 0; q < 4; ++q) gate[q] = to_f32<T>(xg[j][q]);
        } else {
          load4(gate, ring + (s & 1) * BT * G + r * G + lu * 4);  // xw, parity-cast
        }
#pragma unroll 4  // loads in flight four at a time; the sum's order stays 0 .. ksplit-1
        for (int ks = 0; ks < p.ksplit; ++ks) {
          float part[4];
          load4(part, gs + (ks * BT + r) * G + lu * 4);
#pragma unroll
          for (int q = 0; q < 4; ++q) prod[q] = ks == 0 ? part[q] : prod[q] + part[q];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) gate[q] += prod[q];
        if constexpr (kGatesOut) {  // kept in the cell's own columns of plane 0 until (e)
          *reinterpret_cast<float4*>(gs + r * G + lu * 4) =
              make_float4(gate[0], gate[1], gate[2], gate[3]);
        }
        const float c = sigmoid(gate[1]) * cs[r * U + lu] + sigmoid(gate[0]) * tanhf(gate[2]);
        h = sigmoid(gate[3]) * tanhf(c);
        cs[r * U + lu] = c;
        c_new[j] = c;
      }
      h_out[j] = h;
      if (send) {
        float v[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) v[x] = __shfl_sync(quad, h, (lane & 28) | x);
        const int lg = lu & ~3;
        if (u0 + lg < H) {
          const uint32_t at = h_next + (uint32_t)((r * hrow + u0 + lg) * sizeof(T));
          for (int q = lane & 3; q < n_cta; q += 4) {
            if constexpr (sizeof(T) == 2) {
              st_async(peer_addr(at, q), peer_addr(bar_next, q),
                       pack_bf16(from_f32<T>(v[0]), from_f32<T>(v[1])),
                       pack_bf16(from_f32<T>(v[2]), from_f32<T>(v[3])));
            } else {
              st_async(peer_addr(at, q), peer_addr(bar_next, q), v);
            }
          }
        }
      }
    }
    // the next step's gate input is read now that the cell is done with
    // this one's: its loads are in flight during the wait and the product
    if constexpr (kGateMajor) {
      if (s + 1 < p.t_len) fetch(s + 1);
    }
    // (e) h (and c, and the gate sums) go out to global memory after the
    // exchange, off its critical path
#pragma unroll
    for (int j = 0; j < kRecItemsMax; ++j) {
      const int i = tid + j * nthr, lu = i % U, r = i / U, b = b0 + r;
      if (i < items && lu < nu && b < p.batch) {
        const size_t at = ((size_t)t * p.batch + b) * H + u0 + lu;
        out[at] = from_f32<O>(h_out[j]);
        if constexpr (kCellOut) c_out[at] = c_new[j];
        if constexpr (kGatesOut) {
          *reinterpret_cast<float4*>(p.gates + (((size_t)s * 2 + dir) * p.batch + b) * g4 +
                                     (size_t)(u0 + lu) * 4) =
              *reinterpret_cast<const float4*>(gs + r * G + lu * 4);
        }
      }
    }
    __syncthreads();  // gs and this step's ring slot are read: the next product and prefetch may write
  }
  // no CTA leaves while a peer may still write into its shared memory
  cluster_sync_exit();
}

// ------------------------------------------------------------ the reverse walk

// rec_cluster_bwd: K4's reverse walk (the TPU kernel's _bwd_dir,
// avsi/ops/pallas_lstm.py:563-596) on rec_cluster's cluster and plan.  Per
// direction d and kernel step s = T-1 .. 0, with the f32 carries dc and
// dh_rec (zero at s = T-1):
//   gates = xw_s + round_cd(h_prev) . wh[d]             (K3's saved sums)
//   dh = dout_s + dh_rec;  do = dh tanh(c) o(1-o);  dc += dh o (1 - tanh(c)^2)
//   di = dc g i(1-i);  df = dc c_prev f(1-f);  dg = dc i (1-g^2);  dc *= f
//   dxw_s = round_cd(dgates);  dh_rec = dxw_s . wh[d]^T  (f32 sums)
// The gates are the f32 sums K3 wrote under kGatesOut, so they are K3's bit
// for bit and the walk runs no forward product (the TPU kernel recomputes
// them, as VMEM favoured there).  c_prev is K3's f32 c stream at the
// previous kernel step (zero at s = 0); c and dout are at this one.
//
// CTA `rank` owns units [rank*U, rank*U + nu) with their four gates and keeps
// the same (H x 4U) slice of wh[d] in shared memory as the forward (its first
// `resident` depth rows; the rest from global memory in the same order), for
// the dh_rec product along its gate columns.  Per step:
//  1. the cell backward for the CTA's own (row, unit) cells, dc in
//     registers, from the gates, c, c_prev and dout loaded into registers a
//     step ahead (one float4 of gates a cell, consecutive threads on
//     consecutive units); round_cd(dgates) kept for dxw, which goes out
//     gate-major after the exchange, and into a shared [BT][4U] buffer
//     (bf16: rows padded by 8); one block barrier.
//  2. the partial dh_rec over the CTA's 4U columns for all H units:
//     P[r][k] = sum_c dg[r][c] slice[k][c].  f32: a thread per depth row k
//     and all BT rows, the slice's rows padded by 4 floats so that a warp's
//     rows fall in different banks, dgates read as broadcasts.  bf16:
//     mma.sync with A = the slice (m = depth, k = gate column), made from
//     the resident fragments of slice^T by movmatrix.trans, four per
//     fragment, so the slice is held once in the forward's fragment order
//     and costs no resident rows; B = dgates^T.
//  3. reduce-scatter through DSMEM: P[:, units of q] goes into CTA q's
//     receive buffer, slot `rank` ([N][BT][U], double-buffered by step
//     parity), by st.async on q's mbarrier of that parity (the exchange,
//     above).  f32: a thread sends its depth row's BT partials, one 4-byte
//     st.async a row (gathering 16-byte rows of four units by shuffles ran
//     4-5% slower on the H100).  bf16: the four lanes holding four
//     consecutive depth rows of an mma tile transpose them by shuffles into
//     rows of four units, one 16-byte store each (4-byte stores ran 1-5%
//     slower).  After its wait each CTA sums its N slots in rank
//     order 0 .. N-1 (in the next step's cell), so dh_rec is the same from
//     run to run.  Only a unit's owner needs its dh_rec: nothing is
//     all-gathered.  A block barrier at the end of the step ends every
//     thread's reads of the dgates buffer before the next step's cell
//     writes it.  A slot plane is reused as K3's h buffers are: a peer
//     writes plane b for step n + 2 after its wait at step n + 1, which
//     needs this CTA's partials of step n, sent after this CTA's cell of
//     step n has read plane b.
// The last step (s = 0) has no dh_rec to pass on, so it ends after its cell.
// The plan's depth split sets only the thread count (K3's).
template <typename T, int BT, bool kSpill>
__global__ void __launch_bounds__(rec_threads_max<T>()) rec_cluster_bwd(BwdArgs p) {
  constexpr bool kBf16 = sizeof(T) == 2;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_cta = (int)cluster.dim_blocks().x, rank = (int)cluster.block_rank();
  const int dir = blockIdx.y, b0 = (blockIdx.x / n_cta) * BT;
  const int H = p.hidden, U = p.units, G = 4 * U, u0 = rank * U;
  const int nu = max(0, min(U, H - u0));
  const int kp = padded_depth(H), kres = p.resident;
  const int ws = bwd_slice_stride<T>(U), dgrow = G + 8, slots = n_cta * BT * U;
  const size_t g4 = 4 * (size_t)H;
  const BwdLayout lay = bwd_layout<T>(U, n_cta, BT, kres);
  extern __shared__ __align__(16) unsigned char rec_smem[];
  T* whs = reinterpret_cast<T*>(rec_smem + lay.wh);
  float* dgf = reinterpret_cast<float*>(rec_smem + lay.dg);  // f32 dgates [BT][4U]
  T* dgs = reinterpret_cast<T*>(rec_smem + lay.dg);  // bf16 dgates [BT][4U + 8]
  float* recv = reinterpret_cast<float*>(rec_smem + lay.recv);  // [2][N][BT][U]
  const uint32_t bar0 = smem_addr(rec_smem + lay.bar);  // plane b's barrier at bar0 + 8 b
  const Slice<T> sl{static_cast<const T*>(p.wh) + (size_t)dir * H * g4, H, u0, nu};
  const float* gates = p.gates + (size_t)dir * p.batch * g4;  // rows (s, dir, b) of H float4s
  T* dxw = static_cast<T*>(p.dxw) + (size_t)dir * p.batch * g4;
  const float* c_src = dir == 0 ? p.c_f : p.c_b;
  const T* d_src = static_cast<const T*>(dir == 0 ? p.dout_f : p.dout_b);
  const int tid = threadIdx.x, nthr = blockDim.x, items = U * BT;

  load_slice<T>(whs, ws, sl, G, kres, tid, nthr);
  for (int i = tid; i < 2 * slots; i += nthr) recv[i] = 0.0f;  // dh_rec = 0 at the first step

  // original time of kernel step s, and of step s - 1 (valid for s > 0)
  auto t_of = [&](int s) { return dir == 0 ? s : p.t_len - 1 - s; };
  auto tp_of = [&](int s) { return dir == 0 ? s - 1 : p.t_len - s; };
  // this thread's cells j at step s: the four gates, c, c_prev, dout
  float gt[kRecItemsMax][4], cc[kRecItemsMax], cprev[kRecItemsMax], dy[kRecItemsMax];
  float dc[kRecItemsMax];
  auto fetch = [&](int s) {
    const float* row = gates + (size_t)s * 2 * p.batch * g4;
    const size_t t = t_of(s), tp = tp_of(s);
#pragma unroll
    for (int j = 0; j < kRecItemsMax; ++j) {
      const int i = tid + j * nthr, lu = i % U, b = b0 + i / U;
      if (i < items && lu < nu && b < p.batch) {
        load4(gt[j], row + (size_t)b * g4 + (size_t)(u0 + lu) * 4);
        const size_t at = (t * p.batch + b) * H + u0 + lu;
        cc[j] = c_src[at];
        dy[j] = to_f32<T>(d_src[at]);
        cprev[j] = s > 0 ? c_src[(tp * p.batch + b) * H + u0 + lu] : 0.0f;
      }
    }
  };
#pragma unroll
  for (int j = 0; j < kRecItemsMax; ++j) dc[j] = 0.0f;
  if (p.t_len > 0) fetch(p.t_len - 1);
  // Each of the N CTAs writes this CTA's slot columns for its units and the
  // pad to the last group of four (zeros), in every row: a plane's bytes.
  const int h4 = (H + 3) & ~3, nw = max(0, min(U, h4 - u0));
  const uint32_t fill_bytes = (uint32_t)(n_cta * BT * nw * 4);
  if (tid == 0) {
    mbar_init_pair(bar0);
    if (p.t_len > 1) mbar_arm(bar0 + 8, fill_bytes);  // plane 1's first fill, read at step 1
    if (p.t_len > 2) mbar_arm(bar0, fill_bytes);      // plane 0's, read at step 2
  }
  cluster.sync();  // every CTA runs, has zeroed its receive slots and set up its barriers

  for (int s = p.t_len - 1, n = 0; s >= 0; --s, ++n) {
    // (1) the cell backward; dh_rec = the N slots of parity n, in rank order
    const float* rin = recv + (n & 1) * slots;
    if (n > 0) {  // the peers' partials of step n - 1 have landed in plane n & 1
      const uint32_t bar = bar0 + 8 * (n & 1);
      mbar_wait(bar, fill_parity(n));
      if (tid == 0 && n + 2 < p.t_len) mbar_arm(bar, fill_bytes);  // its next fill
    }
    T dq[kRecItemsMax][4];  // round_cd(dgates) of this thread's cells, for dxw
#pragma unroll
    for (int j = 0; j < kRecItemsMax; ++j) {
      const int i = tid + j * nthr, lu = i % U, r = i / U, b = b0 + r;
      if (i >= items) continue;
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // dgates; 0 past the batch and the units
      if (lu < nu && b < p.batch) {
        float dh_rec = 0.0f;
#pragma unroll 4
        for (int q = 0; q < n_cta; ++q) dh_rec += rin[(q * BT + r) * U + lu];
        const float ig = sigmoid(gt[j][0]), fg = sigmoid(gt[j][1]);
        const float gg = tanhf(gt[j][2]), og = sigmoid(gt[j][3]);
        const float tc = tanhf(cc[j]);
        const float dh = dy[j] + dh_rec;
        const float d_o = dh * tc * og * (1.0f - og);
        const float dcv = dc[j] + dh * og * (1.0f - tc * tc);
        d[0] = dcv * gg * ig * (1.0f - ig);
        d[1] = dcv * cprev[j] * fg * (1.0f - fg);
        d[2] = dcv * ig * (1.0f - gg * gg);
        d[3] = d_o;
        dc[j] = dcv * fg;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          dq[j][q] = from_f32<T>(d[q]);
          d[q] = to_f32<T>(dq[j][q]);
        }
      }
      if constexpr (kBf16) {
#pragma unroll
        for (int q = 0; q < 4; ++q) dgs[r * dgrow + lu * 4 + q] = from_f32<T>(d[q]);
      } else {
        *reinterpret_cast<float4*>(dgf + r * G + lu * 4) = make_float4(d[0], d[1], d[2], d[3]);
      }
    }
    // dxw of this step's cells, gate-major: consecutive threads, consecutive units
    auto store_dxw = [&]() {
#pragma unroll
      for (int j = 0; j < kRecItemsMax; ++j) {
        const int i = tid + j * nthr, lu = i % U, b = b0 + i / U;
        if (i < items && lu < nu && b < p.batch) {
          T* out = dxw + (s * 2 * (size_t)p.batch + b) * g4 + u0 + lu;
#pragma unroll
          for (int q = 0; q < 4; ++q) out[(size_t)q * H] = dq[j][q];
        }
      }
    };
    if (s == 0) {  // nothing to pass on
      store_dxw();
      break;
    }
    fetch(s - 1);  // the next step's inputs fly during the product and the wait
    __syncthreads();  // every dgate is staged, and plane n & 1 is read

    // (2, 3) P[r][k] for all H units k (and zeros to the last group of
    // four), into the slot `rank` of k's owner
    const uint32_t rout = smem_addr(recv + ((n + 1) & 1) * slots + rank * BT * U);
    const uint32_t rbar = bar0 + 8 * ((n + 1) & 1);
    if constexpr (kBf16) {
      const int ksteps = kp / 16, ks_res = kres / 16, mt_n = G / 16;
      const int lane = tid % kWarp, g = lane / 4, tg = lane % 4;
      const uint4* frag = reinterpret_cast<const uint4*>(whs);
      for (int mk = tid / kWarp; mk < ksteps; mk += nthr / kWarp) {
        float acc[BT / 8][4] = {};
        for (int mc = 0; mc < mt_n; ++mc) {
          uint4 f;
          if (!kSpill || mk < ks_res) {  // fragment (mc, mk) of slice^T, transposed
            const uint4 ft = frag[(mc * ks_res + mk) * kWarp + lane];
            f = make_uint4(movmatrix_t(ft.x), movmatrix_t(ft.z), movmatrix_t(ft.y),
                           movmatrix_t(ft.w));
          } else {
            f = sl.frag_t(mk, mc, lane);
          }
          const uint32_t a[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
          for (int nt = 0; nt < BT / 8; ++nt) {
            const T* dr = dgs + (nt * 8 + g) * dgrow + mc * 16 + 2 * tg;
            mma_bf16(acc[nt], a, ld_u32(dr), ld_u32(dr + 8));
          }
        }
        // D[k][r] of this lane: k = mk * 16 + g (+ 8), r = nt * 8 + 2 tg (+ 1).
        // The lanes g = 4c + m, m = 0..3 (lane bits 2 and 3), hold units
        // 4c + m (and 8 + 4c + m): transposed, lane m = x holds units k0 ..
        // k0 + 3 (one owner's: U is a multiple of 4) of row r, x >> 1 the
        // unit half and x & 1 the row.  Zero past H.
        const int x = g & 3, k0 = mk * 16 + 8 * (x >> 1) + 4 * (g >> 2), q = k0 / U;
#pragma unroll
        for (int nt = 0; nt < BT / 8; ++nt) {
          transpose4(acc[nt], lane);
          const int r = nt * 8 + 2 * tg + (x & 1);
          if (k0 < H) {
            st_async(peer_addr(rout + (uint32_t)((r * U + k0 - q * U) * 4), q), peer_addr(rbar, q),
                     acc[nt]);
          }
        }
      }
    } else {
      // a thread per depth row k; rows past H to the group's end are zeros
      for (int k = tid; k < h4; k += nthr) {
        float acc[BT] = {};
        auto fma_rows = [&](const float (&wv)[4], int c) {
#pragma unroll
          for (int r = 0; r < BT; ++r) {
            float dv[4];
            load4(dv, dgf + r * G + c);
            acc[r] = fmaf(dv[3], wv[3], fmaf(dv[2], wv[2], fmaf(dv[1], wv[1], fmaf(dv[0], wv[0], acc[r]))));
          }
        };
        if (!kSpill || k < kres) {
          for (int c = 0; c < G; c += 4) {
            float wv[4];
            load4(wv, whs + k * ws + c);
            fma_rows(wv, c);
          }
        } else {
          for (int c = 0; c < G; c += 4) {
            float wv[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) wv[q] = to_f32<T>(sl.at(c + q, k));
            fma_rows(wv, c);
          }
        }
        const int q = k / U;
        const uint32_t to = peer_addr(rout + (uint32_t)((k - q * U) * 4), q);
        const uint32_t bar = peer_addr(rbar, q);
#pragma unroll
        for (int r = 0; r < BT; ++r) st_async(to + (uint32_t)(r * U * 4), bar, acc[r]);
      }
    }
    store_dxw();  // off the exchange's critical path
    __syncthreads();  // dgates are read: the next step's cell may write them
  }
  // no CTA leaves while a peer may still write into its shared memory
  cluster_sync_exit();
}

// ------------------------------------------------------------ launchers

// Whether (cluster, units, ksplit, resident) at batch tile BT is a plan of
// launch_plan's (or bwd_plan's) that the kernels can run.
template <typename T, int BT, bool kSpill>
bool plan_ok(int hidden, int cluster, int units, int ksplit, int resident) {
  const int threads = (sizeof(T) == 2 ? 8 : 1) * units * ksplit, kp = padded_depth(hidden);
  return cluster >= 1 && cluster <= 16 && units % 4 == 0 && ksplit >= 1 &&
         threads <= rec_threads_max<T>() && units * BT <= kRecItemsMax * threads &&
         !(sizeof(T) == 4 && 4 * ksplit > kp) && (long)cluster * units >= hidden &&
         resident >= 0 && resident % 16 == 0 && (resident < kp) == kSpill && resident <= kp;
}

// Launch a cluster kernel over (cluster x batch tiles, 2 directions).
// Once per device and kernel: opt the kernel in to the card's largest
// dynamic shared memory (an upper bound, so every plan's size fits under it)
// and to clusters of 16.  Once per (device, kernel, plan): check that one
// cluster of the plan fits the card.  The occupancy query costs more host
// time than the launch, and the serving loop is host-bound.
template <typename Args>
int launch_cluster(void (*kernel)(Args), const Args& p, int cluster, int tiles, int threads,
                   size_t smem, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * tiles, 2, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static std::mutex mutex;
  static std::set<std::pair<const void*, int>> ready;
  static std::set<std::tuple<const void*, int, int, int, size_t>> checked;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  const void* fn = reinterpret_cast<const void*>(kernel);
  const auto key = std::make_tuple(fn, device, cluster, threads, smem);
  {
    std::lock_guard<std::mutex> lock(mutex);
    if (!ready.count({fn, device})) {
      int optin = 0;
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
      if (err == cudaSuccess) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
      }
      if (err == cudaSuccess) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      }
      if (err != cudaSuccess) return (int)err;
      ready.insert({fn, device});
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

template <typename T, typename O, int BT, XwLayout kXw, bool kCarry, bool kCellOut,
          bool kGatesOut, bool kSpill>
int launch_rec(const RecArgs& p, int cluster, cudaStream_t stream) {
  if (!plan_ok<T, BT, kSpill>(p.hidden, cluster, p.units, p.ksplit, p.resident)) {
    return (int)cudaErrorInvalidValue;  // not a plan of launch_plan's
  }
  const size_t smem =
      rec_layout<T>(p.hidden, p.units, BT, p.ksplit, p.resident, kXw == XwLayout::kUnitMajor)
          .total;
  return launch_cluster(rec_cluster<T, O, BT, kXw, kCarry, kCellOut, kGatesOut, kSpill>, p,
                        cluster,
                        (p.batch + BT - 1) / BT,
                        (sizeof(T) == 2 ? 8 : 1) * p.units * p.ksplit, smem, stream);
}

template <typename T, int BT, bool kSpill>
int launch_bwd_walk(const BwdArgs& p, int cluster, cudaStream_t stream) {
  if (!plan_ok<T, BT, kSpill>(p.hidden, cluster, p.units, p.ksplit, p.resident)) {
    return (int)cudaErrorInvalidValue;  // not a plan of bwd_plan's
  }
  const size_t smem = bwd_layout<T>(p.units, cluster, BT, p.resident).total;
  return launch_cluster(rec_cluster_bwd<T, BT, kSpill>, p, cluster, (p.batch + BT - 1) / BT,
                        (sizeof(T) == 2 ? 8 : 1) * p.units * p.ksplit, smem, stream);
}

// The reverse walk under a plan of bwd_plan's; nothing to do at T = 0 or B = 0.
template <typename T>
int launch_bwd_walk_plan(BwdArgs p, const Plan& plan, cudaStream_t s) {
  if (p.t_len == 0 || p.batch == 0) return 0;
  p.units = plan.units;
  p.ksplit = plan.ksplit;
  p.resident = plan.resident;
  if (plan.resident < padded_depth(p.hidden)) {  // a wide layer: bwd_plan spills on tiles of 8
    if (plan.btile != 8) return (int)cudaErrorInvalidValue;
    return launch_bwd_walk<T, 8, true>(p, plan.cluster, s);
  }
  if (plan.btile == 8) return launch_bwd_walk<T, 8, false>(p, plan.cluster, s);
  if (plan.btile == 16) return launch_bwd_walk<T, 16, false>(p, plan.cluster, s);
  return (int)cudaErrorInvalidValue;
}

// The recurrence under a plan of launch_plan's (the batch tile and the resident depth pick the
// instance).  Nothing to do at T = 0 or B = 0.
template <typename T, typename O, XwLayout kXw, bool kCarry = false, bool kCellOut = false,
          bool kGatesOut = false>
int launch_rec_plan(RecArgs p, const Plan& plan, cudaStream_t s) {
  if (p.t_len == 0 || p.batch == 0) return 0;
  p.units = plan.units;
  p.ksplit = plan.ksplit;
  p.resident = plan.resident;
  if (plan.resident < padded_depth(p.hidden)) {  // a wide layer: launch_plan spills on tiles of 8
    if (plan.btile != 8) return (int)cudaErrorInvalidValue;
    return launch_rec<T, O, 8, kXw, kCarry, kCellOut, kGatesOut, true>(p, plan.cluster, s);
  }
  const int n = plan.cluster;
  if (plan.btile == 8) return launch_rec<T, O, 8, kXw, kCarry, kCellOut, kGatesOut, false>(p, n, s);
  if (plan.btile == 16) {
    return launch_rec<T, O, 16, kXw, kCarry, kCellOut, kGatesOut, false>(p, n, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Bidirectional LSTM recurrence over a precomputed gate input, forward and
// backward, for Hopper.
//
// Replaces four Pallas TPU kernels of avsi/ops/pallas_lstm.py.  The pair under
// the custom VJP of `_layer` (:1236-1326):
//   K3  bilstm_recurrence_train (_kernel_train, :148-173): the recurrence over a
//       precomputed gate input xw, writing the h streams and the f32 cell-state
//       streams (the residual of the backward);
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
// and dout are (T, B, H) per direction in ORIGINAL time order.  At kernel
// step s, direction 0 is at original time s and direction 1 at T-1-s; the
// previous step (s-1) is at original time s-1 for direction 0 and T-s for
// direction 1 (zero state at s = 0).
//
// Numerics (the TPU kernels' function):
//   K3:  gates = xw_s + round_cd(h_prev) . wh   (f32 sums)
//        c = sig(f) c + sig(i) tanh(g);  h = sig(o) tanh(c)     all f32
//   K4:  the gates are recomputed (dot_col's order, lstm_common.cuh: not the
//        order of K3's split-depth product, so they may differ from K3's in
//        the last bit), then with dh = dout_s + dh_rec and the f32 carries
//        dc, dh_rec:
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
// walk, and h crosses SMs through distributed shared memory with one cluster
// barrier per step.  One launch per call.  It replaced a first design (one
// 1,024-thread block per (direction, batch row), every step re-reading the
// whole (H x 4H) wh from L2 through dot_col: 2B blocks, rows never sharing a
// read of wh).  Its limits are the plan's: a CTA's slice of wh fits 227 KB
// whole up to f32 H = 416 and bf16 H = 624; wider, the plan keeps its first
// depth rows in shared memory and the product reads the rest from L2 every
// step, up to f32 H = 2048 and bf16 H = 1024 (beyond, no plan: the wrappers
// raise).  K5 fills its h buffers with round_cd(h0), as the
// TPU kernel rounds h_prev inside the product (`_cell` :108-110), and its c
// with the f32 c0 as is.  K3, K5 and K6 are one body and take one plan at one
// batch, so where their functions coincide (zero carries; the h streams)
// their outputs are bit for bit equal, and equal to K1's recurrence given
// K1's parity-cast projection as xw.
//
// K4 (the first design) is split in two launches, because the TPU body's
// (2, H, 4H) f32 dWh accumulator (2 MB) is carried across the sequential grid
// in VMEM, which has no Hopper counterpart (an SM has 227 KB, and per-step
// atomics from 2B blocks onto one accumulator would serialise):
//   K4a, the walk: one block per (direction, batch row) stepping s = T-1..0.
//        Thread j recomputes gate column j; thread k (< H) forms the dgates of
//        unit k and updates the dc carry; then dh_rec = dgates . wh^T contracts
//        the 4H axis, one warp per output unit reading a row of wh coalesced,
//        with the rounded dgates staged in shared memory.
//   K4b, the reduction: a tiled shared-memory product (64 x 64 tiles of dWh,
//        16 (s, b) rows at a time, 4 x 4 outputs per thread, f32 sums) over the
//        h streams K3 wrote, shifted by one step, and the dxw K4a wrote.
//
// What bounds them: not the work.  The bound (bytes once at 3.35 TB/s, or the
// products at peak) is far below a chain of 250 dependent steps: K3 is set by
// its per-step latency (product, cell, DSMEM exchange, barrier).  K4a reads
// wh twice per step (gates and dh_rec) from L2 on 2B SMs; K4b is a plain
// tiled product whose cost is small beside the walk.

#include "lstm_cluster.cuh"

namespace {

// ------------------------------------------------------------------ K4a

template <typename T>
__global__ void __launch_bounds__(1024)
bilstm_bwd_walk_kernel(const T* __restrict__ xw, const T* __restrict__ wh,
                       const float* __restrict__ out_f, const float* __restrict__ out_b,
                       const float* __restrict__ c_f, const float* __restrict__ c_b,
                       const T* __restrict__ dout_f, const T* __restrict__ dout_b,
                       T* __restrict__ dxw, int t_len, int batch, int hidden) {
  const int dir = blockIdx.x;
  const int row = blockIdx.y;
  const int g4 = 4 * hidden;
  extern __shared__ float smem[];
  float* hs = smem;            // hidden: h_prev rounded to the compute dtype
  float* dhs = hs + hidden;    // hidden: dh_rec carry, f32
  float* dcs = dhs + hidden;   // hidden: dc carry, f32
  float* gs = dcs + hidden;    // g4: recomputed gate pre-activations, f32
  float* dgs = gs + g4;        // g4: dgates rounded to the compute dtype

  wh += (size_t)dir * hidden * g4;
  const float* h_src = dir == 0 ? out_f : out_b;
  const float* c_src = dir == 0 ? c_f : c_b;
  const T* d_src = dir == 0 ? dout_f : dout_b;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  for (int k = threadIdx.x; k < hidden; k += blockDim.x) {
    dhs[k] = 0.0f;
    dcs[k] = 0.0f;
  }
  for (int s = t_len - 1; s >= 0; --s) {
    const size_t pos = (size_t)(dir == 0 ? s : t_len - 1 - s) * batch + row;
    const size_t pos_prev = (size_t)(dir == 0 ? s - 1 : t_len - s) * batch + row;
    for (int k = threadIdx.x; k < hidden; k += blockDim.x) {
      hs[k] = s > 0 ? round_to<T>(h_src[pos_prev * hidden + k]) : 0.0f;
    }
    __syncthreads();  // hs staged (and last step's dh_rec written)
    const T* xrow = xw + (((size_t)s * 2 + dir) * batch + row) * g4;
    for (int j = threadIdx.x; j < g4; j += blockDim.x) {
      gs[j] = to_f32<T>(xrow[j]) + dot_col<T>(hs, wh, hidden, g4, j);
    }
    __syncthreads();  // gates ready
    T* dxw_row = dxw + (((size_t)s * 2 + dir) * batch + row) * g4;
    for (int k = threadIdx.x; k < hidden; k += blockDim.x) {
      const float i = sigmoid(gs[k]);
      const float f = sigmoid(gs[hidden + k]);
      const float g = tanhf(gs[2 * hidden + k]);
      const float o = sigmoid(gs[3 * hidden + k]);
      const float c_prev = s > 0 ? c_src[pos_prev * hidden + k] : 0.0f;
      const float tc = tanhf(c_src[pos * hidden + k]);
      const float dh = to_f32<T>(d_src[pos * hidden + k]) + dhs[k];
      const float d_o = dh * tc * o * (1.0f - o);
      const float dc = dcs[k] + dh * o * (1.0f - tc * tc);
      const float d_i = dc * g * i * (1.0f - i);
      const float d_f = dc * c_prev * f * (1.0f - f);
      const float d_g = dc * i * (1.0f - g * g);
      dcs[k] = dc * f;
      const float d[4] = {d_i, d_f, d_g, d_o};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const T v = from_f32<T>(d[q]);
        dgs[q * hidden + k] = to_f32<T>(v);
        dxw_row[q * hidden + k] = v;
      }
    }
    __syncthreads();  // dgates staged; dhs free to overwrite
    // dh_rec[k] = sum_j dgates[j] * wh[k, j]: one warp per unit k, lanes
    // stride the 4H axis of row k (coalesced), then a shuffle reduction.
    for (int k = warp; k < hidden; k += n_warps) {
      const T* w_row = wh + (size_t)k * g4;
      float acc = 0.0f;
      for (int j = lane; j < g4; j += 32) acc = fmaf(dgs[j], to_f32<T>(w_row[j]), acc);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
      if (lane == 0) dhs[k] = acc;
    }
    __syncthreads();  // dh_rec of this step visible before the next
  }
}

// ------------------------------------------------------------------ K4b

constexpr int kTile = 64;     // dWh tile: kTile units x kTile gate columns
constexpr int kDepth = 16;    // (s, b) rows per shared-memory stage
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each

template <typename T>
__global__ void __launch_bounds__(kThreads)
bilstm_bwd_dwh_kernel(const float* __restrict__ out_f, const float* __restrict__ out_b,
                      const T* __restrict__ dxw, float* __restrict__ dwh,
                      int t_len, int batch, int hidden) {
  const int dir = blockIdx.z;
  const int k0 = blockIdx.y * kTile;  // unit (row of dWh)
  const int j0 = blockIdx.x * kTile;  // gate column
  const int g4 = 4 * hidden;
  const float* h_src = dir == 0 ? out_f : out_b;
  __shared__ float a_s[kDepth][kTile];  // round_cd(h_prev) rows
  __shared__ float b_s[kDepth][kTile];  // dxw rows
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[4][4] = {};
  const int n_rows = t_len * batch;  // reduction over (s, b), r = s * B + b

  for (int r0 = 0; r0 < n_rows; r0 += kDepth) {
    for (int e = threadIdx.x; e < kDepth * kTile; e += kThreads) {
      const int rr = e / kTile;
      const int cc = e % kTile;
      const int r = r0 + rr;
      float a = 0.0f, b = 0.0f;
      if (r < n_rows) {
        const int s = r / batch;
        const int bi = r % batch;
        const int k = k0 + cc;
        if (s > 0 && k < hidden) {
          const size_t tp = (size_t)(dir == 0 ? s - 1 : t_len - s);
          a = round_to<T>(h_src[(tp * batch + bi) * hidden + k]);
        }
        const int j = j0 + cc;
        if (j < g4) b = to_f32<T>(dxw[(((size_t)s * 2 + dir) * batch + bi) * g4 + j]);
      }
      a_s[rr][cc] = a;
      b_s[rr][cc] = b;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = a_s[kk][ty * 4 + q];
        b[q] = b_s[kk][tx * 4 + q];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int k = k0 + ty * 4 + p;
    if (k >= hidden) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + tx * 4 + q;
      if (j < g4) dwh[((size_t)dir * hidden + k) * g4 + j] = acc[p][q];
    }
  }
}

// ------------------------------------------------------------------ launchers

// K3, K5, K6: the cluster recurrence over the TPU layout of xw; outputs f32.
template <bool kCarry, bool kCellOut>
int recurrence(int in_bf16, const RecArgs& p, const Plan& plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    return launch_rec_plan<__nv_bfloat16, float, XwLayout::kGateMajor, kCarry, kCellOut>(
        p, plan, s);
  }
  return launch_rec_plan<float, float, XwLayout::kGateMajor, kCarry, kCellOut>(p, plan, s);
}

template <typename T>
int launch_bwd(const void* xw, const void* wh, const float* out_f, const float* out_b,
               const float* c_f, const float* c_b, const void* dout_f,
               const void* dout_b, void* dxw, float* dwh, int t_len, int batch,
               int hidden, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 11 * (size_t)hidden;
  auto walk = bilstm_bwd_walk_kernel<T>;
  cudaError_t err = allow_smem(walk, smem);
  if (err != cudaSuccess) return (int)err;
  walk<<<dim3(2, batch), gate_threads(hidden), smem, stream>>>(
      static_cast<const T*>(xw), static_cast<const T*>(wh), out_f, out_b, c_f, c_b,
      static_cast<const T*>(dout_f), static_cast<const T*>(dout_b),
      static_cast<T*>(dxw), t_len, batch, hidden);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((4 * hidden + kTile - 1) / kTile, (hidden + kTile - 1) / kTile, 2);
  bilstm_bwd_dwh_kernel<T><<<grid, kThreads, 0, stream>>>(
      out_f, out_b, static_cast<const T*>(dxw), dwh, t_len, batch, hidden);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K3: xw (T,2,B,4H) and wh (2,H,4H) at the compute dtype; out_f/out_b and
// c_f/c_b (T,B,H) f32; the plan of launch_plan (cluster, units, batch tile,
// depth split, resident depth rows).  Returns the launch's CUDA error.
int avsi_bilstm_recurrence_train(const void* xw, const void* wh, float* out_f,
                                 float* out_b, float* c_f, float* c_b, int t_len,
                                 int batch, int hidden, int in_bf16, int cluster, int units,
                                 int btile, int ksplit, int resident, void* stream) {
  const RecArgs p{xw, wh, nullptr, out_f, out_b, c_f, c_b, t_len, batch, hidden, 0, 0, 0};
  const Plan plan{cluster, units, btile, ksplit, resident};
  return recurrence<false, true>(in_bf16, p, plan, stream);
}

// K5: K3 from the initial carries hc0 (2, 2, B, H) f32 ([h|c][dir]).
int avsi_bilstm_recurrence_carry(const void* xw, const void* wh, const float* hc0,
                                 float* out_f, float* out_b, float* c_f, float* c_b,
                                 int t_len, int batch, int hidden, int in_bf16, int cluster,
                                 int units, int btile, int ksplit, int resident, void* stream) {
  const RecArgs p{xw, wh, hc0, out_f, out_b, c_f, c_b, t_len, batch, hidden, 0, 0, 0};
  const Plan plan{cluster, units, btile, ksplit, resident};
  return recurrence<true, true>(in_bf16, p, plan, stream);
}

// K6: K3 without the c streams; out_f/out_b (T,B,H) f32.
int avsi_bilstm_recurrence(const void* xw, const void* wh, float* out_f, float* out_b,
                           int t_len, int batch, int hidden, int in_bf16, int cluster,
                           int units, int btile, int ksplit, int resident, void* stream) {
  const RecArgs p{xw, wh, nullptr, out_f, out_b, nullptr, nullptr, t_len, batch, hidden, 0, 0, 0};
  const Plan plan{cluster, units, btile, ksplit, resident};
  return recurrence<false, false>(in_bf16, p, plan, stream);
}

// K4 (K4a walk, then K4b dWh): xw, wh, dout_f/dout_b and dxw at the compute
// dtype; out_f/out_b and c_f/c_b f32; dwh (2,H,4H) f32.
int avsi_bilstm_recurrence_bwd(const void* xw, const void* wh, const float* out_f,
                               const float* out_b, const float* c_f,
                               const float* c_b, const void* dout_f,
                               const void* dout_b, void* dxw, float* dwh, int t_len,
                               int batch, int hidden, int in_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return launch_bwd<__nv_bfloat16>(xw, wh, out_f, out_b, c_f, c_b, dout_f, dout_b,
                                     dxw, dwh, t_len, batch, hidden, s);
  return launch_bwd<float>(xw, wh, out_f, out_b, c_f, c_b, dout_f, dout_b, dxw, dwh,
                           t_len, batch, hidden, s);
}

}  // extern "C"

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
// in original time order.  For K2 the projection is split into the rows that
// multiply the forward stream (wxa) and the backward stream (wxb), each summed
// in f32, then added before the bias, as the TPU kernel does.
//
// Design (first, simple version): one thread block per (direction, batch row),
// a grid of (2, B).  The block stages the step's input row and h in shared
// memory; thread j owns gate column j (stride blockDim) and reads the weights
// straight from global memory, coalesced along j.  All B blocks of a direction
// read the same weights, which stay resident in the 50 MB L2 (at most ~6.7 MB
// in f32 for the flagship).  The hidden size is not padded: H = 250 gives
// 1000 gate columns on 1024 threads.
//
// What bounds it: the bound for the work (bytes moved once, operations at the
// card's peak) is far below what this design reaches.  Each block re-reads the
// whole (D + H) x 4H weight slab from L2 every step, so a step costs about one
// SM's L2 bandwidth over ~3 MB, and 250 dependent steps run back to back.  The
// faster designs (wh split over a thread-block cluster with DSMEM, weights kept
// in shared memory, wgmma for the batched products) are later work.

#include "lstm_common.cuh"

namespace {

// T: compute dtype of inputs and weights; O: output dtype.
// kTwoStreams=false: K1 (input xa, weights wxa); true: K2 (xa|xb, wxa|wxb).
template <typename T, typename O, bool kTwoStreams>
__global__ void __launch_bounds__(1024)
bilstm_fused_kernel(const T* __restrict__ xa, const T* __restrict__ xb,
                    const T* __restrict__ wxa, const T* __restrict__ wxb,
                    const float* __restrict__ bias, const T* __restrict__ wh,
                    O* __restrict__ out_f, O* __restrict__ out_b, int t_len,
                    int batch, int da, int db, int hidden) {
  const int dir = blockIdx.x;
  const int row = blockIdx.y;
  const int g4 = 4 * hidden;
  extern __shared__ float smem[];
  float* xs = smem;             // da + db: the step's input row, as f32
  float* hs = xs + da + db;     // hidden: h rounded to the compute dtype
  float* cs = hs + hidden;      // hidden: cell state, f32
  float* gs = cs + hidden;      // g4: gate pre-activations, f32

  wxa += (size_t)dir * da * g4;
  if (kTwoStreams) wxb += (size_t)dir * db * g4;
  wh += (size_t)dir * hidden * g4;
  bias += (size_t)dir * g4;
  O* out = dir == 0 ? out_f : out_b;

  for (int k = threadIdx.x; k < hidden; k += blockDim.x) {
    hs[k] = 0.0f;
    cs[k] = 0.0f;
  }
  for (int s = 0; s < t_len; ++s) {
    const int t = dir == 0 ? s : t_len - 1 - s;
    const size_t pos = (size_t)t * batch + row;
    for (int k = threadIdx.x; k < da; k += blockDim.x) {
      xs[k] = to_f32<T>(xa[pos * da + k]);
    }
    if (kTwoStreams) {
      for (int k = threadIdx.x; k < db; k += blockDim.x) {
        xs[da + k] = to_f32<T>(xb[pos * db + k]);
      }
    }
    __syncthreads();  // xs staged; hs holds the previous step's h
    for (int j = threadIdx.x; j < g4; j += blockDim.x) {
      float proj = dot_col<T>(xs, wxa, da, g4, j);
      if (kTwoStreams) proj += dot_col<T>(xs + da, wxb, db, g4, j);
      const float xw = round_to<T>(proj + bias[j]);
      gs[j] = xw + dot_col<T>(hs, wh, hidden, g4, j);
    }
    __syncthreads();  // all gates ready; nobody reads xs or hs any more
    for (int k = threadIdx.x; k < hidden; k += blockDim.x) {
      const float i = sigmoid(gs[k]);
      const float f = sigmoid(gs[hidden + k]);
      const float g = tanhf(gs[2 * hidden + k]);
      const float o = sigmoid(gs[3 * hidden + k]);
      const float c = f * cs[k] + i * g;
      const float h = o * tanhf(c);
      cs[k] = c;
      hs[k] = round_to<T>(h);
      out[pos * hidden + k] = from_f32<O>(h);
    }
    __syncthreads();  // h and c of this step visible before the next
  }
}

size_t smem_bytes(int da, int db, int hidden) {
  return sizeof(float) * ((size_t)da + db + 2 * (size_t)hidden + 4 * (size_t)hidden);
}

template <typename T, typename O, bool kTwo>
int launch(const void* xa, const void* xb, const void* wxa, const void* wxb,
           const float* bias, const void* wh, void* out_f, void* out_b,
           int t_len, int batch, int da, int db, int hidden, cudaStream_t stream) {
  const size_t smem = smem_bytes(da, db, hidden);
  auto kernel = bilstm_fused_kernel<T, O, kTwo>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(2, batch);
  kernel<<<grid, gate_threads(hidden), smem, stream>>>(
      static_cast<const T*>(xa), static_cast<const T*>(xb),
      static_cast<const T*>(wxa), static_cast<const T*>(wxb), bias,
      static_cast<const T*>(wh), static_cast<O*>(out_f), static_cast<O*>(out_b),
      t_len, batch, da, db, hidden);
  return (int)cudaGetLastError();
}

template <bool kTwo>
int dispatch(const void* xa, const void* xb, const void* wxa, const void* wxb,
             const float* bias, const void* wh, void* out_f, void* out_b,
             int t_len, int batch, int da, int db, int hidden, int in_bf16,
             int out_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!in_bf16 && !out_bf16)
    return launch<float, float, kTwo>(xa, xb, wxa, wxb, bias, wh, out_f, out_b,
                                      t_len, batch, da, db, hidden, s);
  if (in_bf16 && out_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16, kTwo>(
        xa, xb, wxa, wxb, bias, wh, out_f, out_b, t_len, batch, da, db, hidden, s);
  if (in_bf16 && !out_bf16)
    return launch<__nv_bfloat16, float, kTwo>(xa, xb, wxa, wxb, bias, wh, out_f,
                                              out_b, t_len, batch, da, db, hidden, s);
  return (int)cudaErrorInvalidValue;  // f32 inputs with bf16 outputs: not a use
}

}  // namespace

extern "C" {

// K1: x (T,B,D); wx (2,D,4H); b (2,4H) f32; wh (2,H,4H); outs (T,B,H) each.
// Returns the CUDA error of the launch (0 on success).
int avsi_bilstm_fused_proj(const void* x, const void* wx, const float* b,
                           const void* wh, void* out_f, void* out_b, int t_len,
                           int batch, int d_in, int hidden, int in_bf16,
                           int out_bf16, void* stream) {
  return dispatch<false>(x, nullptr, wx, nullptr, b, wh, out_f, out_b, t_len,
                         batch, d_in, 0, hidden, in_bf16, out_bf16, stream);
}

// K2: af, ab (T,B,Hin); wxa, wxb (2,Hin,4H); b (2,4H) f32; wh (2,H,4H).
int avsi_bilstm_fused_proj2(const void* af, const void* ab, const void* wxa,
                            const void* wxb, const float* b, const void* wh,
                            void* out_f, void* out_b, int t_len, int batch,
                            int h_in, int hidden, int in_bf16, int out_bf16,
                            void* stream) {
  return dispatch<true>(af, ab, wxa, wxb, b, wh, out_f, out_b, t_len, batch,
                        h_in, h_in, hidden, in_bf16, out_bf16, stream);
}

}  // extern "C"

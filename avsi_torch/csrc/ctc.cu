// CTC loss and its gradient with respect to the logits, for Hopper: the
// log-softmax, the alpha and beta recursions and the gradient in one launch
// that reads everything from device memory.
//
// Replaces no Pallas kernel: the JAX package's CTC is optax.ctc_loss
// (avsi/ops/ctc.py), XLA code.  It replaces F.ctc_loss on the card, whose
// CUDA implementation builds its target offsets and lengths on the host in
// both its forward and its backward and uploads them with blocking copies
// from pageable memory: the host waits for the device twice a train step.
// This kernel takes logits (B, T, C) f32, labels (B, N), logit_lengths (B,)
// and label_lengths (B,) as device pointers and makes no host round trip.
//
// The function is optax.ctc_loss's (the plain version is
// avsi_torch/ops/ctc.py:_ctc_loss_optax): blank is the last class, log 0 is
// LOG_EPSILON = -1e5, frames past a row's T_b = clamp(logit_length, 0, T)
// leave its states as they are.  A row is feasible where its L labels fit
// its frames (T_b >= L + adjacent repeats, T_b >= 1); there LOG_EPSILON
// never reaches the result and optax's loss is the CTC likelihood of
// F.ctc_loss (tests/test_torch_ctc_plain.py holds the two equal in f64).
// Each row takes one of two walks, decided on the device:
//
// Feasible rows: F.ctc_loss's own arithmetic, operation for operation, in
// f32 (PyTorch's LossCTC.cu): the log-softmax (x - max) - log(sum) with the
// warp's sum order; alpha and beta over the 2L+1 states of the blank-padded
// labels, each step log(exp(a-m) + exp(b-m) + exp(c-m)) + m + lp, in
// log space without rescaling (beta_t includes lp[t]); the gradient of the
// log-probabilities exp(lp) - exp(la + lb + nll - lp) summed by class (the
// blank's sum through a log-sum over its states; F.ctc_loss's backward for
// larger problems, as at the flagship's T=250, where 2T + 2.4B + 0.2C >
// 450; below that it sums a class's posteriors in log space, ~1e-4 of a
// posterior apart), then the log-softmax's backward g - exp(lp) sum(g).
// The loss is F.ctc_loss's bit for bit.  Its values reach ~1e3 at T=250,
// where f32 spacing is 6e-5, so its gradient is ~5e-4 off the exact one,
// mostly one scale a row (the per-frame posteriors sum to 1 + the nll's
// error).  The benchmark's reference (perfbench/reference) runs F.ctc_loss
// too, and a gradient nearer the exact one differs from it by that error,
// more than the benchmark's first-gradient limit allows (PERF.md §6): so
// here the rounding is F.ctc_loss's.
//
// Infeasible rows (F.ctc_loss gives inf): optax's recursion on its own
// states, phi[n] (n labels emitted, n = 0..L) and emit[n] (in label n), with
// rep[n] = (label[n] == label[n+1]) read from the padded row (0 for n =
// N-1), e = emit[n-1] and (+) the log-sum:
//   phi'[n]  = (phi[n] (+) e) + lp[t, blank]
//   emit'[n] = ((phi[n] (+) (e + LOG_EPSILON rep[n-1])) (+) emit[n]) + lp[t, label[n]]
// from phi[0] = 0, every other state LOG_EPSILON; the loss is
// -(phi[L] (+) emit[L-1]) after the last frame.  (optax writes phi' with two
// more LOG_EPSILON terms; each sits beside the same path without them, so
// it vanishes from the log-sum in f32 and in f64 alike.)  Values are pairs
// V = (k, r) standing for k LOG_EPSILON + r: exp(-1e5) underflows in f32
// and in f64, so the log-sum of two values with different k is the one with
// fewer epsilons, exactly; with equal k it is the log-sum of the r.  This
// is the recursion as optax computes it in f64 (in f32 the plain version
// rounds its values near 1e5, spacing 7.8e-3).  Each walk subtracts, after
// every frame, the largest of its values (fewest epsilons, then the largest
// r), so r stays near 0; the loss adds the shifts back (their r in f64).
// The gradient is softmax - occupancy, the posterior alpha_{t+1} beta_{t+1}
// of the states that consumed each class at frame t, normalised over the
// frame (every path consumes one class a frame).
//
// One block of 16 warps per row:
//   A. every warp: the log-softmax's max and log(sum) of its frames into
//      shared memory;
//   B. warp 0 walks alpha forwards and, only when the gradient is asked
//      for, warp 1 beta backwards from the end at the same time: beta does
//      not depend on alpha.  A lane holds K consecutive labels' pairs of
//      states (blank and label; phi and emit) in registers, K =
//      ceil((L+1)/32) for this row, at most 4; shuffles bring the
//      neighbours' values; no block barrier in the frame loop.  Each walk
//      stores its values per frame in a table: in shared memory where both
//      fit (the launcher's `table` is null), else in a scratch tensor of the
//      wrapper's;
//   C. every warp: frames in turn, the posteriors from both tables, then
//      the frame's gradient row; frames past T_b get 0.
//
// What bounds it: not the work (a few MB at B=8, T=250) but the two walks'
// chains of T_b dependent frames (a shuffle, two or three log-sums a
// frame); the walks run at the same time and phase C spreads the frames
// over 16 warps.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <mutex>
#include <set>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kZero = 1 << 28;  // k of log 0 (no path): more epsilons than any path has
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -INFINITY;

struct __align__(8) V {
  int k;    // LOG_EPSILON factors
  float r;  // the rest, in log space
};

struct CtcArgs {
  const float* logits;         // (B, T, C)
  const void* logit_lengths;   // (B,) int32 or int64
  const void* labels;          // (B, N) float32, int32 or int64
  const void* label_lengths;   // (B,) int32 or int64
  float* loss;                 // (B,)
  float* grad;                 // (B, T, C), or null: no gradient
  V* table;                    // (B, 2, T, 64 k_max) scratch, or null: in shared memory
  int t_len, n_cls, n_lab, k_max;
  int labels_code, logit_len_code, label_len_code;  // 0 float32, 1 int32, 2 int64
};

__device__ __forceinline__ long long read_index(const void* p, int code, long long i) {
  if (code == 0) return (long long)static_cast<const float*>(p)[i];
  if (code == 1) return static_cast<const int*>(p)[i];
  return static_cast<const long long*>(p)[i];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// One row as the walks and the gradient see it.
struct Row {
  const float* x;    // (T, C) logits
  const float* mx;   // (T_b,) the log-softmax's max, in shared memory
  const float* ls;   // (T_b,) its log(sum of exp(x - max))
  V* alpha;          // (T_b, 64 K) alpha table by frame
  V* beta;           // (T_b, 64 K) beta table by frame
  int t_b, n_cls, n_lab, len;
};

// F.log_softmax's value: (x - max) - log(sum).
__device__ __forceinline__ float log_prob(float x, float mx, float ls) { return (x - mx) - ls; }

// A lane's labels (clamped into [0, C) for the reads past the row's length)
// and, for each of its K pairs n = lane K + i, whether label n repeats label
// n-1 (rep) and whether label n+1 repeats label n (rep_next), from the
// padded row.
template <int K>
__device__ __forceinline__ void lane_labels(const CtcArgs& p, int b, const Row& w, int (&lab)[K],
                                            bool (&rep)[K], bool (&rep_next)[K]) {
  const int lane = threadIdx.x & 31;
  const long long base = (long long)b * w.n_lab;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int n = lane * K + i;
    const long long v = n < w.n_lab ? read_index(p.labels, p.labels_code, base + n) : 0;
    lab[i] = (int)min(max(v, 0LL), (long long)w.n_cls - 1);
    rep[i] = n >= 1 && n < w.n_lab && read_index(p.labels, p.labels_code, base + n - 1) == v;
    rep_next[i] = n + 1 < w.n_lab && read_index(p.labels, p.labels_code, base + n + 1) == v;
  }
}

// ------------------------------------------------- feasible rows: F.ctc_loss

// log(exp(a - m) + exp(b - m) + exp(c - m)) + m, m the largest of a, b and,
// where `three`, c (0 where all are -inf; c counts as -inf otherwise): the
// log-sum of F.ctc_loss's recursions, term for term.
__device__ __forceinline__ float log_sum3(float a, float b, float c, bool three) {
  float m = a;
  if (b > m) m = b;
  if (three && c > m) m = c;
  if (m == kNegInf) m = 0.f;
  return logf(expf(a - m) + expf(b - m) + expf((three ? c : kNegInf) - m)) + m;
}

// The frame's log-probabilities a walk reads: blank and each pair's label,
// from raw logits read a frame ahead.
template <int K>
struct Frame {
  float xe[K], xb, mx, ls;
};

template <int K>
__device__ __forceinline__ Frame<K> read_frame(const Row& w, int t, const int (&lab)[K]) {
  Frame<K> f;
  const float* row = w.x + (size_t)t * w.n_cls;
#pragma unroll
  for (int i = 0; i < K; ++i) f.xe[i] = row[lab[i]];
  f.xb = row[w.n_cls - 1];
  f.mx = w.mx[t];
  f.ls = w.ls[t];
  return f;
}

// Warp 0 on a feasible row: alpha_t over the blank-padded labels (state 2n
// the blank before label n, 2n+1 label n), alpha_t at row t of the table
// ([t][lane 2K + 2i + {0: blank, 1: label}] as floats) when `store`; the
// row's nll into *nll.
template <int K>
__device__ void lattice_alpha(const CtcArgs& p, int b, const Row& w, bool store, float* nll) {
  const int lane = threadIdx.x & 31;
  int lab[K];
  bool rep[K], rep_next[K];
  lane_labels<K>(p, b, w, lab, rep, rep_next);
  float* table = reinterpret_cast<float*>(w.alpha);
  float bl[K], em[K];
  Frame<K> f = read_frame<K>(w, 0, lab);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int n = lane * K + i;
    bl[i] = n == 0 ? log_prob(f.xb, f.mx, f.ls) : kNegInf;
    em[i] = n == 0 && w.len > 0 ? log_prob(f.xe[i], f.mx, f.ls) : kNegInf;
  }
  if (store) {
    float* out = table + lane * 2 * K;
#pragma unroll
    for (int i = 0; i < K; ++i) out[2 * i] = bl[i], out[2 * i + 1] = em[i];
  }
  if (w.t_b > 1) f = read_frame<K>(w, 1, lab);
  for (int t = 1; t < w.t_b; ++t) {
    const Frame<K> cur = f;
    if (t + 1 < w.t_b) f = read_frame<K>(w, t + 1, lab);
    float up = __shfl_up_sync(kFull, em[K - 1], 1);
    if (lane == 0) up = kNegInf;
    const float lb = log_prob(cur.xb, cur.mx, cur.ls);
    float nb[K], ne[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int n = lane * K + i;
      const float e = i == 0 ? up : em[i - 1];
      nb[i] = n <= w.len ? log_sum3(bl[i], n > 0 ? e : kNegInf, kNegInf, false) + lb : kNegInf;
      ne[i] = n < w.len ? log_sum3(em[i], bl[i], e, n > 0 && !rep[i]) +
                              log_prob(cur.xe[i], cur.mx, cur.ls)
                        : kNegInf;
    }
#pragma unroll
    for (int i = 0; i < K; ++i) bl[i] = nb[i], em[i] = ne[i];
    if (store) {
      float* out = table + (size_t)t * 64 * K + lane * 2 * K;
#pragma unroll
      for (int i = 0; i < K; ++i) out[2 * i] = bl[i], out[2 * i + 1] = em[i];
    }
  }
  float up = __shfl_up_sync(kFull, em[K - 1], 1);
  if (lane == 0) up = kNegInf;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (lane * K + i == w.len) {
      const float l1 = bl[i], l2 = w.len > 0 ? (i == 0 ? up : em[i - 1]) : kNegInf;
      float m = l1 > l2 ? l1 : l2;
      m = m == kNegInf ? 0.f : m;
      *nll = -(logf(expf(l1 - m) + expf(l2 - m)) + m);
    }
  }
}

// Warp 1 on a feasible row: beta_t (which includes lp[t]) from the row's
// last frame back to frame 0, at row t of its table as alpha's.
template <int K>
__device__ void lattice_beta(const CtcArgs& p, int b, const Row& w) {
  const int lane = threadIdx.x & 31;
  int lab[K];
  bool rep[K], rep_next[K];
  lane_labels<K>(p, b, w, lab, rep, rep_next);
  float* table = reinterpret_cast<float*>(w.beta);
  float bl[K], em[K];
  const int last = w.t_b - 1;
  Frame<K> f = read_frame<K>(w, last, lab);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int n = lane * K + i;
    bl[i] = n == w.len ? log_prob(f.xb, f.mx, f.ls) : kNegInf;
    em[i] = n + 1 == w.len ? log_prob(f.xe[i], f.mx, f.ls) : kNegInf;
  }
  if (last > 0) f = read_frame<K>(w, last - 1, lab);
  for (int t = last; ; --t) {
    float* out = table + (size_t)t * 64 * K + lane * 2 * K;
#pragma unroll
    for (int i = 0; i < K; ++i) out[2 * i] = bl[i], out[2 * i + 1] = em[i];
    if (t == 0) break;
    const Frame<K> cur = f;  // frame t - 1
    if (t > 1) f = read_frame<K>(w, t - 2, lab);
    float dn_b = __shfl_down_sync(kFull, bl[0], 1), dn_e = __shfl_down_sync(kFull, em[0], 1);
    if (lane == 31) dn_b = dn_e = kNegInf;
    const float lb = log_prob(cur.xb, cur.mx, cur.ls);
    float nb[K], ne[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int n = lane * K + i;
      const float b1 = i + 1 < K ? bl[i + 1] : dn_b, e1 = i + 1 < K ? em[i + 1] : dn_e;
      nb[i] = n <= w.len ? log_sum3(bl[i], n < w.len ? em[i] : kNegInf, kNegInf, false) + lb
                         : kNegInf;
      ne[i] = n < w.len ? log_sum3(em[i], b1, e1, n + 1 < w.len && !rep_next[i]) +
                              log_prob(cur.xe[i], cur.mx, cur.ls)
                        : kNegInf;
    }
#pragma unroll
    for (int i = 0; i < K; ++i) bl[i] = nb[i], em[i] = ne[i];
  }
}

// Every warp on a feasible row: the gradient rows of its frames, as
// F.ctc_loss's backward and then log_softmax's compute them.  acc: the
// warp's C floats of shared memory, zero.
template <int K>
__device__ void lattice_gradient(const CtcArgs& p, int b, const Row& w, float nll, float* acc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = w.n_cls;
  int lab[K];
  bool rep[K], rep_next[K];
  lane_labels<K>(p, b, w, lab, rep, rep_next);
  const float* ta = reinterpret_cast<const float*>(w.alpha);
  const float* tb = reinterpret_cast<const float*>(w.beta);
  float* g = p.grad + (size_t)b * p.t_len * c;
  for (int t = warp; t < w.t_b; t += kWarps) {
    const float* a = ta + (size_t)t * 64 * K + lane * 2 * K;
    const float* be = tb + (size_t)t * 64 * K + lane * 2 * K;
    const float* xt = w.x + (size_t)t * c;
    const float mx = w.mx[t], ls = w.ls[t];
    float sb[K], se[K];
    float m = kNegInf;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      sb[i] = a[2 * i] + be[2 * i];
      se[i] = a[2 * i + 1] + be[2 * i + 1];
      m = fmaxf(m, sb[i]);
    }
    // the blank: log-sum over its states, + nll - lp, exp
    m = warp_max(m);
    if (fabsf(m) == INFINITY) m = 0.f;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < K; ++i) s += expf(sb[i] - m);
    s = warp_sum(s);
    const float lp_blank = log_prob(xt[c - 1], mx, ls);
    if (lane == 0) atomicAdd(acc + c - 1, expf(((logf(s) + m) + nll) - lp_blank));
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if (lane * K + i < w.len) {
        const float lp = log_prob(xt[lab[i]], mx, ls);
        atomicAdd(acc + lab[i], expf((se[i] + nll) - lp));
      }
    }
    __syncwarp();
    float sum = 0.f;
    for (int j = lane; j < c; j += 32) sum += expf(log_prob(xt[j], mx, ls)) - acc[j];
    sum = warp_sum(sum);
    float* gt = g + (size_t)t * c;
    for (int j = lane; j < c; j += 32) {
      const float lp = log_prob(xt[j], mx, ls);
      const float gl = expf(lp) - acc[j];
      gt[j] = gl - expf(lp) * sum;
      acc[j] = 0.f;
    }
    __syncwarp();
  }
}

// ---------------------------------------------- infeasible rows: optax (k, r)

__device__ __forceinline__ float log_add(float a, float b) {
  return fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
}

__device__ __forceinline__ V oplus(V a, V b) {
  const float s = log_add(a.r, b.r);
  return V{min(a.k, b.k), a.k == b.k ? s : (a.k < b.k ? a.r : b.r)};
}

__device__ __forceinline__ V shift(V v, V m) { return V{v.k - m.k, v.r - m.r}; }

// floats ordered as ints, for the warp's integer max reduction
__device__ __forceinline__ int order_key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float from_key(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

__device__ __forceinline__ V shfl_up(V v) {
  return V{__shfl_up_sync(kFull, v.k, 1), __shfl_up_sync(kFull, v.r, 1)};
}

__device__ __forceinline__ V shfl_down(V v) {
  return V{__shfl_down_sync(kFull, v.k, 1), __shfl_down_sync(kFull, v.r, 1)};
}

// The largest of the warp's values where `on` (fewest epsilons, then the
// largest r); some lane must have one.
template <int S>
__device__ __forceinline__ V warp_lexmax(const V (&v)[S], const bool (&on)[S]) {
  int k = INT_MAX;
#pragma unroll
  for (int s = 0; s < S; ++s) k = on[s] ? min(k, v[s].k) : k;
  k = __reduce_min_sync(kFull, k);
  int key = INT_MIN;
#pragma unroll
  for (int s = 0; s < S; ++s) key = on[s] && v[s].k == k ? max(key, order_key(v[s].r)) : key;
  return V{k, from_key(__reduce_max_sync(kFull, key))};
}

// Warp 0 on an infeasible row: alpha over the row's frames; the loss.
// With a table, the normalised alpha_{t+1} at row t ([t][lane 2K + 2i +
// {0: phi, 1: emit}]).
template <int K>
__device__ void eps_alpha(const CtcArgs& p, int b, const Row& w, bool store) {
  const int lane = threadIdx.x & 31;
  int lab[K];
  bool rep[K], rep_next[K];
  lane_labels<K>(p, b, w, lab, rep, rep_next);
  V st[2 * K];
  bool on[2 * K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int n = lane * K + i;
    st[2 * i] = V{n == 0 ? 0 : 1, 0.f};
    st[2 * i + 1] = V{1, 0.f};
    on[2 * i] = n <= w.len;
    on[2 * i + 1] = n < w.len;
  }
  int ksum = 0;
  double rsum = 0.0;
  Frame<K> f;
  if (w.t_b > 0) f = read_frame<K>(w, 0, lab);
  for (int t = 0; t < w.t_b; ++t) {
    const Frame<K> cur = f;
    if (t + 1 < w.t_b) f = read_frame<K>(w, t + 1, lab);
    const V m = warp_lexmax(st, on);
    V up = shfl_up(st[2 * K - 1]);
    if (lane == 0) up = V{kZero, 0.f};
    const float lb = log_prob(cur.xb, cur.mx, cur.ls);
    V nx[2 * K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const V e = i == 0 ? up : st[2 * i - 1];
      const V a = oplus(st[2 * i], e);
      const V q = rep[i] ? oplus(st[2 * i], V{e.k + 1, e.r}) : a;
      const V s = oplus(q, st[2 * i + 1]);
      nx[2 * i] = shift(V{a.k, a.r + lb}, m);
      nx[2 * i + 1] = shift(V{s.k, s.r + log_prob(cur.xe[i], cur.mx, cur.ls)}, m);
    }
#pragma unroll
    for (int s = 0; s < 2 * K; ++s) st[s] = nx[s];
    ksum += m.k;
    rsum += (double)m.r;
    if (store) {
      V* out = w.alpha + (size_t)t * 64 * K + lane * 2 * K;
#pragma unroll
      for (int s = 0; s < 2 * K; ++s) out[s] = st[s];
    }
  }
  V up = shfl_up(st[2 * K - 1]);
  if (lane == 0) up = V{kZero, 0.f};
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (lane * K + i == w.len) {
      const V f = oplus(st[2 * i], i == 0 ? up : st[2 * i - 1]);
      p.loss[b] = (float)(1e5 * (double)(f.k + ksum) - ((double)f.r + rsum));
    }
  }
}

// Warp 1 on an infeasible row: beta from the end of the row's frames back
// to frame 0; the normalised beta_{t+1} at row t of its table, laid out as
// alpha's.
template <int K>
__device__ void eps_beta(const CtcArgs& p, int b, const Row& w) {
  const int lane = threadIdx.x & 31;
  int lab[K];
  bool rep[K], rep_next[K];
  lane_labels<K>(p, b, w, lab, rep, rep_next);
  V st[2 * K];
  bool on[2 * K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int n = lane * K + i;
    st[2 * i] = V{n == w.len ? 0 : kZero, 0.f};
    st[2 * i + 1] = V{n + 1 == w.len ? 0 : kZero, 0.f};
    on[2 * i] = on[2 * i + 1] = true;
  }
  Frame<K> f;
  if (w.t_b > 0) f = read_frame<K>(w, w.t_b - 1, lab);
  for (int t = w.t_b - 1; t >= 0; --t) {
    V* out = w.beta + (size_t)t * 64 * K + lane * 2 * K;
#pragma unroll
    for (int s = 0; s < 2 * K; ++s) out[s] = st[s];
    const Frame<K> cur = f;
    if (t > 0) f = read_frame<K>(w, t - 1, lab);
    const V m = warp_lexmax(st, on);
    const float lb = log_prob(cur.xb, cur.mx, cur.ls);
    V gp[K], gb[K], xv[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      gp[i] = V{st[2 * i + 1].k, st[2 * i + 1].r + log_prob(cur.xe[i], cur.mx, cur.ls)};
      gb[i] = V{st[2 * i].k, st[2 * i].r + lb};
      // what state n = lane K + i passes back to emit[n - 1]
      xv[i] = oplus(gb[i], V{gp[i].k + rep[i], gp[i].r});
    }
    V dn = shfl_down(xv[0]);
    if (lane == 31) dn = V{kZero, 0.f};
#pragma unroll
    for (int i = 0; i < K; ++i) {
      st[2 * i] = shift(oplus(gb[i], gp[i]), m);
      st[2 * i + 1] = shift(oplus(gp[i], i + 1 < K ? xv[i + 1] : dn), m);
    }
  }
}

// Every warp on an infeasible row: the gradient rows of its frames
// (softmax - occupancy).  acc: the warp's C floats of shared memory, zero.
template <int K>
__device__ void eps_gradient(const CtcArgs& p, int b, const Row& w, float* acc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = w.n_cls;
  int lab[K];
  bool rep[K], rep_next[K];
  lane_labels<K>(p, b, w, lab, rep, rep_next);
  float* g = p.grad + (size_t)b * p.t_len * c;
  for (int t = warp; t < w.t_b; t += kWarps) {
    const V* a = w.alpha + (size_t)t * 64 * K + lane * 2 * K;
    const V* be = w.beta + (size_t)t * 64 * K + lane * 2 * K;
    V v[2 * K];
    bool on[2 * K];
#pragma unroll
    for (int s = 0; s < 2 * K; ++s) {
      const V x = a[s], y = be[s];
      v[s] = V{x.k + y.k, x.r + y.r};
      on[s] = true;
    }
    const V m = warp_lexmax(v, on);
    float wt[2 * K], tot = 0.f, blank = 0.f;
#pragma unroll
    for (int s = 0; s < 2 * K; ++s) {
      wt[s] = v[s].k == m.k ? expf(v[s].r - m.r) : 0.f;
      tot += wt[s];
      if (s % 2 == 0) blank += wt[s];
    }
    const float inv = 1.f / warp_sum(tot);
    blank = warp_sum(blank);
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if (wt[2 * i + 1] > 0.f) atomicAdd(acc + lab[i], wt[2 * i + 1] * inv);
    }
    if (lane == 0) atomicAdd(acc + c - 1, blank * inv);
    __syncwarp();
    const float* xt = w.x + (size_t)t * c;
    const float mx = w.mx[t], ls = w.ls[t];
    float* gt = g + (size_t)t * c;
    for (int j = lane; j < c; j += 32) {
      gt[j] = expf(log_prob(xt[j], mx, ls)) - acc[j];
      acc[j] = 0.f;
    }
    __syncwarp();
  }
}

// ------------------------------------------------------------------ the kernel

template <int K>
__device__ void walks(const CtcArgs& p, int b, const Row& w, bool feasible, bool want_grad,
                      float* nll) {
  const int warp = threadIdx.x >> 5;
  if (feasible) {
    if (warp == 0) lattice_alpha<K>(p, b, w, want_grad, nll);
    if (warp == 1 && want_grad) lattice_beta<K>(p, b, w);
  } else {
    if (warp == 0) eps_alpha<K>(p, b, w, want_grad);
    if (warp == 1 && want_grad) eps_beta<K>(p, b, w);
  }
}

template <int K>
__device__ void gradient(const CtcArgs& p, int b, const Row& w, bool feasible, float nll,
                         float* acc) {
  if (feasible) {
    lattice_gradient<K>(p, b, w, nll, acc);
  } else {
    eps_gradient<K>(p, b, w, acc);
  }
}

__global__ void __launch_bounds__(kThreads) ctc_loss_kernel(CtcArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = p.n_cls;
  float* mx = reinterpret_cast<float*>(smem);
  float* ls = mx + p.t_len;
  float* acc = ls + p.t_len;
  float* nll = acc + kWarps * c;  // the feasible walk's loss, for phase C
  const long long len = read_index(p.label_lengths, p.label_len_code, b);
  const long long frames = read_index(p.logit_lengths, p.logit_len_code, b);
  Row w;
  w.x = p.logits + (size_t)b * p.t_len * c;
  w.mx = mx;
  w.ls = ls;
  w.t_b = (int)min(max(frames, 0LL), (long long)p.t_len);
  w.n_cls = c;
  w.n_lab = p.n_lab;
  w.len = (int)min(max(len, 0LL), (long long)p.n_lab);
  // labels the reference cannot read (a length outside [0, N], a label
  // outside [0, C)): the row's loss and gradient are NaN.  Adjacent repeats
  // (one thread a label: N < kThreads) decide which walk the row takes.
  int bad = len < 0 || len > p.n_lab, repeat = 0;
  if (tid < w.len) {
    const long long base = (long long)b * p.n_lab;
    const long long v = read_index(p.labels, p.labels_code, base + tid);
    bad |= v < 0 || v >= c;
    repeat = tid >= 1 && read_index(p.labels, p.labels_code, base + tid - 1) == v;
  }
  const int repeats = __syncthreads_count(repeat);
  if (__syncthreads_or(bad)) {
    if (tid == 0) p.loss[b] = nanf("");
    if (p.grad) {
      float* g = p.grad + (size_t)b * p.t_len * c;
      for (size_t i = tid; i < (size_t)p.t_len * c; i += kThreads) g[i] = nanf("");
    }
    return;
  }
  const bool feasible = w.t_b >= 1 && w.t_b >= w.len + repeats;
  // A. the log-softmax's max and log(sum) of each frame the row counts, in
  // F.log_softmax's order (lane j sums classes j and j + 32, then the warp)
  for (int t = warp; t < w.t_b; t += kWarps) {
    const float* xt = w.x + (size_t)t * c;
    float m = kNegInf;
    for (int j = lane; j < c; j += 32) m = fmaxf(m, xt[j]);
    m = warp_max(m);
    float s = 0.f;
    for (int j = lane; j < c; j += 32) s += expf(xt[j] - m);
    s = warp_sum(s);
    if (lane == 0) mx[t] = m, ls[t] = logf(s);
  }
  for (int j = tid; j < kWarps * c; j += kThreads) acc[j] = 0.f;
  const int k = (w.len + 32) / 32;  // lanes hold labels 0..w.len
  const size_t region = (size_t)p.t_len * 64 * p.k_max;
  V* tables = p.table ? p.table + (size_t)b * 2 * region
                      : reinterpret_cast<V*>(smem + 8 * ((4 * (2 * p.t_len + kWarps * c + 1) + 7) / 8));
  w.alpha = tables;
  w.beta = tables + region;
  const bool want_grad = p.grad != nullptr;
  __syncthreads();
  // B. the walks
  switch (k) {
    case 1: walks<1>(p, b, w, feasible, want_grad, nll); break;
    case 2: walks<2>(p, b, w, feasible, want_grad, nll); break;
    case 3: walks<3>(p, b, w, feasible, want_grad, nll); break;
    default: walks<4>(p, b, w, feasible, want_grad, nll); break;
  }
  __syncthreads();
  if (feasible && tid == 0) p.loss[b] = *nll;
  if (!want_grad) return;
  // C. the gradient; frames past the row's are 0
  float* g = p.grad + (size_t)b * p.t_len * c;
  for (size_t i = (size_t)w.t_b * c + tid; i < (size_t)p.t_len * c; i += kThreads) g[i] = 0.f;
  float* my_acc = acc + warp * c;
  const float row_nll = *nll;
  switch (k) {
    case 1: gradient<1>(p, b, w, feasible, row_nll, my_acc); break;
    case 2: gradient<2>(p, b, w, feasible, row_nll, my_acc); break;
    case 3: gradient<3>(p, b, w, feasible, row_nll, my_acc); break;
    default: gradient<4>(p, b, w, feasible, row_nll, my_acc); break;
  }
}

}  // namespace

extern "C" {

// logits (B,T,C) f32; logit_lengths, label_lengths (B,) and labels (B,N) in
// the dtypes of their codes (0 float32, 1 int32, 2 int64); loss (B,) f32;
// grad (B,T,C) f32 or null (no gradient); table: the (B, 2, T, 64 k_max)
// scratch of 8-byte entries, or null to keep the tables in shared memory
// (ops/ctc.py:ctc_plan decides).  Returns the launch's CUDA error.
int avsi_ctc_loss(const float* logits, const void* logit_lengths, const void* labels,
                  const void* label_lengths, float* loss, float* grad, void* table, int batch,
                  int t_len, int n_cls, int n_lab, int labels_code, int logit_len_code,
                  int label_len_code, void* stream) {
  if (batch == 0) return 0;
  if (t_len < 0 || n_cls < 1 || n_lab < 0 || n_lab > 127) return (int)cudaErrorInvalidValue;
  const int k_max = (n_lab + 32) / 32;
  size_t smem = 8 * ((4 * (2 * (size_t)t_len + (size_t)kWarps * n_cls + 1) + 7) / 8);
  if (grad != nullptr && table == nullptr) smem += 2 * (size_t)t_len * 64 * k_max * sizeof(V);
  static std::mutex mutex;
  static std::set<int> ready;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  {
    std::lock_guard<std::mutex> lock(mutex);
    if (!ready.count(device)) {
      int optin = 0;
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
      if (err == cudaSuccess) {
        err = cudaFuncSetAttribute(ctc_loss_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   optin);
      }
      if (err != cudaSuccess) return (int)err;
      ready.insert(device);
    }
  }
  const CtcArgs p{logits, logit_lengths, labels, label_lengths, loss, grad,
                  static_cast<V*>(table), t_len, n_cls, n_lab, k_max,
                  labels_code, logit_len_code, label_len_code};
  ctc_loss_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"

// Fused frame-synchronous greedy RNNT decode for Hopper (sm_90a).
//
// Replaces the TPU kernel indic_cl_asr_tpu/ops/decode_fused_pallas.py:
// rnnt_greedy_decode_fused (pl.pallas_call at line 322, body _kernel at
// line 102). Contract: ops/decoding.py rnnt_greedy_decode with the model's
// own pred_step / joint_step (ops/decode_fused.py), each row with the head
// of its own language:
//
//   for each frame t < len:  up to max_symbols rounds of
//     logits = relu(round(f_t + g)) · head[lang] + head_b[lang]   (f32)
//     pred   = first-index argmax
//     blank or out_len == max_out -> next frame
//     else emit pred; LSTM step on embedding[pred]; g = h·W_p + b_p
//
// Design: greedy rows are independent, so each batch row is one block of
// 640 threads that walks its own frames and emission loop (no row waits
// for another, unlike the TPU's batch-wide loop, and each picks its own
// language's head, so a batch may mix languages; the TPU kernel, one loop
// over the whole batch, holds a single head). The embedding row is read
// directly (no one-hot matmul). The decode state (g, h, f32 c, the
// joint input) lives in shared memory; the weights stay in device memory
// and L2. Each mat-vec splits its columns into 16-byte vectors (8 bf16 or
// 4 f32 per load) and its depth into KS slices so every thread has loads
// in flight; the slices' f32 partial sums are added in a fixed order.
// Rounding matches the plain version: every dot accumulates in f32 and is
// rounded to the compute dtype, then each elementwise op of the LSTM cell
// is rounded as PyTorch rounds it; the cell state is kept in f32.
//
// Bound: per LSTM step a row reads W_ih, W_hh and W_p (~7.3 MB bf16 at
// flagship widths) into one SM, one step after another, so the time is
// the L2 rate of one SM times the steps of the longest row, far above
// the bytes bound of the launch (f_proj + weights once, ~12 MB). Spreading
// a row over a cluster of blocks is the next step.
//
// Layouts (row-major): f [B, T, Hj]; table [V, Hp]; w_ih, w_hh [Hp, 4Hp]
// (gate order i, f, g, o); bias [4Hp]; wp [Hp, Hj]; bp [Hj];
// head [L, Hj, V1p] (V1 = V+1 columns, blank last, zero-padded to V1p, a
// multiple of 8); head_b [L, V1] f32; lang_ids [B] (clamped to [0, L), as
// a JAX gather clamps). Outputs ids [B, max_out], lens [B];
// work[0] += joint evaluations, work[1] += LSTM steps.

#include "decode_common.cuh"

namespace {

using namespace decode_common;

// 640 threads split every flagship mat-vec evenly: the gates' 320 column
// groups of 8 bf16 twice over, the projection's 80 eight times, the
// head's 33 nineteen times
constexpr int MAX_THREADS = 640;

__host__ __device__ inline int split_of(int threads, int groups) {
  const int ks = threads / groups;
  return ks < 1 ? 1 : ks;
}

// part[s*N + n] = sum over k in slice s of x[k] * W[k*N + n], and the same
// for (x2, W2) into part2 when TWO. Block-wide; the caller synchronises.
template <typename T, bool TWO>
__device__ void matvec_partial(const float* x, const T* __restrict__ W,
                               const float* x2, const T* __restrict__ W2,
                               int K, int N, float* part, float* part2) {
  constexpr int VEC = Vec16<T>::N;
  const int G = N / VEC;
  const int KS = split_of(blockDim.x, G);
  for (int it = threadIdx.x; it < KS * G; it += blockDim.x) {
    const int g = it % G, s = it / G;
    const int k0 = (s * K) / KS, k1 = ((s + 1) * K) / KS;
    float acc[VEC], acc2[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = acc2[e] = 0.f;
    const T* wp = W + (size_t)k0 * N + g * VEC;
    const T* wp2 = TWO ? W2 + (size_t)k0 * N + g * VEC : nullptr;
#pragma unroll 4
    for (int kk = k0; kk < k1; ++kk) {
      float w[VEC];
      Vec16<T>::load(wp, w);
      const float xv = x[kk];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = fmaf(xv, w[e], acc[e]);
      wp += N;
      if (TWO) {
        float w2[VEC];
        Vec16<T>::load(wp2, w2);
        const float xv2 = x2[kk];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc2[e] = fmaf(xv2, w2[e], acc2[e]);
        wp2 += N;
      }
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      part[s * N + g * VEC + e] = acc[e];
      if (TWO) part2[s * N + g * VEC + e] = acc2[e];
    }
  }
}

// sum of the KS partial slices of column n, in slice order
__device__ __forceinline__ float gather_sum(const float* part, int N, int KS, int n) {
  float acc = part[n];
  for (int s = 1; s < KS; ++s) acc += part[s * N + n];
  return acc;
}

struct Smem {
  float *pa, *pb, *g, *x, *emb, *h, *c, *rv;
  int* ri;
};

template <typename T>
__device__ Smem carve(float* base, int Hj, int Hp, int V1p) {
  constexpr int VEC = Vec16<T>::N;
  int pbuf = blockDim.x * VEC;
  pbuf = max(pbuf, max(4 * Hp, max(Hj, V1p)));
  Smem s;
  s.pa = base;
  s.pb = s.pa + pbuf;
  s.g = s.pb + pbuf;
  s.x = s.g + Hj;
  s.emb = s.x + Hj;
  s.h = s.emb + Hp;
  s.c = s.h + Hp;
  s.rv = s.c + Hp;
  s.ri = reinterpret_cast<int*>(s.rv + blockDim.x / 32);
  return s;
}

// One prediction-net step on s.emb and (s.h, s.c): new h, c, and the
// projected g = round(round(h·W_p) + b_p).
template <typename T>
__device__ void lstm_step(const Smem& s, const T* __restrict__ w_ih,
                          const T* __restrict__ w_hh, const T* __restrict__ bias,
                          const T* __restrict__ wp, const T* __restrict__ bp,
                          int Hj, int Hp) {
  constexpr int VEC = Vec16<T>::N;
  const int N4 = 4 * Hp;
  matvec_partial<T, true>(s.emb, w_ih, s.h, w_hh, Hp, N4, s.pa, s.pb);
  __syncthreads();
  const int KSg = split_of(blockDim.x, N4 / VEC);
  for (int u = threadIdx.x; u < Hp; u += blockDim.x) {
    float gate[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = q * Hp + u;
      const float xw = rnd<T>(rnd<T>(gather_sum(s.pa, N4, KSg, j)) + to_f<T>(bias[j]));
      gate[q] = rnd<T>(xw + rnd<T>(gather_sum(s.pb, N4, KSg, j)));
    }
    const float ig = rnd<T>(sigm(gate[0]));
    const float fg = rnd<T>(sigm(gate[1]));
    const float gg = rnd<T>(tanhf(gate[2]));
    const float og = rnd<T>(sigm(gate[3]));
    const float cn = rnd<T>(rnd<T>(fg * rnd<T>(s.c[u])) + rnd<T>(ig * gg));
    s.c[u] = cn;
    s.h[u] = rnd<T>(og * rnd<T>(tanhf(cn)));
  }
  __syncthreads();
  matvec_partial<T, false>(s.h, wp, nullptr, nullptr, Hp, Hj, s.pa, nullptr);
  __syncthreads();
  const int KSp = split_of(blockDim.x, Hj / VEC);
  for (int j = threadIdx.x; j < Hj; j += blockDim.x)
    s.g[j] = rnd<T>(rnd<T>(gather_sum(s.pa, Hj, KSp, j)) + to_f<T>(bp[j]));
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS, 1) rnnt_greedy_decode_kernel(
    const T* __restrict__ f, const int* __restrict__ flens,
    const int* __restrict__ lang_ids, const T* __restrict__ table,
    const T* __restrict__ w_ih, const T* __restrict__ w_hh,
    const T* __restrict__ bias,
    const T* __restrict__ wp, const T* __restrict__ bp,
    const T* __restrict__ heads, const float* __restrict__ heads_b,
    int* __restrict__ out_ids, int* __restrict__ out_lens,
    unsigned long long* __restrict__ work, int T_, int Hj, int Hp, int V1,
    int V1p, int L, int blank, int max_symbols, int max_out) {
  constexpr int VEC = Vec16<T>::N;
  extern __shared__ float smem[];
  __shared__ int s_pred;
  const Smem s = carve<T>(smem, Hj, Hp, V1p);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32, nwarps = blockDim.x / 32;
  int n = flens[b];
  n = n < 0 ? 0 : (n > T_ ? T_ : n);
  const int lang = min(max(lang_ids[b], 0), L - 1);
  const T* head = heads + (size_t)lang * Hj * V1p;
  const float* head_b = heads_b + (size_t)lang * V1;
  int* out = out_ids + (size_t)b * max_out;
  for (int i = tid; i < max_out; i += blockDim.x) out[i] = blank;
  if (n == 0) {
    if (tid == 0) out_lens[b] = 0;
    return;
  }
  // SOS priming: a blank label feeds a zero embedding into a zero state
  for (int i = tid; i < Hp; i += blockDim.x) s.emb[i] = s.h[i] = s.c[i] = 0.f;
  __syncthreads();
  lstm_step<T>(s, w_ih, w_hh, bias, wp, bp, Hj, Hp);
  unsigned long long n_joint = 0, n_lstm = 1;
  int out_len = 0;
  const int KSh = split_of(blockDim.x, V1p / VEC);

  for (int t = 0; t < n; ++t) {
    const T* ft = f + ((size_t)b * T_ + t) * Hj;
    for (int k = 0; k < max_symbols; ++k) {
      for (int i = tid; i < Hj; i += blockDim.x)
        s.x[i] = fmaxf(rnd<T>(to_f<T>(ft[i]) + s.g[i]), 0.f);
      __syncthreads();
      matvec_partial<T, false>(s.x, head, nullptr, nullptr, Hj, V1p, s.pa, nullptr);
      __syncthreads();
      float best = -INFINITY;
      int bi = 0x7fffffff;
      for (int v = tid; v < V1; v += blockDim.x) {
        const float val = gather_sum(s.pa, V1p, KSh, v) + head_b[v];
        if (val > best || (val == best && v < bi)) {
          best = val;
          bi = v;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ov > best || (ov == best && oi < bi)) {
          best = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        s.rv[warp] = best;
        s.ri[warp] = bi;
      }
      __syncthreads();
      if (warp == 0) {
        best = lane < nwarps ? s.rv[lane] : -INFINITY;
        bi = lane < nwarps ? s.ri[lane] : 0x7fffffff;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, best, off);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
          if (ov > best || (ov == best && oi < bi)) {
            best = ov;
            bi = oi;
          }
        }
        if (lane == 0) s_pred = bi;
      }
      __syncthreads();
      const int pred = s_pred;
      ++n_joint;
      if (pred == blank || out_len >= max_out) break;  // uniform over the block
      if (tid == 0) out[out_len] = pred;
      ++out_len;
      for (int i = tid; i < Hp; i += blockDim.x)
        s.emb[i] = to_f<T>(table[(size_t)pred * Hp + i]);
      __syncthreads();
      lstm_step<T>(s, w_ih, w_hh, bias, wp, bp, Hj, Hp);
      ++n_lstm;
    }
  }
  if (tid == 0) {
    out_lens[b] = out_len;
    atomicAdd(work, n_joint);
    atomicAdd(work + 1, n_lstm);
  }
}

// The card's own limit: one block's shared memory (the decode state and
// two partial-sum buffers) must fit what cudaFuncSetAttribute grants,
// 227 KB a block on an H100; over it the call fails and so does the launch.
template <typename T>
cudaError_t launch(const void* f, const void* flens, const void* lang_ids,
                   const void* table, const void* w_ih, const void* w_hh,
                   const void* bias, const void* wp, const void* bp,
                   const void* head, const void* head_b, void* ids, void* olen,
                   void* work, int B, int T_, int Hj, int Hp, int V1, int V1p,
                   int L, int blank, int max_symbols, int max_out, int threads,
                   cudaStream_t stream) {
  constexpr int VEC = Vec16<T>::N;
  if (threads % 32 || threads > MAX_THREADS || Hp % VEC || Hj % VEC || V1p % VEC ||
      V1p < V1 || L < 1)
    return cudaErrorInvalidValue;
  int pbuf = threads * VEC;
  pbuf = pbuf > 4 * Hp ? pbuf : 4 * Hp;
  pbuf = pbuf > Hj ? pbuf : Hj;
  pbuf = pbuf > V1p ? pbuf : V1p;
  const int smem = 4 * (2 * pbuf + 2 * Hj + 3 * Hp + 2 * (threads / 32));
  cudaError_t e = cudaFuncSetAttribute(
      rnnt_greedy_decode_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  rnnt_greedy_decode_kernel<T><<<B, threads, smem, stream>>>(
      (const T*)f, (const int*)flens, (const int*)lang_ids, (const T*)table,
      (const T*)w_ih,
      (const T*)w_hh, (const T*)bias, (const T*)wp, (const T*)bp,
      (const T*)head, (const float*)head_b, (int*)ids, (int*)olen,
      (unsigned long long*)work, T_, Hj, Hp, V1, V1p, L, blank, max_symbols,
      max_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rnnt_greedy_decode_fused(
    const void* f, const void* flens, const void* lang_ids, const void* table,
    const void* w_ih, const void* w_hh, const void* bias, const void* wp,
    const void* bp, const void* head, const void* head_b, void* ids,
    void* olen, void* work, int B, int T_, int Hj, int Hp, int V1, int V1p,
    int L, int blank, int max_symbols, int max_out, int dtype, int threads,
    void* stream) {
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (dtype == 0)
    e = launch<float>(f, flens, lang_ids, table, w_ih, w_hh, bias, wp, bp,
                      head, head_b, ids, olen, work, B, T_, Hj, Hp, V1, V1p,
                      L, blank, max_symbols, max_out, threads, s);
  else if (dtype == 1)
    e = launch<__nv_bfloat16>(f, flens, lang_ids, table, w_ih, w_hh, bias, wp,
                              bp, head, head_b, ids, olen, work, B, T_, Hj, Hp,
                              V1, V1p, L, blank, max_symbols, max_out, threads,
                              s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

extern "C" const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

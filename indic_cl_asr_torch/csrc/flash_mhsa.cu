// Transformer-XL relative-position MHSA, forward and backward, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels of indic_cl_asr_tpu/ops/flash_mhsa.py:
// _flash_fwd (pl.pallas_call at line 383, body _fwd_kernel at line 197)
// and _flash_bwd (pl.pallas_call at line 416, body _bwd_kernel at line 225).
//
//   out[b,t,h,:] = sum_j Pd[t,j] v[b,j,h,:],
//   P  = softmax_j(((q+u)·k_j + round(rel_shift((q+v)·pᵀ))[t,j]) / sqrt(D))
//   Pd = keep[t,j] ? P[t,j] / (1 - rate) : 0     (inverted dropout)
//
// masked by the valid length of the row and an optional (left, right)
// band; fully masked rows give 0. Layouts: q, k, v, out [B, T, H*D];
// p [2T-1, H*D] in XL order (row m encodes relative position (T-1)-m);
// bias_u, bias_v [H*D]; lens [B] int32.
//
// Forward design (a first, simple kernel): one block per (64-row query
// tile, head, batch row), 256 threads, an online softmax over 64-wide key
// tiles. For a (t0, j0) tile pair the rel-shift reads only p rows
// (T-1)+j0-t0-63 ... (T-1)+j0-t0+63, a 127-row window held in shared
// memory; bd[t,j] is the dot of (q+v)[t] with window row
// (j-j0)-(t-t0)+63, computed only for the 64x64 pairs that need it
// (the TPU's strided roll becomes an index; T needs no 128-padding and
// has no cap). Key tiles outside the valid length or the band are
// skipped. Each thread owns a 4x4 block of scores and 4 rows x D/16
// output columns; all sums are f32 (scalar FMAs from shared memory).
// With ``lse`` given it also writes each row's log-sum-exp, the one
// statistic the backward needs to rebuild the probabilities.
//
// Dropout: the TPU kernel draws its keep mask from the TPU's PRNG seeded
// per (batch, head) and draws it again in the backward. Here the bits come
// from a counter-based hash: key = fmix32(seed ^ (b*H+h)·0x9E3779B9),
// bits[t,j] = fmix32(key ^ fmix32(t*T + j)), with fmix32 murmur3's
// finaliser. Every multiply keeps the low 32 bits, so the plain PyTorch
// version (ops/flash_mhsa.py:dropout_bits) computes the same bits in
// int64 tensor ops; Philox would need the high half of 32x32 products.
// The keep test is the TPU kernel's: bits <= uint32((1-rate)(2^32-1)).
// Nothing is stored: the backward draws the same bits again.
//
// Backward design: the forward's tiling. A block per (query tile, head,
// batch row) rebuilds its scores exactly as the forward does (same loop,
// same rounding), P = exp(s - lse), and walks the key tiles twice. The
// first walk sums delta = rowsum(dP ∘ P) in registers, from the very P and
// dP the gradients use (rowsum(dO ∘ O) would be cheaper, but O is rounded
// to the compute dtype, which leaves a residue where the exact gradient is
// 0). The second walk accumulates
//   dv  += Pdᵀ dO                      dP = keep ? (dO vᵀ) / (1-rate) : 0
//   dS   = P (dP - delta) scale
//   dqu += dS k,  dqv += unskew(dS) p  (registers: the block owns its rows)
//   dk  += dSᵀ qu, dp += unskew(dS)ᵀ qv (f32 atomicAdd: many blocks add)
// dS is rounded to the compute dtype before the four products (the TPU
// kernel's dSc). dk, dv sum over query tiles and dp over query tiles and
// the batch: the TPU's sequential grid carried those sums; here f32
// atomics into zeroed scratch do, so their order, and their last bits,
// change from run to run.
//
// Bound at flagship shapes (B16 T204 E512 H8, bf16): the forward ~2 GFLOP
// and ~13 MB per call, the backward ~2.7x the flops and ~30 MB: below the
// H100's bf16 ridge, so the bytes bound both (~4 us and ~9 us). These
// kernels run on the CUDA cores, far from that bound; wgmma, TMA and bf16
// shared-memory tiles are the next step.
//
// Numerics follow the plain version (ops/flash_mhsa.py): q+u and q+v
// rounded to the compute dtype, f32 dots, the position score rounded once
// to the compute dtype, probabilities rounded to the compute dtype before
// P·V, f32 accumulation, the outputs rounded once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TQ = 64;            // query rows per block
constexpr int TK = 64;            // key columns per tile
constexpr int NT = 256;           // threads per block
constexpr int PW = TQ + TK - 1;   // rows of the p window
constexpr float NEG = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// round an f32 value to the compute dtype and back
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f<T>(from_f<T>(x));
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t drop_key(uint32_t seed, int b, int h, int H) {
  return fmix32(seed ^ ((uint32_t)(b * H + h) * 0x9E3779B9u));
}

__device__ __forceinline__ uint32_t drop_bits(uint32_t key, int t, int j, int T_) {
  return fmix32(key ^ fmix32((uint32_t)(t * T_ + j)));
}

struct Drop {
  uint32_t seed;   // per-call seed
  uint32_t thr;    // keep when bits <= thr
  float scale;     // 1 / (1 - rate)
  int on;
};

template <int D> constexpr int fwd_smem_floats() {
  // Qu, Qv [TQ][D+1]; K, V [TK][D+1]; p window [PW][D+1]; P tile [TQ][TK+1]
  return (2 * TQ + 2 * TK + PW) * (D + 1) + TQ * (TK + 1);
}

template <int D> constexpr int bwd_smem_floats() {
  // Qu, Qv, dO [TQ][D+1]; K, V [TK][D+1]; p window [PW][D+1];
  // dS, Pd [TQ][TK+1]
  return (3 * TQ + 2 * TK + PW) * (D + 1) + 2 * TQ * (TK + 1);
}

// (q + bias) rounded to the compute dtype, for rows t0 .. t0+TQ-1 of head h
template <typename T, int D>
__device__ __forceinline__ void load_q(const T* q, const T* bu, const T* bv,
                                       float* sQu, float* sQv, int b, int h,
                                       int t0, int T_, int E) {
  constexpr int DP = D + 1;
  for (int idx = threadIdx.x; idx < TQ * D; idx += NT) {
    const int r = idx / D, d = idx % D, t = t0 + r;
    float qu = 0.f, qv = 0.f;
    if (t < T_) {
      const float qq = to_f<T>(q[((size_t)b * T_ + t) * E + h * D + d]);
      qu = rnd<T>(qq + to_f<T>(bu[h * D + d]));
      qv = rnd<T>(qq + to_f<T>(bv[h * D + d]));
    }
    sQu[r * DP + d] = qu;
    sQv[r * DP + d] = qv;
  }
}

// keys/values j0 .. j0+TK-1 and the p window of the (t0, j0) tile pair
template <typename T, int D>
__device__ __forceinline__ void load_kv_window(const T* k, const T* v,
                                               const T* p, float* sK,
                                               float* sV, float* sP, int b,
                                               int h, int t0, int j0, int T_,
                                               int E) {
  constexpr int DP = D + 1;
  for (int idx = threadIdx.x; idx < TK * D; idx += NT) {
    const int r = idx / D, d = idx % D, j = j0 + r;
    float kk = 0.f, vv = 0.f;
    if (j < T_) {
      const size_t off = ((size_t)b * T_ + j) * E + h * D + d;
      kk = to_f<T>(k[off]);
      vv = to_f<T>(v[off]);
    }
    sK[r * DP + d] = kk;
    sV[r * DP + d] = vv;
  }
  const int g0 = (T_ - 1) + j0 - t0 - (TQ - 1);
  for (int idx = threadIdx.x; idx < PW * D; idx += NT) {
    const int w = idx / D, d = idx % D, g = g0 + w;
    sP[w * DP + d] =
        (g >= 0 && g < 2 * T_ - 1) ? to_f<T>(p[(size_t)g * E + h * D + d]) : 0.f;
  }
}

// raw scores of the thread's 4x4 block: ac = qu·k, bd = qv·p_window
template <int D>
__device__ __forceinline__ void tile_scores(const float* sQu, const float* sQv,
                                            const float* sK, const float* sP,
                                            int ty, int tx, float ac[4][4],
                                            float bd[4][4]) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) ac[i][c] = bd[i][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qu[4], qv[4], kc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qu[i] = sQu[(ty * 4 + i) * DP + d];
      qv[i] = sQv[(ty * 4 + i) * DP + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) kc[c] = sK[(tx + 16 * c) * DP + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int w = (tx + 16 * c) - (ty * 4 + i) + (TQ - 1);
        ac[i][c] = fmaf(qu[i], kc[c], ac[i][c]);
        bd[i][c] = fmaf(qv[i], sP[w * DP + d], bd[i][c]);
      }
  }
}

__device__ __forceinline__ bool visible(int t, int j, int n, int left, int right) {
  const int rel = j - t;
  return t < n && j < n && (left < 0 || rel >= -left) && (right < 0 || rel <= right);
}

// keys any row of the query tile at t0 may see: [j_lo, j_hi)
__device__ __forceinline__ void key_range(int t0, int n, int left, int right,
                                          int* j_lo, int* j_hi) {
  *j_lo = left >= 0 ? max(0, t0 - left) : 0;
  *j_hi = right >= 0 ? min(n, t0 + TQ + right) : n;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_relpos_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ p, const T* __restrict__ bu,
    const T* __restrict__ bv, const int* __restrict__ lens,
    T* __restrict__ out, float* __restrict__ lse, int T_, int H, int left,
    int right, float scale, Drop drop) {
  constexpr int DP = D + 1;   // padded row stride: no shared-memory bank conflicts
  constexpr int SP = TK + 1;
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQu = smem;
  float* sQv = sQu + TQ * DP;
  float* sK = sQv + TQ * DP;
  float* sV = sK + TK * DP;
  float* sP = sV + TK * DP;
  float* sS = sP + PW * DP;

  const int t0 = blockIdx.x * TQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int E = H * D;
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3 of the tile
  const int tx = tid % 16;  // columns tx + 16*c
  int n = lens[b];
  n = n < 0 ? 0 : (n > T_ ? T_ : n);
  const uint32_t key = drop_key(drop.seed, b, h, H);

  float o[4][DC];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[i][c] = 0.f;
  }

  if (t0 < n) {
    load_q<T, D>(q, bu, bv, sQu, sQv, b, h, t0, T_, E);
    int j_lo, j_hi;
    key_range(t0, n, left, right, &j_lo, &j_hi);
    for (int j0 = (j_lo / TK) * TK; j0 < j_hi; j0 += TK) {
      __syncthreads();  // the previous tile's readers are done
      load_kv_window<T, D>(k, v, p, sK, sV, sP, b, h, t0, j0, T_, E);
      __syncthreads();

      float ac[4][4], bd[4][4];
      tile_scores<D>(sQu, sQv, sK, sP, ty, tx, ac, bd);

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty * 4 + i;
        float s[4];
        bool ok[4];
        float tmax = NEG;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = j0 + tx + 16 * c;
          ok[c] = visible(t, j, n, left, right);
          s[c] = ok[c] ? (ac[i][c] + rnd<T>(bd[i][c])) * scale : NEG;
          tmax = fmaxf(tmax, s[c]);
        }
        // the 16 threads of a row are one half-warp: reduce within it
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
        const float m_new = fmaxf(m_i[i], tmax);
        const float alpha = expf(m_i[i] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float e = ok[c] ? expf(s[c] - m_new) : 0.f;
          psum += e;
          const bool kept =
              !drop.on || drop_bits(key, t, j0 + tx + 16 * c, T_) <= drop.thr;
          sS[(ty * 4 + i) * SP + tx + 16 * c] = kept ? rnd<T>(e) : 0.f;
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          psum += __shfl_xor_sync(0xffffffffu, psum, off);
        l_i[i] = l_i[i] * alpha + psum;
        m_i[i] = m_new;
#pragma unroll
        for (int c = 0; c < DC; ++c) o[i][c] *= alpha;
      }
      __syncthreads();

#pragma unroll 4
      for (int j = 0; j < TK; ++j) {
        float vj[DC];
#pragma unroll
        for (int c = 0; c < DC; ++c) vj[c] = sV[j * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pij = sS[(ty * 4 + i) * SP + j];
#pragma unroll
          for (int c = 0; c < DC; ++c) o[i][c] = fmaf(pij, vj[c], o[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty * 4 + i;
    if (t >= T_) continue;
    const float inv = (l_i[i] == 0.f ? 1.f : 1.f / l_i[i]) * drop.scale;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      out[((size_t)b * T_ + t) * E + h * D + tx + 16 * c] = from_f<T>(o[i][c] * inv);
    if (lse != nullptr && tx == 0)
      lse[((size_t)b * H + h) * T_ + t] = l_i[i] > 0.f ? m_i[i] + logf(l_i[i]) : 0.f;
  }
}

// P, Pd and dP of the thread's 4x4 block of a (t0, j0) tile pair
template <typename T, int D>
__device__ __forceinline__ void tile_probs(
    const float* sQu, const float* sQv, const float* sK, const float* sV,
    const float* sP, const float* sdO, const float lse[4], int ty, int tx,
    int t0, int j0, int n, int left, int right, int T_, float scale,
    uint32_t key, const Drop& drop, float P[4][4], float Pd[4][4],
    float dP[4][4]) {
  constexpr int DP = D + 1;
  float ac[4][4], bd[4][4], dpd[4][4];
  tile_scores<D>(sQu, sQv, sK, sP, ty, tx, ac, bd);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) dpd[i][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float g[4], vc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) g[i] = sdO[(ty * 4 + i) * DP + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) vc[c] = sV[(tx + 16 * c) * DP + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) dpd[i][c] = fmaf(g[i], vc[c], dpd[i][c]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty * 4 + i;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      float p = 0.f;
      if (visible(t, j, n, left, right))
        p = expf((ac[i][c] + rnd<T>(bd[i][c])) * scale - lse[i]);
      const bool kept = !drop.on || drop_bits(key, t, j, T_) <= drop.thr;
      P[i][c] = p;
      Pd[i][c] = kept ? p * drop.scale : 0.f;
      dP[i][c] = kept ? dpd[i][c] * drop.scale : 0.f;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_relpos_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ p, const T* __restrict__ bu,
    const T* __restrict__ bv, const int* __restrict__ lens,
    const T* __restrict__ dout, const float* __restrict__ lse_g,
    float* __restrict__ dqu, float* __restrict__ dqv, float* __restrict__ dk,
    float* __restrict__ dv, float* __restrict__ dp, int T_, int H, int left,
    int right, float scale, Drop drop) {
  constexpr int DP = D + 1;
  constexpr int SP = TK + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* sQu = smem;
  float* sQv = sQu + TQ * DP;
  float* sdO = sQv + TQ * DP;
  float* sK = sdO + TQ * DP;
  float* sV = sK + TK * DP;
  float* sP = sV + TK * DP;
  float* sDS = sP + PW * DP;
  float* sPd = sDS + TQ * SP;

  const int t0 = blockIdx.x * TQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int E = H * D;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  int n = lens[b];
  n = n < 0 ? 0 : (n > T_ ? T_ : n);
  const uint32_t key = drop_key(drop.seed, b, h, H);

  float gqu[4][DC], gqv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) gqu[i][c] = gqv[i][c] = 0.f;

  if (t0 < n) {
    load_q<T, D>(q, bu, bv, sQu, sQv, b, h, t0, T_, E);
    for (int idx = tid; idx < TQ * D; idx += NT) {
      const int r = idx / D, d = idx % D, t = t0 + r;
      sdO[r * DP + d] =
          t < T_ ? to_f<T>(dout[((size_t)b * T_ + t) * E + h * D + d]) : 0.f;
    }
    float lse[4], delta[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty * 4 + i;
      lse[i] = t < T_ ? lse_g[((size_t)b * H + h) * T_ + t] : 0.f;
      delta[i] = 0.f;
    }
    int j_lo, j_hi;
    key_range(t0, n, left, right, &j_lo, &j_hi);
    const int j_first = (j_lo / TK) * TK;
    float P[4][4], Pd[4][4], dP[4][4];

    // pass 1: delta[t] = sum_j dP[t,j] P[t,j], from the same P and dP the
    // gradients use (the TPU kernel's delta; no rounded O enters it)
    for (int j0 = j_first; j0 < j_hi; j0 += TK) {
      __syncthreads();
      load_kv_window<T, D>(k, v, p, sK, sV, sP, b, h, t0, j0, T_, E);
      __syncthreads();
      tile_probs<T, D>(sQu, sQv, sK, sV, sP, sdO, lse, ty, tx, t0, j0, n, left,
                       right, T_, scale, key, drop, P, Pd, dP);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) part = fmaf(dP[i][c], P[i][c], part);
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        delta[i] += part;
      }
    }

    // pass 2: the gradients
    for (int j0 = j_first; j0 < j_hi; j0 += TK) {
      __syncthreads();
      load_kv_window<T, D>(k, v, p, sK, sV, sP, b, h, t0, j0, T_, E);
      __syncthreads();
      tile_probs<T, D>(sQu, sQv, sK, sV, sP, sdO, lse, ty, tx, t0, j0, n, left,
                       right, T_, scale, key, drop, P, Pd, dP);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int cc = tx + 16 * c;
          sDS[r * SP + cc] = rnd<T>(P[i][c] * (dP[i][c] - delta[i]) * scale);
          sPd[r * SP + cc] = Pd[i][c];
        }
      }
      __syncthreads();

      // dqu, dqv: the thread's 4 query rows x D/16 columns
#pragma unroll 4
      for (int jj = 0; jj < TK; ++jj) {
        float kv[DC];
#pragma unroll
        for (int c = 0; c < DC; ++c) kv[c] = sK[jj * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty * 4 + i;
          const float ds = sDS[r * SP + jj];
          const float* pw = sP + (jj - r + (TQ - 1)) * DP;
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            gqu[i][c] = fmaf(ds, kv[c], gqu[i][c]);
            gqv[i][c] = fmaf(ds, pw[tx + 16 * c], gqv[i][c]);
          }
        }
      }
      // dk, dv: the thread's 4 key rows x D/16 columns, summed over the tile
      {
        float ak[4][DC], av[4][DC];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < DC; ++c) ak[i][c] = av[i][c] = 0.f;
#pragma unroll 4
        for (int r = 0; r < TQ; ++r) {
          float qc[DC], gc[DC];
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            qc[c] = sQu[r * DP + tx + 16 * c];
            gc[c] = sdO[r * DP + tx + 16 * c];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float ds = sDS[r * SP + ty * 4 + i];
            const float pd = sPd[r * SP + ty * 4 + i];
#pragma unroll
            for (int c = 0; c < DC; ++c) {
              ak[i][c] = fmaf(ds, qc[c], ak[i][c]);
              av[i][c] = fmaf(pd, gc[c], av[i][c]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = j0 + ty * 4 + i;
          if (j >= n) continue;
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            const size_t off = ((size_t)b * T_ + j) * E + h * D + tx + 16 * c;
            atomicAdd(dk + off, ak[i][c]);
            atomicAdd(dv + off, av[i][c]);
          }
        }
      }
      // dp over the window: dp[g0+w] += sum_r dS[r, r+w-63] qv[r]
      {
        const int g0 = (T_ - 1) + j0 - t0 - (TQ - 1);
        for (int idx = tid; idx < PW * D; idx += NT) {
          const int w = idx / D, d = idx % D, g = g0 + w;
          if (g < 0 || g >= 2 * T_ - 1) continue;
          const int r_lo = max(0, (TQ - 1) - w);
          const int r_hi = min(TQ, (TQ - 1) - w + TK);
          float acc = 0.f;
          for (int r = r_lo; r < r_hi; ++r)
            acc = fmaf(sDS[r * SP + r + w - (TQ - 1)], sQv[r * DP + d], acc);
          if (acc != 0.f) atomicAdd(dp + (size_t)g * E + h * D + d, acc);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty * 4 + i;
    if (t >= T_) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const size_t off = ((size_t)b * T_ + t) * E + h * D + tx + 16 * c;
      dqu[off] = gqu[i][c];
      dqv[off] = gqv[i][c];
    }
  }
}

// bits[b,h,t,j] of the dropout hash, for holding it against the plain version
__global__ void dropout_bits_kernel(uint32_t seed, int B, int H, int T_,
                                    uint32_t* __restrict__ bits) {
  const size_t total = (size_t)B * H * T_ * T_;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int j = (int)(i % T_);
    const int t = (int)((i / T_) % T_);
    const int h = (int)((i / ((size_t)T_ * T_)) % H);
    const int b = (int)(i / ((size_t)T_ * T_ * H));
    bits[i] = drop_bits(drop_key(seed, b, h, H), t, j, T_);
  }
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* p, const void* bu, const void* bv,
                       const void* lens, void* out, float* lse, int B, int T_,
                       int H, int left, int right, float scale, Drop drop,
                       cudaStream_t stream) {
  const int smem = fwd_smem_floats<D>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_relpos_fwd_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((T_ + TQ - 1) / TQ, H, B);
  flash_relpos_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)p, (const T*)bu,
      (const T*)bv, (const int*)lens, (T*)out, lse, T_, H, left, right, scale,
      drop);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* p, const void* bu, const void* bv,
                       const void* lens, const void* dout,
                       const float* lse, float* dqu, float* dqv, float* dk,
                       float* dv, float* dp, int B, int T_, int H, int left,
                       int right, float scale, Drop drop, cudaStream_t stream) {
  const int smem = bwd_smem_floats<D>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_relpos_bwd_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((T_ + TQ - 1) / TQ, H, B);
  flash_relpos_bwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)p, (const T*)bu,
      (const T*)bv, (const int*)lens, (const T*)dout, lse, dqu,
      dqv, dk, dv, dp, T_, H, left, right, scale, drop);
  return cudaGetLastError();
}

Drop make_drop(unsigned seed, unsigned thr, float drop_scale, int use_drop) {
  Drop d;
  d.seed = seed;
  d.thr = thr;
  d.scale = use_drop ? drop_scale : 1.f;
  d.on = use_drop;
  return d;
}

}  // namespace

extern "C" int flash_relpos_fwd(const void* q, const void* k, const void* v,
                                const void* p, const void* bu, const void* bv,
                                const void* lens, void* out, void* lse, int B,
                                int T_, int H, int D, int left, int right,
                                float scale, unsigned seed, unsigned thr,
                                float drop_scale, int use_drop, int dtype,
                                void* stream) {
  if (B == 0 || T_ == 0) return (int)cudaSuccess;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Drop dr = make_drop(seed, thr, drop_scale, use_drop);
  float* l = (float*)lse;
#define FWD(TY, DD)                                                          \
  launch_fwd<TY, DD>(q, k, v, p, bu, bv, lens, out, l, B, T_, H, left, right, \
                     scale, dr, s)
#define FWD_D(TY)                                     \
  switch (D) {                                        \
    case 16: return (int)FWD(TY, 16);                 \
    case 32: return (int)FWD(TY, 32);                 \
    case 64: return (int)FWD(TY, 64);                 \
    case 128: return (int)FWD(TY, 128);               \
    default: return (int)cudaErrorInvalidValue;       \
  }
  if (dtype == 0) {
    FWD_D(float)
  } else if (dtype == 1) {
    FWD_D(__nv_bfloat16)
  }
#undef FWD_D
#undef FWD
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_relpos_bwd(const void* q, const void* k, const void* v,
                                const void* p, const void* bu, const void* bv,
                                const void* lens, const void* dout,
                                const void* lse, void* dqu,
                                void* dqv, void* dk, void* dv, void* dp, int B,
                                int T_, int H, int D, int left, int right,
                                float scale, unsigned seed, unsigned thr,
                                float drop_scale, int use_drop, int dtype,
                                void* stream) {
  if (B == 0 || T_ == 0) return (int)cudaSuccess;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Drop dr = make_drop(seed, thr, drop_scale, use_drop);
#define BWD(TY, DD)                                                           \
  launch_bwd<TY, DD>(q, k, v, p, bu, bv, lens, dout, (const float*)lse,       \
                     (float*)dqu, (float*)dqv, (float*)dk, (float*)dv,        \
                     (float*)dp, B, T_, H, left, right, scale, dr, s)
#define BWD_D(TY)                                     \
  switch (D) {                                        \
    case 16: return (int)BWD(TY, 16);                 \
    case 32: return (int)BWD(TY, 32);                 \
    case 64: return (int)BWD(TY, 64);                 \
    default: return (int)cudaErrorInvalidValue;       \
  }
  if (dtype == 0) {
    BWD_D(float)
  } else if (dtype == 1) {
    BWD_D(__nv_bfloat16)
  }
#undef BWD_D
#undef BWD
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_dropout_bits(unsigned seed, int B, int H, int T_,
                                  void* bits, void* stream) {
  const size_t total = (size_t)B * H * T_ * T_;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  const int blocks = (int)((total + threads - 1) / threads < 65535
                               ? (total + threads - 1) / threads
                               : 65535);
  dropout_bits_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      seed, B, H, T_, (uint32_t*)bits);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

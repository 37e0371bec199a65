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
// Forward in bf16 (flash_relpos_fwd_mma_kernel), on the tensor cores: one
// block of 4 warps per (64-row query tile, head, batch row), walking
// 64-wide key tiles with an online softmax; warp w owns query rows
// 16w .. 16w+15. Qu = round(q+u) and Qv = round(q+v), the key tile K, the
// value tile V and, for the (t0, j0) tile pair, the 128-row window of p
// rows (T-1)+j0-t0-63 ... (the rel-shift reads only those) are staged in
// shared memory as bf16, rows padded by 16 bytes so that ldmatrix reads
// them without bank conflicts; K, V and window rows past the valid length
// or outside [0, 2T-2] are zero-filled by the cp.async copies (a NaN bit
// pattern left there would survive P = 0 in an mma). Each warp keeps its
// Qu and Qv A fragments in registers for the whole walk. Per key tile the
// scores come from warp_scores, which the backward calls too:
//   ac  = Qu·Kᵀ, 16x64 a warp, mma.sync.m16n8k16 bf16 with f32 sums;
//   bd: for rows r and columns c the window row is c - r + 63, so warp w
//       needs window rows 48-16w .. 127-16w only: it computes that 16x80
//       product raw = Qv·Winᵀ on mma.sync, rounds it to bf16 as it writes
//       it to its own staging rows in shared memory (the one rounding
//       point of the position score), and reads bd[i][c] back at column
//       c - i + 15 of staging row i (the TPU's strided roll becomes this
//       skewed index; T needs no padding and has no cap);
//   s = (ac + bd)·scale, masked, rounded (every later subtraction from
//       it is __fsub_rn, which no FMA contraction may absorb); then the
//       online softmax in the C-fragment registers: row max and later the
//       row sum reduced over the lane quad with __shfl_xor_sync, the
//       dropout bits hashed at each element's (t, j), O rescaled when the
//       row max moves;
//   O += P·V on mma.sync, P's C fragments repacked in registers as bf16 A
//       fragments (the FlashAttention-2 idiom), V read by ldmatrix.trans.
// Key tiles outside the valid length or the band are skipped. The bd
// staging rows reuse the shared memory of the Q tiles once every warp
// holds its fragments: 55,296 B a block at D 64, and three blocks share
// an SM. Loads are not overlapped with the products inside a block
// (single-buffered cp.async); the other resident blocks hide them (a
// double-buffered ring needs 92 KB a block, which fits two an SM).
//
// Forward in f32 (flash_relpos_fwd_kernel, the CPU-parity dtype): scalar
// f32 FMAs from shared memory, one block of 256 threads per (query tile,
// head, batch row), each thread a 4x4 block of scores and 4 rows x D/16
// output columns; bd[t,j] is the dot of (q+v)[t] with window row
// (j-j0)-(t-t0)+63 of the same 127-row window.
// With ``lse`` given both forwards also write each row's log-sum-exp, the
// one statistic the backward needs to rebuild the probabilities.
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
// Backward, both dtypes: the gradients of _bwd_kernel, from P = exp(s -
// lse) with the forward's lse, in two walks over the key tiles. The first
// sums delta = rowsum(dP ∘ P) from the very P and dP the gradients use
// (rowsum(dO ∘ O) would be cheaper, but O is rounded to the compute
// dtype, which leaves a residue where the exact gradient is 0). The
// second forms dS = P (dP - delta) scale, rounded to the compute dtype
// once (the TPU kernel's dSc), and accumulates
//   dv  += Pdᵀ dO                      dP = keep ? (dO vᵀ) / (1-rate) : 0
//   dqu += dS k,  dqv += unskew(dS) p  (registers: the block owns its rows)
//   dk  += dSᵀ qu, dp += unskew(dS)ᵀ qv
// dq = dqu + dqv is written once; the bias gradients are dqu's and dqv's
// column sums. dk, dv, dp and the bias sums add up over query tiles (and
// dp over the batch) with f32 atomics into a buffer the launch zeroes:
// the TPU's sequential grid carried those sums, and their order, so
// their last bits, changes from run to run here.
//
// Backward in bf16 (flash_relpos_bwd_mma_kernel), on the tensor cores,
// with the forward's layout (4 warps of 16 query rows a 64-row tile, dqu
// and dqv in C-fragment registers). Qu, Qv and dO stay in shared memory
// for the walks, K, V and the 128-row window are staged per key tile as
// the forward stages them. The scores are warp_scores' (the same mma
// order and fragments, the same bf16 staging, the same rounded s), so s is
// bit-identical to the forward's and P = exp(s - lse) is exactly 1 where
// a row's only visible key gave the lse (the card test with a (0, 0)
// band gets dS = 0 and zero dq, dk and dp). Per key tile and warp:
// dP = dO·Vᵀ (V rows read as ldmatrix B operands, as K in the forward);
// dS and Pd rounded to bf16 into the warp's rows of shared memory (over
// its bd staging), dS also skewed into Z[r][w] = dS[r][w + r - 63] (0
// where w + r - 63 falls outside [0, 64), zeroed once); dqu += dS·K
// from dS's repacked C fragments; dqv += Z·Win over the warp's 80 window
// rows; after one barrier dk += dSᵀ·Qu and dv += Pdᵀ·dO for the warp's 16
// key rows (ldmatrix.trans over all four warps' dS and Pd rows), and
// dp += Zᵀ·Qv for two 16-row m-tiles of the window. Atomics: each lane adds four f32
// values with one 16-byte reduction (atomicAdd on float4, sm_90); dp's
// window moves 64 rows a key tile, so its lower half is final after each
// tile and leaves the block once (warps 0-1 and 2-3 swap halves each
// tile) instead of once per tile pair: at the flagship ~3.7 M reductions
// a launch where the scalar kernel issued ~18 M atomics. The first walk
// keeps each thread's keep masks of up to 8 key tiles in shared memory
// for the second. 104,448 B of shared memory a block at D 64 (two blocks
// an SM), 255 registers.
//
// Backward in f32 (flash_relpos_bwd_kernel, the CPU-parity dtype): the
// f32 forward's tiling and scalar FMAs, P rebuilt as the f32 forward
// computes it, dk and dv by one f32 atomicAdd an element per tile pair,
// dp per element of each tile pair's window. At D 128 its tiles of 64
// query rows would need 264 KB of shared memory, so it takes 32 rows a
// block there (181,244 B); the bf16 backward at D 128 is this scalar
// kernel too (in bf16 storage, f32 arithmetic), because the tensor-core
// kernel's register accumulators fit only up to D 64.
//
// Head dims: the kernels are built for D in {16, 32, 64, 128}; the
// wrapper (ops/flash_mhsa.py) zero-pads any other D <= 128 to the next of
// them and passes the scale 1/sqrt(D) of the unpadded head, so the zero
// columns change no score. Above D 128 the f32 forward's tiles (and the
// backward's at any row count that keeps 64-wide key tiles) exceed a
// block's 227 KB, and the wrapper raises.
//
// Bound at flagship shapes (B16 T204 E512 H8, bf16): the forward ~1.2
// GFLOP on the rows' lengths and ~11 MB per call, the backward ~2.7x
// the flops and ~21 MB: below the H100's bf16 ridge, so the bytes bound
// both (~3 us and ~6 us). What holds the bf16 backward back (PERF.md):
// the L2's f32 reductions, the first walk, the exponentials and the
// dropout hash, at two blocks of 4 warps an SM; wgmma and TMA are for
// later.
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

// QR query rows a block (64, or 32 at D 128, where 64 rows' tiles would
// not fit): Qu, Qv, dO [QR][D+1]; K, V [TK][D+1]; p window
// [QR+TK-1][D+1]; dS, Pd [QR][TK+1]
template <int D, int QR> constexpr int bwd_smem_floats() {
  return (3 * QR + 2 * TK + QR + TK - 1) * (D + 1) + 2 * QR * (TK + 1);
}

// (q + bias) rounded to the compute dtype, for rows t0 .. t0+QR-1 of head h
template <typename T, int D, int QR = TQ>
__device__ __forceinline__ void load_q(const T* q, const T* bu, const T* bv,
                                       float* sQu, float* sQv, int b, int h,
                                       int t0, int T_, int E) {
  constexpr int DP = D + 1;
  for (int idx = threadIdx.x; idx < QR * D; idx += NT) {
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
// (QR + TK - 1 rows for a tile of QR query rows)
template <typename T, int D, int QR = TQ>
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
  const int g0 = (T_ - 1) + j0 - t0 - (QR - 1);
  for (int idx = threadIdx.x; idx < (QR + TK - 1) * D; idx += NT) {
    const int w = idx / D, d = idx % D, g = g0 + w;
    sP[w * DP + d] =
        (g >= 0 && g < 2 * T_ - 1) ? to_f<T>(p[(size_t)g * E + h * D + d]) : 0.f;
  }
}

// raw scores of the thread's RxR4 block (R = QR/16 query rows ty*R + i,
// 4 keys tx + 16c): ac = qu·k, bd = qv·p_window
template <int D, int QR = TQ>
__device__ __forceinline__ void tile_scores(const float* sQu, const float* sQv,
                                            const float* sK, const float* sP,
                                            int ty, int tx, float ac[QR / 16][4],
                                            float bd[QR / 16][4]) {
  constexpr int DP = D + 1;
  constexpr int R = QR / 16;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) ac[i][c] = bd[i][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qu[R], qv[R], kc[4];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      qu[i] = sQu[(ty * R + i) * DP + d];
      qv[i] = sQv[(ty * R + i) * DP + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) kc[c] = sK[(tx + 16 * c) * DP + d];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int w = (tx + 16 * c) - (ty * R + i) + (QR - 1);
        ac[i][c] = fmaf(qu[i], kc[c], ac[i][c]);
        bd[i][c] = fmaf(qv[i], sP[w * DP + d], bd[i][c]);
      }
  }
}

__device__ __forceinline__ bool visible(int t, int j, int n, int left, int right) {
  const int rel = j - t;
  return t < n && j < n && (left < 0 || rel >= -left) && (right < 0 || rel <= right);
}

// keys any row of the query tile of QR rows at t0 may see: [j_lo, j_hi)
__device__ __forceinline__ void key_range(int t0, int n, int left, int right,
                                          int* j_lo, int* j_hi, int QR = TQ) {
  *j_lo = left >= 0 ? max(0, t0 - left) : 0;
  *j_hi = right >= 0 ? min(n, t0 + QR + right) : n;
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

// ---- the bf16 forward on the tensor cores (mma.sync.m16n8k16) ----

constexpr int MW = 4;            // warps a block, 16 query rows each
constexpr int MNT = MW * 32;     // threads a block
constexpr int WR = 128;          // window rows staged a key tile (PW used)
constexpr int XW = 80;           // window rows a warp reads: 48-16w .. 127-16w
constexpr int SLD = 88;          // staging row stride (bf16): conflict-free writes

typedef __nv_bfloat16 bf16;

template <int D> struct MmaLayout {
  static constexpr int LD = D + 8;                 // bf16 a staged row (+16 B)
  static constexpr int Q_HALVES = 2 * TQ * LD;     // Qu, Qv
  static constexpr int ST_HALVES = MW * 16 * SLD;  // bd staging, reusing Q's rows
  static constexpr int A_HALVES = Q_HALVES > ST_HALVES ? Q_HALVES : ST_HALVES;
  static constexpr int BYTES = (A_HALVES + (2 * TK + WR) * LD) * 2;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a·b, one m16n8k16 tile: bf16 operands, f32 accumulation
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte asynchronous copy global -> shared; zero-filled when !valid
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// eight bf16 values of a + b, each summed in f32 and rounded to bf16
__device__ __forceinline__ uint4 add_round8(uint4 a, uint4 b) {
  const uint32_t* x = reinterpret_cast<const uint32_t*>(&a);
  const uint32_t* y = reinterpret_cast<const uint32_t*>(&b);
  uint4 r;
  uint32_t* z = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + i));
    const float2 w = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(y + i));
    z[i] = pack_bf16(u.x + w.x, u.y + w.y);
  }
  return r;
}

// Qu = round(q + u) and Qv = round(q + v), rows t0 .. t0+63 of head h
// (zero past T), as bf16 [TQ][LD] tiles
template <int D>
__device__ __forceinline__ void load_q_mma(const bf16* q, const bf16* bu, const bf16* bv,
                                           bf16* sQu, bf16* sQv, int b, int h, int t0,
                                           int T_, int E) {
  constexpr int LD = D + 8, C8 = D / 8;
  for (int idx = threadIdx.x; idx < TQ * C8; idx += MNT) {
    const int r = idx / C8, c = (idx % C8) * 8, t = t0 + r;
    uint4 wu = make_uint4(0, 0, 0, 0), wv = wu;
    if (t < T_) {
      const uint4 qq = *reinterpret_cast<const uint4*>(q + ((size_t)b * T_ + t) * E + h * D + c);
      wu = add_round8(qq, *reinterpret_cast<const uint4*>(bu + h * D + c));
      wv = add_round8(qq, *reinterpret_cast<const uint4*>(bv + h * D + c));
    }
    *reinterpret_cast<uint4*>(sQu + r * LD + c) = wu;
    *reinterpret_cast<uint4*>(sQv + r * LD + c) = wv;
  }
}

// K and V rows j0 .. j0+63 (zero from the valid length n on) and the
// 128-row p window of the (t0, j0) tile pair (zero outside [0, 2T-2]),
// copied with cp.async; returns once every thread's copies have landed
template <int D>
__device__ __forceinline__ void load_tile_mma(const bf16* k, const bf16* v, const bf16* p,
                                              bf16* sK, bf16* sV, bf16* sW, int b, int h,
                                              int t0, int j0, int n, int T_, int E) {
  constexpr int LD = D + 8, C8 = D / 8;
  const int g0 = (T_ - 1) + j0 - t0 - (TQ - 1);
  for (int idx = threadIdx.x; idx < TK * C8; idx += MNT) {
    const int r = idx / C8, c = (idx % C8) * 8, j = j0 + r;
    const bool ok = j < n;
    const size_t off = ok ? ((size_t)b * T_ + j) * E + h * D + c : 0;
    cp16(sK + r * LD + c, k + off, ok);
    cp16(sV + r * LD + c, v + off, ok);
  }
  for (int idx = threadIdx.x; idx < WR * C8; idx += MNT) {
    const int w = idx / C8, c = (idx % C8) * 8, gg = g0 + w;
    const bool ok = w < PW && gg >= 0 && gg < 2 * T_ - 1;
    cp16(sW + w * LD + c, p + (ok ? (size_t)gg * E + h * D + c : 0), ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
}

// A warp's scores against a 64-key tile, the one arithmetic that both
// the forward and the backward use, so that the backward rebuilds the
// forward's scores bit for bit. The position scores raw = Qv·Winᵀ over
// the warp's 80 window rows (48-16w ..) on mma.sync, rounded to bf16 as
// they are written to the warp's staging rows st [16][SLD] (the one
// rounding point of a position score) and read back at column c - i + 15
// (the rel-shift); the content scores ac = Qu·Kᵀ; s = (ac + bd)·scale
// where (t, j) is visible, NEG elsewhere. The callers subtract from s
// with __fsub_rn, which no FMA contraction may absorb, so the forward's
// row max, its exps and lse and the backward's exp(s - lse) all see this
// rounded s.
// Element e of n-tile nt is row g + 8(e/2), column 8nt + 2tg + e%2;
// returns the visible mask, bit 4nt + e.
template <int D>
__device__ __forceinline__ uint32_t warp_scores(
    const uint32_t (&aqu)[D / 16][4], const uint32_t (&aqv)[D / 16][4], const bf16* sK,
    const bf16* sW, bf16* st, int wi, int lane, int t0, int j0, int n, int left,
    int right, float scale, float (&s)[TK / 8][4]) {
  constexpr int LD = D + 8, KS = D / 16;
  const int g = lane >> 2, tg = lane & 3;
  // ldmatrix row and column of this lane for B operands ([n][k] rows)
  const int lr = ((lane >> 4) << 3) + (lane & 7), lc = ((lane >> 3) & 1) * 8;
  const int wbase = (TQ - 16) - 16 * wi;  // first window row the warp reads
#pragma unroll
  for (int pr = 0; pr < XW / 16; ++pr) {
    float c2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t bw[4];
      ldsm_x4(bw, sW + (wbase + pr * 16 + lr) * LD + ks * 16 + lc);
      mma16816(c2[0], aqv[ks], bw[0], bw[1]);
      mma16816(c2[1], aqv[ks], bw[2], bw[3]);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = pr * 16 + e * 8 + 2 * tg;
      *reinterpret_cast<uint32_t*>(st + g * SLD + col) = pack_bf16(c2[e][0], c2[e][1]);
      *reinterpret_cast<uint32_t*>(st + (g + 8) * SLD + col) = pack_bf16(c2[e][2], c2[e][3]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < TK / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int np = 0; np < TK / 16; ++np)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t bk[4];
      ldsm_x4(bk, sK + (np * 16 + lr) * LD + ks * 16 + lc);
      mma16816(s[2 * np], aqu[ks], bk[0], bk[1]);
      mma16816(s[2 * np + 1], aqu[ks], bk[2], bk[3]);
    }
  __syncwarp();
  uint32_t okm = 0;
#pragma unroll
  for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ri = g + (e >> 1) * 8, c = nt * 8 + 2 * tg + (e & 1);
      const float bd = __bfloat162float(st[ri * SLD + c - ri + (16 - 1)]);
      const bool ok = visible(t0 + 16 * wi + ri, j0 + c, n, left, right);
      okm |= (ok ? 1u : 0u) << (nt * 4 + e);
      s[nt][e] = ok ? (s[nt][e] + bd) * scale : NEG;
    }
  return okm;
}

// Up to D 64, three blocks an SM: registers capped at 168 a thread (ptxas
// spills none), where left to itself it took 209 and fitted two.
template <int D>
__global__ void __launch_bounds__(MNT, D <= 64 ? 3 : 1) flash_relpos_fwd_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ p, const bf16* __restrict__ bu,
    const bf16* __restrict__ bv, const int* __restrict__ lens,
    bf16* __restrict__ out, float* __restrict__ lse, int T_, int H, int left,
    int right, float scale, Drop drop) {
  using L = MmaLayout<D>;
  constexpr int LD = L::LD;
  constexpr int KS = D / 16;  // k-steps of the score products
  constexpr int C8 = D / 8;   // output n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQu = reinterpret_cast<bf16*>(smem_raw);
  bf16* sQv = sQu + TQ * LD;
  bf16* sK = sQu + L::A_HALVES;
  bf16* sV = sK + TK * LD;
  bf16* sW = sV + TK * LD;

  const int t0 = blockIdx.x * TQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int E = H * D;
  const int tid = threadIdx.x;
  const int wi = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;  // C fragment: rows g, g+8; columns 2tg, 2tg+1
  int n = lens[b];
  n = n < 0 ? 0 : (n > T_ ? T_ : n);
  const uint32_t key = drop_key(drop.seed, b, h, H);

  float o[C8][4];
#pragma unroll
  for (int c = 0; c < C8; ++c) o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.f;
  float m_r[2] = {NEG, NEG}, l_r[2] = {0.f, 0.f};  // rows g, g+8; l_r per lane

  if (t0 < n) {
    load_q_mma<D>(q, bu, bv, sQu, sQv, b, h, t0, T_, E);
    __syncthreads();
    uint32_t aqu[KS][4], aqv[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int off = (16 * wi + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8;
      ldsm_x4(aqu[ks], sQu + off);
      ldsm_x4(aqv[ks], sQv + off);
    }
    // this warp's bd staging rows: [16][SLD], over the Q rows once all
    // warps hold their fragments (the barrier at the top of each key tile)
    bf16* st = sQu + wi * 16 * SLD;

    int j_lo, j_hi;
    key_range(t0, n, left, right, &j_lo, &j_hi);
    for (int j0 = (j_lo / TK) * TK; j0 < j_hi; j0 += TK) {
      __syncthreads();  // the previous tile's readers are done
      load_tile_mma<D>(k, v, p, sK, sV, sW, b, h, t0, j0, n, T_, E);

      float s[TK / 8][4];
      const uint32_t okm = warp_scores<D>(aqu, aqv, sK, sW, st, wi, lane, t0, j0, n, left,
                                          right, scale, s);
      float mx[2] = {NEG, NEG};
#pragma unroll
      for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_r[r], mx[r]);
        alpha[r] = expf(m_r[r] - m_new);
        m_r[r] = m_new;
        l_r[r] *= alpha[r];
      }
#pragma unroll
      for (int c = 0; c < C8; ++c) {
        o[c][0] *= alpha[0];
        o[c][1] *= alpha[0];
        o[c][2] *= alpha[1];
        o[c][3] *= alpha[1];
      }
      // exps: summed unrounded, rounded to bf16 (dropped ones 0) for P·V
#pragma unroll
      for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ri = g + (e >> 1) * 8, c = nt * 8 + 2 * tg + (e & 1);
          const float ex = (okm >> (nt * 4 + e)) & 1u ? expf(__fsub_rn(s[nt][e], m_r[e >> 1])) : 0.f;
          l_r[e >> 1] += ex;
          const bool kept =
              !drop.on || drop_bits(key, t0 + 16 * wi + ri, j0 + c, T_) <= drop.thr;
          s[nt][e] = kept ? ex : 0.f;
        }
      // O += P·V: the C fragments of key columns 16kk.. are the A fragment
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t bvv[4];
          ldsm_x4_t(bvv, sV + (kk * 16 + (lane & 15)) * LD + dp * 16 + (lane >> 4) * 8);
          mma16816(o[2 * dp], pa, bvv[0], bvv[1]);
          mma16816(o[2 * dp + 1], pa, bvv[2], bvv[3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    const int t = t0 + 16 * wi + g + 8 * r;
    if (t >= T_) continue;
    const float inv = (l_r[r] == 0.f ? 1.f : 1.f / l_r[r]) * drop.scale;
    bf16* orow = out + ((size_t)b * T_ + t) * E + h * D + 2 * tg;
#pragma unroll
    for (int c = 0; c < C8; ++c)
      *reinterpret_cast<uint32_t*>(orow + 8 * c) =
          pack_bf16(o[c][2 * r] * inv, o[c][2 * r + 1] * inv);
    if (lse != nullptr && tg == 0)
      lse[((size_t)b * H + h) * T_ + t] = l_r[r] > 0.f ? m_r[r] + logf(l_r[r]) : 0.f;
  }
}

// P, Pd and dP of the thread's Rx4 block of a (t0, j0) tile pair
template <typename T, int D, int QR>
__device__ __forceinline__ void tile_probs(
    const float* sQu, const float* sQv, const float* sK, const float* sV,
    const float* sP, const float* sdO, const float lse[QR / 16], int ty, int tx,
    int t0, int j0, int n, int left, int right, int T_, float scale,
    uint32_t key, const Drop& drop, float P[QR / 16][4], float Pd[QR / 16][4],
    float dP[QR / 16][4]) {
  constexpr int DP = D + 1;
  constexpr int R = QR / 16;
  float ac[R][4], bd[R][4], dpd[R][4];
  tile_scores<D, QR>(sQu, sQv, sK, sP, ty, tx, ac, bd);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) dpd[i][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float g[R], vc[4];
#pragma unroll
    for (int i = 0; i < R; ++i) g[i] = sdO[(ty * R + i) * DP + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) vc[c] = sV[(tx + 16 * c) * DP + d];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) dpd[i][c] = fmaf(g[i], vc[c], dpd[i][c]);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int t = t0 + ty * R + i;
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

// The scalar backward: QR query rows a block (R = QR/16 a thread), 256
// threads. The f32 backward at every head dim (QR 64, and 32 at D 128,
// whose 64-row tiles would need 264 KB of shared memory), and the bf16
// backward at D 128, where the tensor-core kernel's register accumulators
// (dqu, dqv and the held dp window) do not fit.
template <typename T, int D, int QR>
__global__ void __launch_bounds__(NT) flash_relpos_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ p, const T* __restrict__ bu,
    const T* __restrict__ bv, const int* __restrict__ lens,
    const T* __restrict__ dout, const float* __restrict__ lse_g,
    T* __restrict__ dq, float* __restrict__ dbias, float* __restrict__ dk,
    float* __restrict__ dv, float* __restrict__ dp, int T_, int H, int left,
    int right, float scale, Drop drop) {
  constexpr int DP = D + 1;
  constexpr int SP = TK + 1;
  constexpr int DC = D / 16;
  constexpr int R = QR / 16;         // query rows a thread
  constexpr int PWQ = QR + TK - 1;   // rows of the p window
  extern __shared__ float smem[];
  float* sQu = smem;
  float* sQv = sQu + QR * DP;
  float* sdO = sQv + QR * DP;
  float* sK = sdO + QR * DP;
  float* sV = sK + TK * DP;
  float* sP = sV + TK * DP;
  float* sDS = sP + PWQ * DP;
  float* sPd = sDS + QR * SP;

  const int t0 = blockIdx.x * QR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int E = H * D;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  int n = lens[b];
  n = n < 0 ? 0 : (n > T_ ? T_ : n);
  const uint32_t key = drop_key(drop.seed, b, h, H);

  float gqu[R][DC], gqv[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) gqu[i][c] = gqv[i][c] = 0.f;

  if (t0 < n) {
    load_q<T, D, QR>(q, bu, bv, sQu, sQv, b, h, t0, T_, E);
    for (int idx = tid; idx < QR * D; idx += NT) {
      const int r = idx / D, d = idx % D, t = t0 + r;
      sdO[r * DP + d] =
          t < T_ ? to_f<T>(dout[((size_t)b * T_ + t) * E + h * D + d]) : 0.f;
    }
    float lse[R], delta[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int t = t0 + ty * R + i;
      lse[i] = t < T_ ? lse_g[((size_t)b * H + h) * T_ + t] : 0.f;
      delta[i] = 0.f;
    }
    int j_lo, j_hi;
    key_range(t0, n, left, right, &j_lo, &j_hi, QR);
    const int j_first = (j_lo / TK) * TK;
    float P[R][4], Pd[R][4], dP[R][4];

    // pass 1: delta[t] = sum_j dP[t,j] P[t,j], from the same P and dP the
    // gradients use (the TPU kernel's delta; no rounded O enters it)
    for (int j0 = j_first; j0 < j_hi; j0 += TK) {
      __syncthreads();
      load_kv_window<T, D, QR>(k, v, p, sK, sV, sP, b, h, t0, j0, T_, E);
      __syncthreads();
      tile_probs<T, D, QR>(sQu, sQv, sK, sV, sP, sdO, lse, ty, tx, t0, j0, n, left,
                           right, T_, scale, key, drop, P, Pd, dP);
#pragma unroll
      for (int i = 0; i < R; ++i) {
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
      load_kv_window<T, D, QR>(k, v, p, sK, sV, sP, b, h, t0, j0, T_, E);
      __syncthreads();
      tile_probs<T, D, QR>(sQu, sQv, sK, sV, sP, sdO, lse, ty, tx, t0, j0, n, left,
                           right, T_, scale, key, drop, P, Pd, dP);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = ty * R + i;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int cc = tx + 16 * c;
          sDS[r * SP + cc] = rnd<T>(P[i][c] * (dP[i][c] - delta[i]) * scale);
          sPd[r * SP + cc] = Pd[i][c];
        }
      }
      __syncthreads();

      // dqu, dqv: the thread's R query rows x D/16 columns
#pragma unroll 4
      for (int jj = 0; jj < TK; ++jj) {
        float kv[DC];
#pragma unroll
        for (int c = 0; c < DC; ++c) kv[c] = sK[jj * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int r = ty * R + i;
          const float ds = sDS[r * SP + jj];
          const float* pw = sP + (jj - r + (QR - 1)) * DP;
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
        for (int r = 0; r < QR; ++r) {
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
      // dp over the window: dp[g0+w] += sum_r dS[r, r+w-(QR-1)] qv[r]
      {
        const int g0 = (T_ - 1) + j0 - t0 - (QR - 1);
        for (int idx = tid; idx < PWQ * D; idx += NT) {
          const int w = idx / D, d = idx % D, g = g0 + w;
          if (g < 0 || g >= 2 * T_ - 1) continue;
          const int r_lo = max(0, (QR - 1) - w);
          const int r_hi = min(QR, (QR - 1) - w + TK);
          float acc = 0.f;
          for (int r = r_lo; r < r_hi; ++r)
            acc = fmaf(sDS[r * SP + r + w - (QR - 1)], sQv[r * DP + d], acc);
          if (acc != 0.f) atomicAdd(dp + (size_t)g * E + h * D + d, acc);
        }
      }
    }
  }

  // dq = dqu + dqv; the bias gradients are dqu's and dqv's column sums
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int t = t0 + ty * R + i;
    if (t >= T_) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      dq[((size_t)b * T_ + t) * E + h * D + tx + 16 * c] = from_f<T>(gqu[i][c] + gqv[i][c]);
  }
#pragma unroll
  for (int c = 0; c < DC; ++c) {
    float su = 0.f, sv = 0.f;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      su += gqu[i][c];
      sv += gqv[i][c];
    }
    if (su != 0.f) atomicAdd(dbias + h * D + tx + 16 * c, su);
    if (sv != 0.f) atomicAdd(dbias + E + h * D + tx + 16 * c, sv);
  }
}

// ---- the bf16 backward on the tensor cores (mma.sync.m16n8k16) ----

constexpr int SD = TK + 8;         // dS / Pd row stride (bf16): 64 key columns + 16 B
constexpr int ZLD = WR + 8;        // Z row stride (bf16): 128 window columns + 16 B
constexpr int WREG = 2 * 16 * SD;  // a warp's dS and Pd rows; its bd staging reuses them
constexpr int KEEP_TILES = 8;      // key tiles whose dropout masks the first walk keeps
static_assert(16 * SLD <= WREG, "a warp's bd staging fits its dS and Pd rows");

template <int D> struct BwdLayout {
  static constexpr int LD = D + 8;
  // Qu, Qv, dO [TQ][LD]; K, V [TK][LD]; window [WR][LD]; per warp dS and
  // Pd [2][16][SD]; Z [TQ][ZLD]; then each thread's keep masks [KEEP_TILES][MNT]
  static constexpr int BYTES =
      ((3 * TQ + 2 * TK + WR) * LD + MW * WREG + TQ * ZLD) * 2 + KEEP_TILES * MNT * 4;
};

// Adds a warp's 16x8 C-fragment tile into f32 rows with one 16-byte
// reduction a lane: lanes pair up within their quad, the even one adds
// row g at columns 2tg .. 2tg+3, the odd one row g+8 at 2tg-2 .. 2tg+1.
// row_lo / row_hi point at the tile's first column of rows g and g+8
// (ignored where ok_lo / ok_hi is false); all-zero quads are not added.
__device__ __forceinline__ void red_frag(float* row_lo, float* row_hi, const float c[4],
                                         int tg, bool ok_lo, bool ok_hi) {
  const bool odd = tg & 1;
  const float x0 = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
  const float x1 = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
  const float4 val = odd ? make_float4(x0, x1, c[2], c[3]) : make_float4(c[0], c[1], x0, x1);
  if (!(odd ? ok_hi : ok_lo)) return;
  if (val.x == 0.f && val.y == 0.f && val.z == 0.f && val.w == 0.f) return;
  atomicAdd(reinterpret_cast<float4*>(odd ? row_hi + 2 * tg - 2 : row_lo + 2 * tg), val);
}

// A warp's P = exp(s - lse) (0 where not visible) and dP = keep ?
// (dO·Vᵀ)·drop.scale : 0 against the staged key tile, s by the forward's
// arithmetic (warp_scores); returns the keep mask, bit 4nt + e, drawn
// from the dropout hash unless ``cached`` holds it already. The
// exponential is the hardware's ex2 (__expf, a few ulp): the full-range
// expf took a fifth of the kernel's time, and exp(0) is 1 either way.
// P exactly 1 where a row's only visible score equals its lse.
template <int D>
__device__ __forceinline__ uint32_t warp_probs(
    const bf16* sQu, const bf16* sQv, const bf16* sdO, const bf16* sK, const bf16* sV,
    const bf16* sW, bf16* st, int wi, int lane, int t0, int j0, int n, int left, int right,
    int T_, float scale, uint32_t key, const Drop& drop, const uint32_t* cached,
    const float (&lse)[2], float (&P)[TK / 8][4], float (&dP)[TK / 8][4]) {
  constexpr int LD = D + 8, KS = D / 16;
  const int g = lane >> 2, tg = lane & 3;
  const int lr = ((lane >> 4) << 3) + (lane & 7), lc = ((lane >> 3) & 1) * 8;
  const int arow = (16 * wi + (lane & 15)) * LD + (lane >> 4) * 8;
  uint32_t okm;
  {
    uint32_t aqu[KS][4], aqv[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      ldsm_x4(aqu[ks], sQu + arow + ks * 16);
      ldsm_x4(aqv[ks], sQv + arow + ks * 16);
    }
    okm = warp_scores<D>(aqu, aqv, sK, sW, st, wi, lane, t0, j0, n, left, right, scale, P);
  }
  uint32_t ado[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) ldsm_x4(ado[ks], sdO + arow + ks * 16);
#pragma unroll
  for (int nt = 0; nt < TK / 8; ++nt) dP[nt][0] = dP[nt][1] = dP[nt][2] = dP[nt][3] = 0.f;
#pragma unroll
  for (int np = 0; np < TK / 16; ++np)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t bv[4];
      ldsm_x4(bv, sV + (np * 16 + lr) * LD + ks * 16 + lc);
      mma16816(dP[2 * np], ado[ks], bv[0], bv[1]);
      mma16816(dP[2 * np + 1], ado[ks], bv[2], bv[3]);
    }
  uint32_t keepm = ~0u;
  if (cached != nullptr) {
    keepm = *cached;
  } else if (drop.on) {
    keepm = 0;
#pragma unroll
    for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = g + (e >> 1) * 8, c = nt * 8 + 2 * tg + (e & 1);
        keepm |= (drop_bits(key, t0 + 16 * wi + ri, j0 + c, T_) <= drop.thr ? 1u : 0u)
                 << (nt * 4 + e);
      }
  }
#pragma unroll
  for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      P[nt][e] = (okm >> (nt * 4 + e)) & 1u ? __expf(__fsub_rn(P[nt][e], lse[e >> 1])) : 0.f;
      dP[nt][e] = (keepm >> (nt * 4 + e)) & 1u ? dP[nt][e] * drop.scale : 0.f;
    }
  return keepm;
}

// Query-major, as the forward: a block of 4 warps per (64-row query
// tile, head, batch row), warp w owning rows 16w .. 16w+15, dqu and dqv in
// registers. Two walks over the key tiles: the first sums delta =
// rowsum(dP ∘ P), the second forms dS = P (dP - delta) scale, rounds it to
// bf16 once and runs the five products on mma.sync. dk and dv of the tile
// and dp of the window rows that no later tile reaches leave the block by
// 16-byte f32 reductions. Registers: capped at 255 by two blocks an SM,
// which the shared memory (104,448 B at D 64) allows.
template <int D>
__global__ void __launch_bounds__(MNT, 2) flash_relpos_bwd_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ p, const bf16* __restrict__ bu, const bf16* __restrict__ bv,
    const int* __restrict__ lens, const bf16* __restrict__ dout,
    const float* __restrict__ lse_g, bf16* __restrict__ dq, float* __restrict__ dbias,
    float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dp, int T_, int H,
    int left, int right, float scale, Drop drop) {
  using L = BwdLayout<D>;
  constexpr int LD = L::LD;
  constexpr int KS = D / 16;
  constexpr int C8 = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQu = reinterpret_cast<bf16*>(smem_raw);
  bf16* sQv = sQu + TQ * LD;
  bf16* sdO = sQv + TQ * LD;
  bf16* sK = sdO + TQ * LD;
  bf16* sV = sK + TK * LD;
  bf16* sW = sV + TK * LD;
  bf16* sR = sW + WR * LD;    // per warp: dS rows [16][SD], then Pd rows [16][SD]
  bf16* sZ = sR + MW * WREG;  // Z [TQ][ZLD]: Z[r][w] = dS[r][w + r - 63], 0 off the band
  // each thread's keep masks of the first KEEP_TILES key tiles, drawn in
  // the first walk and read back in the second
  uint32_t* sKeep = reinterpret_cast<uint32_t*>(sZ + TQ * ZLD);

  const int t0 = blockIdx.x * TQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int E = H * D;
  const int tid = threadIdx.x;
  const int wi = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  // ldmatrix row and column of this lane for transposed A operands ([k][m] rows)
  const int lr = ((lane >> 4) << 3) + (lane & 7), lc = ((lane >> 3) & 1) * 8;
  int n = lens[b];
  n = n < 0 ? 0 : (n > T_ ? T_ : n);
  const uint32_t key = drop_key(drop.seed, b, h, H);

  float gqu[C8][4], gqv[C8][4];
#pragma unroll
  for (int c = 0; c < C8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) gqu[c][e] = gqv[c][e] = 0.f;

  if (t0 < n) {
    load_q_mma<D>(q, bu, bv, sQu, sQv, b, h, t0, T_, E);
    for (int idx = tid; idx < TQ * (D / 8); idx += MNT) {
      const int r = idx / (D / 8), c = (idx % (D / 8)) * 8, t = t0 + r;
      const bool ok = t < T_;
      cp16(sdO + r * LD + c, dout + (ok ? ((size_t)b * T_ + t) * E + h * D + c : 0), ok);
    }
    // Z's band is rewritten every tile; outside it Z stays 0
    for (int idx = tid; idx < TQ * ZLD / 8; idx += MNT)
      reinterpret_cast<uint4*>(sZ)[idx] = make_uint4(0, 0, 0, 0);
    float lse[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = t0 + 16 * wi + g + 8 * r;
      lse[r] = t < T_ ? lse_g[((size_t)b * H + h) * T_ + t] : 0.f;
    }
    bf16* st = sR + wi * WREG;  // the warp's dS rows; its bd staging first
    int j_lo, j_hi;
    key_range(t0, n, left, right, &j_lo, &j_hi);
    const int j_first = (j_lo / TK) * TK;

    // walk 1: delta = rowsum(dP ∘ P), from the very P and dP the gradients
    // use (the TPU kernel's delta)
    float delta[2] = {0.f, 0.f};
    for (int j0 = j_first, it = 0; j0 < j_hi; j0 += TK, ++it) {
      __syncthreads();  // the previous tile's readers are done
      load_tile_mma<D>(k, v, p, sK, sV, sW, b, h, t0, j0, n, T_, E);
      float P[TK / 8][4], dP[TK / 8][4];
      const uint32_t keepm = warp_probs<D>(sQu, sQv, sdO, sK, sV, sW, st, wi, lane, t0, j0,
                                           n, left, right, T_, scale, key, drop, nullptr,
                                           lse, P, dP);
      if (it < KEEP_TILES) sKeep[it * MNT + tid] = keepm;
#pragma unroll
      for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) delta[e >> 1] = fmaf(dP[nt][e], P[nt][e], delta[e >> 1]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 1);
      delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 2);
    }

    // walk 2: the gradients. gdp holds two 16-row m-tiles of the window's
    // dp: the window moves 64 rows a key tile, so its lower half is final
    // after each tile and its upper half is the next tile's lower half.
    // Warps 0-1 hold one half and warps 2-3 the other, swapping roles each
    // tile: the holders of the lower half add it to dp and start afresh.
    float gdp[2][C8][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int c = 0; c < C8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) gdp[m][c][e] = 0.f;
    for (int j0 = j_first, it = 0; j0 < j_hi; j0 += TK, ++it) {
      __syncthreads();  // the previous tile's readers are done
      load_tile_mma<D>(k, v, p, sK, sV, sW, b, h, t0, j0, n, T_, E);
      float P[TK / 8][4], dP[TK / 8][4];
      const uint32_t keepm = warp_probs<D>(
          sQu, sQv, sdO, sK, sV, sW, st, wi, lane, t0, j0, n, left, right, T_, scale, key,
          drop, drop.on && it < KEEP_TILES ? sKeep + it * MNT + tid : nullptr, lse, P, dP);
      __syncwarp();  // the staging rows under st are read
      // dS = P (dP - delta) scale, rounded to bf16 once (the TPU kernel's
      // dSc): register pairs for dqu, the warp's dS rows for dk, its band
      // of Z for dqv and dp; Pd = keep ? P / (1 - rate) : 0 for dv
      uint32_t ds[TK / 8][2];
#pragma unroll
      for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int e0 = 2 * rh, ri = g + 8 * rh, c = nt * 8 + 2 * tg;
          ds[nt][rh] = pack_bf16(P[nt][e0] * (dP[nt][e0] - delta[rh]) * scale,
                                 P[nt][e0 + 1] * (dP[nt][e0 + 1] - delta[rh]) * scale);
          const bool k0 = (keepm >> (nt * 4 + e0)) & 1u, k1 = (keepm >> (nt * 4 + e0 + 1)) & 1u;
          *reinterpret_cast<uint32_t*>(st + ri * SD + c) = ds[nt][rh];
          *reinterpret_cast<uint32_t*>(st + (16 + ri) * SD + c) =
              pack_bf16(k0 ? P[nt][e0] * drop.scale : 0.f, k1 ? P[nt][e0 + 1] * drop.scale : 0.f);
          unsigned short* zr = reinterpret_cast<unsigned short*>(
              sZ + (16 * wi + ri) * ZLD + (TQ - 1) - (16 * wi + ri) + c);
          zr[0] = (unsigned short)(ds[nt][rh] & 0xffffu);
          zr[1] = (unsigned short)(ds[nt][rh] >> 16);
        }
      __syncwarp();
      // dqu += dS·K: dS's C fragments repacked as A fragments, K by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        const uint32_t pa[4] = {ds[2 * kk][0], ds[2 * kk][1], ds[2 * kk + 1][0],
                                ds[2 * kk + 1][1]};
#pragma unroll
        for (int d2 = 0; d2 < KS; ++d2) {
          uint32_t bk[4];
          ldsm_x4_t(bk, sK + (kk * 16 + (lane & 15)) * LD + d2 * 16 + (lane >> 4) * 8);
          mma16816(gqu[2 * d2], pa, bk[0], bk[1]);
          mma16816(gqu[2 * d2 + 1], pa, bk[2], bk[3]);
        }
      }
      // dqv += Z·Win over the warp's 80 window rows (the forward's bd rows)
      {
        const int wbase = (TQ - 16) - 16 * wi;
#pragma unroll
        for (int ks = 0; ks < XW / 16; ++ks) {
          uint32_t az[4];
          ldsm_x4(az, sZ + (16 * wi + (lane & 15)) * ZLD + wbase + ks * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int d2 = 0; d2 < KS; ++d2) {
            uint32_t bw[4];
            ldsm_x4_t(bw, sW + (wbase + ks * 16 + (lane & 15)) * LD + d2 * 16 + (lane >> 4) * 8);
            mma16816(gqv[2 * d2], az, bw[0], bw[1]);
            mma16816(gqv[2 * d2 + 1], az, bw[2], bw[3]);
          }
        }
      }
      __syncthreads();  // every warp's dS, Pd and Z rows are written

      // dk += dSᵀ·Qu and dv += Pdᵀ·dO for key rows j0+16w .., over the 64
      // query rows (k-step ks reads warp ks's dS and Pd rows)
      if (j0 + 16 * wi < n) {
        float ak[C8][4], av[C8][4];
#pragma unroll
        for (int c = 0; c < C8; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) ak[c][e] = av[c][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < TQ / 16; ++ks) {
          if (t0 + 16 * ks >= n) break;  // rows past the length: dS = Pd = 0
          const bf16* rg = sR + ks * WREG;
          uint32_t ads[4], apd[4];
          ldsm_x4_t(ads, rg + lr * SD + 16 * wi + lc);
          ldsm_x4_t(apd, rg + (16 + lr) * SD + 16 * wi + lc);
#pragma unroll
          for (int d2 = 0; d2 < KS; ++d2) {
            const int off = (16 * ks + (lane & 15)) * LD + d2 * 16 + (lane >> 4) * 8;
            uint32_t bq[4], bo[4];
            ldsm_x4_t(bq, sQu + off);
            ldsm_x4_t(bo, sdO + off);
            mma16816(ak[2 * d2], ads, bq[0], bq[1]);
            mma16816(ak[2 * d2 + 1], ads, bq[2], bq[3]);
            mma16816(av[2 * d2], apd, bo[0], bo[1]);
            mma16816(av[2 * d2 + 1], apd, bo[2], bo[3]);
          }
        }
        const int jl = j0 + 16 * wi + g, jh = jl + 8;
        const size_t ol = ((size_t)b * T_ + (jl < n ? jl : 0)) * E + h * D;
        const size_t oh = ((size_t)b * T_ + (jh < n ? jh : 0)) * E + h * D;
#pragma unroll
        for (int c = 0; c < C8; ++c) {
          red_frag(dk + ol + 8 * c, dk + oh + 8 * c, ak[c], tg, jl < n, jh < n);
          red_frag(dv + ol + 8 * c, dv + oh + 8 * c, av[c], tg, jl < n, jh < n);
        }
      }

      // dp += Zᵀ·Qv over the warp's two m-tiles of window rows: half hf,
      // m-tiles 2(w % 2) and 2(w % 2) + 1 of it
      {
        const int hf = (wi >> 1) ^ (it & 1);
        const int g0 = (T_ - 1) + j0 - t0 - (TQ - 1);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int mt = 4 * hf + 2 * (wi & 1) + m;
#pragma unroll
          for (int ks = 0; ks < TQ / 16; ++ks) {
            uint32_t az[4];
            ldsm_x4_t(az, sZ + (16 * ks + lr) * ZLD + 16 * mt + lc);
#pragma unroll
            for (int d2 = 0; d2 < KS; ++d2) {
              uint32_t bq[4];
              ldsm_x4_t(bq, sQv + (16 * ks + (lane & 15)) * LD + d2 * 16 + (lane >> 4) * 8);
              mma16816(gdp[m][2 * d2], az, bq[0], bq[1]);
              mma16816(gdp[m][2 * d2 + 1], az, bq[2], bq[3]);
            }
          }
        }
        if (hf == 0 || j0 + TK >= j_hi) {  // final: no later tile reaches these rows
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const int mt = 4 * hf + 2 * (wi & 1) + m;
            const int gl = g0 + 16 * mt + g, gh = gl + 8;
            const bool okl = gl >= 0 && gl < 2 * T_ - 1, okh = gh >= 0 && gh < 2 * T_ - 1;
            const size_t ol = (size_t)(okl ? gl : 0) * E + h * D;
            const size_t oh = (size_t)(okh ? gh : 0) * E + h * D;
#pragma unroll
            for (int c = 0; c < C8; ++c) {
              red_frag(dp + ol + 8 * c, dp + oh + 8 * c, gdp[m][c], tg, okl, okh);
              gdp[m][c][0] = gdp[m][c][1] = gdp[m][c][2] = gdp[m][c][3] = 0.f;
            }
          }
        }
      }
    }
  }

  // dq = dqu + dqv, rounded once
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t0 + 16 * wi + g + 8 * r;
    if (t >= T_) continue;
    bf16* row = dq + ((size_t)b * T_ + t) * E + h * D + 2 * tg;
#pragma unroll
    for (int c = 0; c < C8; ++c)
      *reinterpret_cast<uint32_t*>(row + 8 * c) =
          pack_bf16(gqu[c][2 * r] + gqv[c][2 * r], gqu[c][2 * r + 1] + gqv[c][2 * r + 1]);
  }
  // the bias gradients: dqu's and dqv's column sums over the warp's rows
  // (rows past the length hold 0), one 8-byte reduction a column pair
  if (t0 >= n) return;
#pragma unroll
  for (int c = 0; c < C8; ++c) {
    float s4[4] = {gqu[c][0] + gqu[c][2], gqu[c][1] + gqu[c][3], gqv[c][0] + gqv[c][2],
                   gqv[c][1] + gqv[c][3]};
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) s4[e] += __shfl_xor_sync(0xffffffffu, s4[e], off);
    if (g == 0) {
      const int col = h * D + 8 * c + 2 * tg;
      atomicAdd(reinterpret_cast<float2*>(dbias + col), make_float2(s4[0], s4[1]));
      atomicAdd(reinterpret_cast<float2*>(dbias + E + col), make_float2(s4[2], s4[3]));
    }
  }
}

// four f32 values stored as T
__device__ __forceinline__ void store4(float* y, float4 a) { *reinterpret_cast<float4*>(y) = a; }
__device__ __forceinline__ void store4(bf16* y, float4 a) {
  *reinterpret_cast<uint2*>(y) = make_uint2(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w));
}

// The backward's outputs from its f32 sums acc = [dk | dv | dp | d_bias_u |
// d_bias_v] (lengths bte, bte, pe, e, e, each a multiple of 4): dk, dv and
// dp in the compute dtype T, the bias gradients in f32; four values a
// thread a step
template <typename T>
__global__ void bwd_finish_kernel(const float* __restrict__ acc, T* __restrict__ dk,
                                  T* __restrict__ dv, T* __restrict__ dp,
                                  float* __restrict__ dbu, float* __restrict__ dbv,
                                  size_t bte, size_t pe, size_t e) {
  const size_t n = 2 * bte + pe + 2 * e;
  for (size_t i = 4 * (blockIdx.x * (size_t)blockDim.x + threadIdx.x); i < n;
       i += 4 * (size_t)gridDim.x * blockDim.x) {
    const float4 a = *reinterpret_cast<const float4*>(acc + i);
    if (i < bte) store4(dk + i, a);
    else if (i < 2 * bte) store4(dv + i - bte, a);
    else if (i < 2 * bte + pe) store4(dp + i - 2 * bte, a);
    else if (i < 2 * bte + pe + e) store4(dbu + i - 2 * bte - pe, a);
    else store4(dbv + i - 2 * bte - pe - e, a);
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

template <int D>
cudaError_t launch_fwd_f32(const void* q, const void* k, const void* v,
                           const void* p, const void* bu, const void* bv,
                           const void* lens, void* out, float* lse, int B,
                           int T_, int H, int left, int right, float scale,
                           Drop drop, cudaStream_t stream) {
  const int smem = fwd_smem_floats<D>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_relpos_fwd_kernel<float, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((T_ + TQ - 1) / TQ, H, B);
  flash_relpos_fwd_kernel<float, D><<<grid, NT, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)p,
      (const float*)bu, (const float*)bv, (const int*)lens, (float*)out, lse, T_,
      H, left, right, scale, drop);
  return cudaGetLastError();
}

// the scalar backward in T at head dim D, QR query rows a block
template <typename T, int D, int QR>
cudaError_t launch_bwd_scalar(const void* q, const void* k, const void* v,
                              const void* p, const void* bu, const void* bv,
                              const void* lens, const void* dout, const float* lse,
                              void* dq, float* dbias, float* dk, float* dv, float* dp,
                              int B, int T_, int H, int left, int right, float scale,
                              Drop drop, cudaStream_t stream) {
  constexpr int smem = bwd_smem_floats<D, QR>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_relpos_bwd_kernel<T, D, QR>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((T_ + QR - 1) / QR, H, B);
  flash_relpos_bwd_kernel<T, D, QR><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)p, (const T*)bu, (const T*)bv,
      (const int*)lens, (const T*)dout, lse, (T*)dq, dbias, dk, dv, dp, T_, H, left, right,
      scale, drop);
  return cudaGetLastError();
}

// the f32 backward: 64 query rows a block, 32 at D 128
template <int D>
cudaError_t launch_bwd_f32(const void* q, const void* k, const void* v,
                           const void* p, const void* bu, const void* bv,
                           const void* lens, const void* dout,
                           const float* lse, void* dq, float* dbias, float* dk,
                           float* dv, float* dp, int B, int T_, int H, int left,
                           int right, float scale, Drop drop, cudaStream_t stream) {
  return launch_bwd_scalar<float, D, D <= 64 ? TQ : TQ / 2>(
      q, k, v, p, bu, bv, lens, dout, lse, dq, dbias, dk, dv, dp, B, T_, H, left, right,
      scale, drop, stream);
}

template <int D>
cudaError_t launch_bwd_mma(const void* q, const void* k, const void* v,
                           const void* p, const void* bu, const void* bv,
                           const void* lens, const void* dout,
                           const float* lse, void* dq, float* dbias, float* dk,
                           float* dv, float* dp, int B, int T_, int H, int left,
                           int right, float scale, Drop drop, cudaStream_t stream) {
  if constexpr (D > 64) {
    // the tensor-core kernel's register accumulators (dqu, dqv and the
    // held dp window) fit up to D 64: the scalar kernel, 32 rows a block
    return launch_bwd_scalar<bf16, D, TQ / 2>(q, k, v, p, bu, bv, lens, dout, lse, dq,
                                              dbias, dk, dv, dp, B, T_, H, left, right,
                                              scale, drop, stream);
  } else {
    constexpr int smem = BwdLayout<D>::BYTES;
    // every call: the attribute is the current device's
    cudaError_t e = cudaFuncSetAttribute(flash_relpos_bwd_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    dim3 grid((T_ + TQ - 1) / TQ, H, B);
    flash_relpos_bwd_mma_kernel<D><<<grid, MNT, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)p, (const bf16*)bu,
        (const bf16*)bv, (const int*)lens, (const bf16*)dout, lse, (bf16*)dq, dbias, dk,
        dv, dp, T_, H, left, right, scale, drop);
    return cudaGetLastError();
  }
}

template <int D>
cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v,
                           const void* p, const void* bu, const void* bv,
                           const void* lens, void* out, float* lse, int B,
                           int T_, int H, int left, int right, float scale,
                           Drop drop, cudaStream_t stream) {
  constexpr int smem = MmaLayout<D>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(flash_relpos_fwd_mma_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((T_ + TQ - 1) / TQ, H, B);
  flash_relpos_fwd_mma_kernel<D><<<grid, MNT, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)p, (const bf16*)bu,
      (const bf16*)bv, (const int*)lens, (bf16*)out, lse, T_, H, left, right, scale, drop);
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
#define FWD(LAUNCH, DD) \
  LAUNCH<DD>(q, k, v, p, bu, bv, lens, out, l, B, T_, H, left, right, scale, dr, s)
#define FWD_D(LAUNCH)                                 \
  switch (D) {                                        \
    case 16: return (int)FWD(LAUNCH, 16);             \
    case 32: return (int)FWD(LAUNCH, 32);             \
    case 64: return (int)FWD(LAUNCH, 64);             \
    case 128: return (int)FWD(LAUNCH, 128);           \
    default: return (int)cudaErrorInvalidValue;       \
  }
  if (dtype == 0) {
    FWD_D(launch_fwd_f32)
  } else if (dtype == 1) {
    FWD_D(launch_fwd_mma)
  }
#undef FWD_D
#undef FWD
  return (int)cudaErrorInvalidValue;
}

// acc [2·B·T·E + (2T-1)·E + 2E] f32 scratch: zeroed here, the kernel adds
// dk, dv, dp and the two bias gradients into it, and a second launch
// writes them to dk, dv, dp (in the compute dtype) and dbu, dbv (f32)
extern "C" int flash_relpos_bwd(const void* q, const void* k, const void* v,
                                const void* p, const void* bu, const void* bv,
                                const void* lens, const void* dout,
                                const void* lse, void* dq, void* dk_out, void* dv_out,
                                void* dp_out, void* dbu, void* dbv, void* acc,
                                int B, int T_, int H, int D, int left, int right,
                                float scale, unsigned seed, unsigned thr,
                                float drop_scale, int use_drop, int dtype,
                                void* stream) {
  if (B == 0 || T_ == 0) return (int)cudaSuccess;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Drop dr = make_drop(seed, thr, drop_scale, use_drop);
  const size_t E = (size_t)H * D, bte = (size_t)B * T_ * E, n = 2 * bte + (2 * (size_t)T_ - 1) * E;
  float* dk = (float*)acc;
  float* dv = dk + bte;
  float* dp = dk + 2 * bte;
  float* dbias = dk + n;
  cudaError_t e = cudaMemsetAsync(acc, 0, (n + 2 * E) * sizeof(float), s);
  if (e != cudaSuccess) return (int)e;
#define BWD(LAUNCH, DD)                                                                 \
  LAUNCH<DD>(q, k, v, p, bu, bv, lens, dout, (const float*)lse, dq, dbias, dk, dv, dp, B, \
             T_, H, left, right, scale, dr, s)
#define BWD_D(LAUNCH)                               \
  switch (D) {                                      \
    case 16: e = BWD(LAUNCH, 16); break;            \
    case 32: e = BWD(LAUNCH, 32); break;            \
    case 64: e = BWD(LAUNCH, 64); break;            \
    case 128: e = BWD(LAUNCH, 128); break;          \
    default: return (int)cudaErrorInvalidValue;     \
  }
  if (dtype == 0) {
    BWD_D(launch_bwd_f32)
  } else {
    BWD_D(launch_bwd_mma)
  }
#undef BWD_D
#undef BWD
  if (e != cudaSuccess) return (int)e;
  const size_t n4 = (n + 2 * E) / 4;  // E is a multiple of 16
  const int blocks = (int)((n4 + 255) / 256 < 1056 ? (n4 + 255) / 256 : 1056);
  if (dtype == 0)
    bwd_finish_kernel<float><<<blocks, 256, 0, s>>>(dk, (float*)dk_out, (float*)dv_out,
                                                    (float*)dp_out, (float*)dbu,
                                                    (float*)dbv, bte, n - 2 * bte, E);
  else
    bwd_finish_kernel<bf16><<<blocks, 256, 0, s>>>(dk, (bf16*)dk_out, (bf16*)dv_out,
                                                   (bf16*)dp_out, (float*)dbu, (float*)dbv,
                                                   bte, n - 2 * bte, E);
  return (int)cudaGetLastError();
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

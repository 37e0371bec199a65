// Transformer-XL relative-position MHSA forward for Hopper (sm_90a).
//
// Replaces the TPU kernel indic_cl_asr_tpu/ops/flash_mhsa.py:_flash_fwd
// (pl.pallas_call at line 383, body _fwd_kernel at line 197).
//
//   out[b,t,h,:] = sum_j P[t,j] v[b,j,h,:],
//   P = softmax_j(((q+u)·k_j + round(rel_shift((q+v)·pᵀ))[t,j]) / sqrt(D))
//
// masked by the valid length of the row and an optional (left, right)
// band; fully masked rows give 0. Layouts: q, k, v, out [B, T, H*D];
// p [2T-1, H*D] in XL order (row m encodes relative position (T-1)-m);
// bias_u, bias_v [H*D]; lens [B] int32.
//
// Design (a first, simple kernel): one block per (64-row query tile,
// head, batch row), 256 threads, an online softmax over 64-wide key
// tiles. For a (t0, j0) tile pair the rel-shift reads only p rows
// (T-1)+j0-t0-63 ... (T-1)+j0-t0+63, a 127-row window held in shared
// memory; bd[t,j] is the dot of (q+v)[t] with window row
// (j-j0)-(t-t0)+63, computed only for the 64x64 pairs that need it
// (the TPU's strided roll becomes an index; T needs no 128-padding and
// has no cap). Key tiles outside the valid length or the band are
// skipped. Each thread owns a 4x4 block of scores and 4 rows x D/16
// output columns; all sums are f32 (scalar FMAs from shared memory).
//
// Bound at flagship shapes (B16 T204 E512 H8, bf16): ~2 GFLOP and ~13 MB
// per call, below the H100's bf16 ridge, so the bytes bound it (~4 us).
// This kernel runs on the CUDA cores, far from that bound; wgmma, TMA and
// bf16 shared-memory tiles are the next step.
//
// Numerics follow the plain version (ops/flash_mhsa.py): q+u and q+v
// rounded to the compute dtype, f32 dots, the position score rounded once
// to the compute dtype, probabilities rounded to the compute dtype before
// P·V, f32 accumulation, the output rounded once.

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

template <int D> constexpr int smem_floats() {
  // Qu, Qv [TQ][D+1]; K, V [TK][D+1]; p window [PW][D+1]; P tile [TQ][TK+1]
  return (2 * TQ + 2 * TK + PW) * (D + 1) + TQ * (TK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_relpos_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ p, const T* __restrict__ bu,
    const T* __restrict__ bv, const int* __restrict__ lens,
    T* __restrict__ out, int T_, int H, int left, int right, float scale) {
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
    for (int idx = tid; idx < TQ * D; idx += NT) {
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
    // keys that any row of this tile may see
    int j_lo = 0, j_hi = n;
    if (left >= 0) j_lo = max(0, t0 - left);
    if (right >= 0) j_hi = min(n, t0 + TQ + right);
    for (int j0 = (j_lo / TK) * TK; j0 < j_hi; j0 += TK) {
      __syncthreads();  // the previous tile's readers are done
      for (int idx = tid; idx < TK * D; idx += NT) {
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
      for (int idx = tid; idx < PW * D; idx += NT) {
        const int w = idx / D, d = idx % D, g = g0 + w;
        sP[w * DP + d] =
            (g >= 0 && g < 2 * T_ - 1) ? to_f<T>(p[(size_t)g * E + h * D + d]) : 0.f;
      }
      __syncthreads();

      float ac[4][4], bd[4][4];
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

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty * 4 + i;
        float s[4];
        bool ok[4];
        float tmax = NEG;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = j0 + tx + 16 * c;
          const int rel = j - t;
          ok[c] = t < n && j < n && (left < 0 || rel >= -left) &&
                  (right < 0 || rel <= right);
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
          sS[(ty * 4 + i) * SP + tx + 16 * c] = rnd<T>(e);
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
    const float inv = 1.f / (l_i[i] == 0.f ? 1.f : l_i[i]);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      out[((size_t)b * T_ + t) * E + h * D + tx + 16 * c] = from_f<T>(o[i][c] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* p,
                   const void* bu, const void* bv, const void* lens, void* out,
                   int B, int T_, int H, int left, int right, float scale,
                   cudaStream_t stream) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_relpos_fwd_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((T_ + TQ - 1) / TQ, H, B);
  flash_relpos_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)p, (const T*)bu,
      (const T*)bv, (const int*)lens, (T*)out, T_, H, left, right, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const void* p, const void* bu, const void* bv,
                       const void* lens, void* out, int B, int T_, int H,
                       int left, int right, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, p, bu, bv, lens, out, B, T_, H, left, right, scale, s);
    case 32: return launch<T, 32>(q, k, v, p, bu, bv, lens, out, B, T_, H, left, right, scale, s);
    case 64: return launch<T, 64>(q, k, v, p, bu, bv, lens, out, B, T_, H, left, right, scale, s);
    case 128: return launch<T, 128>(q, k, v, p, bu, bv, lens, out, B, T_, H, left, right, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_relpos_fwd(const void* q, const void* k, const void* v,
                                const void* p, const void* bu, const void* bv,
                                const void* lens, void* out, int B, int T_,
                                int H, int D, int left, int right, float scale,
                                int dtype, void* stream) {
  if (B == 0 || T_ == 0) return (int)cudaSuccess;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (dtype == 0)
    e = dispatch_d<float>(D, q, k, v, p, bu, bv, lens, out, B, T_, H, left, right, scale, s);
  else if (dtype == 1)
    e = dispatch_d<__nv_bfloat16>(D, q, k, v, p, bu, bv, lens, out, B, T_, H, left, right, scale, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

extern "C" const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

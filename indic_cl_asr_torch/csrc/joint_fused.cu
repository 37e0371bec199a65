// Fused RNNT joint head, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of indic_cl_asr_tpu/ops/joint_fused_pallas.py:
// _call_fwd (pl.pallas_call at line 201, body _fwd_kernel at line 44) and
// _bwd (pl.pallas_call at line 256, body _bwd_kernel at line 87).
//
// For every (frame t, label position u) pair of batch row b:
//
//   x[h]   = drop(relu(f[b,t,h] + g[b,u,h]))          compute dtype T
//   z[v]   = sum_h x[h] W[b,h,v] + bias[b,v]           f32 accumulation
//   lse    = log sum_v exp(z[v])
//   lpb    = z[blank] - lse,  lpl = z[labels[b,u]] - lse   (f32 slabs)
//
// f [B,T,H] and g [B,U1,H] are in the compute dtype (f32 or bf16) and
// x is rounded to it, as the TPU kernel forms it; the head W [B,H,V1] and
// bias [B,V1] enter as f32, uncast (bf16 input x f32 weight, f32 sums).
// A label outside [0, V1) reads as logit 0, as the TPU kernel's one-hot.
//
// Dropout: the TPU kernel draws its mask from the TPU's PRNG, seeded per
// (batch row, chunk). Here the bits are a counter-based hash, the flash
// kernels' murmur3 finaliser: key = fmix32(seed ^ b*0x9E3779B9),
// bits = fmix32(key ^ fmix32((t*U1 + u)*H + h)) with 32-bit wrap; keep
// where bits <= uint32((1-rate)(2^32-1)), then x = round(x * 1/(1-rate)).
// The bits depend on (seed, b, t, u, h) only, so the forward and the
// backward draw the same mask whatever the tiling, and the plain version
// (ops/joint_fused.py) computes them with int64 tensor ops.
//
// Forward design (a first, simple kernel): one block per (8-frame x
// 8-label tile of pairs, row b), 256 threads. The block forms the 64
// pairs' joint input for all of H once, into shared memory (compute
// dtype), then walks V1 in 64-column tiles: a register-tiled product
// (each thread 4 pairs x 4 columns, W staged 32 rows at a time), the
// logits of the tile to shared memory, and one thread per pair keeps an
// online max and sum over the columns and picks the blank and label
// logits. It writes both slabs and the per-pair log-sum-exp, which the
// backward uses to rebuild the softmax without a second reduction.
//
// Backward design: two kernels.
//   1. dlogits_dinp: per pair tile, the forward's product again (the same
//      loop, so the same logits), dlogits = onehot(blank)*dlpb +
//      onehot(y)*dlpl - softmax*(dlpb+dlpl) written to an f32 scratch
//      [B,T,U1,V1]; then, from that tile reloaded into shared memory,
//      d_x = dlogits . W^T per 64-wide slice of H, masked by relu' and
//      the dropout keep (scaled), summed over the tile's labels into
//      df and over its frames into dg (shared-memory atomics, then one
//      f32 global atomic per value and tile).
//   2. dw_db: one block per (64 x 64 tile of W[b]) walks all T*U1 pairs
//      of row b, rebuilding x from f, g and the hash, dW = x^T . dlogits;
//      the blocks of the first H tile also sum db = sum dlogits.
// The TPU kernel carries dW, db and dg across its sequential chunk grid
// in VMEM; blocks here run in parallel, so dW and db take a second pass
// over the scratch and df, dg take atomics (their last bits vary from run
// to run). dg is accumulated in f32 and rounded once by the caller (the
// TPU kernel adds each chunk into a bf16 buffer).
//
// Bound at the flagship (B16 T204 U1 129 H640 V1 257): the forward is
// 2*421,056 pairs*640*257 = 138.5 GFLOP, the backward three such products
// (415.5 GFLOP), against ~21 MB and ~34 MB of inputs and outputs: far
// above the ridge, so operations bound both. These kernels run scalar f32
// FMAs on the CUDA cores from shared memory (the head is f32); tensor
// cores (wgmma on a bf16 or tf32 head) and TMA are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TT = 8;         // frames per pair tile
constexpr int TU = 8;         // label positions per pair tile
constexpr int BM = TT * TU;   // pairs per tile
constexpr int BN = 64;        // columns (V1 or H) per register tile
constexpr int BK = 32;        // depth staged per step
constexpr int WS = BN + 4;    // padded row of a staged tile (16-byte rows)
constexpr int NT = 256;       // threads: 16 x 16, each 4 rows x 4 columns
constexpr int SMEM_MAX = 232448;  // bytes a block may use on an H100

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

// four consecutive values of a shared-memory row, as f32
__device__ __forceinline__ void load4(const float* p, float a[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float a[4]) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 lo = __bfloat1622float2(q[0]);
  const float2 hi = __bfloat1622float2(q[1]);
  a[0] = lo.x; a[1] = lo.y; a[2] = hi.x; a[3] = hi.y;
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t row_key(uint32_t seed, int b) {
  return fmix32(seed ^ ((uint32_t)b * 0x9E3779B9u));
}

__device__ __forceinline__ uint32_t drop_bits(uint32_t key, int t, int u, int h,
                                              int U1, int H) {
  return fmix32(key ^ fmix32(((uint32_t)t * (uint32_t)U1 + (uint32_t)u) *
                                 (uint32_t)H + (uint32_t)h));
}

struct Dims {
  int T, U1, H, V1, blank;
};

struct Drop {
  uint32_t seed;   // per-call seed
  uint32_t thr;    // keep when bits <= thr
  float scale;     // 1 / (1 - rate)
  int on;
};

// pre = round(f + g) and the joint input x = drop(relu(pre)) of one
// (t, u, h); ``grad`` is d x / d pre (0, 1 or the dropout scale)
template <typename T>
__device__ __forceinline__ float joint_input(const T* __restrict__ f,
                                             const T* __restrict__ g, int b,
                                             int t, int u, int h, const Dims& dm,
                                             const Drop& dr, uint32_t key,
                                             float* grad) {
  const float pre = rnd<T>(to_f<T>(f[((size_t)b * dm.T + t) * dm.H + h]) +
                           to_f<T>(g[((size_t)b * dm.U1 + u) * dm.H + h]));
  float x = pre > 0.f ? pre : 0.f;
  float d = pre > 0.f ? 1.f : 0.f;
  if (dr.on) {
    const bool keep = drop_bits(key, t, u, h, dm.U1, dm.H) <= dr.thr;
    x = keep ? rnd<T>(x * dr.scale) : 0.f;
    d = keep ? d * dr.scale : 0.f;
  }
  *grad = d;
  return x;
}

// the 64 pairs' joint input for all of H, [H][BM] in the compute dtype
template <typename T>
__device__ void form_inputs(T* Xs, const T* f, const T* g, int b, int t0, int u0,
                            const Dims& dm, const Drop& dr, uint32_t key) {
  for (int idx = threadIdx.x; idx < dm.H * BM; idx += NT) {
    const int h = idx / BM, p = idx % BM;
    const int t = t0 + p / TU, u = u0 + p % TU;
    float x = 0.f, d;
    if (t < dm.T && u < dm.U1) x = joint_input<T>(f, g, b, t, u, h, dm, dr, key, &d);
    Xs[idx] = from_f<T>(x);
  }
}

// acc[i][j] = sum_h Xs[h][ty*4+i] * W[b, h, c0+tx*4+j] over all of H;
// columns at or past V1 read W as 0
template <typename T>
__device__ void logits_tile(float acc[4][4], const T* Xs, float* Ws,
                            const float* __restrict__ w, int b, int c0,
                            const Dims& dm) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < dm.H; k0 += BK) {
    __syncthreads();  // the previous stage's readers are done
    for (int idx = threadIdx.x; idx < BK * BN; idx += NT) {
      const int kk = idx / BN, c = idx % BN;
      const int k = k0 + kk, v = c0 + c;
      Ws[kk * WS + c] = (k < dm.H && v < dm.V1) ? w[((size_t)b * dm.H + k) * dm.V1 + v] : 0.f;
    }
    __syncthreads();
    const int kn = dm.H - k0 < BK ? dm.H - k0 : BK;
    for (int kk = 0; kk < kn; ++kk) {
      float a[4], wv[4];
      load4(Xs + (size_t)(k0 + kk) * BM + ty * 4, a);
      load4(Ws + kk * WS + tx * 4, wv);
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], wv[j], acc[i][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
joint_fwd_kernel(const T* __restrict__ f, const T* __restrict__ g,
                 const float* __restrict__ w, const float* __restrict__ bias,
                 const int* __restrict__ labels, float* __restrict__ lpb,
                 float* __restrict__ lpl, float* __restrict__ lse_out, Dims dm,
                 Drop dr, int xs_bytes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Xs = reinterpret_cast<T*>(smem_raw);
  float* Ws = reinterpret_cast<float*>(smem_raw + xs_bytes);  // [BK][WS]
  float* Zs = Ws + BK * WS;                                    // [BM][BN+1]
  const int b = blockIdx.z, t0 = blockIdx.x * TT, u0 = blockIdx.y * TU;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  form_inputs<T>(Xs, f, g, b, t0, u0, dm, dr, row_key(dr.seed, b));

  // one thread per pair keeps the running max/sum and the two logits
  const int p = threadIdx.x;
  const int pt = t0 + p / TU, pu = u0 + p % TU;
  const bool mine = p < BM && pt < dm.T && pu < dm.U1;
  const int lab = mine ? labels[(size_t)b * dm.U1 + pu] : -1;
  float m = -INFINITY, s = 0.f, zb = 0.f, zl = 0.f;

  for (int c0 = 0; c0 < dm.V1; c0 += BN) {
    float acc[4][4];
    logits_tile<T>(acc, Xs, Ws, w, b, c0, dm);
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) Zs[(ty * 4 + i) * (BN + 1) + tx * 4 + j] = acc[i][j];
    __syncthreads();
    if (mine) {
      const int cn = dm.V1 - c0 < BN ? dm.V1 - c0 : BN;
      for (int c = 0; c < cn; ++c) {
        const int v = c0 + c;
        const float z = Zs[p * (BN + 1) + c] + bias[(size_t)b * dm.V1 + v];
        if (v == dm.blank) zb = z;
        if (v == lab) zl = z;
        if (z > m) {
          s = s * expf(m - z) + 1.f;
          m = z;
        } else {
          s += expf(z - m);
        }
      }
    }
    __syncthreads();  // Zs is rewritten by the next tile
  }
  if (mine) {
    const float l = m + logf(s);
    const size_t o = ((size_t)b * dm.T + pt) * dm.U1 + pu;
    lpb[o] = zb - l;
    lpl[o] = zl - l;
    lse_out[o] = l;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
joint_dlogits_dinp_kernel(const T* __restrict__ f, const T* __restrict__ g,
                          const float* __restrict__ w, const float* __restrict__ bias,
                          const int* __restrict__ labels, const float* __restrict__ lse,
                          const float* __restrict__ dlpb, const float* __restrict__ dlpl,
                          float* __restrict__ dlogits, float* __restrict__ df,
                          float* __restrict__ dg, Dims dm, Drop dr, int region_bytes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Xs = reinterpret_cast<T*>(smem_raw);          // [H][BM], then:
  float* Gs = reinterpret_cast<float*>(smem_raw);  // [V1p][BM] dlogits
  float* Ws = reinterpret_cast<float*>(smem_raw + region_bytes);  // [BK][WS]
  float* sdf = Ws + BK * WS;                                       // [TT][BN]
  float* sdg = sdf + TT * BN;                                      // [TU][BN]
  const int b = blockIdx.z, t0 = blockIdx.x * TT, u0 = blockIdx.y * TU;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const uint32_t key = row_key(dr.seed, b);
  form_inputs<T>(Xs, f, g, b, t0, u0, dm, dr, key);

  // this thread's 4 pairs: one frame, 4 label positions
  const int t = t0 + ty / 2;
  int u[4], lab[4];
  float l[4], cb[4], cl[4];
  bool ok[4];
  for (int i = 0; i < 4; ++i) {
    u[i] = u0 + (ty % 2) * 4 + i;
    ok[i] = t < dm.T && u[i] < dm.U1;
    const size_t o = ((size_t)b * dm.T + t) * dm.U1 + u[i];
    lab[i] = ok[i] ? labels[(size_t)b * dm.U1 + u[i]] : -1;
    l[i] = ok[i] ? lse[o] : 0.f;
    cb[i] = ok[i] ? dlpb[o] : 0.f;
    cl[i] = ok[i] ? dlpl[o] : 0.f;
  }

  // 1. logits again (the forward's loop), dlogits to the scratch
  for (int c0 = 0; c0 < dm.V1; c0 += BN) {
    float acc[4][4];
    logits_tile<T>(acc, Xs, Ws, w, b, c0, dm);
    for (int i = 0; i < 4; ++i) {
      if (!ok[i]) continue;
      const size_t o = (((size_t)b * dm.T + t) * dm.U1 + u[i]) * dm.V1;
      for (int j = 0; j < 4; ++j) {
        const int v = c0 + tx * 4 + j;
        if (v >= dm.V1) continue;
        const float z = acc[i][j] + bias[(size_t)b * dm.V1 + v];
        const float one = (v == dm.blank ? cb[i] : 0.f) + (v == lab[i] ? cl[i] : 0.f);
        dlogits[o + v] = one - expf(z - l[i]) * (cb[i] + cl[i]);
      }
    }
  }
  __syncthreads();  // dlogits written and Xs no longer read

  // 2. the tile's dlogits into shared memory, [V1p][BM], zero-padded
  const int V1p = (dm.V1 + BK - 1) / BK * BK;
  for (int idx = threadIdx.x; idx < V1p * BM; idx += NT) {
    const int v = idx / BM, p = idx % BM;
    const int pt = t0 + p / TU, pu = u0 + p % TU;
    Gs[idx] = (v < dm.V1 && pt < dm.T && pu < dm.U1)
                  ? dlogits[(((size_t)b * dm.T + pt) * dm.U1 + pu) * dm.V1 + v]
                  : 0.f;
  }

  // 3. d_x = dlogits . W^T per 64 columns of H, masked, reduced to df, dg
  for (int h0 = 0; h0 < dm.H; h0 += BN) {
    float acc[4][4];
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int idx = threadIdx.x; idx < (TT + TU) * BN; idx += NT) sdf[idx] = 0.f;
    for (int v0 = 0; v0 < V1p; v0 += BK) {
      __syncthreads();
      for (int idx = threadIdx.x; idx < BK * BN; idx += NT) {
        const int vv = idx % BK, hh = idx / BK;
        const int v = v0 + vv, h = h0 + hh;
        Ws[vv * WS + hh] = (v < dm.V1 && h < dm.H) ? w[((size_t)b * dm.H + h) * dm.V1 + v] : 0.f;
      }
      __syncthreads();
      for (int vv = 0; vv < BK; ++vv) {
        float a[4], wv[4];
        load4(Gs + (size_t)(v0 + vv) * BM + ty * 4, a);
        load4(Ws + vv * WS + tx * 4, wv);
        for (int i = 0; i < 4; ++i)
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], wv[j], acc[i][j]);
      }
    }
    for (int j = 0; j < 4; ++j) {
      const int hh = tx * 4 + j, h = h0 + hh;
      if (h >= dm.H) continue;
      float row = 0.f;
      for (int i = 0; i < 4; ++i) {
        if (!ok[i]) continue;
        float d;
        joint_input<T>(f, g, b, t, u[i], h, dm, dr, key, &d);
        const float v = acc[i][j] * d;
        row += v;
        atomicAdd(&sdg[((ty % 2) * 4 + i) * BN + hh], v);
      }
      atomicAdd(&sdf[(ty / 2) * BN + hh], row);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < (TT + TU) * BN; idx += NT) {
      const int r = idx / BN, hh = idx % BN, h = h0 + hh;
      if (h >= dm.H) continue;
      if (r < TT) {
        if (t0 + r < dm.T) atomicAdd(&df[((size_t)b * dm.T + t0 + r) * dm.H + h], sdf[idx]);
      } else if (u0 + r - TT < dm.U1) {
        atomicAdd(&dg[((size_t)b * dm.U1 + u0 + r - TT) * dm.H + h], sdf[idx]);
      }
    }
    __syncthreads();  // sdf, sdg are zeroed for the next slice
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
joint_dw_db_kernel(const T* __restrict__ f, const T* __restrict__ g,
                   const float* __restrict__ dlogits, float* __restrict__ dw,
                   float* __restrict__ db, Dims dm, Drop dr) {
  __shared__ __align__(16) float Xc[BK * WS];  // [pair][h]
  __shared__ __align__(16) float Gc[BK * WS];  // [pair][v]
  const int b = blockIdx.z, h0 = blockIdx.y * BN, v0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const uint32_t key = row_key(dr.seed, b);
  const int P = dm.T * dm.U1;
  float acc[4][4], dbias[4];
  for (int i = 0; i < 4; ++i) {
    dbias[i] = 0.f;
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  const bool bias_block = blockIdx.y == 0 && ty == 0;
  for (int p0 = 0; p0 < P; p0 += BK) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < BK * BN; idx += NT) {
      const int pp = idx / BN, c = idx % BN, p = p0 + pp;
      const int h = h0 + c, v = v0 + c;
      float x = 0.f, d, gl = 0.f;
      if (p < P) {
        if (h < dm.H) x = joint_input<T>(f, g, b, p / dm.U1, p % dm.U1, h, dm, dr, key, &d);
        if (v < dm.V1) gl = dlogits[((size_t)b * P + p) * dm.V1 + v];
      }
      Xc[pp * WS + c] = x;
      Gc[pp * WS + c] = gl;
    }
    __syncthreads();
    for (int pp = 0; pp < BK; ++pp) {
      float a[4], gv[4];
      load4(Xc + pp * WS + ty * 4, a);
      load4(Gc + pp * WS + tx * 4, gv);
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], gv[j], acc[i][j]);
      if (bias_block)
        for (int j = 0; j < 4; ++j) dbias[j] += gv[j];
    }
  }
  for (int i = 0; i < 4; ++i) {
    const int h = h0 + ty * 4 + i;
    if (h >= dm.H) continue;
    for (int j = 0; j < 4; ++j) {
      const int v = v0 + tx * 4 + j;
      if (v < dm.V1) dw[((size_t)b * dm.H + h) * dm.V1 + v] = acc[i][j];
    }
  }
  if (bias_block)
    for (int j = 0; j < 4; ++j) {
      const int v = v0 + tx * 4 + j;
      if (v < dm.V1) db[(size_t)b * dm.V1 + v] = dbias[j];
    }
}

__global__ void joint_bits_kernel(uint32_t seed, int B, Dims dm, uint32_t* bits) {
  const size_t n = (size_t)B * dm.T * dm.U1 * dm.H;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int h = i % dm.H;
    const size_t r = i / dm.H;
    const int u = r % dm.U1;
    const size_t r2 = r / dm.U1;
    const int t = r2 % dm.T, b = r2 / dm.T;
    bits[i] = drop_bits(row_key(seed, b), t, u, h, dm.U1, dm.H);
  }
}

int align16(int n) { return (n + 15) / 16 * 16; }

template <typename T>
int fwd_smem(const Dims& dm) {
  return align16(dm.H * BM * (int)sizeof(T)) + BK * WS * 4 + BM * (BN + 1) * 4;
}

template <typename T>
int bwd_region(const Dims& dm) {
  const int V1p = (dm.V1 + BK - 1) / BK * BK;
  const int xs = align16(dm.H * BM * (int)sizeof(T));
  return xs > V1p * BM * 4 ? xs : V1p * BM * 4;
}

template <typename T>
int bwd_smem(const Dims& dm) {
  return bwd_region<T>(dm) + BK * WS * 4 + (TT + TU) * BN * 4;
}

template <typename T>
cudaError_t launch_fwd(const void* f, const void* g, const void* w, const void* bias,
                       const void* labels, void* lpb, void* lpl, void* lse, int B,
                       const Dims& dm, const Drop& dr, cudaStream_t stream) {
  const int smem = fwd_smem<T>(dm);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(joint_fwd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((dm.T + TT - 1) / TT, (dm.U1 + TU - 1) / TU, B);
  joint_fwd_kernel<T><<<grid, NT, smem, stream>>>(
      (const T*)f, (const T*)g, (const float*)w, (const float*)bias, (const int*)labels,
      (float*)lpb, (float*)lpl, (float*)lse, dm, dr, align16(dm.H * BM * (int)sizeof(T)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* f, const void* g, const void* w, const void* bias,
                       const void* labels, const void* lse, const void* dlpb,
                       const void* dlpl, void* dlogits, void* df, void* dg, void* dw,
                       void* db, int B, const Dims& dm, const Drop& dr,
                       cudaStream_t stream) {
  const int smem = bwd_smem<T>(dm);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(joint_dlogits_dinp_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((dm.T + TT - 1) / TT, (dm.U1 + TU - 1) / TU, B);
  joint_dlogits_dinp_kernel<T><<<grid, NT, smem, stream>>>(
      (const T*)f, (const T*)g, (const float*)w, (const float*)bias, (const int*)labels,
      (const float*)lse, (const float*)dlpb, (const float*)dlpl, (float*)dlogits,
      (float*)df, (float*)dg, dm, dr, bwd_region<T>(dm));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid2((dm.V1 + BN - 1) / BN, (dm.H + BN - 1) / BN, B);
  joint_dw_db_kernel<T><<<grid2, NT, 0, stream>>>(
      (const T*)f, (const T*)g, (const float*)dlogits, (float*)dw, (float*)db, dm, dr);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (f and g; the head is float32)
extern "C" int joint_fused_fwd(const void* f, const void* g, const void* w,
                               const void* bias, const void* labels, void* lpb,
                               void* lpl, void* lse, int B, int T, int U1, int H,
                               int V1, int blank, unsigned seed, unsigned thr,
                               float scale, int drop_on, int dtype, void* stream) {
  if (B == 0 || T == 0 || U1 == 0) return (int)cudaSuccess;
  const Dims dm{T, U1, H, V1, blank};
  const Drop dr{seed, thr, scale, drop_on};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch_fwd<float>(f, g, w, bias, labels, lpb, lpl, lse, B, dm, dr, s);
  if (dtype == 1)
    return (int)launch_fwd<__nv_bfloat16>(f, g, w, bias, labels, lpb, lpl, lse, B, dm, dr, s);
  return (int)cudaErrorInvalidValue;
}

// df [B,T,H] and dg [B,U1,H] f32 must be zeroed; dlogits [B,T,U1,V1] f32
// is scratch; dw [B,H,V1] and db [B,V1] f32 are written whole
extern "C" int joint_fused_bwd(const void* f, const void* g, const void* w,
                               const void* bias, const void* labels, const void* lse,
                               const void* dlpb, const void* dlpl, void* dlogits,
                               void* df, void* dg, void* dw, void* db, int B, int T,
                               int U1, int H, int V1, int blank, unsigned seed,
                               unsigned thr, float scale, int drop_on, int dtype,
                               void* stream) {
  if (B == 0 || T == 0 || U1 == 0) return (int)cudaSuccess;
  const Dims dm{T, U1, H, V1, blank};
  const Drop dr{seed, thr, scale, drop_on};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_bwd<float>(f, g, w, bias, labels, lse, dlpb, dlpl, dlogits, df, dg,
                                  dw, db, B, dm, dr, s);
  if (dtype == 1)
    return (int)launch_bwd<__nv_bfloat16>(f, g, w, bias, labels, lse, dlpb, dlpl, dlogits,
                                          df, dg, dw, db, B, dm, dr, s);
  return (int)cudaErrorInvalidValue;
}

// shared memory (bytes) the forward and the backward need, for the wrapper's checks
extern "C" int joint_fused_smem(int H, int V1, int dtype, int backward) {
  const Dims dm{1, 1, H, V1, 0};
  if (dtype == 0) return backward ? bwd_smem<float>(dm) : fwd_smem<float>(dm);
  return backward ? bwd_smem<__nv_bfloat16>(dm) : fwd_smem<__nv_bfloat16>(dm);
}

// the kernels' dropout bits [B,T,U1,H] (uint32), for the test against the plain version
extern "C" int joint_dropout_bits(unsigned seed, int B, int T, int U1, int H, void* bits,
                                  void* stream) {
  if ((size_t)B * T * U1 * H == 0) return (int)cudaSuccess;
  const Dims dm{T, U1, H, 1, 0};
  joint_bits_kernel<<<1024, 256, 0, (cudaStream_t)stream>>>(seed, B, dm, (uint32_t*)bits);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

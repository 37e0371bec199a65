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
// backward uses to rebuild the softmax without a second reduction. It
// runs scalar f32 FMAs on the CUDA cores.
//
// Backward: what bounds it. Per pair it computes what _bwd_kernel does:
//   dlogits = onehot(blank)*dlpb + onehot(y)*dlpl - softmax*(dlpb+dlpl)
//   d_x     = dlogits . W^T, masked by relu' and the dropout keep/scale
//   df = sum_u d_x,  dg = sum_t d_x,  dW = sum_p x^T . dlogits,  db = sum_p dlogits
// Three products of 2*pairs*H*V1 flops each: 415.5 GFLOP at the flagship
// (B16 T204 U1 129 H640 V1 257) against ~38 MB of inputs and outputs, so
// operations bound it: 0.42 ms at the 989 TFLOP/s bf16 tensor rate, 6.2
// ms at the 67 TFLOP/s f32 CUDA-core rate. All three products run on the
// tensor cores, as warp-level mma.sync.m16n8k8 in TF32.
//
// Precision: f32-faithful split operands (3xTF32). TF32 keeps 11
// significant bits, so each f32 operand a is split into big = tf32(a) and
// small = a - big (exact in f32), and a product is accumulated in f32 as
// small*big + big*small + big*big. The tensor cores read the 19 high bits
// of a TF32 operand and ignore the 13 low ones, so big is a itself, read
// as tf32(a) rounded toward zero, and the split costs two full-rate
// operations (a mask and an f32 subtract); the dropped small*small term
// and small's truncation are ~2^-20 of a*b, so each product is about as
// faithful as the plain version's f32 sums, which the tolerances (dW, db
// within 1e-5 of max|ref|; df, dg 1e-5 in f32) ask for, where one TF32
// pass is ~1e-4 off (tests/test_torch_joint_fused.py emulates both). A
// bf16 joint input is exact in TF32 (8 significant bits), so with bf16
// f/g the logits (x.W) and dW (x^T.dlogits) take two passes and d_x
// (dlogits.W^T) three: seven TF32 passes of 138.5 GFLOP, 970 GFLOP, a
// bound of 1.96 ms at the 495 TFLOP/s TF32 rate (f32 f/g split x too:
// nine passes); warp-level mma.sync does not reach that rate on Hopper,
// wgmma does. The tensor cores add a k-step's products into the
// accumulator with truncation, which over a long sum drifts one way; so
// every mma chain runs for at most PROMOTE k-steps (128 terms) from zero
// and is then added into an f32 total with a rounded add. dW sums 26,316
// pairs of a row, which a single chain would bias by up to ~1e-5 of
// max|dW|.
//
// Backward design: four launches, m16n8k8 tiles, 8 warps a block.
//   0. joint_pad_head_kernel copies the head into the scratch with rows
//      padded to V8 (V1 rounded up to 8), so that head tiles move 16
//      bytes a copy; joint_form_kernel forms x and its relu'*keep bits
//      (the dropout hash) once for every pair into the scratch, a thread
//      a pair's 8 columns, many blocks an SM. Formed inside the pair-tile
//      kernel, where 8 warps an SM could not hide the loads behind the
//      hash, x cost more than this launch does.
//   1. joint_dlogits_dx_kernel: one block per pair tile (bf16: 16 frames
//      x 8 labels = 128 pairs; f32: 8 x 8 = 64 pairs) of row b. It copies
//      the tile's x for all of H (128 x 648 bf16 = 162 KB; f32 64 x 644 x
//      4 = 161 KB) and its mask bytes (10 KB) into shared memory, then
//      (a) logits in 96-column chunks of V1 (3 at V1 257): the padded
//      head streams through a 2-stage cp.async ring of 64 x 96 f32 tiles
//      (26 KB each), each warp owns a 32-pair x 48-column tile (2 x 6 mma
//      tiles); the chunk's dlogits, from the forward's saved log-sum-exp,
//      go to the scratch;
//      (b) the tile's dlogits read back into the shared memory x vacated
//      ([pairs][V8 + 4]: 135 KB), 16 bytes a load;
//      (c) d_x in 64-column chunks of H (64 x 64 head tiles through the
//      same ring, 2 x 4 mma tiles a warp), masked into a d_x tile that the
//      ring's memory holds, and reduced from there: df sums a frame's 8
//      labels and dg a label's frames, one f32 global atomic per value and
//      tile.
//      Shared memory 226 KB (bf16) / 219 KB (f32) at H640 V1 257, which
//      bounds H at 640 in bf16 and V8 at ~320: one block an SM, 3,536
//      blocks at the flagship.
//   2. joint_dw_db_kernel: dW[b] = x^T . dlogits as a GEMM over K =
//      T*U1 pairs, x and dlogits read from the scratch by 16-byte
//      cp.async through a 3-stage ring of 64 pairs (129 KB bf16). Output
//      tile 128 rows of H x 88 columns of V1 (11 mma tiles, split and
//      multiplied 4 at a time; 257 columns are 3 tiles, 264 wide), one
//      warp per 16 rows of H: 3 x 5 x 16 = 240 blocks, two waves on 132
//      SMs. The blocks of the first H tile also sum db.
// The scratch (joint_fused_bwd_scratch words) holds dlogits [B,T,U1][V8]
// f32 (445 MB at the flagship), x [B,T,U1][HP] in the compute dtype (539
// MB bf16), the mask bytes (34 MB) and the padded head (11 MB).
// The TPU kernel carries dW, db and dg across its sequential chunk grid
// in VMEM; blocks here run in parallel, so dW and db take a second pass
// over the scratch and df, dg take atomics (their last bits vary from
// run to run). dg is accumulated in f32 and rounded once by the caller
// (the TPU kernel adds each chunk into a bf16 buffer). Fragments are read
// from shared memory with 32-bit loads; every staged row is padded so
// that a fragment's 32 lanes hit 32 banks.
//
// Left for later: wgmma (asynchronous warpgroup products from shared
// memory descriptors, the rate mma.sync does not reach), TMA with
// multicast of a row's head across a cluster (every pair tile of a row
// reads the same head twice from L2), the forward on the same split
// scheme sharing the head tile loader, and dW without the scratch (a
// fourth product, the logits again, inside the dW kernel).

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

// ---------------------------------------------------------------------------
// Backward on the tensor cores: mma.sync m16n8k8 TF32 with split operands.

namespace bwd {

constexpr int THREADS = 256;  // 8 warps
constexpr int LABELS = 8;     // label positions per pair tile
constexpr int KT = 64;        // depth of a staged head tile
constexpr int CA = 96;        // columns of V1 a logits chunk (a): 6 mma tiles a warp
constexpr int CN = 64;        // columns of H a d_x chunk (c): 4 mma tiles a warp
constexpr int NSTAGE = 2;     // head tiles in flight
constexpr int WSTAGE = KT * (CA + 8);  // floats a head stage: [64][104] or [64][68]
static_assert(CN * (KT + 4) <= WSTAGE, "a (c) head tile fits a stage");
static_assert(NSTAGE * WSTAGE >= 128 * (CN + 8), "the ring holds a d_x tile");
constexpr int PROMOTE = 16;   // k-steps of an mma chain before its f32 add
// kernel 2
constexpr int BH = 128;       // rows of H per block, 16 a warp
constexpr int NB = 11;        // mma tiles of 8 columns of V1 per block
constexpr int NG = 4;         // of which a group is split and multiplied at a time
constexpr int KP = 64;        // pairs per stage
constexpr int DSTAGE = 3;     // stages in flight
constexpr int XSD = BH + 8;   // padded rows of a staged x tile (elements)
constexpr int GSD = NB * 8 + 16;  // padded rows of a staged dlogits tile

// one stage of kernel 2: x [KP][XSD] in the compute dtype, then dlogits
// [KP][GSD] f32
template <typename T> struct DwStage {
  static constexpr int XBYTES = KP * XSD * (int)sizeof(T);
  static constexpr int BYTES = XBYTES + KP * GSD * 4;
};

// The scratch, in 4-byte words: dlogits [B,T,U1][V8] f32 (rows padded
// with zeros to a multiple of 8 columns, 16-byte aligned); the joint input
// x [B,T,U1][HP] in the compute dtype (HP = H rounded up to 8,
// zero-padded) and its relu'*keep bits [B,T,U1][MB] bytes (a bit per
// column, MB = HP/8 rounded up to 16), both formed once by
// joint_form_kernel; and the head [B,H][V8] f32 with its rows padded
// likewise, which the head tiles are copied from 16 bytes at a time.
__host__ __device__ inline int pad8(int n) { return (n + 7) / 8 * 8; }

__host__ __device__ inline int mask_bytes(int H) { return (pad8(H) / 8 + 15) / 16 * 16; }
__host__ __device__ inline size_t scratch_x(int B, int T_, int U1, int V1) {
  return (size_t)B * T_ * U1 * pad8(V1);
}
template <typename T>
__host__ __device__ inline size_t scratch_mask(int B, int T_, int U1, int H, int V1) {
  return scratch_x(B, T_, U1, V1) + (size_t)B * T_ * U1 * pad8(H) * sizeof(T) / 4;
}
template <typename T>
__host__ __device__ inline size_t scratch_head(int B, int T_, int U1, int H, int V1) {
  return scratch_mask<T>(B, T_, U1, H, V1) + (size_t)B * T_ * U1 * mask_bytes(H) / 4;
}
template <typename T>
__host__ __device__ inline size_t scratch_words(int B, int T_, int U1, int H, int V1) {
  return scratch_head<T>(B, T_, U1, H, V1) + (size_t)B * H * pad8(V1);
}

// pairs per tile: 16 frames x 8 labels in bf16, 8 x 8 in f32, where the
// x tile is twice as wide
template <typename T> struct Tile {
  static constexpr int BM = sizeof(T) == 2 ? 128 : 64;
  static constexpr int TT = BM / LABELS;
  static constexpr int MI = BM / 64;  // m16 tiles a warp: 4 warps along the pairs
};

// shared-memory layout of kernel 1 (bytes), on the host and the card
struct Layout {
  int hp;      // H rounded up to the staged depth
  int xs;      // row stride of the x tile (elements)
  int gs;      // row stride of the dlogits tile (floats)
  int region;  // x tile, then dlogits tile
  int masks;   // relu'*keep bits [BM][mask_bytes(H)]
  int total;
};

template <typename T>
__host__ __device__ inline Layout layout(int H, int V1) {
  constexpr int BM = Tile<T>::BM;
  Layout L;
  L.hp = (H + KT - 1) / KT * KT;
  L.xs = L.hp + 16 / (int)sizeof(T);
  L.gs = pad8(V1) + 4;
  const int xs_bytes = BM * L.xs * (int)sizeof(T), gs_bytes = BM * L.gs * 4;
  L.region = ((xs_bytes > gs_bytes ? xs_bytes : gs_bytes) + 15) / 16 * 16;
  L.masks = BM * mask_bytes(H);
  L.total = L.region + L.masks + NSTAGE * WSTAGE * 4 + 4 * BM * 4;
  return L;
}

// a = big + small. The tensor cores read the 19 high bits of a TF32
// operand and ignore the 13 low ones, so big is a itself, read as
// tf32(a) rounded toward zero, and small = a - tf32(a), exact in f32, of
// which they read the high bits too. Two full-rate operations.
__device__ __forceinline__ void split(float a, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(a);
  small = __float_as_uint(a - __uint_as_float(big & 0xFFFFE000u));
}

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += a.b over MI x NI tiles with split operands: pass by pass over
// all tiles, the small terms first, so that consecutive mma are
// independent. An operand exact in TF32 (SA or SB false) has no small
// part. Tiles past the edge of the data multiply zeros.
template <int MI, int NI, bool SA, bool SB>
__device__ __forceinline__ void mma_passes(float acc[MI][NI][4], const uint32_t ab[MI][4],
                                           const uint32_t as[MI][4], const uint32_t bb[NI][2],
                                           const uint32_t bs[NI][2]) {
  if (SA) {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) mma(acc[mi][ni], as[mi], bb[ni]);
  }
  if (SB) {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) mma(acc[mi][ni], ab[mi], bs[ni]);
  }
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) mma(acc[mi][ni], ab[mi], bb[ni]);
}

// the A fragment's four values (rows r, r+8; columns k, k+4), split
template <bool S>
__device__ __forceinline__ void frag_a(const float v[4], uint32_t big[4], uint32_t small[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (S) split(v[i], big[i], small[i]);
    else big[i] = __float_as_uint(v[i]);
  }
}

__device__ __forceinline__ void frag_b(float v0, float v1, uint32_t big[2], uint32_t small[2]) {
  split(v0, big[0], small[0]);
  split(v1, big[1], small[1]);
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 16-byte asynchronous copy global -> shared; zero-filled when !valid
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

// head tiles for the ring from the padded head wp [H][V8] of row b: (a)
// [KT][CA + 8], rows kt*KT.., columns c0..; (c) [CN][KT + 4], rows h0..,
// columns kt*KT.. (W^T's columns as rows). Outside the head they are zero.
__device__ __forceinline__ void load_head_a(float* dst, const float* wp, int kt, int c0,
                                            const Dims& dm) {
  constexpr int CPR = CA / 4;  // copies a row
  const int V8 = pad8(dm.V1);
  for (int i = threadIdx.x; i < KT * CPR; i += THREADS) {
    const int kk = i / CPR, c = i % CPR, h = kt * KT + kk, v = c0 + c * 4;
    const bool ok = h < dm.H && v < V8;
    cp16(dst + kk * (CA + 8) + c * 4, ok ? wp + (size_t)h * V8 + v : wp, ok);
  }
}
__device__ __forceinline__ void load_head_c(float* dst, const float* wp, int kt, int h0,
                                            const Dims& dm) {
  constexpr int CPR = KT / 4;
  const int V8 = pad8(dm.V1);
  for (int i = threadIdx.x; i < CN * CPR; i += THREADS) {
    const int hh = i / CPR, c = i % CPR, h = h0 + hh, v = kt * KT + c * 4;
    const bool ok = h < dm.H && v < V8;
    cp16(dst + hh * (KT + 4) + c * 4, ok ? wp + (size_t)h * V8 + v : wp, ok);
  }
}

template <int M, int N>
__device__ __forceinline__ void promote(float tot[M][N][4], float acc[M][N][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        tot[i][j][e] += acc[i][j][e];
        acc[i][j][e] = 0.f;
      }
}

// the joint input of one element and whether relu' * keep is non-zero
template <typename T>
__device__ __forceinline__ float joint_x(float fv, float gv, int t, int u, int h,
                                         const Dims& dm, const Drop& dr, uint32_t key,
                                         bool* live) {
  const float pre = rnd<T>(fv + gv);
  bool on = pre > 0.f;
  float x = on ? pre : 0.f;
  if (dr.on) {
    const bool keep = drop_bits(key, t, u, h, dm.U1, dm.H) <= dr.thr;
    x = keep ? rnd<T>(x * dr.scale) : 0.f;
    on = on && keep;
  }
  *live = on;
  return x;
}

}  // namespace bwd

// Kernel 0: the joint input x and its relu'*keep bits for every pair, into
// the scratch, formed once for kernels 1 and 2; a thread forms 8
// consecutive columns of one pair (16 bytes of bf16 x, one mask byte).
// Many small blocks an SM hide the loads behind the hash's integer work.
template <typename T>
__global__ void __launch_bounds__(bwd::THREADS)
joint_form_kernel(const T* __restrict__ f, const T* __restrict__ g, float* __restrict__ scratch,
                  int B, Dims dm, Drop dr) {
  using namespace bwd;
  const int HP = pad8(dm.H), MB = mask_bytes(dm.H), CH = HP / 8;
  T* xg = reinterpret_cast<T*>(scratch + scratch_x(B, dm.T, dm.U1, dm.V1));
  unsigned char* mg = reinterpret_cast<unsigned char*>(
      scratch + scratch_mask<T>(B, dm.T, dm.U1, dm.H, dm.V1));
  const size_t n = (size_t)B * dm.T * dm.U1 * CH;
  for (size_t i = blockIdx.x * (size_t)THREADS + threadIdx.x; i < n;
       i += (size_t)gridDim.x * THREADS) {
    const int c = i % CH;
    const size_t row = i / CH;  // ((b*T + t)*U1 + u)
    const int u = row % dm.U1, t = row / dm.U1 % dm.T, b = row / dm.U1 / dm.T;
    const int h0 = c * 8;
    const uint32_t key = row_key(dr.seed, b);
    const T* fr = f + ((size_t)b * dm.T + t) * dm.H + h0;
    const T* gr = g + ((size_t)b * dm.U1 + u) * dm.H + h0;
    union Row {
      T e[8];
      uint4 v[8 * sizeof(T) / 16];
    } fl, gl, out;
    if (dm.H % 8 == 0) {  // rows 16-byte aligned: whole 16-byte loads
#pragma unroll
      for (int q = 0; q < (int)(8 * sizeof(T) / 16); ++q) {
        fl.v[q] = reinterpret_cast<const uint4*>(fr)[q];
        gl.v[q] = reinterpret_cast<const uint4*>(gr)[q];
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const bool ok = h0 + k < dm.H;
        fl.e[k] = ok ? fr[k] : from_f<T>(0.f);
        gl.e[k] = ok ? gr[k] : from_f<T>(0.f);
      }
    }
    unsigned bits = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      bool live = false;
      float x = 0.f;
      if (h0 + k < dm.H)
        x = joint_x<T>(to_f<T>(fl.e[k]), to_f<T>(gl.e[k]), t, u, h0 + k, dm, dr, key, &live);
      out.e[k] = from_f<T>(x);
      bits |= (unsigned)live << k;
    }
    uint4* dst = reinterpret_cast<uint4*>(xg + row * HP + h0);
#pragma unroll
    for (int q = 0; q < (int)(8 * sizeof(T) / 16); ++q) dst[q] = out.v[q];
    mg[row * MB + c] = (unsigned char)bits;
  }
}

// Kernel 1: per pair tile, the logits again, dlogits to the scratch, then
// d_x = dlogits . W^T masked and reduced into df and dg.
template <typename T>
__global__ void __launch_bounds__(bwd::THREADS, 1)
joint_dlogits_dx_kernel(const float* __restrict__ bias, const int* __restrict__ labels,
                        const float* __restrict__ lse, const float* __restrict__ dlpb,
                        const float* __restrict__ dlpl, float* __restrict__ dlogits,
                        float* __restrict__ df, float* __restrict__ dg, Dims dm, Drop dr) {
  using namespace bwd;
  constexpr int BM = Tile<T>::BM, TT = Tile<T>::TT, MI = Tile<T>::MI;
  constexpr bool SX = sizeof(T) == 4;  // an f32 x needs its small part
  constexpr int EPC = 16 / (int)sizeof(T);  // elements a 16-byte copy
  const Layout L = layout<T>(dm.H, dm.V1);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Xs = reinterpret_cast<T*>(smem_raw);          // [BM][xs]
  float* Gs = reinterpret_cast<float*>(smem_raw);  // [BM][gs], once x is done
  unsigned char* Ms = smem_raw + L.region;         // relu'*keep bits [BM][MB]
  float* Ws = reinterpret_cast<float*>(smem_raw + L.region + L.masks);
  float* Pl = Ws + NSTAGE * WSTAGE;  // per pair: lse, dlpb, dlpl, label
  float* Pb = Pl + BM;
  float* Pc = Pb + BM;
  int* Pk = reinterpret_cast<int*>(Pc + BM);

  const int b = blockIdx.z, t0 = blockIdx.x * TT, u0 = blockIdx.y * LABELS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int wm = warp % 4, wn = warp / 4;  // 4 warps along the pairs, 2 along columns
  const int rw = wm * 16 * MI;             // the warp's first pair row
  const int V8 = pad8(dm.V1), HP = pad8(dm.H), MB = mask_bytes(dm.H);

  // the tile's x (zero past H and past the row's pairs) and mask bits,
  // formed by joint_form_kernel, 16 bytes a copy
  {
    const int B = gridDim.z, xcr = L.hp / EPC, mcr = MB / 16;
    const T* xg = reinterpret_cast<const T*>(dlogits + scratch_x(B, dm.T, dm.U1, dm.V1));
    const unsigned char* mg = reinterpret_cast<const unsigned char*>(
        dlogits + scratch_mask<T>(B, dm.T, dm.U1, dm.H, dm.V1));
    for (int i = threadIdx.x; i < BM * xcr; i += THREADS) {
      const int p = i / xcr, c = i % xcr, t = t0 + p / LABELS, u = u0 + p % LABELS;
      const size_t row = ((size_t)b * dm.T + t) * dm.U1 + u;
      const bool ok = t < dm.T && u < dm.U1 && c * EPC < HP;
      cp16(Xs + p * L.xs + c * EPC, ok ? xg + row * HP + c * EPC : xg, ok);
    }
    for (int i = threadIdx.x; i < BM * mcr; i += THREADS) {
      const int p = i / mcr, c = i % mcr, t = t0 + p / LABELS, u = u0 + p % LABELS;
      const size_t row = ((size_t)b * dm.T + t) * dm.U1 + u;
      const bool ok = t < dm.T && u < dm.U1;
      cp16(Ms + p * MB + c * 16, ok ? mg + row * MB + c * 16 : mg, ok);
    }
    cp_commit();
  }
  for (int p = threadIdx.x; p < BM; p += THREADS) {
    const int t = t0 + p / LABELS, u = u0 + p % LABELS;
    const bool ok = t < dm.T && u < dm.U1;
    const size_t o = ((size_t)b * dm.T + t) * dm.U1 + u;
    Pl[p] = ok ? lse[o] : 0.f;
    Pb[p] = ok ? dlpb[o] : 0.f;
    Pc[p] = ok ? dlpl[o] : 0.f;
    Pk[p] = ok ? labels[(size_t)b * dm.U1 + u] : -1;
  }
  cp_wait<0>();
  __syncthreads();

  // (a) logits in chunks of CA columns of V1, dlogits to the scratch
  const float* wb = dlogits + scratch_head<T>(gridDim.z, dm.T, dm.U1, dm.H, dm.V1) +
                    (size_t)b * dm.H * V8;  // the padded head
  for (int c0 = 0; c0 < dm.V1; c0 += CA) {
    float acc[MI][6][4] = {}, tot[MI][6][4] = {};
    const int nk = L.hp / KT;
#pragma unroll
    for (int s = 0; s < NSTAGE - 1; ++s) {
      if (s < nk) load_head_a(Ws + s * WSTAGE, wb, s, c0, dm);
      cp_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_wait<NSTAGE - 2>();
      __syncthreads();  // tile kt landed; every warp is done with tile kt-1
      if (kt + NSTAGE - 1 < nk)
        load_head_a(Ws + (kt + NSTAGE - 1) % NSTAGE * WSTAGE, wb, kt + NSTAGE - 1, c0, dm);
      cp_commit();
      const float* Wt = Ws + kt % NSTAGE * WSTAGE;
#pragma unroll
      for (int ks = 0; ks < KT / 8; ++ks) {
        const int k = kt * KT + ks * 8 + tq;
        uint32_t ab[MI][4], as[MI][4], bb[6][2], bs[6][2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          const T* x0 = Xs + (rw + mi * 16 + gq) * L.xs + k;
          const T* x8 = x0 + 8 * L.xs;
          const float v[4] = {to_f<T>(x0[0]), to_f<T>(x8[0]), to_f<T>(x0[4]), to_f<T>(x8[4])};
          frag_a<SX>(v, ab[mi], as[mi]);
        }
#pragma unroll
        for (int ni = 0; ni < 6; ++ni) {
          const float* w0 = Wt + (ks * 8 + tq) * (CA + 8) + wn * 48 + ni * 8 + gq;
          frag_b(w0[0], w0[4 * (CA + 8)], bb[ni], bs[ni]);
        }
        mma_passes<MI, 6, SX, true>(acc, ab, as, bb, bs);
      }
      if ((kt + 1) % (PROMOTE / (KT / 8)) == 0) promote<MI, 6>(tot, acc);
    }
    __syncthreads();  // the ring is free for the next walk
    promote<MI, 6>(tot, acc);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < 6; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = rw + mi * 16 + gq + (e >= 2 ? 8 : 0);
          const int v = c0 + wn * 48 + ni * 8 + 2 * tq + (e & 1);
          const int t = t0 + r / LABELS, u = u0 + r % LABELS;
          if (t >= dm.T || u >= dm.U1 || v >= V8) continue;
          float d = 0.f;  // the row's padding past V1 is zero
          if (v < dm.V1) {
            const float z = tot[mi][ni][e] + bias[(size_t)b * dm.V1 + v];
            const float one = (v == dm.blank ? Pb[r] : 0.f) + (v == Pk[r] ? Pc[r] : 0.f);
            d = one - expf(z - Pl[r]) * (Pb[r] + Pc[r]);
          }
          dlogits[(((size_t)b * dm.T + t) * dm.U1 + u) * V8 + v] = d;
        }
  }
  __syncthreads();  // the tile's dlogits written; x no longer read

  // (b) the tile's dlogits into the shared memory x held; a thread moves 8
  // columns, four such loads in flight
  {
    const int gpr = V8 / 8;
    for (int i0 = threadIdx.x; i0 < BM * gpr; i0 += 4 * THREADS) {
      float4 lo[4], hi[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + q * THREADS, r = i / gpr, c = i % gpr;
        const int t = t0 + r / LABELS, u = u0 + r % LABELS;
        const bool ok = i < BM * gpr && t < dm.T && u < dm.U1;
        const float4* src = reinterpret_cast<const float4*>(
                                dlogits + (((size_t)b * dm.T + t) * dm.U1 + u) * V8) + 2 * c;
        lo[q] = ok ? __ldcg(src) : make_float4(0.f, 0.f, 0.f, 0.f);
        hi[q] = ok ? __ldcg(src + 1) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + q * THREADS;
        if (i >= BM * gpr) continue;
        float4* dst = reinterpret_cast<float4*>(Gs + i / gpr * L.gs + i % gpr * 8);
        dst[0] = lo[q];
        dst[1] = hi[q];
      }
    }
  }
  __syncthreads();

  // (c) d_x = dlogits . W^T in chunks of CN columns of H, reduced to df, dg
  const float gscale = dr.on ? dr.scale : 1.f;
  for (int h0 = 0; h0 < dm.H; h0 += CN) {
    float acc[MI][4][4] = {}, tot[MI][4][4] = {};
    const int nk = (dm.V1 + KT - 1) / KT;
#pragma unroll
    for (int s = 0; s < NSTAGE - 1; ++s) {
      if (s < nk) load_head_c(Ws + s * WSTAGE, wb, s, h0, dm);
      cp_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_wait<NSTAGE - 2>();
      __syncthreads();
      if (kt + NSTAGE - 1 < nk)
        load_head_c(Ws + (kt + NSTAGE - 1) % NSTAGE * WSTAGE, wb, kt + NSTAGE - 1, h0, dm);
      cp_commit();
      const float* Wt = Ws + kt % NSTAGE * WSTAGE;
#pragma unroll
      for (int ks = 0; ks < KT / 8; ++ks) {
        const int k = kt * KT + ks * 8;
        if (k >= V8) break;
        uint32_t ab[MI][4], as[MI][4], bb[4][2], bs[4][2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          const float* g0 = Gs + (rw + mi * 16 + gq) * L.gs + k + tq;
          const float* g8 = g0 + 8 * L.gs;
          const float v[4] = {g0[0], g8[0], g0[4], g8[4]};
          frag_a<true>(v, ab[mi], as[mi]);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const float* w0 = Wt + (wn * 32 + ni * 8 + gq) * (KT + 4) + ks * 8 + tq;
          frag_b(w0[0], w0[4], bb[ni], bs[ni]);
        }
        mma_passes<MI, 4, true, true>(acc, ab, as, bb, bs);
      }
      if ((kt + 1) % (PROMOTE / (KT / 8)) == 0) promote<MI, 4>(tot, acc);
    }
    __syncthreads();
    promote<MI, 4>(tot, acc);
    // the masked d_x tile into the ring's shared memory, [BM][CN + 8]
    float* Ds = Ws;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = rw + mi * 16 + gq + 8 * half, col = wn * 32 + ni * 8 + 2 * tq;
          const int h = h0 + col;  // even: h and h + 1 share a mask byte
          const unsigned m = h < HP ? Ms[r * MB + h / 8] >> (h % 8) : 0u;
          const bool l0 = m & 1u, l1 = m & 2u;
          float2 d;
          d.x = l0 ? tot[mi][ni][2 * half] * gscale : 0.f;
          d.y = l1 ? tot[mi][ni][2 * half + 1] * gscale : 0.f;
          *reinterpret_cast<float2*>(Ds + r * (CN + 8) + col) = d;
        }
    __syncthreads();
    // df sums a frame's labels, dg a label's frames: one f32 atomic per
    // value and tile
    for (int i = threadIdx.x; i < (TT + LABELS) * CN; i += THREADS) {
      const int row = i / CN, col = i % CN, h = h0 + col;
      if (h >= dm.H) continue;
      float sum = 0.f;
      if (row < TT) {
#pragma unroll
        for (int u = 0; u < LABELS; ++u) sum += Ds[(row * LABELS + u) * (CN + 8) + col];
        if (t0 + row < dm.T) atomicAdd(&df[((size_t)b * dm.T + t0 + row) * dm.H + h], sum);
      } else {
        const int u = row - TT;
#pragma unroll
        for (int fr = 0; fr < TT; ++fr) sum += Ds[(fr * LABELS + u) * (CN + 8) + col];
        if (u0 + u < dm.U1) atomicAdd(&dg[((size_t)b * dm.U1 + u0 + u) * dm.H + h], sum);
      }
    }
    __syncthreads();  // the ring is free for the next chunk
  }
}

// Issue the copies of kernel 2's stage for pairs kt*KP..: their x over the
// block's rows of H and their dlogits over its columns of V1, from the
// scratch's padded rows; one commit group.
template <typename T>
__device__ __forceinline__ void dw_issue(unsigned char* st, const T* xl, const float* gl,
                                         int kt, int h0, int v0, const Dims& dm) {
  using namespace bwd;
  constexpr int EPC = 16 / (int)sizeof(T), XC = BH / EPC, GC = NB * 8 / 4;
  const int P = dm.T * dm.U1, HP = pad8(dm.H), V8 = pad8(dm.V1);
  T* X = reinterpret_cast<T*>(st);
  float* G = reinterpret_cast<float*>(st + DwStage<T>::XBYTES);
  for (int i = threadIdx.x; i < KP * XC; i += THREADS) {
    const int pp = i / XC, c = i % XC, p = kt * KP + pp, h = h0 + c * EPC;
    const bool ok = p < P && h < HP;
    cp16(X + pp * XSD + c * EPC, ok ? xl + (size_t)p * HP + h : xl, ok);
  }
  for (int i = threadIdx.x; i < KP * GC; i += THREADS) {
    const int pp = i / GC, c = i % GC, p = kt * KP + pp, v = v0 + c * 4;
    const bool ok = p < P && v < V8;
    cp16(G + pp * GSD + c * 4, ok ? gl + (size_t)p * V8 + v : gl, ok);
  }
  cp_commit();
}

// Kernel 2: dW[b] = x^T . dlogits over the row's T*U1 pairs, 128 rows of H
// x 88 columns of V1 a block; the first H tile's blocks also sum db.
template <typename T>
__global__ void __launch_bounds__(bwd::THREADS)
joint_dw_db_kernel(const float* __restrict__ dlogits, float* __restrict__ dw,
                   float* __restrict__ db, Dims dm) {
  using namespace bwd;
  constexpr bool SX = sizeof(T) == 4;
  using S = DwStage<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.z, h0 = blockIdx.y * BH, v0 = blockIdx.x * NB * 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int P = dm.T * dm.U1, nk = (P + KP - 1) / KP, V8 = pad8(dm.V1);
  const float* gl = dlogits + (size_t)b * P * V8;
  const T* xl = reinterpret_cast<const T*>(dlogits + (size_t)gridDim.z * P * V8) +
                (size_t)b * P * pad8(dm.H);
  const bool bias_thread = blockIdx.y == 0 && threadIdx.x < NB * 8;
  float dbias[4] = {};

  float acc[1][NB][4] = {}, tot[1][NB][4] = {};
#pragma unroll
  for (int s = 0; s < DSTAGE - 1; ++s) {
    if (s < nk) dw_issue<T>(smem_raw + s * S::BYTES, xl, gl, s, h0, v0, dm);
    else cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<DSTAGE - 2>();
    __syncthreads();  // stage kt landed; every warp is done with stage kt-1
    if (kt + DSTAGE - 1 < nk)
      dw_issue<T>(smem_raw + (kt + DSTAGE - 1) % DSTAGE * S::BYTES, xl, gl, kt + DSTAGE - 1,
                  h0, v0, dm);
    else
      cp_commit();
    const unsigned char* st = smem_raw + kt % DSTAGE * S::BYTES;
    const T* X = reinterpret_cast<const T*>(st);
    const float* G = reinterpret_cast<const float*>(st + S::XBYTES);
    if (bias_thread)
#pragma unroll
      for (int pp = 0; pp < KP; ++pp) dbias[pp % 4] += G[pp * GSD + threadIdx.x];
#pragma unroll
    for (int ks = 0; ks < KP / 8; ++ks) {
      const T* x0 = X + (ks * 8 + tq) * XSD + warp * 16 + gq;
      const float v[4] = {to_f<T>(x0[0]), to_f<T>(x0[8]), to_f<T>(x0[4 * XSD]),
                          to_f<T>(x0[4 * XSD + 8])};
      uint32_t ab[4], as[4];
      frag_a<SX>(v, ab, as);
      // NG tiles at a time: fewer split values live at once
#pragma unroll
      for (int n0 = 0; n0 < NB; n0 += NG) {
        uint32_t bb[NG][2], bs[NG][2];
#pragma unroll
        for (int j = 0; j < NG && n0 + j < NB; ++j) {
          const float* g0 = G + (ks * 8 + tq) * GSD + (n0 + j) * 8 + gq;
          frag_b(g0[0], g0[4 * GSD], bb[j], bs[j]);
        }
        if (SX) {
#pragma unroll
          for (int j = 0; j < NG && n0 + j < NB; ++j) mma(acc[0][n0 + j], as, bb[j]);
        }
#pragma unroll
        for (int j = 0; j < NG && n0 + j < NB; ++j) mma(acc[0][n0 + j], ab, bs[j]);
#pragma unroll
        for (int j = 0; j < NG && n0 + j < NB; ++j) mma(acc[0][n0 + j], ab, bb[j]);
      }
    }
    if ((kt + 1) % (PROMOTE / (KP / 8)) == 0) promote<1, NB>(tot, acc);
  }
  promote<1, NB>(tot, acc);
#pragma unroll
  for (int ni = 0; ni < NB; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hr = h0 + warp * 16 + gq + (e >= 2 ? 8 : 0);
      const int v = v0 + ni * 8 + 2 * tq + (e & 1);
      if (hr < dm.H && v < dm.V1) dw[((size_t)b * dm.H + hr) * dm.V1 + v] = tot[0][ni][e];
    }
  if (bias_thread && v0 + (int)threadIdx.x < dm.V1)
    db[(size_t)b * dm.V1 + v0 + threadIdx.x] = (dbias[0] + dbias[1]) + (dbias[2] + dbias[3]);
}

// the head [B*H][V1] into the scratch with its rows padded to V8 by zeros
__global__ void joint_pad_head_kernel(const float* __restrict__ w, float* __restrict__ wp,
                                      int rows, int V1) {
  const int V8 = bwd::pad8(V1);
  const size_t n = (size_t)rows * V8;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int v = i % V8;
    wp[i] = v < V1 ? w[i / V8 * V1 + v] : 0.f;
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
int bwd_smem(const Dims& dm) {
  const int k1 = bwd::layout<T>(dm.H, dm.V1).total;
  constexpr int k2 = bwd::DSTAGE * bwd::DwStage<T>::BYTES;
  return k1 > k2 ? k1 : k2;
}

template <typename T>
cudaError_t launch_bwd(const void* f, const void* g, const void* w, const void* bias,
                       const void* labels, const void* lse, const void* dlpb,
                       const void* dlpl, void* dlogits, void* df, void* dg, void* dw,
                       void* db, int B, const Dims& dm, const Drop& dr,
                       cudaStream_t stream) {
  const int smem = bwd::layout<T>(dm.H, dm.V1).total;
  if (bwd_smem<T>(dm) > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(joint_dlogits_dx_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  joint_pad_head_kernel<<<264, 256, 0, stream>>>(
      (const float*)w,
      (float*)dlogits + bwd::scratch_head<T>(B, dm.T, dm.U1, dm.H, dm.V1),
      B * dm.H, dm.V1);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  joint_form_kernel<T><<<132 * 8, bwd::THREADS, 0, stream>>>((const T*)f, (const T*)g,
                                                             (float*)dlogits, B, dm, dr);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  constexpr int TT = bwd::Tile<T>::TT;
  const dim3 grid((dm.T + TT - 1) / TT, (dm.U1 + bwd::LABELS - 1) / bwd::LABELS, B);
  joint_dlogits_dx_kernel<T><<<grid, bwd::THREADS, smem, stream>>>(
      (const float*)bias, (const int*)labels, (const float*)lse, (const float*)dlpb,
      (const float*)dlpl, (float*)dlogits, (float*)df, (float*)dg, dm, dr);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  constexpr int smem2 = bwd::DSTAGE * bwd::DwStage<T>::BYTES;
  e = cudaFuncSetAttribute(joint_dw_db_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem2);
  if (e != cudaSuccess) return e;
  const dim3 grid2(((dm.V1 + 7) / 8 + bwd::NB - 1) / bwd::NB, (dm.H + bwd::BH - 1) / bwd::BH, B);
  joint_dw_db_kernel<T><<<grid2, bwd::THREADS, smem2, stream>>>(
      (const float*)dlogits, (float*)dw, (float*)db, dm);
  return cudaGetLastError();
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

// df [B,T,H] and dg [B,U1,H] f32 must be zeroed; dlogits is scratch of
// joint_fused_bwd_scratch(...) 4-byte words; dw [B,H,V1] and db [B,V1]
// f32 are written whole
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

// 4-byte words of the backward's scratch: dlogits, then the joint input
extern "C" long long joint_fused_bwd_scratch(int B, int T, int U1, int H, int V1, int dtype) {
  return (long long)(dtype == 0 ? bwd::scratch_words<float>(B, T, U1, H, V1)
                                : bwd::scratch_words<__nv_bfloat16>(B, T, U1, H, V1));
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


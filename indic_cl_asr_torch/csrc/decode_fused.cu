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
// Design: greedy rows are independent, so each batch row is one
// thread-block cluster of C blocks (C = 8, the portable maximum: a serving
// batch of 16 rows is 128 blocks, one wave on the H100's 132 SMs) that
// walks its own frames and emission loop with its own language's head
// (a batch may mix languages; the TPU kernel, one loop over the whole
// batch, holds a single head). The weights stay in device memory and L2;
// each block of a cluster streams only its own slice of them, given by
// the wrapper (ops/decode_fused.py:cluster_split) in whole 16-byte groups:
//
//   - hidden units [unit[c], unit[c+1]): all four gate columns (i, f, g,
//     o) of each, so the cell update is local and the f32 cell state of
//     those units stays in the block's shared memory;
//   - projection columns [proj[c], proj[c+1]) of W_p;
//   - head columns [head[c], head[c+1]) (uneven shares: 33 groups of 8
//     bf16 over 8 blocks); the zero-padded columns past V1 are loaded with
//     their group but never scored.
//
// The blocks exchange what the next product needs through distributed
// shared memory (each writes into every peer's copy, then one barrier of
// the cluster): the new h of its units after the gates, its columns of g
// after the projection, and its (best logit, first index) after the joint;
// every block then reduces the C candidates in rank order with the same
// tie rule, so all of them hold the same prediction and take the same
// branch. Each block keeps the full h (double-buffered: a peer may send
// the next h while this block still reads the current one), the full g
// and the joint input in shared memory. Block 0 alone writes ids, lens
// and the work counters.
//
// Each mat-vec splits the block's columns into 16-byte vectors (8 bf16 or
// 4 f32 per load) and its depth into KS slices so every thread has loads
// in flight; the slices' f32 partial sums are added in a fixed order (runs
// of consecutive slices, then the runs in order). Rounding matches the
// plain version: every dot accumulates in f32 and is rounded to the
// compute dtype, then each elementwise op of the LSTM cell is rounded as
// PyTorch rounds it; the cell state is kept in f32.
//
// Bound: per LSTM step a row reads W_ih, W_hh and W_p (~7.3 MB in bf16 at
// flagship widths), now 1/C of it into each of C SMs, and per joint 1/C of
// its head each; steps of a row still run one after another. So the
// launch lasts as long as its longest row's chain: per step, the L2 draw
// of the cluster's SMs plus two cluster barriers and four block barriers;
// per joint, the latency of a short head slice, one cluster barrier and
// three block barriers. Both stay far above the bytes bound of the launch
// (f_proj + weights once, ~12 MB). PERF.md gives the measured split.
//
// Layouts (row-major): f [B, T, Hj]; table [V, Hp]; w_ih, w_hh [Hp, 4Hp]
// (gate order i, f, g, o); bias [4Hp]; wp [Hp, Hj]; bp [Hj];
// head [L, Hj, V1p] (V1 = V+1 columns, blank last, zero-padded to V1p, a
// multiple of 8); head_b [L, V1] f32; lang_ids [B] (clamped to [0, L), as
// a JAX gather clamps). Outputs ids [B, max_out], lens [B];
// work[0] += joint evaluations, work[1] += LSTM steps, work[2] and work[3]
// the most of either that one row ran.

#include <cooperative_groups.h>

#include <algorithm>

#include "decode_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace decode_common;

// 640 threads split every flagship mat-vec of a block of 8 evenly: its
// 40 gate groups of 8 bf16 sixteen times over, its 10 projection groups
// 64 times, its 4 or 5 head groups 160 or 128 times
constexpr int MAX_THREADS = 640;
constexpr int MAX_CLUSTER = 16;

// Each block's columns in a cluster of C (from the wrapper), and the
// sizes of its shared buffers.
struct Split {
  int unit[MAX_CLUSTER + 1];  // hidden units (all four gates of each)
  int proj[MAX_CLUSTER + 1];  // columns of W_p
  int head[MAX_CLUSTER + 1];  // columns of the head (padded to V1p)
  int pbuf, rbuf, cmax;       // partial sums, run sums, cell state
};

__device__ inline int split_of(int threads, int groups) {
  const int ks = groups > 0 ? threads / groups : 1;
  return ks < 1 ? 1 : ks;
}

// number of runs the KS slices of N columns are summed in: as many as
// the threads allow, at most one per slice
__device__ inline int runs_of(int threads, int N, int KS) {
  int r = N > 0 ? threads / N : 1;
  r = r < 1 ? 1 : r;
  return r < KS ? r : KS;
}

// part[s*N + n] = sum over k in slice s of x[k] * W[k*ld + col], for the
// N = G*VEC columns of G 16-byte groups, group gi starting at global
// column col0(gi); the same for (x2, W2) into part2 when TWO. Block-wide;
// the caller synchronises.
template <typename T, bool TWO, typename ColOf>
__device__ void matvec_partial(const float* x, const T* __restrict__ W,
                               const float* x2, const T* __restrict__ W2,
                               int K, int ld, int G, ColOf col0, float* part,
                               float* part2) {
  constexpr int VEC = Vec16<T>::N;
  const int N = G * VEC;
  const int KS = split_of(blockDim.x, G);
  for (int it = threadIdx.x; it < KS * G; it += blockDim.x) {
    const int g = it % G, s = it / G;
    const int k0 = (s * K) / KS, k1 = ((s + 1) * K) / KS;
    float acc[VEC], acc2[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = acc2[e] = 0.f;
    const int col = col0(g);
    const T* wp = W + (size_t)k0 * ld + col;
    const T* wp2 = TWO ? W2 + (size_t)k0 * ld + col : nullptr;
#pragma unroll 4
    for (int kk = k0; kk < k1; ++kk) {
      float w[VEC];
      Vec16<T>::load(wp, w);
      const float xv = x[kk];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = fmaf(xv, w[e], acc[e]);
      wp += ld;
      if (TWO) {
        float w2[VEC];
        Vec16<T>::load(wp2, w2);
        const float xv2 = x2[kk];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc2[e] = fmaf(xv2, w2[e], acc2[e]);
        wp2 += ld;
      }
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      part[s * N + g * VEC + e] = acc[e];
      if (TWO) part2[s * N + g * VEC + e] = acc2[e];
    }
  }
}

// runs[r*N + n] = the sum of slices [r*KS/R, (r+1)*KS/R) of column n of
// part [KS, N], in slice order, R = runs_of(blockDim.x, N, KS).
// Block-wide; the caller synchronises.
__device__ void sum_runs(const float* part, int N, int KS, float* runs) {
  const int R = runs_of(blockDim.x, N, KS);
  for (int it = threadIdx.x; it < R * N; it += blockDim.x) {
    const int n = it % N, r = it / N;
    const int s0 = (r * KS) / R, s1 = ((r + 1) * KS) / R;
    float acc = part[s0 * N + n];
    for (int s = s0 + 1; s < s1; ++s) acc += part[s * N + n];
    runs[r * N + n] = acc;
  }
}

// the whole dot of column n: its R run sums, in run order
__device__ __forceinline__ float dot_of(const float* runs, int N, int R, int n) {
  float acc = runs[n];
  for (int r = 1; r < R; ++r) acc += runs[r * N + n];
  return acc;
}

struct Smem {
  float *pa, *pb, *ra, *rb, *h[2], *g, *x, *emb, *c, *bv;
  int* bi;
};

__device__ Smem carve(float* base, const Split& sp, int Hj, int Hp) {
  Smem s;
  s.pa = base;
  s.pb = s.pa + sp.pbuf;
  s.ra = s.pb + sp.pbuf;
  s.rb = s.ra + sp.rbuf;
  s.h[0] = s.rb + sp.rbuf;
  s.h[1] = s.h[0] + Hp;
  s.g = s.h[1] + Hp;
  s.x = s.g + Hj;
  s.emb = s.x + Hj;
  s.c = s.emb + Hp;
  s.bv = s.c + sp.cmax;  // [2][MAX_CLUSTER]: one set per joint parity
  s.bi = reinterpret_cast<int*>(s.bv + 2 * MAX_CLUSTER);
  return s;
}

// One prediction-net step of the row across its cluster, on s.emb and the
// full h in s.h[cur]: the gates of this block's units [u0, u0+U), their
// cell update, and their new h written into every block's s.h[cur ^ 1];
// one cluster barrier; then g = round(round(h·W_p) + b_p) of this block's
// projection columns [j0, j0+P) written into every block's s.g; a second
// barrier. On return every block holds the full new h and g.
//
// Writing s.h[cur ^ 1] of a peer is safe: the peer last read it as its
// input of the step before, and this block passed that step's barriers
// only after the peer had arrived, its gates done. Writing s.g is safe:
// a peer reads it only to form the joint input, before the barrier of
// the joint that led to this step.
template <typename T>
__device__ void lstm_step(cg::cluster_group& cluster, const Smem& s, int cur,
                          const T* __restrict__ w_ih, const T* __restrict__ w_hh,
                          const T* __restrict__ bias, const T* __restrict__ wp,
                          const T* __restrict__ bp, int Hj, int Hp, int u0, int U,
                          int j0, int P) {
  constexpr int VEC = Vec16<T>::N;
  const int C = (int)cluster.num_blocks();
  const int UG = U / VEC, GU = 4 * UG, NG = 4 * U;
  matvec_partial<T, true>(
      s.emb, w_ih, s.h[cur], w_hh, Hp, 4 * Hp, GU,
      [=](int gi) { return (gi / UG) * Hp + u0 + (gi % UG) * VEC; }, s.pa, s.pb);
  __syncthreads();
  const int KSg = split_of(blockDim.x, GU);
  sum_runs(s.pa, NG, KSg, s.ra);
  sum_runs(s.pb, NG, KSg, s.rb);
  __syncthreads();
  const int Rg = runs_of(blockDim.x, NG, KSg);
  float* h_next = s.h[cur ^ 1];
  for (int i = threadIdx.x; i < U; i += blockDim.x) {
    float gate[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = q * U + i;
      const float xw = rnd<T>(rnd<T>(dot_of(s.ra, NG, Rg, n)) + to_f<T>(bias[q * Hp + u0 + i]));
      gate[q] = rnd<T>(xw + rnd<T>(dot_of(s.rb, NG, Rg, n)));
    }
    const float ig = rnd<T>(sigm(gate[0]));
    const float fg = rnd<T>(sigm(gate[1]));
    const float gg = rnd<T>(tanhf(gate[2]));
    const float og = rnd<T>(sigm(gate[3]));
    const float cn = rnd<T>(rnd<T>(fg * rnd<T>(s.c[i])) + rnd<T>(ig * gg));
    s.c[i] = cn;
    const float hv = rnd<T>(og * rnd<T>(tanhf(cn)));
    for (int r = 0; r < C; ++r) cluster.map_shared_rank(h_next, r)[u0 + i] = hv;
  }
  cluster.sync();
  const int GP = P / VEC;
  matvec_partial<T, false>(
      h_next, wp, nullptr, nullptr, Hp, Hj, GP,
      [=](int gi) { return j0 + gi * VEC; }, s.pa, nullptr);
  __syncthreads();
  const int KSp = split_of(blockDim.x, GP);
  sum_runs(s.pa, P, KSp, s.ra);
  __syncthreads();
  const int Rp = runs_of(blockDim.x, P, KSp);
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const float gv = rnd<T>(rnd<T>(dot_of(s.ra, P, Rp, i)) + to_f<T>(bp[j0 + i]));
    for (int r = 0; r < C; ++r) cluster.map_shared_rank(s.g, r)[j0 + i] = gv;
  }
  cluster.sync();
}

__device__ __forceinline__ void take_better(float v, int i, float& best, int& bi) {
  if (v > best || (v == best && i < bi)) {
    best = v;
    bi = i;
  }
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
    unsigned long long* __restrict__ work, const Split split, int T_, int Hj,
    int Hp, int V1, int V1p, int L, int blank, int max_symbols, int max_out) {
  constexpr int VEC = Vec16<T>::N;
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int u0 = split.unit[rank], U = split.unit[rank + 1] - u0;
  const int j0 = split.proj[rank], P = split.proj[rank + 1] - j0;
  const int v0 = split.head[rank], NH = split.head[rank + 1] - v0;
  int n = flens[b];
  n = n < 0 ? 0 : (n > T_ ? T_ : n);
  const int lang = min(max(lang_ids[b], 0), L - 1);
  const T* head = heads + (size_t)lang * Hj * V1p;
  const float* head_b = heads_b + (size_t)lang * V1;
  int* out = out_ids + (size_t)b * max_out;
  if (rank == 0)
    for (int i = tid; i < max_out; i += blockDim.x) out[i] = blank;
  if (n == 0) {  // uniform over the cluster: no block touches a peer
    if (rank == 0 && tid == 0) out_lens[b] = 0;
    return;
  }
  const Smem s = carve(smem, split, Hj, Hp);
  // SOS priming: a blank label feeds a zero embedding into a zero state
  for (int i = tid; i < Hp; i += blockDim.x) s.emb[i] = s.h[0][i] = 0.f;
  for (int i = tid; i < U; i += blockDim.x) s.c[i] = 0.f;
  // every block of the cluster runs, its state zeroed, before peers write
  cluster.sync();
  int cur = 0;
  lstm_step<T>(cluster, s, cur, w_ih, w_hh, bias, wp, bp, Hj, Hp, u0, U, j0, P);
  cur ^= 1;
  unsigned long long n_joint = 0, n_lstm = 1;
  int out_len = 0;
  const int GH = NH / VEC;
  const int KSh = split_of(blockDim.x, GH);
  const int Rh = runs_of(blockDim.x, NH, KSh);
  constexpr int LINE = 128 / sizeof(T);  // elements of one L2 line

  for (int t = 0; t < n; ++t) {
    const T* ft = f + ((size_t)b * T_ + t) * Hj;
    if (t + 1 < n)  // the next frame's row, into L2 while this one decodes
      for (int i = tid * LINE; i < Hj; i += blockDim.x * LINE)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(ft + Hj + i));
    for (int k = 0; k < max_symbols; ++k) {
      for (int i = tid; i < Hj; i += blockDim.x)
        s.x[i] = fmaxf(rnd<T>(to_f<T>(ft[i]) + s.g[i]), 0.f);
      __syncthreads();
      matvec_partial<T, false>(
          s.x, head, nullptr, nullptr, Hj, V1p, GH,
          [=](int gi) { return v0 + gi * VEC; }, s.pa, nullptr);
      __syncthreads();
      sum_runs(s.pa, NH, KSh, s.ra);
      __syncthreads();
      // this block's best (logit, first index) over its scored columns,
      // sent into every block's slot of this joint's parity
      const int par = (int)(n_joint & 1) * MAX_CLUSTER;
      if (warp == 0) {
        float best = -INFINITY;
        int bi = 0x7fffffff;
        for (int i = lane; i < NH && v0 + i < V1; i += 32)
          take_better(dot_of(s.ra, NH, Rh, i) + head_b[v0 + i], v0 + i, best, bi);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, best, off);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
          take_better(ov, oi, best, bi);
        }
        if (lane < C) {
          cluster.map_shared_rank(s.bv, lane)[par + rank] = best;
          cluster.map_shared_rank(s.bi, lane)[par + rank] = bi;
        }
      }
      // a slot of one parity is written again two joints later, after
      // every block has passed the next joint's barrier, so after it read
      cluster.sync();
      float best = s.bv[par];
      int pred = s.bi[par];
      for (int r = 1; r < C; ++r) take_better(s.bv[par + r], s.bi[par + r], best, pred);
      ++n_joint;
      if (pred == blank || out_len >= max_out) break;  // uniform over the cluster
      if (rank == 0 && tid == 0) out[out_len] = pred;
      ++out_len;
      for (int i = tid; i < Hp; i += blockDim.x)
        s.emb[i] = to_f<T>(table[(size_t)pred * Hp + i]);
      __syncthreads();
      lstm_step<T>(cluster, s, cur, w_ih, w_hh, bias, wp, bp, Hj, Hp, u0, U, j0, P);
      cur ^= 1;
      ++n_lstm;
    }
  }
  if (rank == 0 && tid == 0) {
    out_lens[b] = out_len;
    atomicAdd(work, n_joint);
    atomicAdd(work + 1, n_lstm);
    atomicMax(work + 2, n_joint);
    atomicMax(work + 3, n_lstm);
  }
  // every write into a peer came before a barrier all blocks passed; this
  // last one keeps each block's shared memory alive until all are done
  cluster.sync();
}

// bounds[3][C+1] (units, projection columns, head columns) must start at
// 0, rise, be multiples of the vector width and end at Hp, Hj and V1p.
template <typename T>
bool fill_split(const int* bounds, int C, int Hp, int Hj, int V1p, int threads,
                Split& sp) {
  constexpr int VEC = Vec16<T>::N;
  const int ends[3] = {Hp, Hj, V1p};
  int* dst[3] = {sp.unit, sp.proj, sp.head};
  int most[3] = {0, 0, 0};
  for (int a = 0; a < 3; ++a) {
    const int* src = bounds + a * (C + 1);
    if (src[0] != 0 || src[C] != ends[a]) return false;
    for (int c = 0; c <= C; ++c) {
      if (src[c] % VEC || (c > 0 && src[c] < src[c - 1])) return false;
      dst[a][c] = src[c];
      if (c > 0 && src[c] - src[c - 1] > most[a]) most[a] = src[c] - src[c - 1];
    }
  }
  const int widest = std::max(4 * most[0], std::max(most[1], most[2]));
  sp.pbuf = std::max(threads * VEC, widest);
  sp.rbuf = std::max(threads, widest);
  sp.cmax = most[0];
  return true;
}

size_t smem_bytes(const Split& sp, int Hp, int Hj) {
  return sizeof(float) * (2 * (size_t)sp.pbuf + 2 * (size_t)sp.rbuf + 3 * (size_t)Hp +
                          2 * (size_t)Hj + sp.cmax + 2 * MAX_CLUSTER) +
         sizeof(int) * 2 * MAX_CLUSTER;
}

// The card's own limits: one block's shared memory (its partial and run
// sums, the full h twice, g, the joint input, the embedding row and its
// units' cell state) must fit what cudaFuncSetAttribute grants, 227 KB a
// block on an H100, and C blocks of that size must fit one GPC; over
// either the call or the launch fails and returns its error.
template <typename T>
cudaError_t launch(const void* f, const void* flens, const void* lang_ids,
                   const void* table, const void* w_ih, const void* w_hh,
                   const void* bias, const void* wp, const void* bp,
                   const void* head, const void* head_b, void* ids, void* olen,
                   void* work, int B, int T_, int Hj, int Hp, int V1, int V1p,
                   int L, int blank, int max_symbols, int max_out, int threads,
                   int C, const int* bounds, cudaStream_t stream) {
  constexpr int VEC = Vec16<T>::N;
  Split sp;
  if (threads % 32 || threads > MAX_THREADS || threads < 32 || C < 1 ||
      C > MAX_CLUSTER || Hp % VEC || Hj % VEC || V1p % VEC || V1p < V1 || L < 1 ||
      !fill_split<T>(bounds, C, Hp, Hj, V1p, threads, sp))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(sp, Hp, Hj);
  auto kernel = rnnt_greedy_decode_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  if (C > 8) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(
      &cfg, kernel, (const T*)f, (const int*)flens, (const int*)lang_ids,
      (const T*)table, (const T*)w_ih, (const T*)w_hh, (const T*)bias, (const T*)wp,
      (const T*)bp, (const T*)head, (const float*)head_b, (int*)ids, (int*)olen,
      (unsigned long long*)work, sp, T_, Hj, Hp, V1, V1p, L, blank, max_symbols,
      max_out);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" int rnnt_greedy_decode_fused(
    const void* f, const void* flens, const void* lang_ids, const void* table,
    const void* w_ih, const void* w_hh, const void* bias, const void* wp,
    const void* bp, const void* head, const void* head_b, void* ids,
    void* olen, void* work, int B, int T_, int Hj, int Hp, int V1, int V1p,
    int L, int blank, int max_symbols, int max_out, int dtype, int threads,
    int cluster, const int* bounds, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (dtype == 0)
    e = launch<float>(f, flens, lang_ids, table, w_ih, w_hh, bias, wp, bp,
                      head, head_b, ids, olen, work, B, T_, Hj, Hp, V1, V1p,
                      L, blank, max_symbols, max_out, threads, cluster, bounds, s);
  else if (dtype == 1)
    e = launch<__nv_bfloat16>(f, flens, lang_ids, table, w_ih, w_hh, bias, wp,
                              bp, head, head_b, ids, olen, work, B, T_, Hj, Hp,
                              V1, V1p, L, blank, max_symbols, max_out, threads,
                              cluster, bounds, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

// Dynamic shared memory one block of the launch asks for, or -1 where the
// launch would refuse the widths or the split.
extern "C" long long rnnt_greedy_decode_smem_bytes(int Hj, int Hp, int V1p, int dtype,
                                                   int threads, int cluster,
                                                   const int* bounds) {
  Split sp;
  if (cluster < 1 || cluster > MAX_CLUSTER) return -1;
  const bool ok = dtype == 0 ? fill_split<float>(bounds, cluster, Hp, Hj, V1p, threads, sp)
                : dtype == 1 ? fill_split<__nv_bfloat16>(bounds, cluster, Hp, Hj, V1p,
                                                         threads, sp)
                             : false;
  return ok ? (long long)smem_bytes(sp, Hp, Hj) : -1;
}

extern "C" const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

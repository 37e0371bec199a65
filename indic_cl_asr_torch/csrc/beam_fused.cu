// Fused frame-synchronous RNNT beam search for Hopper (sm_90a).
//
// Replaces the TPU kernel indic_cl_asr_tpu/ops/beam_fused_pallas.py:
// rnnt_beam_search_fused (pl.pallas_call at line 468, body _kernel at
// line 97). Contract: ops/beam_search.py rnnt_beam_search_batched over the
// model's own pred_step / joint_step (ops/beam_fused.py), each row with the
// head of its own language. Per row and frame t < len:
//
//   done_k = score_k <= NEG/2 (dead slots never expand)
//   up to max_expansions rounds while some hypothesis of the row is live:
//     lp_k    = log_softmax(relu(round(f_t + g_k)) · head + head_b)  (f32)
//     cand    = per parent k: [stay_k, ext_k_0 .. ext_k_{P-1}]
//               stay = done ? score : score + lp_k[blank]
//               ext  = live and len < max_out ? score + top-P non-blank : NEG
//     the K best candidates, lowest index first among equal values
//     children copy their parent (tokens, len, g, h, c); an extension
//     appends its token and takes one LSTM step; done |= stay
//   score += lp[blank] for the hypotheses still live (force-finalise)
//   logaddexp-merge equal label sequences, pairs (i, j), i < j, into i
// and the best hypothesis (first index of the largest score) at the end.
//
// Design: each batch row is one thread-block cluster of C blocks (C = 8:
// a serving batch of 16 rows is 128 blocks, one wave on the H100's 132
// SMs) of 256 threads, as the greedy decode (decode_fused.cu) is. Each
// block streams only its own slice of the weights, given by the wrapper
// (ops/decode_fused.py:cluster_split) in whole 16-byte groups: all four
// gates of its hidden units (so the f32 cell state of those units stays
// in the block), its columns of W_p and its columns of the row's head.
// Every weight is read once a round for all K hypotheses:
//
//   - f32 (the CPU-parity dtype): FMAs on the weights as they are, a
//     thread's 16-byte column group over a slice of the depth, eight rows
//     of loads in flight, four hypotheses' sums in registers;
//   - bf16: every mat-vec input (the joint input, an embedding row, h) is
//     a bf16 value, so the products run on the tensor cores
//     (mma.sync.m16n8k16, f32 sums) with the output columns as A rows and
//     up to eight hypotheses as B columns, on weights the wrapper
//     transposes (a row per output column, its depth contiguous; see
//     matvec_mma for the depth order inside a batch).
//
// The depth slices' partial sums meet in shared memory with a slice
// stride that puts a warp's 32 reads in 32 banks. What the next step
// needs is exchanged through distributed shared memory: each block writes
// into every peer's copy, then the cluster meets at one barrier.
//
// Replicated state. Every block holds the same tokens [K, max_out] (and a
// copy for the parent gather), lengths, scores, done flags, the full h
// [K, Hp] and g [K, Hj] of every hypothesis, and makes the same decisions
// from them; only the cell state is split by units. A round:
//
//   1. the joint of the K hypotheses on the block's head columns (f32);
//      per hypothesis the block's partial (max, sum of exp(x - max)) over
//      its columns, its top-P non-blank (logit, index), first index among
//      equal logits, and, in the block that owns it, the blank's logit,
//      written into every peer; barrier 1;
//   2. every block merges the C partials in rank order: max m, sum s =
//      sum_c s_c·exp(m_c - m), lse = log s, lp = (x - m) - lse for the
//      blank and for the C·P candidates, the top-P of those by (lp, then
//      the lower index): the same bits in every block. lp is monotone in
//      x, so the global top-P by lp lies in the union of the blocks'
//      top-P by logit, except where two logits round to one lp across the
//      P-th place, where the plain version's own trace shows a gap of 0;
//   3. the top-K of the K·(P+1) candidates, and the parent gather of
//      tokens, lengths, scores and the block's cell slice; h and g are
//      not moved: a slot's rows are found through hsrc / gsrc, composed
//      with each gather, so no peer's buffer is rewritten while it reads;
//   4. if a child emits: the gates of the block's units for the K
//      hypotheses (an extension's embedding row and its parent's h), the
//      cell update, and each slot's new h (a stay's: its parent's) written
//      into every peer's other h buffer; barrier 2; the projection on the
//      block's W_p columns, each slot's g (a stay's: its parent's) written
//      into every peer's other g buffer; barrier 3. A round that emits
//      nothing has one barrier.
//
// Each selection (a block's top-P, the merge's top-P, the top-K) ranks
// every candidate by the number that come before it (larger value, then
// lower index), one warp, the values passed by shuffles where they are at
// most 64, else read from shared memory: ranks are exact where repeated
// argmax passes would each wait on a shuffle tree.
//
// Agreement: every loop bound and branch (rounds, a row's early stop, the
// emit step, force-finalisation) is read from replicated state, and every
// cross-block reduction runs over the peers in rank order, so the blocks
// never take different branches. Buffer safety: the exchange of a joint
// alternates between two parities (a slot is written again two joints
// later, after every block passed the joint in between, so after it read);
// a peer's other h (g) buffer is written only after every block passed
// the barrier of the exchange that made the current buffer current, after
// which no block reads the other one.
//
// A row stops its expansion loop when all its hypotheses are done; the
// plain version loops while any row of the batch has a live hypothesis.
// The answers agree: after a round the beam is sorted by score, ties in
// candidate order; a further round over a row with no live hypothesis
// picks each finite hypothesis's stay candidate (its score; extensions of
// done parents are NEG) in that same order, so finite hypotheses keep
// their slot, tokens, length, state and score. Only slots at NEG may be
// refilled with other NEG candidates. Those are done (their parent was),
// are never merged, never beat a finite candidate and are never the best
// of a row that holds a finite hypothesis. Rows past their length are
// untouched in both.
//
// Bound: a round's LSTM step reads W_ih, W_hh and W_p (~7.3 MB bf16 at
// flagship widths), now 1/C of it into each SM of the row's cluster, and
// the head (~0.33 MB) once for the K joints; rounds of a row run one after
// another. So the launch lasts as long as its longest row's chain of
// rounds: a round without a step is a chain of short phases (the joint's
// slice of the head, the exchange, the merge, the top-K, the gather),
// each a few µs of latency; a round with one adds the L2 draw of the
// block's 0.9 MB of weights (PERF.md gives the measured split). Both stay
// far above the bytes bound of the launch.
//
// Numerics as in decode_fused.cu: every dot accumulates in f32 and is
// rounded to the compute dtype where the model's steps round; the cell
// state is f32; the log-softmax is (x - m) - log(sum exp(x - m)), its sum
// taken by blocks (the last bits differ from one sum over all columns).
//
// Layouts (row-major): f [B, T, Hj] (16-byte aligned); table [V, Hp];
// bias [4Hp]; bp [Hj]; head_b [L, V1] f32; lang_ids [B]; in f32 w_ih,
// w_hh [Hp, 4Hp], wp [Hp, Hj], head [L, Hj, V1p]; in bf16 transposed:
// w_ih, w_hh [4Hp, Hp], wp [Hj, Hp], head [L, V1p, Hj] (gate order i, f,
// g, o). Outputs ids [B, max_out], lens [B], scores [B] f32;
// work[0] += joint evaluations of live hypotheses, work[1] += LSTM steps
// of emitting hypotheses, work[2] += rounds (each row once, from block 0).

#include <cooperative_groups.h>

#include <algorithm>
#include <type_traits>

#include "decode_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace decode_common;

constexpr int MAX_THREADS = 256;
constexpr int MAX_K = 8;        // hypotheses a row (one warp each)
constexpr int MAX_P = 16;       // non-blank extensions per hypothesis
constexpr int MAX_CLUSTER = 8;  // blocks a row
constexpr int NVEC = 4;         // hypotheses per pass of a mat-vec
constexpr float NEG = -1e30f;   // dead score: finite, as in the plain version
constexpr int NONE = 0x7fffffff;

// Each block's columns in a cluster of C (from the wrapper), the widest
// share of each, and the floats a hypothesis's partial sums may take.
struct Split {
  int unit[MAX_CLUSTER + 1];  // hidden units (all four gates of each)
  int proj[MAX_CLUSTER + 1];  // columns of W_p
  int head[MAX_CLUSTER + 1];  // columns of the head (padded to V1p)
  int umax, pk;
};

// replicated small state (every block holds the same values)
struct Small {
  float score[MAX_K], nscore[MAX_K], lpb[MAX_K];
  float ext_lp[MAX_K * MAX_P], cand[MAX_K * (MAX_P + 1)];
  int ext_id[MAX_K * MAX_P];
  int len[2][MAX_K], done[2][MAX_K];
  int parent[MAX_K], etok[MAX_K];  // etok: the appended token, -1 for a stay
  int hsrc[MAX_K], gsrc[MAX_K];    // the h and g rows of each slot
  int same[MAX_K * MAX_K];
  int all_done, any_emit, any_live, span;
  unsigned long long n_joint, n_lstm, n_round;
};

struct Smem {
  float *pa, *pb, *h[2], *g[2], *c[2], *x, *xv;
  int *xi, *tok[2];
};

__device__ Smem carve(float* base, const Split& sp, int K, int C, int P, int Hj, int Hp,
                      int max_out) {
  Smem s;
  float* p = base;
  s.pa = p; p += (size_t)K * sp.pk;
  s.pb = p; p += (size_t)K * sp.pk;
  for (int i = 0; i < 2; ++i) { s.h[i] = p; p += K * Hp; }
  for (int i = 0; i < 2; ++i) { s.g[i] = p; p += K * Hj; }
  for (int i = 0; i < 2; ++i) { s.c[i] = p; p += K * sp.umax; }
  s.x = p; p += K * (Hj > Hp ? Hj : Hp);
  s.xv = p; p += 2 * C * K * (P + 3);  // per parity, peer, hypothesis: m, s, blank, top-P
  int* q = reinterpret_cast<int*>(p);
  s.xi = q; q += 2 * C * K * P;         // the top-P indices
  s.tok[0] = q; q += K * max_out;
  s.tok[1] = q;
  return s;
}

// (a, ia) comes before (b, ib): the larger value, then the lower index
__device__ __forceinline__ int before(float a, int ia, float b, int ib) {
  return (a > b) || (a == b && ia < ib);
}

// The ranks r0, r1 (the number that come before) of a warp's values
// (v0, i0) and (v1, i1), elements lane and lane + 32 of n <= 64, among all
// n; past n a lane holds (-inf, NONE), which comes before nothing. The
// values pass by shuffles. n is uniform over the warp.
__device__ __forceinline__ void warp_rank2(float v0, int i0, float v1, int i1, int n, int& r0,
                                           int& r1) {
  r0 = r1 = 0;
#pragma unroll 8
  for (int src = 0; src < 32; ++src) {
    const float w = __shfl_sync(0xffffffffu, v0, src);
    const int wi = __shfl_sync(0xffffffffu, i0, src);
    r0 += before(w, wi, v0, i0);
    r1 += before(w, wi, v1, i1);
  }
  if (n > 32) {
#pragma unroll 8
    for (int src = 0; src < 32; ++src) {
      const float w = __shfl_sync(0xffffffffu, v1, src);
      const int wi = __shfl_sync(0xffffffffu, i1, src);
      r0 += before(w, wi, v0, i0);
      r1 += before(w, wi, v1, i1);
    }
  }
}

// lanes that sum one element's slices in reduce_slices: about eight
// slices a lane
__device__ inline int lanes_per_elem(int KS) {
  int lpe = 1;
  while (lpe < 32 && 8 * lpe < KS) lpe <<= 1;
  return lpe;
}

// the floats between two slices of M partial sums: at least M, and
// congruent to the elements a warp reduces at once (32 / lanes_per_elem)
// modulo the 32 banks, so the 32 lanes of a warp read 32 banks
__device__ inline int slice_stride(int M, int KS) {
  const int pw = 32 / lanes_per_elem(KS);
  return M + (((pw - M) % 32) + 32) % 32;
}

// depth slices of a mat-vec over G 16-byte groups and M = nv·N outputs:
// as many as the threads fill, but no more than the cap floats hold
__device__ __forceinline__ int slices_of(int threads, int G, int M, int cap) {
  if (G <= 0) return 1;
  int ks = threads / G;
  while (ks > 1 && (size_t)ks * slice_stride(M, ks) > (size_t)cap) --ks;
  return ks < 1 ? 1 : ks;
}

__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// f32: part[s*SS + k*N + n] = sum over d in slice s of x_k[d] * W[d*ld +
// col] for the nv hypotheses k (x_k = x + (xr ? xr[k] : k)*xs) and the N =
// 4G columns of G 16-byte groups, group gi at global column col0(gi), SS =
// slice_stride(nv*N, KS). Weights are read once for every NVEC hypotheses,
// RB rows of them in flight a thread (a thread's slice is a chain of L2
// round trips: the loads of RB rows are issued together). Block-wide; the
// caller synchronises.
template <typename ColOf>
__device__ void matvec_f32(const float* x, const int* xr, int xs, const float* __restrict__ W,
                           int depth, int ld, int G, ColOf col0, int nv, int KS,
                           float* part) {
  constexpr int RB = 8;
  const int N = 4 * G;
  const int SS = slice_stride(nv * N, KS);
  for (int it = threadIdx.x; it < KS * G; it += blockDim.x) {
    const int g = it % G, s = it / G;
    const int d0 = (s * depth) / KS, d1 = ((s + 1) * depth) / KS;
    const int col = col0(g);
    for (int v0 = 0; v0 < nv; v0 += NVEC) {
      int xo[NVEC];  // each hypothesis's row of x
#pragma unroll
      for (int j = 0; j < NVEC; ++j) {
        const int k = v0 + j < nv ? v0 + j : v0;
        xo[j] = (xr ? xr[k] : k) * xs;
      }
      float acc[NVEC][4];
#pragma unroll
      for (int j = 0; j < NVEC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      const float* wp = W + (size_t)d0 * ld + col;
      for (int d = d0; d < d1; d += RB) {
        const int nr = d1 - d;
        float4 w[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r)
          if (r < nr) w[r] = __ldg(reinterpret_cast<const float4*>(wp + (size_t)r * ld));
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          if (r < nr) {
#pragma unroll
            for (int j = 0; j < NVEC; ++j) {
              const float xv = x[xo[j] + d + r];
              acc[j][0] = fmaf(xv, w[r].x, acc[j][0]);
              acc[j][1] = fmaf(xv, w[r].y, acc[j][1]);
              acc[j][2] = fmaf(xv, w[r].z, acc[j][2]);
              acc[j][3] = fmaf(xv, w[r].w, acc[j][3]);
            }
          }
        }
        wp += (size_t)RB * ld;
      }
#pragma unroll
      for (int j = 0; j < NVEC; ++j) {
        if (v0 + j >= nv) break;
        float* o = part + (size_t)s * SS + (v0 + j) * N + g * 4;
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] = acc[j][e];
      }
    }
  }
}

// ---- bf16: the same products on the tensor cores (mma.sync.m16n8k16) ----
//
// In bf16 every mat-vec input (the joint input, the embedding rows, h) is
// a bf16 value, so the products go to mma with f32 sums, the outputs'
// columns as the A rows and up to eight hypotheses as the B columns. The
// weights come transposed (WT: a row per output column, its depth
// contiguous): lane (g, t) of a warp loads 16 consecutive depth values of
// output rows g and g+8 of a 16-column tile (two 16-byte loads each), and
// the depth order inside a 64-deep batch is permuted to match: in k-step j
// the k slots 2t, 2t+1, 2t+8, 2t+9 hold depths 16t + 4j + 0..3, and the B
// fragment takes the same depths of the lane's hypothesis g. A warp takes
// units of MT tiles over one of S depth ranges, each range a slice of the
// partial sums that reduce_slices adds up.

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

constexpr int MT = 4;  // 16-column tiles a warp's unit covers: one B fragment for them

// depth ranges the N columns are cut into: about two units (a group of MT
// tiles, a depth range) a warp, no more ranges than 64-deep batches, and
// the slices' partial sums within cap floats
__device__ __forceinline__ int mma_slices(int N, int depth, int M, int cap) {
  const int n_grp = ((N + 15) / 16 + MT - 1) / MT, nb = (depth + 63) / 64;
  const int nw = blockDim.x / 32;
  int S = (2 * nw + n_grp - 1) / n_grp;
  S = S > nb ? nb : S;
  while (S > 1 && (size_t)S * slice_stride(M, S) > (size_t)cap) --S;
  return S < 1 ? 1 : S;
}

// part[s*SS + k*N + c] = sum over the depths of range s of
// x_k[d] * WT[row_of(c)*depth + d] for the nv <= 8 hypotheses k (x_k = x +
// (xr ? xr[k] : k)*xs) and the N columns c, SS = slice_stride(nv*N, S). A
// unit is MT tiles over one depth range: per 64-deep batch a lane packs
// its B fragment once and issues the 4·MT loads of the tiles' A rows
// together. Warp-wide units; the caller synchronises.
template <typename RowOf>
__device__ void matvec_mma(const float* x, const int* xr, int xs,
                           const __nv_bfloat16* __restrict__ WT, int depth, int N,
                           RowOf row_of, int nv, int S, float* part) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, nw = blockDim.x / 32;
  const int g = lane >> 2, t = lane & 3;
  const int n_mt = (N + 15) / 16, n_grp = (n_mt + MT - 1) / MT, nb = (depth + 63) / 64;
  const int SS = slice_stride(nv * N, S);
  const float* xg = g < nv ? x + (size_t)(xr ? xr[g] : g) * xs : nullptr;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int u = warp; u < n_grp * S; u += nw) {
    const int grp = u % n_grp, sr = u / n_grp;
    const int b0 = (sr * nb) / S, b1 = ((sr + 1) * nb) / S;
    const __nv_bfloat16* rows[MT][2];  // this lane's A rows g and g+8 of each tile
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int c = 16 * (grp * MT + m) + g;
      rows[m][0] = c < N ? WT + (size_t)row_of(c) * depth : nullptr;
      rows[m][1] = c + 8 < N ? WT + (size_t)row_of(c + 8) * depth : nullptr;
    }
    float acc[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
    for (int bb = b0; bb < b1; ++bb) {
      const int d0 = bb * 64 + 16 * t;  // this lane's 16 depths of the batch
      uint4 a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int d = d0 + 8 * h;
          a[m][h] = rows[m][0] && d < depth ? ld16(rows[m][0] + d) : zero;
          a[m][2 + h] = rows[m][1] && d < depth ? ld16(rows[m][1] + d) : zero;
        }
      uint32_t bw[8];
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        const int d = d0 + 2 * w;
        if (xg && d < depth) {
          const float2 p = *reinterpret_cast<const float2*>(xg + d);
          bw[w] = pack_bf16(p.x, p.y);
        } else {
          bw[w] = 0u;
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const uint32_t* A0 = reinterpret_cast<const uint32_t*>(&a[m][0]);
        const uint32_t* A1 = reinterpret_cast<const uint32_t*>(&a[m][2]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[m], A0[2 * j], A1[2 * j], A0[2 * j + 1], A1[2 * j + 1], bw[2 * j],
                   bw[2 * j + 1]);
      }
    }
    float* o = part + (size_t)sr * SS;
    const int k0 = 2 * t, k1 = 2 * t + 1;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int c0 = 16 * (grp * MT + m) + g, c1 = c0 + 8;
      if (c0 < N) {
        if (k0 < nv) o[k0 * N + c0] = acc[m][0];
        if (k1 < nv) o[k1 * N + c0] = acc[m][1];
      }
      if (c1 < N) {
        if (k0 < nv) o[k0 * N + c1] = acc[m][2];
        if (k1 < nv) o[k1 * N + c1] = acc[m][3];
      }
    }
  }
}

// The products of a block's N output columns, local column c being
// global column col_of(c), into part's slices (the number of slices
// returned): f32 on the FMA units with the weights as they are (column
// col_of(c) of W [depth][ld]), bf16 on the tensor cores with the weights
// transposed (row col_of(c) of WT [.][depth]).
template <typename T, typename ColOf>
__device__ int matvec_cols(const float* x, const int* xr, int xs, const T* __restrict__ W,
                           int depth, int ld, int N, ColOf col_of, int nv, int cap,
                           float* part) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int S = mma_slices(N, depth, nv * N, cap);
    matvec_mma(x, xr, xs, W, depth, N, col_of, nv, S, part);
    return S;
  } else {
    const int G = N / 4;
    const int KS = slices_of(blockDim.x, G, nv * N, cap);
    matvec_f32(x, xr, xs, W, depth, ld, G, [=](int gi) { return col_of(4 * gi); }, nv, KS,
               part);
    return KS;
  }
}

// part[m] = sum over the KS slices s of part[s*SS + m], in place (slice 0
// holds the sums after): lanes_per_elem lanes per element, each summing
// every lpe-th slice in order, then a shuffle tree; with the slice stride
// SS a warp's 32 reads fall in 32 banks. An element is read and written
// by its own lanes only. Block-wide; the caller synchronises.
__device__ void reduce_slices(float* part, int KS, int M) {
  if (KS == 1) return;
  const int lpe = lanes_per_elem(KS), SS = slice_stride(M, KS);
  const int per_warp = 32 / lpe;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, nw = blockDim.x / 32;
  const int sub = lane / lpe, sl = lane % lpe;
  for (int m0 = warp * per_warp; m0 < M; m0 += nw * per_warp) {
    const int m = m0 + sub;
    float acc = 0.f;
    if (m < M)
#pragma unroll 4
      for (int s = sl; s < KS; s += lpe) acc += part[(size_t)s * SS + m];
    for (int off = lpe / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (sl == 0 && m < M) part[m] = acc;
  }
}

struct Row {
  int rank, C, K, P, Hj, Hp, V1, V1p, V, blank, max_out;
  int u0, U, j0, PJ, v0, NH, owner;  // this block's columns; the blank's block
};

// The K joints on this block's head columns at frame ft and each
// hypothesis's partial log-softmax and local top-P, written into every
// peer's exchange slot of parity par; one cluster barrier.
template <typename T>
__device__ void joint_partials(cg::cluster_group& cluster, const Smem s, const Small& sm,
                               const Row rw, int pk, int gb, int par,
                               const T* __restrict__ ft, const T* __restrict__ head,
                               const float* __restrict__ head_b) {
  constexpr int VEC = Vec16<T>::N;
  const int K = rw.K, Hj = rw.Hj, P = rw.P, C = rw.C;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int HG = Hj / VEC;
  for (int i = threadIdx.x; i < K * HG; i += blockDim.x) {
    const int k = i / HG, j0 = (i % HG) * VEC;
    float fv[VEC];
    Vec16<T>::load(ft + j0, fv);
    const float* g = s.g[gb] + sm.gsrc[k] * Hj + j0;
    float* xo = s.x + k * Hj + j0;
#pragma unroll
    for (int e = 0; e < VEC; ++e) xo[e] = fmaxf(rnd<T>(fv[e] + g[e]), 0.f);
  }
  __syncthreads();
  const int v0 = rw.v0;
  const int KS = matvec_cols<T>(s.x, nullptr, Hj, head, Hj, rw.V1p, rw.NH,
                                [=](int c) { return v0 + c; }, K, K * pk, s.pa);
  __syncthreads();
  reduce_slices(s.pa, KS, K * rw.NH);
  __syncthreads();
  if (warp < K) {
    const int k = warp;
    float* row = s.pa + k * rw.NH;
    const int NS = max(0, min(rw.NH, rw.V1 - v0));  // scored columns
    float m = -INFINITY;
    for (int i = lane; i < NS; i += 32) {
      const float xv = row[i] + head_b[v0 + i];
      row[i] = xv;
      m = fmaxf(m, xv);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.f;
    for (int i = lane; i < NS; i += 32) sum += expf(row[i] - m);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    __syncwarp();
    float* rec = s.xv + ((size_t)(par * C + rw.rank) * K + k) * (P + 3);
    int* reci = s.xi + ((size_t)(par * C + rw.rank) * K + k) * P;
    if (lane == 0) {
      rec[0] = m;
      rec[1] = sum;
      rec[2] = 0.f;
      if (rw.rank == rw.owner) {
        rec[2] = row[rw.blank - v0];
        row[rw.blank - v0] = -INFINITY;  // not an extension
      }
    }
    __syncwarp();
    // the block's top-P non-blank by (logit, then the lower index): each
    // column's rank among the block's columns (the blank now at -inf); a
    // block with fewer than P columns leaves (-inf, NONE) in the rest
    for (int p = lane; p < P; p += 32) {
      rec[3 + p] = -INFINITY;
      reci[p] = NONE;
    }
    __syncwarp();
    if (NS <= 64) {
      const float va = lane < NS ? row[lane] : -INFINITY;
      const float vb = lane + 32 < NS ? row[lane + 32] : -INFINITY;
      const int ia = va > -INFINITY ? v0 + lane : NONE;
      const int ib = vb > -INFINITY ? v0 + lane + 32 : NONE;
      int ra, rb;
      warp_rank2(va, ia, vb, ib, NS, ra, rb);
      if (ia != NONE && ra < P) {
        rec[3 + ra] = va;
        reci[ra] = ia;
      }
      if (ib != NONE && rb < P) {
        rec[3 + rb] = vb;
        reci[rb] = ib;
      }
    } else {
      for (int i = lane; i < NS; i += 32) {
        const float xv = row[i];
        if (!(xv > -INFINITY)) continue;
        int rank = 0;
#pragma unroll 4
        for (int j = 0; j < NS; ++j) rank += before(row[j], j, xv, i);
        if (rank < P) {
          rec[3 + rank] = xv;
          reci[rank] = v0 + i;
        }
      }
    }
    __syncwarp();
    // the record into every peer's slot of this parity
    const int W = 2 * P + 3;
    for (int e = lane; e < C * W; e += 32) {
      const int r = e / W, f = e % W;
      if (r == rw.rank) continue;
      if (f < P + 3)
        cluster.map_shared_rank(rec, r)[f] = rec[f];
      else
        cluster.map_shared_rank(reci, r)[f - P - 3] = reci[f - P - 3];
    }
  }
  cluster.sync();
}

// Every block, warp k: the merge of hypothesis k's C partials in rank
// order into its lse, its blank log-prob (sm.lpb) and, with TOPP, its
// top-P non-blank (sm.ext_lp / sm.ext_id), lower index first among equal
// log-probs. The same arithmetic on the same records in every block.
template <bool TOPP>
__device__ void merge_partials(const Smem s, Small& sm, const Row rw, int par) {
  const int K = rw.K, P = rw.P, C = rw.C;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (warp >= K) return;
  const int k = warp;
  auto rec = [&](int r) { return s.xv + ((size_t)(par * C + r) * K + k) * (P + 3); };
  float m = -INFINITY;
  for (int r = 0; r < C; ++r) m = fmaxf(m, rec(r)[0]);
  float sum = 0.f;
  for (int r = 0; r < C; ++r) sum += rec(r)[1] * expf(rec(r)[0] - m);
  const float lse = logf(sum);
  if (lane == 0) sm.lpb[k] = (rec(rw.owner)[2] - m) - lse;
  if (!TOPP) return;
  // the C·P records' entries by (lp, then the lower index); the blank
  // at NEG comes after every finite entry and ends a top-P only where P
  // reaches V1, as in the plain version; (-inf, NONE) fills never enter
  const int NR = C * P;
  // entry e: peer e / P's p-th, its lp and index (-inf, NONE for a fill)
  auto entry = [&](int e, float& v, int& id) {
    v = -INFINITY;
    id = NONE;
    if (e < NR) {
      const int r = e / P, p = e % P;
      v = (rec(r)[3 + p] - m) - lse;
      id = s.xi[((size_t)(par * C + r) * K + k) * P + p];
    }
  };
  int finite = 0;
  if (NR <= 64) {
    float va, vb;
    int ia, ib, ra, rb;
    entry(lane, va, ia);
    entry(lane + 32, vb, ib);
    warp_rank2(va, ia, vb, ib, NR, ra, rb);
    finite = __popc(__ballot_sync(0xffffffffu, va > -INFINITY)) +
             __popc(__ballot_sync(0xffffffffu, vb > -INFINITY));
    if (ia != NONE && ra < P) {
      sm.ext_lp[k * P + ra] = va;
      sm.ext_id[k * P + ra] = ia;
    }
    if (ib != NONE && rb < P) {
      sm.ext_lp[k * P + rb] = vb;
      sm.ext_id[k * P + rb] = ib;
    }
  } else {
    for (int e = lane; e < NR; e += 32) {
      float v, wv;
      int id, wi;
      entry(e, v, id);
      if (id == NONE) continue;
      int rank = 0;
      for (int o = 0; o < NR; ++o) {
        entry(o, wv, wi);
        rank += before(wv, wi, v, id);
      }
      if (rank < P) {
        sm.ext_lp[k * P + rank] = v;
        sm.ext_id[k * P + rank] = id;
      }
    }
    for (int e = lane; e < (NR + 31) / 32 * 32; e += 32) {  // whole warps: a ballot each
      float v;
      int id;
      entry(e, v, id);
      finite += __popc(__ballot_sync(0xffffffffu, v > -INFINITY));
    }
  }
  if (lane == 0 && finite < P) {
    sm.ext_lp[k * P + finite] = NEG;
    sm.ext_id[k * P + finite] = rw.blank;
  }
  __syncwarp();
}

// One prediction-net step of the slots k with etok[k] >= 0 across the
// cluster: x = the embedding row of etok (the zero row for the blank/SOS),
// h = slot hsrc[k] of s.h[hb], c = this block's cell slice (s.c[cb]); the
// gates of the block's units, the cell update in place, and each slot's
// new h (a stay's: its parent's h) into every block's s.h[hb ^ 1]; one
// barrier; g = round(round(h·W_p) + b_p) of the block's projection columns
// (a stay's: slot gsrc[k] of s.g[gb]) into every block's s.g[gb ^ 1]; a
// second barrier. The caller flips hb and gb and resets hsrc and gsrc.
template <typename T>
__device__ void lstm_step(cg::cluster_group& cluster, const Smem s, const Small& sm,
                          const Row rw, int pk, int hb, int gb, int cb,
                          const T* __restrict__ table, const T* __restrict__ w_ih,
                          const T* __restrict__ w_hh, const T* __restrict__ bias,
                          const T* __restrict__ wp, const T* __restrict__ bp) {
  constexpr int VEC = Vec16<T>::N;
  const int K = rw.K, Hp = rw.Hp, Hj = rw.Hj, C = rw.C;
  const int u0 = rw.u0, U = rw.U, j0 = rw.j0, PJ = rw.PJ;
  const int PG = Hp / VEC;
  for (int i = threadIdx.x; i < K * PG; i += blockDim.x) {
    const int k = i / PG, u0v = (i % PG) * VEC;
    const int tk = sm.etok[k];
    float ev[VEC];
    if (tk >= 0 && tk < rw.V) {
      Vec16<T>::load(table + (size_t)tk * Hp + u0v, ev);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) ev[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) s.x[k * Hp + u0v + e] = ev[e];
  }
  __syncthreads();
  const int NG = 4 * U;
  // local column c of the gates is gate c / U of unit u0 + c % U
  const auto gate_col = [=](int c) { return (c / U) * Hp + u0 + c % U; };
  const int KSg = matvec_cols<T>(s.x, nullptr, Hp, w_ih, Hp, 4 * Hp, NG, gate_col, K,
                                 K * pk, s.pa);
  matvec_cols<T>(s.h[hb], sm.hsrc, Hp, w_hh, Hp, 4 * Hp, NG, gate_col, K, K * pk, s.pb);
  __syncthreads();
  reduce_slices(s.pa, KSg, K * NG);
  reduce_slices(s.pb, KSg, K * NG);
  __syncthreads();
  float* h_next = s.h[hb ^ 1];
  float* c = s.c[cb];
  for (int i = threadIdx.x; i < K * U; i += blockDim.x) {
    const int k = i / U, ui = i % U;
    float hv;
    if (sm.etok[k] >= 0) {
      float gate[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = k * NG + q * U + ui;
        const float xw = rnd<T>(rnd<T>(s.pa[n]) + to_f<T>(bias[q * Hp + u0 + ui]));
        gate[q] = rnd<T>(xw + rnd<T>(s.pb[n]));
      }
      const float ig = rnd<T>(sigm(gate[0]));
      const float fg = rnd<T>(sigm(gate[1]));
      const float gg = rnd<T>(tanhf(gate[2]));
      const float og = rnd<T>(sigm(gate[3]));
      const float cn = rnd<T>(rnd<T>(fg * rnd<T>(c[k * U + ui])) + rnd<T>(ig * gg));
      c[k * U + ui] = cn;
      hv = rnd<T>(og * rnd<T>(tanhf(cn)));
    } else {
      hv = s.h[hb][sm.hsrc[k] * Hp + u0 + ui];
    }
    for (int r = 0; r < C; ++r) cluster.map_shared_rank(h_next, r)[k * Hp + u0 + ui] = hv;
  }
  cluster.sync();
  const int KSp = matvec_cols<T>(h_next, nullptr, Hp, wp, Hp, Hj, PJ,
                                 [=](int c) { return j0 + c; }, K, K * pk, s.pa);
  __syncthreads();
  reduce_slices(s.pa, KSp, K * PJ);
  __syncthreads();
  float* g_next = s.g[gb ^ 1];
  for (int i = threadIdx.x; i < K * PJ; i += blockDim.x) {
    const int k = i / PJ, jj = i % PJ;
    const float gv = sm.etok[k] >= 0
                         ? rnd<T>(rnd<T>(s.pa[k * PJ + jj]) + to_f<T>(bp[j0 + jj]))
                         : s.g[gb][sm.gsrc[k] * Hj + j0 + jj];
    for (int r = 0; r < C; ++r) cluster.map_shared_rank(g_next, r)[k * Hj + j0 + jj] = gv;
  }
  cluster.sync();
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS, 1) rnnt_beam_kernel(
    const T* __restrict__ f, const int* __restrict__ flens,
    const int* __restrict__ lang_ids, const T* __restrict__ table,
    const T* __restrict__ w_ih, const T* __restrict__ w_hh,
    const T* __restrict__ bias, const T* __restrict__ wp, const T* __restrict__ bp,
    const T* __restrict__ heads, const float* __restrict__ heads_b,
    int* __restrict__ out_ids, int* __restrict__ out_lens, float* __restrict__ out_scores,
    unsigned long long* __restrict__ work, const Split split, int T_, int Hj, int Hp,
    int V1, int V1p, int L, int blank, int K, int P, int max_expansions, int max_out) {
  extern __shared__ float smem[];
  __shared__ Small sm;
  cg::cluster_group cluster = cg::this_cluster();
  Row rw;
  rw.C = (int)cluster.num_blocks();
  rw.rank = (int)cluster.block_rank();
  rw.K = K; rw.P = P; rw.Hj = Hj; rw.Hp = Hp; rw.V1 = V1; rw.V1p = V1p; rw.V = V1 - 1;
  rw.blank = blank; rw.max_out = max_out;
  rw.u0 = split.unit[rw.rank]; rw.U = split.unit[rw.rank + 1] - rw.u0;
  rw.j0 = split.proj[rw.rank]; rw.PJ = split.proj[rw.rank + 1] - rw.j0;
  rw.v0 = split.head[rw.rank]; rw.NH = split.head[rw.rank + 1] - rw.v0;
  rw.owner = 0;
  for (int r = 0; r < rw.C; ++r)
    if (split.head[r] <= blank && blank < split.head[r + 1]) rw.owner = r;
  const int C = rw.C, rank = rw.rank, U = rw.U;
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32, nwarps = blockDim.x / 32;
  const int NC = K * (P + 1);
  int n = flens[b];
  n = n < 0 ? 0 : (n > T_ ? T_ : n);
  const int lang = min(max(lang_ids[b], 0), L - 1);
  const T* head = heads + (size_t)lang * Hj * V1p;
  const float* head_b = heads_b + (size_t)lang * V1;
  const Smem s = carve(smem, split, K, C, P, Hj, Hp, max_out);
  int cur = 0;   // tokens, lengths, done flags, cell slice: this round's copy
  int hb = 0, gb = 0, par = 0;

  // every slot holds the empty prefix primed with the blank/SOS step; only
  // slot 0 is live
  for (int i = tid; i < K * max_out; i += blockDim.x) s.tok[0][i] = blank;
  for (int i = tid; i < K * Hp; i += blockDim.x) s.h[0][i] = 0.f;
  for (int i = tid; i < K * U; i += blockDim.x) s.c[0][i] = 0.f;
  if (tid < K) {
    sm.score[tid] = tid == 0 ? 0.f : NEG;
    sm.len[0][tid] = 0;
    sm.etok[tid] = blank;  // the SOS step emits the blank's zero row
    sm.hsrc[tid] = sm.gsrc[tid] = tid;
  }
  if (tid == 0) sm.n_joint = sm.n_lstm = sm.n_round = 0;
  if (n > 0) {
    // every block of the cluster runs, its state zeroed, before peers write
    cluster.sync();
    lstm_step<T>(cluster, s, sm, rw, split.pk, hb, gb, 0, table, w_ih, w_hh, bias, wp, bp);
    hb ^= 1;
    gb ^= 1;
    if (tid == 0) sm.n_lstm += 1;
  }  // n == 0 is uniform over the cluster: no block touches a peer

  for (int t = 0; t < n; ++t) {
    const T* ft = f + ((size_t)b * T_ + t) * Hj;
    if (warp == 0) {
      const bool dn = lane >= K || sm.score[lane] <= NEG / 2;
      if (lane < K) sm.done[cur][lane] = dn;
      const unsigned open = __ballot_sync(0xffffffffu, !dn);
      if (lane == 0) sm.all_done = open == 0;
    }
    __syncthreads();
    for (int e = 0; e < max_expansions && !sm.all_done; ++e) {
      const int nxt = cur ^ 1;
      joint_partials<T>(cluster, s, sm, rw, split.pk, gb, par, ft, head, head_b);
      merge_partials<true>(s, sm, rw, par);
      par ^= 1;
      __syncthreads();
      // the row's top-K over its K·(P+1) candidates, in the plain version's order
      if (warp == 0) {
        for (int ci = lane; ci < NC; ci += 32) {
          const int k = ci / (P + 1), q = ci % (P + 1);
          const bool dn = sm.done[cur][k];
          float val;
          if (q == 0) {
            val = dn ? sm.score[k] : sm.score[k] + sm.lpb[k];
          } else {
            const bool can = !dn && sm.len[cur][k] < max_out;
            val = can ? sm.score[k] + sm.ext_lp[k * P + q - 1] : NEG;
          }
          sm.cand[ci] = val;
        }
        __syncwarp();
        // each candidate's rank by (value, then the lower index)
        for (int ci = lane; ci < NC; ci += 32) {
          const float v = sm.cand[ci];
          int rank = 0;
#pragma unroll 4
          for (int o = 0; o < NC; ++o) rank += before(sm.cand[o], o, v, ci);
          if (rank < K) {
            const int pa = ci / (P + 1), q = ci % (P + 1);
            sm.nscore[rank] = v;
            sm.parent[rank] = pa;
            sm.etok[rank] = q == 0 ? -1 : sm.ext_id[pa * P + q - 1];
          }
        }
        __syncwarp();
        // the children's lengths, done flags, scores and h / g rows, lane j
        // for child j
        const bool in = lane < K;
        const int pa = in ? sm.parent[lane] : 0;
        const bool emit = in && sm.etok[lane] >= 0;
        const int nl = sm.len[cur][pa] + (emit ? 1 : 0);
        const int nd = sm.done[cur][pa] | !emit;
        const int hs = sm.hsrc[pa], gs = sm.gsrc[pa];
        const unsigned live = __ballot_sync(0xffffffffu, in && !sm.done[cur][lane]);
        const unsigned open = __ballot_sync(0xffffffffu, in && !nd);
        const unsigned emits = __ballot_sync(0xffffffffu, emit);
        int span = in ? min(nl, max_out) : 0;  // the children's longest prefix
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          span = max(span, __shfl_xor_sync(0xffffffffu, span, off));
        __syncwarp();
        if (in) {
          sm.len[nxt][lane] = nl;
          sm.done[nxt][lane] = nd;
          sm.score[lane] = sm.nscore[lane];
          sm.hsrc[lane] = hs;
          sm.gsrc[lane] = gs;
        }
        if (lane == 0) {
          sm.span = span;
          sm.all_done = open == 0;
          sm.any_emit = emits != 0;
          sm.n_joint += __popc(live);
          sm.n_round += 1;
        }
      }
      __syncthreads();
      // children copy their parents' tokens and cell slice; an extension
      // appends its token at min(len, max_out - 1). Only the first span
      // positions are copied: a row's tokens past its length are never
      // read (the merge compares, and the output writes, min(len,
      // max_out) of them), so they may hold another slot's
      const int span = sm.span;
      for (int i = tid; i < K * span; i += blockDim.x) {
        const int j = i / span, pos = i % span;
        const int pa = sm.parent[j];
        int v = s.tok[cur][pa * max_out + pos];
        const int pl = sm.len[cur][pa];
        if (sm.etok[j] >= 0 && pos == min(pl, max_out - 1)) v = sm.etok[j];
        s.tok[nxt][j * max_out + pos] = v;
      }
      for (int i = tid; i < K * U; i += blockDim.x)
        s.c[nxt][i] = s.c[cur][sm.parent[i / U] * U + i % U];
      __syncthreads();
      if (sm.any_emit) {
        lstm_step<T>(cluster, s, sm, rw, split.pk, hb, gb, nxt, table, w_ih, w_hh, bias, wp,
                     bp);
        hb ^= 1;
        gb ^= 1;
        if (tid < K) sm.hsrc[tid] = sm.gsrc[tid] = tid;
        if (tid == 0)
          for (int j = 0; j < K; ++j) sm.n_lstm += sm.etok[j] >= 0;
        __syncthreads();
      }
      cur = nxt;
    }
    // force-finalise the hypotheses still live after max_expansions rounds
    if (warp == 0) {
      const unsigned live =
          __ballot_sync(0xffffffffu, lane < K && !sm.done[cur][lane] && sm.score[lane] > NEG / 2);
      if (lane == 0) sm.any_live = live != 0;
    }
    __syncthreads();
    if (sm.any_live) {
      joint_partials<T>(cluster, s, sm, rw, split.pk, gb, par, ft, head, head_b);
      merge_partials<false>(s, sm, rw, par);
      par ^= 1;
      __syncthreads();
      if (warp == 0) {
        const bool live = lane < K && !sm.done[cur][lane] && sm.score[lane] > NEG / 2;
        const unsigned lives = __ballot_sync(0xffffffffu, live);
        if (live) sm.score[lane] += sm.lpb[lane];
        if (lane == 0) sm.n_joint += __popc(lives);
      }
    }
    // equal label sequences (equal lengths, then their tokens), one warp
    // per pair of slots
    for (int q = warp; q < K * K; q += nwarps) {
      const int i = q / K, j = q % K;
      if (i >= j) continue;
      const int li = sm.len[cur][i];
      bool diff = li != sm.len[cur][j];
      for (int pos = lane; !diff && pos < min(li, max_out); pos += 32)
        diff |= s.tok[cur][i * max_out + pos] != s.tok[cur][j * max_out + pos];
      diff = __any_sync(0xffffffffu, diff);
      if (lane == 0) sm.same[q] = !diff;
    }
    __syncthreads();
    if (tid == 0) {
      for (int i = 0; i < K; ++i) {
        for (int j = i + 1; j < K; ++j) {
          const float a = sm.score[i], c2 = sm.score[j];
          if (sm.same[i * K + j] && sm.len[cur][i] == sm.len[cur][j] && a > NEG / 2 &&
              c2 > NEG / 2) {
            const float m = fmaxf(a, c2);
            sm.score[i] = m + log1pf(expf(-fabsf(a - c2)));
            sm.score[j] = NEG;
          }
        }
      }
    }
    __syncthreads();
  }

  // the best hypothesis: the first index of the largest score; block 0
  // alone writes the row's outputs and work
  __syncthreads();
  if (rank == 0) {
    int best = 0;
    for (int k = 1; k < K; ++k)
      if (sm.score[k] > sm.score[best]) best = k;
    if (tid == 0) {
      out_lens[b] = sm.len[cur][best];
      out_scores[b] = sm.score[best];
      atomicAdd(work, sm.n_joint);
      atomicAdd(work + 1, sm.n_lstm);
      atomicAdd(work + 2, sm.n_round);
    }
    const int n_out = min(sm.len[cur][best], max_out);
    for (int i = tid; i < max_out; i += blockDim.x)
      out_ids[(size_t)b * max_out + i] = i < n_out ? s.tok[cur][best * max_out + i] : blank;
  }
  // every write into a peer came before a barrier all blocks passed; this
  // last one keeps each block's shared memory alive until all are done
  if (n > 0) cluster.sync();
}

// bounds[3][C+1] (units, projection columns, head columns) must start at
// 0, rise, be multiples of the vector width and end at Hp, Hj and V1p.
template <typename T>
bool fill_split(const int* bounds, int C, int Hp, int Hj, int V1p, Split& sp, int most[3]) {
  constexpr int VEC = Vec16<T>::N;
  const int ends[3] = {Hp, Hj, V1p};
  int* dst[3] = {sp.unit, sp.proj, sp.head};
  for (int a = 0; a < 3; ++a) {
    const int* src = bounds + a * (C + 1);
    most[a] = 0;
    if (src[0] != 0 || src[C] != ends[a]) return false;
    for (int c = 0; c <= C; ++c) {
      if (src[c] % VEC || (c > 0 && src[c] < src[c - 1])) return false;
      dst[a][c] = src[c];
      if (c > 0 && src[c] - src[c - 1] > most[a]) most[a] = src[c] - src[c - 1];
    }
  }
  sp.umax = most[0];
  return true;
}

// dynamic shared memory of a block whose partial sums take pk floats a
// hypothesis
size_t smem_bytes(const Split& sp, int K, int C, int P, int Hj, int Hp, int max_out) {
  const size_t floats = (size_t)2 * K * sp.pk + (size_t)2 * K * Hp + (size_t)2 * K * Hj +
                        (size_t)2 * K * sp.umax + (size_t)K * std::max(Hj, Hp) +
                        (size_t)2 * C * K * (P + 3);
  const size_t ints = (size_t)2 * C * K * P + (size_t)2 * K * max_out;
  return 4 * (floats + ints);
}

// The card's own limits: one block's state (the replicated tokens, h and
// g of the K hypotheses, its cell slice, the exchange slots) and its
// partial sums must fit the dynamic shared memory cudaFuncSetAttribute
// grants (227 KB a block on an H100, less the static state); the partial
// sums take what is left, up to what the threads fill, and at least one
// slice of the widest product. Over the limit the call fails and so does
// the launch. A cluster of C such blocks must fit one GPC.
template <typename T>
cudaError_t launch(const void* f, const void* flens, const void* lang_ids,
                   const void* table, const void* w_ih, const void* w_hh,
                   const void* bias, const void* wp, const void* bp,
                   const void* head, const void* head_b, void* ids, void* olen,
                   void* oscore, void* work, int B, int T_, int Hj, int Hp, int V1,
                   int V1p, int L, int blank, int K, int P, int max_expansions,
                   int max_out, int threads, int C, const int* bounds,
                   cudaStream_t stream) {
  constexpr int VEC = Vec16<T>::N;
  Split sp;
  int most[3];
  if (threads % 32 || threads > MAX_THREADS || threads / 32 < K || K < 1 ||
      K > MAX_K || P < 1 || P > MAX_P || P > V1 || Hp % VEC || Hj % VEC ||
      V1p % VEC || V1p < V1 || L < 1 || max_out < 1 || blank != V1 - 1 || C < 1 ||
      C > MAX_CLUSTER || !fill_split<T>(bounds, C, Hp, Hj, V1p, sp, most))
    return cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const int widest = std::max(4 * most[0], std::max(most[1], most[2]));
  sp.pk = 0;
  const size_t fixed = smem_bytes(sp, K, C, P, Hj, Hp, max_out);
  const long long room = (long long)optin - (long long)sizeof(Small) - (long long)fixed;
  const long long fit = room > 0 ? room / (2 * 4 * K) : 0;
  sp.pk = (int)std::max<long long>(widest, std::min<long long>(threads * VEC, fit));
  const size_t smem = smem_bytes(sp, K, C, P, Hj, Hp, max_out);
  auto kernel = rnnt_beam_kernel<T>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) {
    cudaGetLastError();  // not left behind for the next launch to report
    return e;
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
      &cfg, kernel, (const T*)f, (const int*)flens, (const int*)lang_ids, (const T*)table,
      (const T*)w_ih, (const T*)w_hh, (const T*)bias, (const T*)wp, (const T*)bp,
      (const T*)head, (const float*)head_b, (int*)ids, (int*)olen, (float*)oscore,
      (unsigned long long*)work, sp, T_, Hj, Hp, V1, V1p, L, blank, K, P, max_expansions,
      max_out);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int rnnt_beam_search_fused(
    const void* f, const void* flens, const void* lang_ids, const void* table,
    const void* w_ih, const void* w_hh, const void* bias, const void* wp,
    const void* bp, const void* head, const void* head_b, void* ids, void* olen,
    void* oscore, void* work, int B, int T_, int Hj, int Hp, int V1, int V1p, int L,
    int blank, int K, int P, int max_expansions, int max_out, int dtype, int threads,
    int cluster, const int* bounds, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (dtype == 0)
    e = launch<float>(f, flens, lang_ids, table, w_ih, w_hh, bias, wp, bp, head, head_b,
                      ids, olen, oscore, work, B, T_, Hj, Hp, V1, V1p, L, blank, K, P,
                      max_expansions, max_out, threads, cluster, bounds, s);
  else if (dtype == 1)
    e = launch<__nv_bfloat16>(f, flens, lang_ids, table, w_ih, w_hh, bias, wp, bp, head,
                              head_b, ids, olen, oscore, work, B, T_, Hj, Hp, V1, V1p, L,
                              blank, K, P, max_expansions, max_out, threads, cluster,
                              bounds, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

extern "C" const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

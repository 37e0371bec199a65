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
// Design: one block per batch row. The row's K hypotheses live in shared
// memory (tokens [K, max_out] and a copy for the parent gather, lens,
// scores, g [K, Hj], h and f32 c [K, Hp], log-probs [K, V1p]); a parent
// gather is an index into them, where the TPU kernel needed one-hot MXU
// products. The weights stay in device memory and L2; every mat-vec
// streams its weight once a round for all K hypotheses (16-byte loads,
// up to four hypotheses' f32 sums in registers), splitting the depth over
// threads only as far as the partial sums fit a [K, max(4Hp, Hj, V1p)]
// buffer. The top-P of each hypothesis is P first-index masked argmax
// passes of one warp; the top-K of the row one warp's K passes over the
// K·(P+1) candidates. Every dot accumulates in f32 and is rounded to the
// compute dtype where the model's steps round (see decode_fused.cu).
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
// Bound: as in the greedy decode, each round's LSTM step streams W_ih,
// W_hh and W_p (~7.3 MB bf16 at flagship widths) into one SM and the
// head (~0.33 MB) once for the joint of all K hypotheses; rounds of a row
// run one after another, so the time is the L2 rate of one SM times the
// rounds of the longest row, far above the launch's bytes bound.
//
// Layouts (row-major) as in decode_fused.cu: f [B, T, Hj]; table [V, Hp];
// w_ih, w_hh [Hp, 4Hp]; bias [4Hp]; wp [Hp, Hj]; bp [Hj]; head [L, Hj, V1p];
// head_b [L, V1] f32; lang_ids [B]. Outputs ids [B, max_out], lens [B],
// scores [B] f32; work[0] += joint evaluations of live hypotheses,
// work[1] += LSTM steps of emitting hypotheses, work[2] += rounds.

#include "decode_common.cuh"

namespace {

using namespace decode_common;

constexpr int MAX_THREADS = 320;
constexpr int MAX_K = 8;       // hypotheses a row (one warp each for top-P)
constexpr int MAX_P = 16;      // non-blank extensions per hypothesis
constexpr int NVEC = 4;        // hypotheses per pass of a mat-vec
constexpr float NEG = -1e30f;  // dead score: finite, as in the plain version

__host__ __device__ inline int pbuf_of(int Hj, int Hp, int V1p) {
  int pb = 4 * Hp;
  pb = pb > Hj ? pb : Hj;
  return pb > V1p ? pb : V1p;
}

// depth slices of an [Kd] x [Kd, N] mat-vec: as many as the threads fill,
// but no more than the [K, pbuf] partial buffer holds
__host__ __device__ inline int slices(int threads, int N, int vec, int pbuf) {
  int ks = threads / (N / vec);
  const int cap = pbuf / N;
  ks = ks < cap ? ks : cap;
  return ks < 1 ? 1 : ks;
}

// part[(s*nv + k)*N + n] = sum over d in slice s of x[k*xs + d] * W[d*N + n]
// for the nv hypotheses k, and the same for (x2, W2) into part2 when TWO.
// The weights are read once for every NVEC hypotheses. Block-wide; the
// caller synchronises.
template <typename T, bool TWO>
__device__ void matvec_multi(const float* x, int xs, const T* __restrict__ W,
                             const float* x2, int xs2, const T* __restrict__ W2,
                             int Kd, int N, int nv, int KS, float* part, float* part2) {
  constexpr int VEC = Vec16<T>::N;
  const int G = N / VEC;
  for (int it = threadIdx.x; it < KS * G; it += blockDim.x) {
    const int g = it % G, s = it / G;
    const int d0 = (s * Kd) / KS, d1 = ((s + 1) * Kd) / KS;
    for (int v0 = 0; v0 < nv; v0 += NVEC) {
      float acc[NVEC][VEC], acc2[NVEC][VEC];
#pragma unroll
      for (int j = 0; j < NVEC; ++j)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[j][e] = acc2[j][e] = 0.f;
      const T* wp = W + (size_t)d0 * N + g * VEC;
      const T* wp2 = TWO ? W2 + (size_t)d0 * N + g * VEC : nullptr;
      for (int d = d0; d < d1; ++d) {
        float w[VEC];
        Vec16<T>::load(wp, w);
        wp += N;
#pragma unroll
        for (int j = 0; j < NVEC; ++j) {
          const float xv = v0 + j < nv ? x[(v0 + j) * xs + d] : 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[j][e] = fmaf(xv, w[e], acc[j][e]);
        }
        if (TWO) {
          float w2[VEC];
          Vec16<T>::load(wp2, w2);
          wp2 += N;
#pragma unroll
          for (int j = 0; j < NVEC; ++j) {
            const float xv = v0 + j < nv ? x2[(v0 + j) * xs2 + d] : 0.f;
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc2[j][e] = fmaf(xv, w2[e], acc2[j][e]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NVEC; ++j) {
        if (v0 + j >= nv) break;
        float* o = part + ((size_t)s * nv + v0 + j) * N + g * VEC;
#pragma unroll
        for (int e = 0; e < VEC; ++e) o[e] = acc[j][e];
        if (TWO) {
          float* o2 = part2 + ((size_t)s * nv + v0 + j) * N + g * VEC;
#pragma unroll
          for (int e = 0; e < VEC; ++e) o2[e] = acc2[j][e];
        }
      }
    }
  }
}

// hypothesis k's column n summed over the KS slices, in slice order
__device__ __forceinline__ float psum(const float* part, int nv, int N, int KS, int k, int n) {
  float acc = part[k * N + n];
  for (int s = 1; s < KS; ++s) acc += part[((size_t)s * nv + k) * N + n];
  return acc;
}

// first index of the largest value over a warp's (value, index) pairs
__device__ __forceinline__ void warp_argmax(float& best, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (ov > best || (ov == best && oi < bi)) {
      best = ov;
      bi = oi;
    }
  }
}

struct Small {
  float score[MAX_K], nscore[MAX_K], lpb[MAX_K];
  float ext_lp[MAX_K * MAX_P], cand[MAX_K * (MAX_P + 1)];
  int ext_id[MAX_K * MAX_P];
  int len[2][MAX_K], done[2][MAX_K];
  int parent[MAX_K], etok[MAX_K];  // etok: the appended token, -1 for a stay
  int same[MAX_K * MAX_K];
  int all_done, any_emit, any_live;
  unsigned long long n_joint, n_lstm, n_round;
};

struct Row {
  float *A, *Bp, *g[2], *h[2], *c[2], *xin, *lp;
  int* tok[2];
};

template <typename T>
__device__ Row carve(float* base, int K, int Hj, int Hp, int V1p, int max_out) {
  const int pb = pbuf_of(Hj, Hp, V1p);
  Row r;
  float* p = base;
  r.A = p; p += K * pb;
  r.Bp = p; p += K * pb;
  for (int i = 0; i < 2; ++i) { r.g[i] = p; p += K * Hj; }
  for (int i = 0; i < 2; ++i) { r.h[i] = p; p += K * Hp; }
  for (int i = 0; i < 2; ++i) { r.c[i] = p; p += K * Hp; }
  r.xin = p; p += K * (Hj > Hp ? Hj : Hp);
  r.lp = p; p += K * V1p;
  int* q = reinterpret_cast<int*>(p);
  r.tok[0] = q;
  r.tok[1] = q + K * max_out;
  return r;
}

// log-probs lp[k, :V1] of the K hypotheses with joint inputs g (f32
// values of the compute dtype) at frame ft
template <typename T>
__device__ void joint_logp(const Row& r, const float* g, const T* __restrict__ ft,
                           const T* __restrict__ head, const float* __restrict__ head_b,
                           int K, int Hj, int Hp, int V1, int V1p) {
  constexpr int VEC = Vec16<T>::N;
  for (int i = threadIdx.x; i < K * Hj; i += blockDim.x) {
    const int j = i % Hj;
    r.xin[i] = fmaxf(rnd<T>(to_f<T>(ft[j]) + g[i]), 0.f);
  }
  __syncthreads();
  const int pb = pbuf_of(Hj, Hp, V1p);
  const int KS = slices(blockDim.x, V1p, VEC, pb);
  matvec_multi<T, false>(r.xin, Hj, head, nullptr, 0, nullptr, Hj, V1p, K, KS, r.A, nullptr);
  __syncthreads();
  for (int i = threadIdx.x; i < K * V1; i += blockDim.x) {
    const int k = i / V1, v = i % V1;
    r.lp[k * V1p + v] = psum(r.A, K, V1p, KS, k, v) + head_b[v];
  }
  __syncthreads();
  // (x - m) - log(sum(exp(x - m))) per hypothesis, one warp each
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (warp < K) {
    float* row = r.lp + warp * V1p;
    float m = -INFINITY;
    for (int v = lane; v < V1; v += 32) m = fmaxf(m, row[v]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float s = 0.f;
    for (int v = lane; v < V1; v += 32) s += expf(row[v] - m);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    const float lse = logf(s);
    for (int v = lane; v < V1; v += 32) row[v] = (row[v] - m) - lse;
  }
  __syncthreads();
}

// One prediction-net step of the hypotheses k with emit[k], from (h, c)
// of slot k and the embedding of etok[k]: new h, c and
// g = round(round(h·W_p) + b_p), in place. The weights are read once for
// all K (the others' products are computed and dropped).
template <typename T>
__device__ void lstm_multi(const Row& r, Small& sm, float* g, float* h, float* c,
                           const T* __restrict__ table, const T* __restrict__ w_ih,
                           const T* __restrict__ w_hh, const T* __restrict__ bias,
                           const T* __restrict__ wp, const T* __restrict__ bp,
                           int K, int Hj, int Hp, int V1p, int V) {
  constexpr int VEC = Vec16<T>::N;
  const int N4 = 4 * Hp;
  const int pb = pbuf_of(Hj, Hp, V1p);
  for (int i = threadIdx.x; i < K * Hp; i += blockDim.x) {
    const int k = i / Hp, u = i % Hp;
    const int tk = sm.etok[k];
    // a blank or stay label reads the zero row (pred_step's blank/SOS)
    r.xin[i] = (tk >= 0 && tk < V) ? to_f<T>(table[(size_t)tk * Hp + u]) : 0.f;
  }
  __syncthreads();
  const int KSg = slices(blockDim.x, N4, VEC, pb);
  matvec_multi<T, true>(r.xin, Hp, w_ih, h, Hp, w_hh, Hp, N4, K, KSg, r.A, r.Bp);
  __syncthreads();
  // gates in place of slice 0: round(round(round(x·W_ih) + b) + round(h·W_hh))
  for (int i = threadIdx.x; i < K * N4; i += blockDim.x) {
    const int k = i / N4, j = i % N4;
    const float xw = rnd<T>(rnd<T>(psum(r.A, K, N4, KSg, k, j)) + to_f<T>(bias[j]));
    // only this thread reads (k, j): slices s >= 1 lie past K * N4
    r.A[k * N4 + j] = rnd<T>(xw + rnd<T>(psum(r.Bp, K, N4, KSg, k, j)));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < K * Hp; i += blockDim.x) {
    const int k = i / Hp, u = i % Hp;
    if (sm.etok[k] < 0) continue;
    const float* gt = r.A + k * N4;
    const float ig = rnd<T>(sigm(gt[u]));
    const float fg = rnd<T>(sigm(gt[Hp + u]));
    const float gg = rnd<T>(tanhf(gt[2 * Hp + u]));
    const float og = rnd<T>(sigm(gt[3 * Hp + u]));
    const float cn = rnd<T>(rnd<T>(fg * rnd<T>(c[i])) + rnd<T>(ig * gg));
    c[i] = cn;
    h[i] = rnd<T>(og * rnd<T>(tanhf(cn)));
  }
  __syncthreads();
  const int KSp = slices(blockDim.x, Hj, VEC, pb);
  matvec_multi<T, false>(h, Hp, wp, nullptr, 0, nullptr, Hp, Hj, K, KSp, r.A, nullptr);
  __syncthreads();
  for (int i = threadIdx.x; i < K * Hj; i += blockDim.x) {
    const int k = i / Hj, j = i % Hj;
    if (sm.etok[k] < 0) continue;
    g[i] = rnd<T>(rnd<T>(psum(r.A, K, Hj, KSp, k, j)) + to_f<T>(bp[j]));
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS, 1) rnnt_beam_kernel(
    const T* __restrict__ f, const int* __restrict__ flens,
    const int* __restrict__ lang_ids, const T* __restrict__ table,
    const T* __restrict__ w_ih, const T* __restrict__ w_hh,
    const T* __restrict__ bias, const T* __restrict__ wp, const T* __restrict__ bp,
    const T* __restrict__ heads, const float* __restrict__ heads_b,
    int* __restrict__ out_ids, int* __restrict__ out_lens, float* __restrict__ out_scores,
    unsigned long long* __restrict__ work, int T_, int Hj, int Hp, int V1, int V1p,
    int L, int blank, int K, int P, int max_expansions, int max_out) {
  extern __shared__ float smem[];
  __shared__ Small sm;
  const Row r = carve<T>(smem, K, Hj, Hp, V1p, max_out);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32, nwarps = blockDim.x / 32;
  const int V = V1 - 1;
  const int C = K * (P + 1);
  int n = flens[b];
  n = n < 0 ? 0 : (n > T_ ? T_ : n);
  const int lang = min(max(lang_ids[b], 0), L - 1);
  const T* head = heads + (size_t)lang * Hj * V1p;
  const float* head_b = heads_b + (size_t)lang * V1;
  int cur = 0;

  // every slot holds the empty prefix primed with the blank/SOS step; only
  // slot 0 is live
  for (int i = tid; i < K * max_out; i += blockDim.x) r.tok[0][i] = blank;
  for (int i = tid; i < K * Hp; i += blockDim.x) r.h[0][i] = r.c[0][i] = 0.f;
  if (tid < K) {
    sm.score[tid] = tid == 0 ? 0.f : NEG;
    sm.len[0][tid] = 0;
    sm.etok[tid] = blank;  // the SOS step emits the blank's zero row
  }
  if (tid == 0) sm.n_joint = sm.n_lstm = sm.n_round = 0;
  __syncthreads();
  if (n > 0) {
    lstm_multi<T>(r, sm, r.g[0], r.h[0], r.c[0], table, w_ih, w_hh, bias, wp, bp,
                  K, Hj, Hp, V1p, V);
    if (tid == 0) sm.n_lstm += 1;
  }

  for (int t = 0; t < n; ++t) {
    const T* ft = f + ((size_t)b * T_ + t) * Hj;
    if (tid == 0) {
      int all = 1;
      for (int k = 0; k < K; ++k) {
        sm.done[cur][k] = sm.score[k] <= NEG / 2;
        all &= sm.done[cur][k];
      }
      sm.all_done = all;
    }
    __syncthreads();
    for (int e = 0; e < max_expansions && !sm.all_done; ++e) {
      const int nxt = cur ^ 1;
      joint_logp<T>(r, r.g[cur], ft, head, head_b, K, Hj, Hp, V1, V1p);
      // top-P non-blank of each hypothesis: P first-index argmax passes
      if (warp < K) {
        float* row = r.lp + warp * V1p;
        const float lb = row[blank];
        __syncwarp();
        if (lane == 0) {
          sm.lpb[warp] = lb;
          row[blank] = NEG;
        }
        __syncwarp();
        for (int p = 0; p < P; ++p) {
          float best = -INFINITY;
          int bi = 0x7fffffff;
          for (int v = lane; v < V1; v += 32) {
            const float val = row[v];
            if (val > best) {  // lanes walk v upwards: the first index wins
              best = val;
              bi = v;
            }
          }
          warp_argmax(best, bi);
          if (lane == 0) {
            sm.ext_lp[warp * P + p] = best;
            sm.ext_id[warp * P + p] = bi;
            row[bi] = -INFINITY;  // taken: below every candidate, NEG included
          }
          __syncwarp();
        }
      }
      __syncthreads();
      // the row's top-K over its K·(P+1) candidates, in the plain version's order
      if (warp == 0) {
        for (int ci = lane; ci < C; ci += 32) {
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
        for (int j = 0; j < K; ++j) {
          float best = -INFINITY;
          int bi = 0x7fffffff;
          for (int ci = lane; ci < C; ci += 32) {
            const float val = sm.cand[ci];
            if (val > best) {
              best = val;
              bi = ci;
            }
          }
          warp_argmax(best, bi);
          if (lane == 0) {
            sm.nscore[j] = best;
            const int par = bi / (P + 1), q = bi % (P + 1);
            sm.parent[j] = par;
            sm.etok[j] = q == 0 ? -1 : sm.ext_id[par * P + q - 1];
            sm.cand[bi] = -INFINITY;
          }
          __syncwarp();
        }
        if (lane == 0) {
          int all = 1, any = 0;
          unsigned long long live = 0;
          for (int k = 0; k < K; ++k) live += !sm.done[cur][k];
          for (int j = 0; j < K; ++j) {
            const int par = sm.parent[j];
            const bool emit = sm.etok[j] >= 0;
            sm.len[nxt][j] = sm.len[cur][par] + (emit ? 1 : 0);
            sm.done[nxt][j] = sm.done[cur][par] | !emit;
            all &= sm.done[nxt][j];
            any |= emit;
          }
          for (int j = 0; j < K; ++j) sm.score[j] = sm.nscore[j];
          sm.all_done = all;
          sm.any_emit = any;
          sm.n_joint += live;
          sm.n_round += 1;
        }
      }
      __syncthreads();
      // children copy their parents; an extension appends its token at
      // min(len, max_out - 1)
      for (int i = tid; i < K * max_out; i += blockDim.x) {
        const int j = i / max_out, pos = i % max_out;
        const int par = sm.parent[j];
        int v = r.tok[cur][par * max_out + pos];
        const int pl = sm.len[cur][par];
        if (sm.etok[j] >= 0 && pos == min(pl, max_out - 1)) v = sm.etok[j];
        r.tok[nxt][i] = v;
      }
      for (int i = tid; i < K * Hj; i += blockDim.x)
        r.g[nxt][i] = r.g[cur][sm.parent[i / Hj] * Hj + i % Hj];
      for (int i = tid; i < K * Hp; i += blockDim.x) {
        const int src = sm.parent[i / Hp] * Hp + i % Hp;
        r.h[nxt][i] = r.h[cur][src];
        r.c[nxt][i] = r.c[cur][src];
      }
      __syncthreads();
      if (sm.any_emit) {
        lstm_multi<T>(r, sm, r.g[nxt], r.h[nxt], r.c[nxt], table, w_ih, w_hh, bias,
                      wp, bp, K, Hj, Hp, V1p, V);
        if (tid == 0)
          for (int j = 0; j < K; ++j) sm.n_lstm += sm.etok[j] >= 0;
      }
      cur = nxt;
    }
    // force-finalise the hypotheses still live after max_expansions rounds
    if (tid == 0) {
      int any = 0;
      for (int k = 0; k < K; ++k) any |= !sm.done[cur][k] && sm.score[k] > NEG / 2;
      sm.any_live = any;
    }
    __syncthreads();
    if (sm.any_live) {
      joint_logp<T>(r, r.g[cur], ft, head, head_b, K, Hj, Hp, V1, V1p);
      if (tid == 0) {
        for (int k = 0; k < K; ++k) {
          if (!sm.done[cur][k] && sm.score[k] > NEG / 2) {
            sm.score[k] += r.lp[k * V1p + blank];
            sm.n_joint += 1;
          }
        }
      }
    }
    // equal label sequences, one warp per pair of slots
    for (int q = warp; q < K * K; q += nwarps) {
      const int i = q / K, j = q % K;
      if (i >= j) continue;
      bool diff = false;
      for (int pos = lane; pos < max_out; pos += 32)
        diff |= r.tok[cur][i * max_out + pos] != r.tok[cur][j * max_out + pos];
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

  // the best hypothesis: the first index of the largest score
  if (tid == 0) {
    int best = 0;
    for (int k = 1; k < K; ++k)
      if (sm.score[k] > sm.score[best]) best = k;
    sm.parent[0] = best;
    out_lens[b] = sm.len[cur][best];
    out_scores[b] = sm.score[best];
    atomicAdd(work, sm.n_joint);
    atomicAdd(work + 1, sm.n_lstm);
    atomicAdd(work + 2, sm.n_round);
  }
  __syncthreads();
  const int best = sm.parent[0];
  for (int i = tid; i < max_out; i += blockDim.x)
    out_ids[(size_t)b * max_out + i] = r.tok[cur][best * max_out + i];
}

// The card's own limit: the row's hypotheses, two partial-sum buffers and
// the copies for the parent gather must fit the dynamic shared memory
// cudaFuncSetAttribute grants (227 KB a block on an H100); over it the
// call fails and so does the launch.
template <typename T>
cudaError_t launch(const void* f, const void* flens, const void* lang_ids,
                   const void* table, const void* w_ih, const void* w_hh,
                   const void* bias, const void* wp, const void* bp,
                   const void* head, const void* head_b, void* ids, void* olen,
                   void* oscore, void* work, int B, int T_, int Hj, int Hp, int V1,
                   int V1p, int L, int blank, int K, int P, int max_expansions,
                   int max_out, int threads, cudaStream_t stream) {
  constexpr int VEC = Vec16<T>::N;
  if (threads % 32 || threads > MAX_THREADS || threads / 32 < K || K < 1 ||
      K > MAX_K || P < 1 || P > MAX_P || P > V1 || Hp % VEC || Hj % VEC ||
      V1p % VEC || V1p < V1 || L < 1 || max_out < 1 || blank != V1 - 1)
    return cudaErrorInvalidValue;
  const size_t floats = (size_t)2 * K * pbuf_of(Hj, Hp, V1p) + (size_t)2 * K * Hj +
                        (size_t)4 * K * Hp + (size_t)K * (Hj > Hp ? Hj : Hp) +
                        (size_t)K * V1p;
  const size_t smem = 4 * (floats + (size_t)2 * K * max_out);
  cudaError_t e = cudaFuncSetAttribute(
      rnnt_beam_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) {
    cudaGetLastError();  // not left behind for the next launch to report
    return e;
  }
  rnnt_beam_kernel<T><<<B, threads, smem, stream>>>(
      (const T*)f, (const int*)flens, (const int*)lang_ids, (const T*)table,
      (const T*)w_ih, (const T*)w_hh, (const T*)bias, (const T*)wp, (const T*)bp,
      (const T*)head, (const float*)head_b, (int*)ids, (int*)olen, (float*)oscore,
      (unsigned long long*)work, T_, Hj, Hp, V1, V1p, L, blank, K, P, max_expansions,
      max_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rnnt_beam_search_fused(
    const void* f, const void* flens, const void* lang_ids, const void* table,
    const void* w_ih, const void* w_hh, const void* bias, const void* wp,
    const void* bp, const void* head, const void* head_b, void* ids, void* olen,
    void* oscore, void* work, int B, int T_, int Hj, int Hp, int V1, int V1p, int L,
    int blank, int K, int P, int max_expansions, int max_out, int dtype, int threads,
    void* stream) {
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (dtype == 0)
    e = launch<float>(f, flens, lang_ids, table, w_ih, w_hh, bias, wp, bp, head, head_b,
                      ids, olen, oscore, work, B, T_, Hj, Hp, V1, V1p, L, blank, K, P,
                      max_expansions, max_out, threads, s);
  else if (dtype == 1)
    e = launch<__nv_bfloat16>(f, flens, lang_ids, table, w_ih, w_hh, bias, wp, bp, head,
                              head_b, ids, olen, oscore, work, B, T_, Hj, Hp, V1, V1p, L,
                              blank, K, P, max_expansions, max_out, threads, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

extern "C" const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

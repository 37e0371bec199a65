// Edit distance of the port's host runtime (word-level WER).
//
// Levenshtein distance over int64 token ids, one pair or a batch of pairs
// on a thread pool. C ABI bound with ctypes
// (indic_cl_asr_torch/utils/native.py), which maps words to ids through
// one shared table, so distances equal those over the words themselves.

#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// Levenshtein distance between two id sequences (two-row DP).
int64_t edit_distance_i64(const int64_t* a, int64_t na, const int64_t* b,
                          int64_t nb) {
  if (na < nb) {
    std::swap(a, b);
    std::swap(na, nb);
  }
  if (nb == 0) return na;
  std::vector<int64_t> prev(nb + 1), cur(nb + 1);
  for (int64_t j = 0; j <= nb; ++j) prev[j] = j;
  for (int64_t i = 1; i <= na; ++i) {
    cur[0] = i;
    const int64_t ai = a[i - 1];
    for (int64_t j = 1; j <= nb; ++j) {
      const int64_t sub = prev[j - 1] + (ai != b[j - 1]);
      cur[j] = std::min({prev[j] + 1, cur[j - 1] + 1, sub});
    }
    std::swap(prev, cur);
  }
  return prev[nb];
}

// Batched edit distance over flattened, offset-indexed sequence pairs.
// a_flat/b_flat hold all sequences back to back; a_off/b_off are n+1
// offsets. Distances land in out[n]. Runs on `n_threads` std::threads.
void edit_distance_batch_i64(const int64_t* a_flat, const int64_t* a_off,
                             const int64_t* b_flat, const int64_t* b_off,
                             int64_t n, int64_t* out, int64_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  auto worker = [&](int64_t t) {
    for (int64_t i = t; i < n; i += n_threads) {
      out[i] = edit_distance_i64(a_flat + a_off[i], a_off[i + 1] - a_off[i],
                                 b_flat + b_off[i], b_off[i + 1] - b_off[i]);
    }
  };
  if (n_threads == 1) {
    worker(0);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int64_t t = 0; t < n_threads; ++t) threads.emplace_back(worker, t);
  for (auto& th : threads) th.join();
}

}  // extern "C"

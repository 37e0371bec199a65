// Batch WAV loader of the port's host runtime: WAV decode, resampling and
// padded batch assembly in one threaded call.
//
// One C++ call decodes a whole batch of WAV files on a thread pool
// directly into the caller's preallocated [B, S] float32 buffer: no Python
// in the per-sample loop, no intermediate copies. The same decoder as the
// JAX package's native loader, so both read a file to the same samples.
//
// Supports RIFF/WAVE PCM 8/16/24/32-bit and IEEE float32, any channel
// count (averaged to mono), with linear resampling to the target rate.
// C ABI bound with ctypes (indic_cl_asr_torch/utils/native.py).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct WavInfo {
  uint16_t format = 0;       // 1 = PCM, 3 = IEEE float
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
  long data_offset = -1;
  uint32_t data_bytes = 0;
};

bool parse_header(FILE* f, WavInfo* info) {
  char id[4];
  uint32_t size;
  if (fread(id, 1, 4, f) != 4 || memcmp(id, "RIFF", 4) != 0) return false;
  if (fread(&size, 4, 1, f) != 1) return false;
  if (fread(id, 1, 4, f) != 4 || memcmp(id, "WAVE", 4) != 0) return false;
  while (fread(id, 1, 4, f) == 4 && fread(&size, 4, 1, f) == 1) {
    if (memcmp(id, "fmt ", 4) == 0) {
      uint8_t buf[16];
      if (size < 16 || fread(buf, 1, 16, f) != 16) return false;
      memcpy(&info->format, buf + 0, 2);
      memcpy(&info->channels, buf + 2, 2);
      memcpy(&info->sample_rate, buf + 4, 4);
      memcpy(&info->bits, buf + 14, 2);
      if (size > 16) fseek(f, size - 16, SEEK_CUR);
    } else if (memcmp(id, "data", 4) == 0) {
      info->data_offset = ftell(f);
      info->data_bytes = size;
      return info->format != 0;
    } else {
      fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
  return false;
}

// Decode a file to mono float32 at its native rate. Returns sample count,
// -1 on failure.
int64_t decode_wav(const char* path, std::vector<float>* out,
                   uint32_t* sample_rate) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  if (!parse_header(f, &info) || info.channels == 0) {
    fclose(f);
    return -1;
  }
  *sample_rate = info.sample_rate;
  const int64_t bytes_per = info.bits / 8;
  const int64_t frames = info.data_bytes / (bytes_per * info.channels);
  std::vector<uint8_t> raw(info.data_bytes);
  fseek(f, info.data_offset, SEEK_SET);
  const size_t got = fread(raw.data(), 1, info.data_bytes, f);
  fclose(f);
  const int64_t got_frames =
      static_cast<int64_t>(got) / (bytes_per * info.channels);
  const int64_t n = std::min(frames, got_frames);
  out->resize(n);
  const double inv_ch = 1.0 / info.channels;
  for (int64_t i = 0; i < n; ++i) {
    double acc = 0.0;
    for (int c = 0; c < info.channels; ++c) {
      const uint8_t* p = raw.data() + (i * info.channels + c) * bytes_per;
      double v = 0.0;
      if (info.format == 3 && info.bits == 32) {
        float fv;
        memcpy(&fv, p, 4);
        v = fv;
      } else if (info.bits == 16) {
        int16_t s;
        memcpy(&s, p, 2);
        v = s / 32768.0;
      } else if (info.bits == 32) {
        int32_t s;
        memcpy(&s, p, 4);
        v = s / 2147483648.0;
      } else if (info.bits == 24) {
        int32_t s = (p[0] | (p[1] << 8) | (p[2] << 16));
        if (s & 0x800000) s |= ~0xFFFFFF;
        v = s / 8388608.0;
      } else if (info.bits == 8) {
        v = (p[0] - 128) / 128.0;
      }
      acc += v;
    }
    (*out)[i] = static_cast<float>(acc * inv_ch);
  }
  return n;
}

void resample_linear(const std::vector<float>& in, uint32_t sr_in,
                     uint32_t sr_out, std::vector<float>* out) {
  if (sr_in == sr_out || in.empty()) {
    *out = in;
    return;
  }
  const int64_t n_out =
      static_cast<int64_t>(in.size() * (double)sr_out / sr_in + 0.5);
  out->resize(n_out);
  const double step = (double)sr_in / sr_out;
  for (int64_t i = 0; i < n_out; ++i) {
    const double t = i * step;
    const int64_t j = static_cast<int64_t>(t);
    const double frac = t - j;
    const float a = in[std::min<int64_t>(j, in.size() - 1)];
    const float b = in[std::min<int64_t>(j + 1, in.size() - 1)];
    (*out)[i] = static_cast<float>(a + (b - a) * frac);
  }
}

}  // namespace

extern "C" {

// Decode `n` WAV files into batch[B, max_samples] (zero-padded), writing
// valid lengths to lengths[B]. paths is a flat \0-separated buffer.
// Returns 0 on success; lengths[i] = -1 marks per-file decode failure.
int load_wav_batch(const char* paths_flat, int64_t n, int64_t max_samples,
                   int64_t target_sr, float* batch, int64_t* lengths,
                   int64_t n_threads) {
  std::vector<const char*> paths;
  paths.reserve(n);
  const char* p = paths_flat;
  for (int64_t i = 0; i < n; ++i) {
    paths.push_back(p);
    p += strlen(p) + 1;
  }
  if (n_threads < 1) n_threads = 1;
  auto worker = [&](int64_t t) {
    std::vector<float> tmp, res;
    for (int64_t i = t; i < n; i += n_threads) {
      uint32_t sr = 0;
      float* row = batch + i * max_samples;
      memset(row, 0, sizeof(float) * max_samples);
      if (decode_wav(paths[i], &tmp, &sr) < 0) {
        lengths[i] = -1;
        continue;
      }
      resample_linear(tmp, sr, static_cast<uint32_t>(target_sr), &res);
      const int64_t m =
          std::min<int64_t>(res.size(), max_samples);
      memcpy(row, res.data(), sizeof(float) * m);
      lengths[i] = m;
    }
  };
  std::vector<std::thread> threads;
  for (int64_t t = 0; t < n_threads; ++t) threads.emplace_back(worker, t);
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"

// Native batch audio decoder of the PyTorch/CUDA port.
//
// Copy of robust_speech_analysis_framework_tpu/native/audio_io.cc: RIFF/WAVE
// parsing (PCM 8/16/24/32 and IEEE float 32/64), mono mixdown in double, and
// a worker pool of std::threads that decodes a whole list of files at once.
//
// C ABI (consumed from Python via ctypes: audio/native_io.py):
//   raf_decode_mono(path, &buf, &len, &sr)        decode one file
//   raf_decode_batch_mono(paths, n, bufs, lens, srs, status, n_threads)
//   raf_free(buf)                                 release a decoded buffer
//   raf_version()
//
// Built at first use by audio/native_io.py with g++ into build/native/.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Chunk {
  const uint8_t* data;
  size_t size;
};

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  if (size < 12) {
    std::fclose(f);
    return false;
  }
  std::fseek(f, 0, SEEK_SET);
  out->resize(static_cast<size_t>(size));
  size_t got = std::fread(out->data(), 1, out->size(), f);
  std::fclose(f);
  return got == out->size();
}

uint32_t rd_u32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

uint16_t rd_u16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0]) | (static_cast<uint16_t>(p[1]) << 8);
}

// Decode one WAV file to mono float32. Returns 0 on success.
int decode_mono(const char* path, float** out, int64_t* n_samples, int* sr) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return -1;
  if (buf.size() < 12 || std::memcmp(buf.data(), "RIFF", 4) != 0 ||
      std::memcmp(buf.data() + 8, "WAVE", 4) != 0)
    return -2;

  Chunk fmt{nullptr, 0}, data{nullptr, 0};
  size_t pos = 12;
  while (pos + 8 <= buf.size()) {
    const uint8_t* cid = buf.data() + pos;
    uint32_t size = rd_u32(buf.data() + pos + 4);
    size_t body = pos + 8;
    if (body + size > buf.size()) size = static_cast<uint32_t>(buf.size() - body);
    if (std::memcmp(cid, "fmt ", 4) == 0) {
      fmt = {buf.data() + body, size};
    } else if (std::memcmp(cid, "data", 4) == 0) {
      data = {buf.data() + body, size};
    }
    pos = body + size + (size & 1);  // word alignment
    if (fmt.data && data.data) break;
  }
  if (!fmt.data || fmt.size < 16 || !data.data) return -3;

  uint16_t format = rd_u16(fmt.data);
  uint16_t channels = rd_u16(fmt.data + 2);
  uint32_t rate = rd_u32(fmt.data + 4);
  uint16_t bits = rd_u16(fmt.data + 14);
  if (format == 0xFFFE && fmt.size >= 26) format = rd_u16(fmt.data + 24);
  if (channels == 0) return -4;

  size_t bytes_per = bits / 8;
  if (bytes_per == 0) return -5;
  size_t n_frames = data.size / (bytes_per * channels);
  float* mono = static_cast<float*>(std::malloc(n_frames * sizeof(float)));
  if (!mono) return -6;

  const uint8_t* p = data.data;
  const double inv_ch = 1.0 / channels;
  for (size_t i = 0; i < n_frames; ++i) {
    double acc = 0.0;
    for (unsigned c = 0; c < channels; ++c) {
      const uint8_t* s = p + (i * channels + c) * bytes_per;
      double v = 0.0;
      if (format == 1) {  // PCM
        switch (bits) {
          case 8:
            v = (static_cast<int>(s[0]) - 128) / 128.0;
            break;
          case 16: {
            int16_t x = static_cast<int16_t>(s[0] | (s[1] << 8));
            v = x / 32768.0;
            break;
          }
          case 24: {
            int32_t x = s[0] | (s[1] << 8) | (s[2] << 16);
            if (x >= (1 << 23)) x -= (1 << 24);
            v = x / 8388608.0;
            break;
          }
          case 32: {
            int32_t x;
            std::memcpy(&x, s, 4);
            v = x / 2147483648.0;
            break;
          }
          default:
            std::free(mono);
            return -7;
        }
      } else if (format == 3) {  // IEEE float
        if (bits == 32) {
          float x;
          std::memcpy(&x, s, 4);
          v = x;
        } else if (bits == 64) {
          double x;
          std::memcpy(&x, s, 8);
          v = x;
        } else {
          std::free(mono);
          return -7;
        }
      } else {
        std::free(mono);
        return -8;
      }
      acc += v;
    }
    mono[i] = static_cast<float>(acc * inv_ch);
  }
  *out = mono;
  *n_samples = static_cast<int64_t>(n_frames);
  *sr = static_cast<int>(rate);
  return 0;
}

}  // namespace

extern "C" {

const char* raf_version() { return "raf-audio 1.0"; }

int raf_decode_mono(const char* path, float** out, int64_t* n_samples,
                    int* sr) {
  return decode_mono(path, out, n_samples, sr);
}

void raf_free(float* buf) { std::free(buf); }

// Decode n files concurrently with a worker pool. outs/lens/srs are arrays
// of length n; per-file status codes are written to status (0 = ok).
void raf_decode_batch_mono(const char** paths, int n, float** outs,
                           int64_t* lens, int* srs, int* status,
                           int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next{0};
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      outs[i] = nullptr;
      lens[i] = 0;
      srs[i] = 0;
      status[i] = decode_mono(paths[i], &outs[i], &lens[i], &srs[i]);
    }
  };
  std::vector<std::thread> pool;
  int workers = n_threads < n ? n_threads : n;
  pool.reserve(static_cast<size_t>(workers));
  for (int t = 0; t < workers; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // extern "C"

// Native audio I/O for the host-side data pipeline.
//
// The reference's dataset decodes audio through torchaudio's C++ kernels
// (reference data.py:14,50). This is the port's copy of
// voicebox_tpu/native/wavio.cpp, unchanged in what it computes: a small,
// dependency-free C++ WAV decoder with a multithreaded batch loader, exposed
// through a C ABI consumed via ctypes (voicebox_tpu_torch/native/__init__.py).
//
// Supported: RIFF/WAVE, PCM 8/16/24/32-bit and IEEE float32/float64, any
// channel count (averaged to mono), arbitrary chunk ordering. Output is
// float32 mono in [-1, 1].
//
// Built at first use by voicebox_tpu_torch/native/__init__.py (g++ -O3 -shared
// -fPIC -std=c++17 ... -lpthread) into the kernels' build directory.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct WavData {
  std::vector<float> samples;  // mono
  int sample_rate = 0;
  bool ok = false;
};

uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const uint8_t* p) {
  return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

WavData decode_wav(const uint8_t* buf, size_t len) {
  WavData out;
  if (len < 44 || memcmp(buf, "RIFF", 4) != 0 || memcmp(buf + 8, "WAVE", 4) != 0)
    return out;

  uint16_t format = 0, channels = 0, bits = 0;
  uint32_t sample_rate = 0;
  const uint8_t* data = nullptr;
  size_t data_len = 0;

  size_t pos = 12;
  while (pos + 8 <= len) {
    const uint8_t* hdr = buf + pos;
    uint32_t chunk_len = rd_u32(hdr + 4);
    const uint8_t* body = hdr + 8;
    if (pos + 8 + chunk_len > len) chunk_len = (uint32_t)(len - pos - 8);

    if (memcmp(hdr, "fmt ", 4) == 0 && chunk_len >= 16) {
      format = rd_u16(body);
      channels = rd_u16(body + 2);
      sample_rate = rd_u32(body + 4);
      bits = rd_u16(body + 14);
      if (format == 0xFFFE && chunk_len >= 40)  // WAVE_FORMAT_EXTENSIBLE
        format = rd_u16(body + 24);
    } else if (memcmp(hdr, "data", 4) == 0) {
      data = body;
      data_len = chunk_len;
    }
    pos += 8 + chunk_len + (chunk_len & 1);  // chunks are word-aligned
  }

  if (!data || channels == 0 || sample_rate == 0) return out;

  size_t bytes_per_sample = bits / 8;
  if (bytes_per_sample == 0) return out;
  size_t n_frames = data_len / (bytes_per_sample * channels);
  out.samples.resize(n_frames);
  out.sample_rate = (int)sample_rate;

  const float inv_ch = 1.0f / (float)channels;
  for (size_t i = 0; i < n_frames; ++i) {
    float acc = 0.0f;
    for (unsigned c = 0; c < channels; ++c) {
      const uint8_t* p = data + (i * channels + c) * bytes_per_sample;
      float v = 0.0f;
      if (format == 1) {  // PCM
        switch (bits) {
          case 8:
            v = ((float)p[0] - 128.0f) / 128.0f;
            break;
          case 16: {
            int16_t s = (int16_t)rd_u16(p);
            v = (float)s / 32768.0f;
            break;
          }
          case 24: {
            int32_t s = (int32_t)((uint32_t)p[0] << 8 | (uint32_t)p[1] << 16 |
                                  (uint32_t)p[2] << 24) >> 8;
            v = (float)s / 8388608.0f;
            break;
          }
          case 32: {
            int32_t s = (int32_t)rd_u32(p);
            v = (float)s / 2147483648.0f;
            break;
          }
          default:
            return out;
        }
      } else if (format == 3) {  // IEEE float
        if (bits == 32) {
          float f;
          memcpy(&f, p, 4);
          v = f;
        } else if (bits == 64) {
          double d;
          memcpy(&d, p, 8);
          v = (float)d;
        } else {
          return out;
        }
      } else {
        return out;
      }
      acc += v;
    }
    out.samples[i] = acc * inv_ch;
  }
  out.ok = true;
  return out;
}

WavData load_file(const char* path) {
  WavData out;
  FILE* f = fopen(path, "rb");
  if (!f) return out;
  fseek(f, 0, SEEK_END);
  long len = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (len <= 0) {
    fclose(f);
    return out;
  }
  std::vector<uint8_t> buf((size_t)len);
  size_t got = fread(buf.data(), 1, (size_t)len, f);
  fclose(f);
  if (got != (size_t)len) return out;
  return decode_wav(buf.data(), buf.size());
}

}  // namespace

extern "C" {

// Probe a wav file: returns n_samples (mono frames), fills *sample_rate.
// Returns -1 on failure.
long long vb_wav_info(const char* path, int* sample_rate) {
  WavData w = load_file(path);
  if (!w.ok) return -1;
  *sample_rate = w.sample_rate;
  return (long long)w.samples.size();
}

// Decode into caller-provided float32 buffer of capacity `max_samples`.
// Returns number of samples written, -1 on failure.
long long vb_wav_read(const char* path, float* out, long long max_samples,
                      int* sample_rate) {
  WavData w = load_file(path);
  if (!w.ok) return -1;
  *sample_rate = w.sample_rate;
  long long n = (long long)w.samples.size();
  if (n > max_samples) n = max_samples;
  memcpy(out, w.samples.data(), (size_t)n * sizeof(float));
  return n;
}

// Threaded batch decode: `n` paths (NUL-separated), each row of `out` is
// zero-padded to `max_samples`. lengths[i] = decoded length or -1.
// Returns number of successfully decoded files.
int vb_wav_read_batch(const char* paths, int n, float* out,
                      long long max_samples, long long* lengths,
                      int num_threads) {
  std::vector<const char*> files;
  const char* p = paths;
  for (int i = 0; i < n; ++i) {
    files.push_back(p);
    p += strlen(p) + 1;
  }

  if (num_threads <= 0) num_threads = (int)std::thread::hardware_concurrency();
  if (num_threads > n) num_threads = n;
  if (num_threads < 1) num_threads = 1;

  std::vector<std::thread> workers;
  for (int t = 0; t < num_threads; ++t) {
    workers.emplace_back([&, t]() {
      for (int i = t; i < n; i += num_threads) {
        float* row = out + (long long)i * max_samples;
        memset(row, 0, (size_t)max_samples * sizeof(float));
        int sr = 0;
        lengths[i] = vb_wav_read(files[i], row, max_samples, &sr);
      }
    });
  }
  for (auto& w : workers) w.join();

  int ok = 0;
  for (int i = 0; i < n; ++i)
    if (lengths[i] >= 0) ++ok;
  return ok;
}

}  // extern "C"

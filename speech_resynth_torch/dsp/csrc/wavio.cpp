// Native WAV reader/writer + multi-threaded batch loader.
//
// The port's copy of speech_resynth_tpu/dsp/csrc/wavio.cpp, the host-side
// data path in place of torchaudio's I/O: RIFF/WAVE parsing for PCM 16/24/32
// and IEEE float32, normalized float32 output, PCM16 writing, and a
// std::thread fan-out that fills a caller-provided padded batch buffer so
// the device feed thread never blocks on per-file python I/O.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct WavData {
  uint32_t sample_rate = 0;
  uint16_t channels = 0;
  std::vector<float> samples;  // interleaved
  bool ok = false;
};

uint32_t rd_u32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}
uint16_t rd_u16(const uint8_t* p) { return p[0] | (p[1] << 8); }

WavData read_wav(const char* path) {
  WavData out;
  FILE* f = std::fopen(path, "rb");
  if (!f) return out;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < 44) {
    std::fclose(f);
    return out;
  }
  std::vector<uint8_t> buf(size);
  if (std::fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
    std::fclose(f);
    return out;
  }
  std::fclose(f);

  if (std::memcmp(buf.data(), "RIFF", 4) || std::memcmp(buf.data() + 8, "WAVE", 4)) return out;

  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t sr = 0;
  size_t pos = 12;
  const uint8_t* data_ptr = nullptr;
  uint32_t data_len = 0;
  while (pos + 8 <= buf.size()) {
    const uint8_t* hdr = buf.data() + pos;
    uint32_t chunk_len = rd_u32(hdr + 4);
    const uint8_t* body = hdr + 8;
    // A declared chunk_len can exceed the file (truncated/malformed input);
    // only read body bytes that are actually present in the buffer.
    size_t avail = buf.size() - (pos + 8);
    if (!std::memcmp(hdr, "fmt ", 4) && chunk_len >= 16 && avail >= 16) {
      fmt = rd_u16(body);
      channels = rd_u16(body + 2);
      sr = rd_u32(body + 4);
      bits = rd_u16(body + 14);
      if (fmt == 0xFFFE && chunk_len >= 40 && avail >= 26) fmt = rd_u16(body + 24);  // WAVE_FORMAT_EXTENSIBLE
    } else if (!std::memcmp(hdr, "data", 4)) {
      data_ptr = body;
      data_len = std::min<uint32_t>(chunk_len, buf.size() - (pos + 8));
    }
    pos += 8 + chunk_len + (chunk_len & 1);
  }
  if (!data_ptr || !channels || !sr) return out;

  size_t n;
  switch (fmt) {
    case 1:  // PCM
      if (bits == 16) {
        n = data_len / 2;
        out.samples.resize(n);
        for (size_t i = 0; i < n; ++i) {
          int16_t v;
          std::memcpy(&v, data_ptr + 2 * i, 2);
          out.samples[i] = v / 32768.0f;
        }
      } else if (bits == 24) {
        n = data_len / 3;
        out.samples.resize(n);
        for (size_t i = 0; i < n; ++i) {
          const uint8_t* p = data_ptr + 3 * i;
          int32_t v = (p[0] << 8) | (p[1] << 16) | (int32_t(p[2]) << 24);
          out.samples[i] = (v >> 8) / 8388608.0f;
        }
      } else if (bits == 32) {
        n = data_len / 4;
        out.samples.resize(n);
        for (size_t i = 0; i < n; ++i) {
          int32_t v;
          std::memcpy(&v, data_ptr + 4 * i, 4);
          out.samples[i] = v / 2147483648.0f;
        }
      } else {
        return out;
      }
      break;
    case 3:  // IEEE float
      if (bits != 32) return out;
      n = data_len / 4;
      out.samples.resize(n);
      std::memcpy(out.samples.data(), data_ptr, n * 4);
      break;
    default:
      return out;
  }
  out.sample_rate = sr;
  out.channels = channels;
  out.ok = true;
  return out;
}

bool ends_with(const char* s, const char* suffix) {
  size_t ls = std::strlen(s), lx = std::strlen(suffix);
  return ls >= lx && std::strcmp(s + ls - lx, suffix) == 0;
}

}  // namespace

// from flac.cpp (same shared object)
extern "C" int flac_info(const char* path, uint32_t* sr, uint32_t* channels, uint64_t* frames);
extern "C" int64_t flac_read(const char* path, float* out, uint64_t max_frames, uint32_t* sr, uint32_t* channels);

extern "C" {

// Query (sr, channels, frames); returns 0 on success.
int wav_info(const char* path, uint32_t* sr, uint32_t* channels, uint64_t* frames) {
  WavData w = read_wav(path);
  if (!w.ok) return -1;
  *sr = w.sample_rate;
  *channels = w.channels;
  *frames = w.samples.size() / w.channels;
  return 0;
}

// Read interleaved float32; returns frames read or -1.
int64_t wav_read(const char* path, float* out, uint64_t max_frames, uint32_t* sr, uint32_t* channels) {
  WavData w = read_wav(path);
  if (!w.ok) return -1;
  *sr = w.sample_rate;
  *channels = w.channels;
  uint64_t frames = w.samples.size() / w.channels;
  uint64_t n = std::min<uint64_t>(frames, max_frames);
  std::memcpy(out, w.samples.data(), n * w.channels * sizeof(float));
  return static_cast<int64_t>(n);
}

// PCM16 mono/interleaved writer; returns 0 on success.
int wav_write(const char* path, const float* samples, uint64_t frames, uint32_t channels, uint32_t sr) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  uint64_t n = frames * channels;
  uint32_t data_len = static_cast<uint32_t>(n * 2);
  uint32_t riff_len = 36 + data_len;
  uint32_t byte_rate = sr * channels * 2;
  uint16_t block_align = channels * 2;

  uint8_t hdr[44];
  std::memcpy(hdr, "RIFF", 4);
  std::memcpy(hdr + 4, &riff_len, 4);
  std::memcpy(hdr + 8, "WAVEfmt ", 8);
  uint32_t fmt_len = 16;
  std::memcpy(hdr + 16, &fmt_len, 4);
  uint16_t fmt = 1;
  std::memcpy(hdr + 20, &fmt, 2);
  uint16_t ch16 = channels;
  std::memcpy(hdr + 22, &ch16, 2);
  std::memcpy(hdr + 24, &sr, 4);
  std::memcpy(hdr + 28, &byte_rate, 4);
  std::memcpy(hdr + 32, &block_align, 2);
  uint16_t bits = 16;
  std::memcpy(hdr + 34, &bits, 2);
  std::memcpy(hdr + 36, "data", 4);
  std::memcpy(hdr + 40, &data_len, 4);
  std::fwrite(hdr, 1, 44, f);

  std::vector<int16_t> pcm(n);
  for (uint64_t i = 0; i < n; ++i) {
    float v = std::max(-1.0f, std::min(1.0f, samples[i]));
    pcm[i] = static_cast<int16_t>(v * 32767.0f);
  }
  std::fwrite(pcm.data(), 2, n, f);
  std::fclose(f);
  return 0;
}

// Threaded batch read: fills a (n_files, max_frames) mono float32 buffer
// (first channel if multichannel), zero-padded; lengths out per file
// (-1 on per-file failure).  n_threads<=0 -> hardware concurrency.
void wav_read_batch(const char** paths, uint64_t n_files, float* out,
                    uint64_t max_frames, int64_t* lengths, uint32_t* srs,
                    int n_threads) {
  if (n_threads <= 0) n_threads = std::max(1u, std::thread::hardware_concurrency());
  n_threads = std::min<int>(n_threads, n_files ? n_files : 1);

  auto work = [&](int tid) {
    for (uint64_t i = tid; i < n_files; i += n_threads) {
      float* dst = out + i * max_frames;
      WavData w;
      if (ends_with(paths[i], ".flac")) {
        uint32_t fsr = 0, fch = 0;
        uint64_t fframes = 0;
        if (flac_info(paths[i], &fsr, &fch, &fframes) == 0 && fch > 0) {
          std::vector<float> tmp(max_frames * fch);
          int64_t got = flac_read(paths[i], tmp.data(), max_frames, &fsr, &fch);
          if (got >= 0) {
            w.ok = true;
            w.sample_rate = fsr;
            w.channels = fch;
            w.samples.assign(tmp.begin(), tmp.begin() + got * fch);
          }
        }
      } else {
        w = read_wav(paths[i]);
      }
      if (!w.ok) {
        lengths[i] = -1;
        srs[i] = 0;
        std::memset(dst, 0, max_frames * sizeof(float));
        continue;
      }
      uint64_t frames = w.samples.size() / w.channels;
      uint64_t n = std::min<uint64_t>(frames, max_frames);
      for (uint64_t j = 0; j < n; ++j) dst[j] = w.samples[j * w.channels];
      std::memset(dst + n, 0, (max_frames - n) * sizeof(float));
      lengths[i] = static_cast<int64_t>(n);
      srs[i] = w.sample_rate;
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < n_threads; ++t) threads.emplace_back(work, t);
  work(0);
  for (auto& th : threads) th.join();
}

}  // extern "C"

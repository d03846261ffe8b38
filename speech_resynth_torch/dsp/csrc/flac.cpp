// Minimal native FLAC decoder (16/24/8-bit, mono/stereo, all stereo modes).
//
// The port's copy of speech_resynth_tpu/dsp/csrc/flac.cpp: reads LibriSpeech
// and Libri-Light .flac without libsndfile.
// Supports the subset those corpora use: STREAMINFO + frames with
// constant/verbatim/fixed/LPC subframes, rice residual partitions (4- and
// 5-bit params incl. escape), independent + left-side/right-side/mid-side
// stereo.  CRC/MD5 are not verified (decode-speed path).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t byte = 0;
  int bit = 0;  // bits consumed in current byte (0..7)
  bool error = false;

  bool eof() const { return byte >= size; }

  uint32_t read_bit() {
    if (byte >= size) {
      error = true;
      return 0;
    }
    uint32_t v = (data[byte] >> (7 - bit)) & 1;
    if (++bit == 8) {
      bit = 0;
      ++byte;
    }
    return v;
  }

  uint64_t read_bits(int n) {
    uint64_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | read_bit();
    return v;
  }

  int64_t read_signed(int n) {
    uint64_t v = read_bits(n);
    if (n == 0) return 0;
    if (v & (1ULL << (n - 1))) return static_cast<int64_t>(v) - (1LL << n);
    return static_cast<int64_t>(v);
  }

  uint32_t read_unary() {
    uint32_t n = 0;
    while (!error && read_bit() == 0) ++n;
    return n;
  }

  void align() {
    if (bit) {
      bit = 0;
      ++byte;
    }
  }
};

int64_t read_utf8_number(BitReader& br) {
  uint32_t b0 = br.read_bits(8);
  int extra = 0;
  uint64_t v = 0;
  if (b0 < 0x80) return b0;
  if ((b0 >> 5) == 0x6) {
    v = b0 & 0x1F;
    extra = 1;
  } else if ((b0 >> 4) == 0xE) {
    v = b0 & 0x0F;
    extra = 2;
  } else if ((b0 >> 3) == 0x1E) {
    v = b0 & 0x07;
    extra = 3;
  } else if ((b0 >> 2) == 0x3E) {
    v = b0 & 0x03;
    extra = 4;
  } else if ((b0 >> 1) == 0x7E) {
    v = b0 & 0x01;
    extra = 5;
  } else if (b0 == 0xFE) {
    v = 0;
    extra = 6;
  } else {
    br.error = true;
    return -1;
  }
  for (int i = 0; i < extra; ++i) v = (v << 6) | (br.read_bits(8) & 0x3F);
  return static_cast<int64_t>(v);
}

// rice-coded residuals for one subframe
bool decode_residuals(BitReader& br, int block_size, int pred_order, std::vector<int64_t>& out) {
  uint32_t method = br.read_bits(2);  // 0: 4-bit rice, 1: 5-bit rice
  if (method > 1) return false;
  int param_bits = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 0xF : 0x1F;
  uint32_t part_order = br.read_bits(4);
  uint32_t parts = 1u << part_order;
  int samples_per_part = block_size >> part_order;
  if (samples_per_part <= 0) return false;

  int idx = pred_order;
  for (uint32_t p = 0; p < parts; ++p) {
    int count = samples_per_part - (p == 0 ? pred_order : 0);
    if (count < 0) return false;
    uint32_t param = br.read_bits(param_bits);
    if (param == escape) {
      uint32_t raw_bits = br.read_bits(5);
      for (int i = 0; i < count; ++i) out[idx++] = br.read_signed(raw_bits);
    } else {
      for (int i = 0; i < count; ++i) {
        uint32_t q = br.read_unary();
        uint64_t r = br.read_bits(param);
        uint64_t zz = (static_cast<uint64_t>(q) << param) | r;
        out[idx++] = (zz >> 1) ^ -static_cast<int64_t>(zz & 1);  // unzigzag
        if (br.error) return false;
      }
    }
  }
  return !br.error;
}

bool decode_subframe(BitReader& br, int block_size, int bps, std::vector<int64_t>& out) {
  if (br.read_bit() != 0) return false;  // mandatory zero pad
  uint32_t type = br.read_bits(6);
  int wasted = 0;
  if (br.read_bit()) wasted = 1 + br.read_unary();
  bps -= wasted;

  out.assign(block_size, 0);
  if (type == 0) {  // constant
    int64_t v = br.read_signed(bps);
    for (int i = 0; i < block_size; ++i) out[i] = v;
  } else if (type == 1) {  // verbatim
    for (int i = 0; i < block_size; ++i) out[i] = br.read_signed(bps);
  } else if (type >= 8 && type <= 12) {  // fixed, order 0..4
    int order = type - 8;
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
    if (!decode_residuals(br, block_size, order, out)) return false;
    for (int i = order; i < block_size; ++i) {
      switch (order) {
        case 0:
          break;
        case 1:
          out[i] += out[i - 1];
          break;
        case 2:
          out[i] += 2 * out[i - 1] - out[i - 2];
          break;
        case 3:
          out[i] += 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3];
          break;
        case 4:
          out[i] += 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3] - out[i - 4];
          break;
      }
    }
  } else if (type >= 32) {  // LPC, order 1..32
    int order = (type & 0x1F) + 1;
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
    uint32_t precision = br.read_bits(4) + 1;
    if (precision == 16) return false;  // 0b1111 invalid
    int shift = static_cast<int>(br.read_signed(5));
    if (shift < 0) return false;
    std::vector<int64_t> coefs(order);
    for (int i = 0; i < order; ++i) coefs[i] = br.read_signed(precision);
    if (!decode_residuals(br, block_size, order, out)) return false;
    for (int i = order; i < block_size; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += coefs[j] * out[i - 1 - j];
      out[i] += pred >> shift;
    }
  } else {
    return false;
  }
  if (wasted) {
    for (auto& v : out) v <<= wasted;
  }
  return !br.error;
}

struct FlacStream {
  uint32_t sample_rate = 0;
  uint32_t channels = 0;
  uint32_t bps = 0;
  uint64_t total_samples = 0;
  std::vector<float> samples;  // interleaved
  bool ok = false;
};

const int BLOCK_SIZES[16] = {0,    192,  576,  1152, 2304, 4608, -1,   -2,
                             256,  512,  1024, 2048, 4096, 8192, 16384, 32768};
const int SAMPLE_RATES[12] = {0,     88200, 176400, 192000, 8000,  16000,
                              22050, 24000, 32000,  44100,  48000, 96000};

FlacStream decode_flac(const uint8_t* data, size_t size) {
  FlacStream s;
  if (size < 42 || std::memcmp(data, "fLaC", 4)) return s;
  size_t pos = 4;

  // metadata blocks
  bool last = false;
  while (!last && pos + 4 <= size) {
    uint8_t hdr = data[pos];
    last = hdr & 0x80;
    uint8_t type = hdr & 0x7F;
    uint32_t len = (data[pos + 1] << 16) | (data[pos + 2] << 8) | data[pos + 3];
    pos += 4;
    // Declared metadata length can exceed the file; verify the 34 STREAMINFO
    // bytes are actually present before reading them.
    if (type == 0 && len >= 34 && pos + 34 <= size) {  // STREAMINFO
      const uint8_t* p = data + pos;
      s.sample_rate = (p[10] << 12) | (p[11] << 4) | (p[12] >> 4);
      s.channels = ((p[12] >> 1) & 0x7) + 1;
      s.bps = (((p[12] & 1) << 4) | (p[13] >> 4)) + 1;
      s.total_samples = (static_cast<uint64_t>(p[13] & 0x0F) << 32) | (static_cast<uint64_t>(p[14]) << 24) |
                        (p[15] << 16) | (p[16] << 8) | p[17];
    }
    pos += len;
  }
  if (!s.sample_rate || !s.channels || s.bps < 8) return s;
  if (s.total_samples) s.samples.reserve(s.total_samples * s.channels);

  BitReader br{data, size};
  br.byte = pos;

  std::vector<std::vector<int64_t>> chan(s.channels);
  const double scale_base = 1.0 / (1ull << (s.bps - 1));

  while (br.byte + 2 < size) {
    // frame sync
    uint32_t sync = br.read_bits(14);
    if (br.error) break;
    if (sync != 0x3FFE) {
      // Desync after at least one decoded frame = trailing junk (e.g. an ID3
      // tag): accept what we have.  Desync before any frame = malformed.
      if (!s.samples.empty()) break;
      return s;
    }
    br.read_bit();  // reserved
    br.read_bit();  // blocking strategy
    uint32_t bs_code = br.read_bits(4);
    uint32_t sr_code = br.read_bits(4);
    uint32_t ch_code = br.read_bits(4);
    uint32_t ss_code = br.read_bits(3);
    br.read_bit();  // reserved
    read_utf8_number(br);

    int block_size;
    if (bs_code == 6)
      block_size = -1;  // read 8-bit later
    else if (bs_code == 7)
      block_size = -2;  // read 16-bit later
    else
      block_size = BLOCK_SIZES[bs_code];
    if (block_size == -1) block_size = br.read_bits(8) + 1;
    else if (block_size == -2) block_size = br.read_bits(16) + 1;
    if (block_size <= 0) return s;

    if (sr_code == 12) br.read_bits(8);
    else if (sr_code == 13 || sr_code == 14) br.read_bits(16);

    int bps = s.bps;
    switch (ss_code) {  // per-frame override
      case 1: bps = 8; break;
      case 2: bps = 12; break;
      case 4: bps = 16; break;
      case 5: bps = 20; break;
      case 6: bps = 24; break;
      default: break;
    }
    br.read_bits(8);  // CRC-8 (unverified)

    int nch = s.channels;
    int assignment = 0;  // 0 independent, 1 L/S, 2 S/R, 3 M/S
    if (ch_code <= 7) {
      nch = ch_code + 1;
    } else if (ch_code == 8) {
      nch = 2;
      assignment = 1;
    } else if (ch_code == 9) {
      nch = 2;
      assignment = 2;
    } else if (ch_code == 10) {
      nch = 2;
      assignment = 3;
    } else {
      return s;
    }
    if (static_cast<uint32_t>(nch) != s.channels) return s;

    for (int c = 0; c < nch; ++c) {
      int sub_bps = bps;
      // side channel carries one extra bit
      if ((assignment == 1 && c == 1) || (assignment == 2 && c == 0) || (assignment == 3 && c == 1)) sub_bps += 1;
      if (!decode_subframe(br, block_size, sub_bps, chan[c])) return s;
    }
    br.align();
    br.read_bits(16);  // CRC-16 (unverified)
    if (br.error) return s;

    // undo stereo decorrelation
    if (assignment == 1) {  // left/side: right = left - side
      for (int i = 0; i < block_size; ++i) chan[1][i] = chan[0][i] - chan[1][i];
    } else if (assignment == 2) {  // side/right: left = side + right
      for (int i = 0; i < block_size; ++i) chan[0][i] = chan[0][i] + chan[1][i];
    } else if (assignment == 3) {  // mid/side
      for (int i = 0; i < block_size; ++i) {
        int64_t mid = chan[0][i];
        int64_t side = chan[1][i];
        mid = (mid << 1) | (side & 1);
        chan[0][i] = (mid + side) >> 1;
        chan[1][i] = (mid - side) >> 1;
      }
    }

    double scale = (bps == static_cast<int>(s.bps)) ? scale_base : 1.0 / (1ull << (bps - 1));
    for (int i = 0; i < block_size; ++i)
      for (uint32_t c = 0; c < s.channels; ++c)
        s.samples.push_back(static_cast<float>(chan[c][i] * scale));
  }

  s.ok = true;
  return s;
}

std::vector<uint8_t> read_file(const char* path) {
  std::vector<uint8_t> buf;
  FILE* f = std::fopen(path, "rb");
  if (!f) return buf;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  buf.resize(size);
  if (std::fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) buf.clear();
  std::fclose(f);
  return buf;
}

}  // namespace

extern "C" {

int flac_info(const char* path, uint32_t* sr, uint32_t* channels, uint64_t* frames) {
  std::vector<uint8_t> buf = read_file(path);
  if (buf.size() < 42 || std::memcmp(buf.data(), "fLaC", 4)) return -1;
  // STREAMINFO only (fast)
  size_t pos = 4;
  bool last = false;
  while (!last && pos + 4 <= buf.size()) {
    uint8_t hdr = buf[pos];
    last = hdr & 0x80;
    uint8_t type = hdr & 0x7F;
    uint32_t len = (buf[pos + 1] << 16) | (buf[pos + 2] << 8) | buf[pos + 3];
    pos += 4;
    if (type == 0 && len >= 34) {
      const uint8_t* p = buf.data() + pos;
      *sr = (p[10] << 12) | (p[11] << 4) | (p[12] >> 4);
      *channels = ((p[12] >> 1) & 0x7) + 1;
      *frames = (static_cast<uint64_t>(p[13] & 0x0F) << 32) | (static_cast<uint64_t>(p[14]) << 24) |
                (p[15] << 16) | (p[16] << 8) | p[17];
      return 0;
    }
    pos += len;
  }
  return -1;
}

// decode; returns frames or -1
int64_t flac_read(const char* path, float* out, uint64_t max_frames, uint32_t* sr, uint32_t* channels) {
  std::vector<uint8_t> buf = read_file(path);
  if (buf.empty()) return -1;
  FlacStream s = decode_flac(buf.data(), buf.size());
  if (!s.ok) return -1;
  *sr = s.sample_rate;
  *channels = s.channels;
  uint64_t frames = s.samples.size() / s.channels;
  uint64_t n = frames < max_frames ? frames : max_frames;
  std::memcpy(out, s.samples.data(), n * s.channels * sizeof(float));
  return static_cast<int64_t>(n);
}

}  // extern "C"

// Native FLAC decoder for the host-side data pipeline.
//
// The reference's AudioDataset globs `**/*.flac` and decodes through
// torchaudio's C++ backends (reference data.py:26-53); this image ships no
// flac-capable library at all (no torchaudio/soundfile/libFLAC), so the
// framework carries its own: a small, dependency-free C++ decoder for the full
// mandatory FLAC subset, exposed through a C ABI consumed via ctypes
// (voicebox_tpu_torch/native/__init__.py). This is the port's copy of
// voicebox_tpu/native/flacio.cpp, unchanged in what it computes.
//
// Supported: fLaC container + STREAMINFO, fixed & variable blocking, all
// block-size/sample-rate/sample-size codes, 4-32 bit depths, channel
// assignments independent/left-side/right-side/mid-side, subframe types
// CONSTANT / VERBATIM / FIXED(0-4) / LPC(1-32), wasted bits, Rice & Rice2
// residual partitions including raw-bits escapes. CRCs are consumed, not
// verified (a decode-side choice; corrupt streams fail structurally).
// Output is float32 mono in [-1, 1] (channels averaged), like wavio.cpp.
//
// Format reference: RFC 9639 (the FLAC specification).
//
// Built at first use by voicebox_tpu_torch/native/__init__.py (g++ -O3 -shared
// -fPIC -std=c++17 ...) into the kernels' build directory.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct ByteBuf {
  std::vector<uint8_t> data;
  bool ok = false;
};

ByteBuf read_file(const char* path) {
  ByteBuf out;
  FILE* f = fopen(path, "rb");
  if (!f) return out;
  fseek(f, 0, SEEK_END);
  long len = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (len <= 0) {
    fclose(f);
    return out;
  }
  out.data.resize((size_t)len);
  out.ok = fread(out.data.data(), 1, (size_t)len, f) == (size_t)len;
  fclose(f);
  return out;
}

// MSB-first bit reader over a byte buffer.
struct BitReader {
  const uint8_t* buf;
  size_t len;     // bytes
  size_t bitpos;  // bits consumed
  bool fail = false;

  BitReader(const uint8_t* b, size_t n) : buf(b), len(n), bitpos(0) {}

  size_t bits_left() const { return len * 8 - bitpos; }

  uint64_t read_bits(unsigned n) {  // n <= 57
    if (fail || n > bits_left()) {
      fail = true;
      return 0;
    }
    uint64_t v = 0;
    unsigned got = 0;
    while (got < n) {
      size_t byte = bitpos >> 3;
      unsigned off = bitpos & 7;          // bits already consumed in byte
      unsigned avail = 8 - off;           // bits left in this byte
      unsigned take = n - got < avail ? n - got : avail;
      unsigned shift = avail - take;      // MSB-first
      uint8_t chunk = (uint8_t)((buf[byte] >> shift) & ((1u << take) - 1));
      v = (v << take) | chunk;
      bitpos += take;
      got += take;
    }
    return v;
  }

  int64_t read_signed(unsigned n) {  // two's complement
    if (n == 0) return 0;
    uint64_t v = read_bits(n);
    if (n < 64 && (v & (1ull << (n - 1)))) v |= ~((1ull << n) - 1);
    return (int64_t)v;
  }

  // unary: count 0 bits until the terminating 1
  uint32_t read_unary() {
    uint32_t q = 0;
    while (!fail) {
      if (bits_left() == 0) {
        fail = true;
        return 0;
      }
      if (read_bits(1)) return q;
      ++q;
      if (q > 1u << 24) {  // corrupt-stream guard
        fail = true;
        return 0;
      }
    }
    return 0;
  }

  void align_byte() { bitpos = (bitpos + 7) & ~(size_t)7; }

  // UTF-8-style coded number (frame/sample number) — value unused, consume
  void skip_utf8() {
    uint64_t first = read_bits(8);
    if (fail) return;
    int extra = 0;
    for (uint8_t m = 0x80; first & m; m >>= 1) ++extra;
    if (extra == 1 || extra > 7) {
      fail = true;  // 10xxxxxx is a continuation byte — invalid lead
      return;
    }
    if (extra > 0) extra -= 1;
    for (int i = 0; i < extra; ++i) read_bits(8);
  }
};

struct StreamInfo {
  uint32_t sample_rate = 0;
  uint32_t channels = 0;
  uint32_t bps = 0;
  uint64_t total_samples = 0;  // 0 = unknown
  bool ok = false;
};

StreamInfo parse_streaminfo(BitReader& br) {
  StreamInfo si;
  br.read_bits(16);  // min block size
  br.read_bits(16);  // max block size
  br.read_bits(24);  // min frame size
  br.read_bits(24);  // max frame size
  si.sample_rate = (uint32_t)br.read_bits(20);
  si.channels = (uint32_t)br.read_bits(3) + 1;
  si.bps = (uint32_t)br.read_bits(5) + 1;
  si.total_samples = br.read_bits(36);
  for (int i = 0; i < 16; ++i) br.read_bits(8);  // MD5
  si.ok = !br.fail && si.sample_rate > 0;
  return si;
}

// -> bits consumed to reach the first frame; fills `si`. 0 on failure.
size_t parse_header(const uint8_t* buf, size_t len, StreamInfo& si) {
  if (len < 8 || memcmp(buf, "fLaC", 4) != 0) return 0;
  BitReader br(buf, len);
  br.read_bits(32);  // magic
  bool last = false;
  bool have_si = false;
  while (!last && !br.fail) {
    last = br.read_bits(1) != 0;
    uint32_t type = (uint32_t)br.read_bits(7);
    uint32_t blen = (uint32_t)br.read_bits(24);
    if (type == 0) {
      si = parse_streaminfo(br);
      have_si = true;
      if (blen > 34)
        for (uint32_t i = 34; i < blen; ++i) br.read_bits(8);
    } else if (type == 127) {
      return 0;  // invalid
    } else {
      if (blen * 8ull > br.bits_left()) return 0;
      br.bitpos += (size_t)blen * 8;
    }
  }
  if (br.fail || !have_si || !si.ok) return 0;
  return br.bitpos;
}

// Rice/Rice2 residual into res[pred_order .. block_size)
bool decode_residual(BitReader& br, unsigned block_size, unsigned pred_order,
                     std::vector<int64_t>& res) {
  unsigned method = (unsigned)br.read_bits(2);
  if (method > 1) return false;
  unsigned pbits = method == 0 ? 4 : 5;
  unsigned escape = method == 0 ? 0xF : 0x1F;
  unsigned porder = (unsigned)br.read_bits(4);
  unsigned partitions = 1u << porder;
  if (block_size % partitions != 0) return false;
  unsigned psize = block_size >> porder;
  if (psize <= pred_order && partitions == 1) return false;
  unsigned idx = pred_order;
  for (unsigned p = 0; p < partitions; ++p) {
    unsigned count = psize - (p == 0 ? pred_order : 0);
    if (p == 0 && psize < pred_order) return false;
    unsigned param = (unsigned)br.read_bits(pbits);
    if (param == escape) {
      unsigned raw = (unsigned)br.read_bits(5);
      for (unsigned i = 0; i < count; ++i) res[idx++] = br.read_signed(raw);
    } else {
      for (unsigned i = 0; i < count; ++i) {
        uint32_t q = br.read_unary();
        uint64_t r = br.read_bits(param);
        uint64_t v = ((uint64_t)q << param) | r;
        res[idx++] = (int64_t)(v >> 1) ^ -(int64_t)(v & 1);  // zigzag
      }
    }
    if (br.fail) return false;
  }
  return idx == block_size;
}

bool decode_subframe(BitReader& br, unsigned block_size, unsigned bps,
                     std::vector<int64_t>& out) {
  if (br.read_bits(1) != 0) return false;  // mandatory zero pad
  unsigned type = (unsigned)br.read_bits(6);
  unsigned wasted = 0;
  if (br.read_bits(1)) wasted = br.read_unary() + 1;
  if (br.fail || wasted >= bps) return false;
  unsigned ebps = bps - wasted;  // effective sample size

  out.assign(block_size, 0);
  if (type == 0) {  // CONSTANT
    int64_t v = br.read_signed(ebps);
    for (unsigned i = 0; i < block_size; ++i) out[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (unsigned i = 0; i < block_size; ++i) out[i] = br.read_signed(ebps);
  } else if ((type & 0x38) == 0x08 && (type & 0x07) <= 4) {  // FIXED
    unsigned order = type & 0x07;
    if (order > block_size) return false;
    for (unsigned i = 0; i < order; ++i) out[i] = br.read_signed(ebps);
    if (!decode_residual(br, block_size, order, out)) return false;
    switch (order) {
      case 0:
        break;
      case 1:
        for (unsigned i = 1; i < block_size; ++i) out[i] += out[i - 1];
        break;
      case 2:
        for (unsigned i = 2; i < block_size; ++i)
          out[i] += 2 * out[i - 1] - out[i - 2];
        break;
      case 3:
        for (unsigned i = 3; i < block_size; ++i)
          out[i] += 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3];
        break;
      case 4:
        for (unsigned i = 4; i < block_size; ++i)
          out[i] += 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3] -
                    out[i - 4];
        break;
    }
  } else if (type & 0x20) {  // LPC
    unsigned order = (type & 0x1F) + 1;
    if (order > block_size) return false;
    for (unsigned i = 0; i < order; ++i) out[i] = br.read_signed(ebps);
    unsigned prec = (unsigned)br.read_bits(4);
    if (prec == 0xF) return false;
    prec += 1;
    int64_t shift = br.read_signed(5);
    if (shift < 0) return false;  // spec: negative shifts disallowed
    std::vector<int64_t> coef(order);
    for (unsigned i = 0; i < order; ++i) coef[i] = br.read_signed(prec);
    if (!decode_residual(br, block_size, order, out)) return false;
    for (unsigned i = order; i < block_size; ++i) {
      __int128 acc = 0;  // order 32 x 33-bit samples x 15-bit coefs
      for (unsigned j = 0; j < order; ++j)
        acc += (__int128)coef[j] * out[i - 1 - j];
      out[i] += (int64_t)(acc >> shift);
    }
  } else {
    return false;  // reserved type
  }
  if (br.fail) return false;
  if (wasted)
    for (unsigned i = 0; i < block_size; ++i) out[i] <<= wasted;
  return true;
}

struct FlacPcm {
  std::vector<float> mono;
  int sample_rate = 0;
  bool ok = false;
};

// `max_needed`: output cap for streams that do NOT declare their length —
// decoding stops once that many samples exist, and the caller (which sized
// its buffer to max_needed) sees a full buffer and retries larger
// (native/__init__.py::flac_read). Declared streams decode to their total,
// which also bounds memory. Keeps a corrupt/hostile undeclared stream from
// growing `mono` without limit.
FlacPcm decode_flac(const uint8_t* buf, size_t len, uint64_t max_needed) {
  FlacPcm out;
  StreamInfo si;
  size_t bitpos = parse_header(buf, len, si);
  if (bitpos == 0) return out;
  BitReader br(buf, len);
  br.bitpos = bitpos;
  out.sample_rate = (int)si.sample_rate;
  // reserve is only a hint: cap it so a corrupt STREAMINFO total (36-bit
  // field, up to 64G samples) cannot force a giant allocation up front
  if (si.total_samples)
    out.mono.reserve((size_t)(si.total_samples < (1ull << 24)
                                  ? si.total_samples
                                  : (1ull << 24)));

  std::vector<std::vector<int64_t>> ch;
  while (br.bits_left() >= 16) {
    // frame header
    if (br.read_bits(14) != 0x3FFE) break;  // sync (EOF padding tolerated)
    if (br.read_bits(1) != 0) return out;   // reserved
    br.read_bits(1);                        // blocking strategy
    unsigned bs_code = (unsigned)br.read_bits(4);
    unsigned sr_code = (unsigned)br.read_bits(4);
    unsigned ch_code = (unsigned)br.read_bits(4);
    unsigned ss_code = (unsigned)br.read_bits(3);
    if (br.read_bits(1) != 0) return out;  // reserved
    br.skip_utf8();

    unsigned block_size = 0;
    switch (bs_code) {
      case 0: return out;  // reserved
      case 1: block_size = 192; break;
      case 6: block_size = (unsigned)br.read_bits(8) + 1; break;
      case 7: block_size = (unsigned)br.read_bits(16) + 1; break;
      default:
        block_size = bs_code <= 5 ? 576u << (bs_code - 2)
                                  : 256u << (bs_code - 8);
    }
    if (sr_code == 12) br.read_bits(8);
    else if (sr_code == 13 || sr_code == 14) br.read_bits(16);
    else if (sr_code == 15) return out;
    br.read_bits(8);  // header CRC-8 (consumed, not verified)

    unsigned bps = si.bps;
    switch (ss_code) {
      case 0: break;
      case 1: bps = 8; break;
      case 2: bps = 12; break;
      case 4: bps = 16; break;
      case 5: bps = 20; break;
      case 6: bps = 24; break;
      case 7: bps = 32; break;
      default: return out;
    }

    unsigned nch;
    if (ch_code < 8) nch = ch_code + 1;
    else if (ch_code <= 10) nch = 2;
    else return out;
    ch.resize(nch);

    for (unsigned c = 0; c < nch; ++c) {
      unsigned cbps = bps;
      // the side channel carries one extra bit
      if ((ch_code == 8 && c == 1) || (ch_code == 9 && c == 0) ||
          (ch_code == 10 && c == 1))
        cbps += 1;
      if (!decode_subframe(br, block_size, cbps, ch[c])) return out;
    }
    br.align_byte();
    br.read_bits(16);  // frame CRC-16 (consumed, not verified)
    if (br.fail) return out;

    // stereo decorrelation
    if (ch_code == 8) {  // left/side
      for (unsigned i = 0; i < block_size; ++i) ch[1][i] = ch[0][i] - ch[1][i];
    } else if (ch_code == 9) {  // right/side: ch0 = side, ch1 = right
      for (unsigned i = 0; i < block_size; ++i) ch[0][i] = ch[1][i] + ch[0][i];
    } else if (ch_code == 10) {  // mid/side
      for (unsigned i = 0; i < block_size; ++i) {
        int64_t side = ch[1][i];
        int64_t mid = (ch[0][i] << 1) | (side & 1);
        ch[0][i] = (mid + side) >> 1;
        ch[1][i] = (mid - side) >> 1;
      }
    }

    const double scale = 1.0 / (double)(1ull << (bps - 1));
    for (unsigned i = 0; i < block_size; ++i) {
      double acc = 0.0;
      for (unsigned c = 0; c < nch; ++c) acc += (double)ch[c][i];
      out.mono.push_back((float)(acc / nch * scale));
    }
    if (si.total_samples) {
      if (out.mono.size() >= si.total_samples) break;
    } else if (out.mono.size() >= max_needed) {
      break;  // caller's buffer is full — it grows it and decodes again
    }
  }
  if (si.total_samples) {
    if (out.mono.size() < si.total_samples) return out;  // truncated stream
    out.mono.resize((size_t)si.total_samples);
  }
  out.ok = !out.mono.empty();
  return out;
}

}  // namespace

extern "C" {

// -> total samples per channel (>=0), or -1 on error, -2 when the stream
// does not declare its length; *sample_rate and *channels are filled on
// success. Header-only (STREAMINFO), no frame decode.
long long vb_flac_info(const char* path, int* sample_rate, int* channels) {
  try {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    uint8_t head[128];
    size_t n = fread(head, 1, sizeof(head), f);
    fclose(f);
    StreamInfo si;
    if (parse_header(head, n, si) == 0) {
      // metadata may exceed the probe window: only STREAMINFO (always the
      // first block, 4 + 4 + 34 bytes) is required
      if (n >= 42 && memcmp(head, "fLaC", 4) == 0 && (head[4] & 0x7F) == 0) {
        BitReader br(head, n);
        br.bitpos = 8 * 8;  // magic + block header
        si = parse_streaminfo(br);
      }
      if (!si.ok) return -1;
    }
    if (sample_rate) *sample_rate = (int)si.sample_rate;
    if (channels) *channels = (int)si.channels;
    if (si.total_samples == 0) return -2;
    return (long long)si.total_samples;
  } catch (...) {
    return -1;  // no exception may cross the C ABI
  }
}

// Decode to float32 mono; writes up to max_samples into out.
// -> samples written, or -1 on error. *sample_rate filled on success.
long long vb_flac_read(const char* path, float* out, long long max_samples,
                       int* sample_rate) {
  try {
    if (max_samples <= 0) return -1;
    ByteBuf file = read_file(path);
    if (!file.ok) return -1;
    FlacPcm pcm =
        decode_flac(file.data.data(), file.data.size(), (uint64_t)max_samples);
    if (!pcm.ok) return -1;
    long long n = (long long)pcm.mono.size();
    if (n > max_samples) n = max_samples;
    memcpy(out, pcm.mono.data(), (size_t)n * sizeof(float));
    if (sample_rate) *sample_rate = pcm.sample_rate;
    return n;
  } catch (...) {
    return -1;  // e.g. bad_alloc from a corrupt/hostile stream
  }
}

}  // extern "C"

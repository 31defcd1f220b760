// FLAC decoder (C++17, no dependencies) for the audio payloads of
// WebDataset tar shards (AudioSet, LibriSpeech).
//
// Implements the full mandatory bitstream: STREAMINFO parsing, frame headers
// with UTF-8 frame numbers, CONSTANT / VERBATIM / FIXED(0-4) / LPC(1-32)
// subframes, Rice/Rice2 partitioned residuals with escape codes, wasted bits,
// and left-side / right-side / mid-side inter-channel decorrelation. CRCs are
// skipped: a corrupt frame surfaces as a decode error and the shard pipeline
// drops the sample.
//
// C ABI (bound with ctypes in flac_native.py; the same as the JAX package's
// build of this decoder, so the two libraries can be compared bit for bit):
//   wavjepa_flac_decode(data, size, &samples, &channels, &frames, &rate)
//     -> 0 on success; samples is planar (channels x frames) float32 in
//        [-1, 1], malloc'd; free with wavjepa_flac_free.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t byte_pos = 0;
  int bit_pos = 0;  // 0..7, MSB first
  bool ok = true;

  explicit BitReader(const uint8_t* d, size_t n) : data(d), size(n) {}

  bool exhausted() const { return byte_pos >= size; }

  uint32_t read_bit() {
    if (byte_pos >= size) {
      ok = false;
      return 0;
    }
    uint32_t bit = (data[byte_pos] >> (7 - bit_pos)) & 1u;
    if (++bit_pos == 8) {
      bit_pos = 0;
      ++byte_pos;
    }
    return bit;
  }

  uint64_t read_bits64(int n) {
    uint64_t value = 0;
    while (n > 0 && ok) {
      if (bit_pos == 0 && n >= 8 && byte_pos < size) {
        value = (value << 8) | data[byte_pos++];
        n -= 8;
      } else {
        value = (value << 1) | read_bit();
        --n;
      }
    }
    return value;
  }

  uint32_t read_bits(int n) { return static_cast<uint32_t>(read_bits64(n)); }

  int64_t read_signed(int n) {
    if (n == 0) return 0;
    uint64_t raw = read_bits64(n);
    uint64_t sign = 1ull << (n - 1);
    return (raw & sign) ? static_cast<int64_t>(raw) - (1ll << n)
                        : static_cast<int64_t>(raw);
  }

  uint32_t read_unary() {
    uint32_t count = 0;
    while (ok) {
      // fast path: scan whole zero bytes
      if (bit_pos == 0) {
        while (byte_pos < size && data[byte_pos] == 0) {
          count += 8;
          ++byte_pos;
        }
      }
      if (read_bit()) return count;
      ++count;
      if (byte_pos >= size) {
        ok = false;
        return count;
      }
    }
    return count;
  }

  void align() {
    if (bit_pos != 0) {
      bit_pos = 0;
      ++byte_pos;
    }
  }
};

uint64_t read_utf8_number(BitReader& br) {
  uint32_t first = br.read_bits(8);
  int extra = 0;
  uint64_t value = 0;
  if ((first & 0x80u) == 0) {
    return first;
  } else if ((first & 0xE0u) == 0xC0u) {
    extra = 1;
    value = first & 0x1Fu;
  } else if ((first & 0xF0u) == 0xE0u) {
    extra = 2;
    value = first & 0x0Fu;
  } else if ((first & 0xF8u) == 0xF0u) {
    extra = 3;
    value = first & 0x07u;
  } else if ((first & 0xFCu) == 0xF8u) {
    extra = 4;
    value = first & 0x03u;
  } else if ((first & 0xFEu) == 0xFCu) {
    extra = 5;
    value = first & 0x01u;
  } else if (first == 0xFEu) {
    extra = 6;
    value = 0;
  } else {
    br.ok = false;
    return 0;
  }
  for (int i = 0; i < extra; ++i) {
    uint32_t b = br.read_bits(8);
    if ((b & 0xC0u) != 0x80u) {
      br.ok = false;
      return 0;
    }
    value = (value << 6) | (b & 0x3Fu);
  }
  return value;
}

struct StreamInfo {
  uint32_t sample_rate = 0;
  int channels = 0;
  int bits_per_sample = 0;
  uint64_t total_samples = 0;
};

bool parse_metadata(BitReader& br, StreamInfo* info) {
  if (br.read_bits(32) != 0x664C6143u) return false;  // "fLaC"
  bool last = false;
  bool have_streaminfo = false;
  while (!last && br.ok) {
    last = br.read_bit() != 0;
    uint32_t type = br.read_bits(7);
    uint32_t length = br.read_bits(24);
    if (type == 0) {  // STREAMINFO
      br.read_bits(16);  // min blocksize
      br.read_bits(16);  // max blocksize
      br.read_bits(24);  // min framesize
      br.read_bits(24);  // max framesize
      info->sample_rate = br.read_bits(20);
      info->channels = static_cast<int>(br.read_bits(3)) + 1;
      info->bits_per_sample = static_cast<int>(br.read_bits(5)) + 1;
      info->total_samples = br.read_bits64(36);
      for (int i = 0; i < 16; ++i) br.read_bits(8);  // md5
      have_streaminfo = true;
    } else {
      for (uint32_t i = 0; i < length && br.ok; ++i) br.read_bits(8);
    }
  }
  return have_streaminfo && br.ok;
}

// Partitioned Rice residual → res[order .. blocksize)
bool read_residual(BitReader& br, int order, int blocksize,
                   std::vector<int64_t>& res) {
  uint32_t method = br.read_bits(2);
  if (method > 1) return false;
  int param_bits = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 0xFu : 0x1Fu;
  uint32_t partition_order = br.read_bits(4);
  uint32_t partitions = 1u << partition_order;
  if ((blocksize >> partition_order) == 0) return false;
  int idx = order;
  for (uint32_t p = 0; p < partitions && br.ok; ++p) {
    int count = blocksize >> partition_order;
    if (p == 0) count -= order;
    if (count < 0) return false;
    uint32_t param = br.read_bits(param_bits);
    if (param == escape) {
      int raw_bits = static_cast<int>(br.read_bits(5));
      for (int i = 0; i < count; ++i) res[idx++] = br.read_signed(raw_bits);
    } else {
      for (int i = 0; i < count; ++i) {
        uint32_t quotient = br.read_unary();
        uint64_t value =
            (static_cast<uint64_t>(quotient) << param) | br.read_bits64(param);
        res[idx++] = static_cast<int64_t>(value >> 1) ^
                     -static_cast<int64_t>(value & 1);  // zigzag
      }
    }
  }
  return br.ok && idx == blocksize;
}

bool decode_subframe(BitReader& br, int bps, int blocksize,
                     std::vector<int64_t>& out) {
  if (br.read_bit() != 0) return false;  // mandatory zero pad bit
  uint32_t type = br.read_bits(6);
  int wasted = 0;
  if (br.read_bit()) wasted = static_cast<int>(br.read_unary()) + 1;
  bps -= wasted;
  if (bps <= 0 || bps > 33) return false;

  out.assign(blocksize, 0);
  if (type == 0) {  // CONSTANT
    int64_t v = br.read_signed(bps);
    for (int i = 0; i < blocksize; ++i) out[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (int i = 0; i < blocksize; ++i) out[i] = br.read_signed(bps);
  } else if (type >= 8 && type <= 12) {  // FIXED, order = type - 8
    int order = static_cast<int>(type) - 8;
    if (order > blocksize) return false;
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
    if (!read_residual(br, order, blocksize, out)) return false;
    switch (order) {
      case 0:
        break;
      case 1:
        for (int i = 1; i < blocksize; ++i) out[i] += out[i - 1];
        break;
      case 2:
        for (int i = 2; i < blocksize; ++i)
          out[i] += 2 * out[i - 1] - out[i - 2];
        break;
      case 3:
        for (int i = 3; i < blocksize; ++i)
          out[i] += 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3];
        break;
      case 4:
        for (int i = 4; i < blocksize; ++i)
          out[i] += 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3] -
                    out[i - 4];
        break;
      default:
        return false;
    }
  } else if (type >= 32) {  // LPC, order = (type & 31) + 1
    int order = static_cast<int>(type & 31u) + 1;
    if (order > blocksize) return false;
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
    int precision = static_cast<int>(br.read_bits(4)) + 1;
    if (precision == 16) return false;  // 0b1111 is invalid
    int shift = static_cast<int>(br.read_signed(5));
    if (shift < 0) return false;
    int64_t coef[32];
    for (int i = 0; i < order; ++i) coef[i] = br.read_signed(precision);
    if (!read_residual(br, order, blocksize, out)) return false;
    for (int i = order; i < blocksize; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += coef[j] * out[i - 1 - j];
      out[i] += pred >> shift;
    }
  } else {
    return false;  // reserved
  }
  if (wasted > 0)
    for (int i = 0; i < blocksize; ++i) out[i] <<= wasted;
  return br.ok;
}

}  // namespace

extern "C" {

// Returns 0 on success:
//  -1 bad magic / no STREAMINFO   -2 unsupported stream parameters
//  -3 corrupt frame               -4 allocation failure
int wavjepa_flac_decode(const uint8_t* data, size_t size, float** out_samples,
                        int32_t* out_channels, int64_t* out_frames,
                        int32_t* out_sample_rate) {
  BitReader br(data, size);
  StreamInfo info;
  if (!parse_metadata(br, &info)) return -1;
  if (info.channels < 1 || info.channels > 8) return -2;
  const int nch = info.channels;

  std::vector<std::vector<int64_t>> chan(nch);
  std::vector<std::vector<float>> pcm(nch);
  if (info.total_samples > 0)
    for (int c = 0; c < nch; ++c) pcm[c].reserve(info.total_samples);

  while (br.ok && !br.exhausted()) {
    // frame sync: 11111111 111110xx
    br.align();
    size_t frame_start = br.byte_pos;
    if (frame_start + 2 > br.size) break;
    uint32_t sync = br.read_bits(14);
    if (!br.ok) break;
    if (sync != 0x3FFEu) {
      // trailing garbage / padding after last frame: stop cleanly
      break;
    }
    br.read_bit();            // reserved
    br.read_bit();            // blocking strategy
    uint32_t bs_code = br.read_bits(4);
    uint32_t sr_code = br.read_bits(4);
    uint32_t ch_code = br.read_bits(4);
    uint32_t ss_code = br.read_bits(3);
    br.read_bit();            // reserved
    read_utf8_number(br);     // frame/sample number (unused)

    int blocksize;
    switch (bs_code) {
      case 0: return -3;
      case 1: blocksize = 192; break;
      case 2: case 3: case 4: case 5:
        blocksize = 576 << (bs_code - 2);
        break;
      case 6: blocksize = static_cast<int>(br.read_bits(8)) + 1; break;
      case 7: blocksize = static_cast<int>(br.read_bits(16)) + 1; break;
      default: blocksize = 256 << (bs_code - 8); break;
    }
    switch (sr_code) {
      case 12: br.read_bits(8); break;
      case 13: case 14: br.read_bits(16); break;
      case 15: return -3;
      default: break;  // table / streaminfo rates: header value unused
    }
    int bps;
    switch (ss_code) {
      case 0: bps = info.bits_per_sample; break;
      case 1: bps = 8; break;
      case 2: bps = 12; break;
      case 4: bps = 16; break;
      case 5: bps = 20; break;
      case 6: bps = 24; break;
      case 7: bps = 32; break;
      default: return -3;
    }
    br.read_bits(8);  // header crc8 (unchecked)

    int frame_channels;
    int mode = 0;  // 0 independent, 1 left/side, 2 right/side, 3 mid/side
    if (ch_code < 8) {
      frame_channels = static_cast<int>(ch_code) + 1;
    } else if (ch_code == 8) {
      frame_channels = 2; mode = 1;
    } else if (ch_code == 9) {
      frame_channels = 2; mode = 2;
    } else if (ch_code == 10) {
      frame_channels = 2; mode = 3;
    } else {
      return -3;
    }
    if (frame_channels != nch) return -3;

    for (int c = 0; c < nch; ++c) {
      int ch_bps = bps;
      if ((mode == 1 && c == 1) || (mode == 2 && c == 0) ||
          (mode == 3 && c == 1))
        ch_bps += 1;  // side channel carries one extra bit
      if (!decode_subframe(br, ch_bps, blocksize, chan[c])) return -3;
    }
    br.align();
    br.read_bits(16);  // frame crc16 (unchecked)
    if (!br.ok) return -3;

    // inter-channel reconstruction
    if (mode == 1) {  // left/side: right = left - side
      for (int i = 0; i < blocksize; ++i) chan[1][i] = chan[0][i] - chan[1][i];
    } else if (mode == 2) {  // right/side: left = right + side
      for (int i = 0; i < blocksize; ++i) chan[0][i] = chan[1][i] + chan[0][i];
    } else if (mode == 3) {  // mid/side
      for (int i = 0; i < blocksize; ++i) {
        int64_t side = chan[1][i];
        int64_t mid = (chan[0][i] << 1) | (side & 1);
        chan[0][i] = (mid + side) >> 1;
        chan[1][i] = (mid - side) >> 1;
      }
    }

    const float scale = 1.0f / static_cast<float>(1ll << (bps - 1));
    for (int c = 0; c < nch; ++c) {
      pcm[c].reserve(pcm[c].size() + blocksize);
      for (int i = 0; i < blocksize; ++i)
        pcm[c].push_back(static_cast<float>(chan[c][i]) * scale);
    }
  }

  const int64_t frames = static_cast<int64_t>(pcm[0].size());
  if (frames == 0) return -3;
  float* out = static_cast<float*>(
      std::malloc(sizeof(float) * static_cast<size_t>(frames) * nch));
  if (out == nullptr) return -4;
  for (int c = 0; c < nch; ++c)
    std::memcpy(out + c * frames, pcm[c].data(), sizeof(float) * frames);

  *out_samples = out;
  *out_channels = nch;
  *out_frames = frames;
  *out_sample_rate = static_cast<int32_t>(info.sample_rate);
  return 0;
}

void wavjepa_flac_free(float* ptr) { std::free(ptr); }

}  // extern "C"

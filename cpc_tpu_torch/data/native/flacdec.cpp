// Native FLAC decoder for the host data plane of the PyTorch port.
//
// A copy of the JAX package's decoder (cpc_tpu/data/native/flacdec.cpp),
// with the same code, bound through ctypes by cpc_tpu_torch/data/flac.py.
// LibriSpeech, the CPC paper's speech corpus, ships as FLAC, and no FLAC
// library is assumed on the host. Covers the subset FLAC encoders emit for
// 8/16/24-bit PCM: CONSTANT / VERBATIM / FIXED(0-4) / LPC(1-32) subframes,
// RICE and RICE2 residual partitions with escape codes, wasted bits, and
// all four channel assignments (independent, left/side, right/side,
// mid/side).
//
// Exported C ABI:
//   int flac_decode_file(const char* path, int32_t** out, int64_t* n_frames,
//                        int32_t* channels, int32_t* sample_rate,
//                        int32_t* bits_per_sample);
//     returns 0 on success; *out is interleaved int32 (caller frees with
//     flac_free). Negative error codes identify the failure site.
//   void flac_free(int32_t* p);

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t byte = 0;
  int bit = 0;  // bits consumed in current byte (0..7), MSB first
  bool ok = true;

  bool aligned() const { return bit == 0; }

  void align() {
    if (bit) { bit = 0; ++byte; }
  }

  uint32_t read_bit() {
    if (byte >= size) { ok = false; return 0; }
    uint32_t v = (data[byte] >> (7 - bit)) & 1u;
    if (++bit == 8) { bit = 0; ++byte; }
    return v;
  }

  uint64_t read_bits(int n) {  // n <= 57
    uint64_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | read_bit();
    return v;
  }

  int64_t read_signed(int n) {
    if (n == 0) return 0;
    uint64_t v = read_bits(n);
    uint64_t sign = 1ull << (n - 1);
    return (v & sign) ? (int64_t)(v | ~((sign << 1) - 1)) : (int64_t)v;
  }

  uint32_t read_unary() {
    uint32_t q = 0;
    while (ok && read_bit() == 0) {
      ++q;
      if (q > (1u << 24)) { ok = false; break; }  // corrupt stream guard
    }
    return q;
  }
};

// UTF-8-style coded number in frame headers (up to 36 bits for sample pos).
bool read_utf8_u64(BitReader& br, uint64_t* out) {
  uint32_t b0 = (uint32_t)br.read_bits(8);
  if (!br.ok) return false;
  int n;
  uint64_t v;
  if ((b0 & 0x80) == 0) { *out = b0; return true; }
  else if ((b0 & 0xE0) == 0xC0) { n = 1; v = b0 & 0x1F; }
  else if ((b0 & 0xF0) == 0xE0) { n = 2; v = b0 & 0x0F; }
  else if ((b0 & 0xF8) == 0xF0) { n = 3; v = b0 & 0x07; }
  else if ((b0 & 0xFC) == 0xF8) { n = 4; v = b0 & 0x03; }
  else if ((b0 & 0xFE) == 0xFC) { n = 5; v = b0 & 0x01; }
  else if (b0 == 0xFE) { n = 6; v = 0; }
  else return false;
  for (int i = 0; i < n; ++i) {
    uint32_t b = (uint32_t)br.read_bits(8);
    if (!br.ok || (b & 0xC0) != 0x80) return false;
    v = (v << 6) | (b & 0x3F);
  }
  *out = v;
  return true;
}

bool decode_residual(BitReader& br, int blocksize, int order,
                     std::vector<int64_t>& res) {
  uint32_t method = (uint32_t)br.read_bits(2);
  if (method > 1) return false;
  int plen = method == 0 ? 4 : 5;
  uint32_t esc = method == 0 ? 0xF : 0x1F;
  uint32_t porder = (uint32_t)br.read_bits(4);
  uint32_t nparts = 1u << porder;
  if (blocksize % nparts) return false;
  int idx = order;
  for (uint32_t p = 0; p < nparts; ++p) {
    int count = blocksize >> porder;
    if (p == 0) count -= order;
    if (count < 0) return false;
    uint32_t param = (uint32_t)br.read_bits(plen);
    if (param == esc) {
      uint32_t bits = (uint32_t)br.read_bits(5);
      for (int i = 0; i < count; ++i) res[idx++] = br.read_signed(bits);
    } else {
      for (int i = 0; i < count; ++i) {
        uint32_t q = br.read_unary();
        uint64_t r = br.read_bits(param);
        uint64_t zz = ((uint64_t)q << param) | r;
        res[idx++] = (zz & 1) ? -((int64_t)(zz >> 1)) - 1 : (int64_t)(zz >> 1);
      }
    }
    if (!br.ok) return false;
  }
  return true;
}

bool decode_subframe(BitReader& br, int blocksize, int bps,
                     std::vector<int64_t>& out) {
  if (br.read_bit() != 0) return false;  // reserved
  uint32_t type = (uint32_t)br.read_bits(6);
  int wasted = 0;
  if (br.read_bit()) wasted = 1 + (int)br.read_unary();
  bps -= wasted;
  if (bps <= 0 || bps > 33) return false;

  out.assign(blocksize, 0);
  if (type == 0) {  // CONSTANT
    int64_t v = br.read_signed(bps);
    for (int i = 0; i < blocksize; ++i) out[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (int i = 0; i < blocksize; ++i) out[i] = br.read_signed(bps);
  } else if (type >= 8 && type <= 12) {  // FIXED, order 0-4
    int order = type - 8;
    if (order > blocksize) return false;
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
    if (!decode_residual(br, blocksize, order, out)) return false;
    switch (order) {
      case 0: break;
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
          out[i] += 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3]
                    - out[i - 4];
        break;
    }
  } else if (type >= 32) {  // LPC, order = type - 31
    int order = (int)type - 31;
    if (order > blocksize) return false;
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
    uint32_t prec = (uint32_t)br.read_bits(4);
    if (prec == 0xF) return false;
    int precision = (int)prec + 1;
    int shift = (int)br.read_signed(5);
    if (shift < 0) return false;
    std::vector<int64_t> coef(order);
    for (int i = 0; i < order; ++i) coef[i] = br.read_signed(precision);
    if (!decode_residual(br, blocksize, order, out)) return false;
    for (int i = order; i < blocksize; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += coef[j] * out[i - 1 - j];
      out[i] += pred >> shift;
    }
  } else {
    return false;
  }
  if (wasted)
    for (int i = 0; i < blocksize; ++i) out[i] <<= wasted;
  return br.ok;
}

const int kBlockSizes[16] = {0, 192, 576, 1152, 2304, 4608, -1, -2,
                             256, 512, 1024, 2048, 4096, 8192, 16384, 32768};
const int kSampleRates[16] = {0, 88200, 176400, 192000, 8000, 16000, 22050,
                              24000, 32000, 44100, 48000, 96000,
                              -1, -2, -3, 0};

}  // namespace

extern "C" {

static int decode_file_impl(const char* path, int32_t** out_samples,
                            int64_t* out_frames, int32_t* out_channels,
                            int32_t* out_rate, int32_t* out_bps) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  if (fsize < 0) { fclose(f); return -2; }
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf;
  try {
    buf.resize((size_t)fsize);
  } catch (...) {
    fclose(f);  // don't leak the fd through the catch(...) -16 path
    return -2;
  }
  if (fread(buf.data(), 1, (size_t)fsize, f) != (size_t)fsize) {
    fclose(f);
    return -2;
  }
  fclose(f);
  if (fsize < 42 || memcmp(buf.data(), "fLaC", 4) != 0) return -3;

  BitReader br{buf.data(), buf.size()};
  br.byte = 4;

  int channels = 0, rate = 0, bps = 0;
  uint64_t total = 0;
  bool last = false, have_info = false;
  while (!last) {
    last = br.read_bit();
    uint32_t type = (uint32_t)br.read_bits(7);
    uint32_t len = (uint32_t)br.read_bits(24);
    if (!br.ok) return -4;
    if (type == 0) {  // STREAMINFO
      br.read_bits(16); br.read_bits(16);  // min/max blocksize
      br.read_bits(24); br.read_bits(24);  // min/max framesize
      rate = (int)br.read_bits(20);
      channels = (int)br.read_bits(3) + 1;
      bps = (int)br.read_bits(5) + 1;
      total = br.read_bits(36);
      br.byte += 16;  // MD5
      have_info = true;
    } else {
      br.byte += len;
    }
    br.bit = 0;
    if (br.byte > br.size) return -5;
  }
  if (!have_info || channels < 1 || channels > 8) return -6;

  std::vector<int32_t> pcm;
  // reserve is only a hint: a corrupt STREAMINFO can claim up to 2^36
  // samples, and an unchecked reserve would throw bad_alloc. FLAC frames
  // cannot expand much beyond ~4 bytes/sample, so cap the hint by the
  // compressed size; growth past it is a plain amortized push_back.
  if (total) {
    size_t hint = (size_t)total * (size_t)channels;
    size_t cap = buf.size() * 2 + 65536;
    pcm.reserve(hint < cap ? hint : cap);
  }
  std::vector<std::vector<int64_t>> ch(channels);

  while (br.byte < br.size) {
    // frame header
    uint32_t sync = (uint32_t)br.read_bits(14);
    if (!br.ok) break;  // clean EOF
    if (sync != 0x3FFE) return -7;
    br.read_bit();  // reserved
    br.read_bit();  // blocking strategy
    uint32_t bs_code = (uint32_t)br.read_bits(4);
    uint32_t sr_code = (uint32_t)br.read_bits(4);
    uint32_t ch_asgn = (uint32_t)br.read_bits(4);
    uint32_t ss_code = (uint32_t)br.read_bits(3);
    br.read_bit();  // reserved
    uint64_t pos;
    if (!read_utf8_u64(br, &pos)) return -8;
    int blocksize;
    if (bs_code == 6) blocksize = (int)br.read_bits(8) + 1;
    else if (bs_code == 7) blocksize = (int)br.read_bits(16) + 1;
    else if (bs_code == 0) return -9;
    else blocksize = kBlockSizes[bs_code];
    if (sr_code == 12) br.read_bits(8);
    else if (sr_code == 13 || sr_code == 14) br.read_bits(16);
    int frame_bps = bps;
    switch (ss_code) {
      case 0: break;
      case 1: frame_bps = 8; break;
      case 2: frame_bps = 12; break;
      case 4: frame_bps = 16; break;
      case 5: frame_bps = 20; break;
      case 6: frame_bps = 24; break;
      case 7: frame_bps = 32; break;
      default: return -10;
    }
    br.read_bits(8);  // header CRC-8 (not verified)
    if (!br.ok) return -11;

    int nch = channels;
    if (ch_asgn <= 7) {
      nch = (int)ch_asgn + 1;
      if (nch != channels) return -12;
      for (int c = 0; c < nch; ++c)
        if (!decode_subframe(br, blocksize, frame_bps, ch[c])) return -13;
    } else if (ch_asgn == 8) {  // left/side
      if (channels != 2) return -12;
      if (!decode_subframe(br, blocksize, frame_bps, ch[0])) return -13;
      if (!decode_subframe(br, blocksize, frame_bps + 1, ch[1])) return -13;
      for (int i = 0; i < blocksize; ++i) ch[1][i] = ch[0][i] - ch[1][i];
    } else if (ch_asgn == 9) {  // right/side
      if (channels != 2) return -12;
      if (!decode_subframe(br, blocksize, frame_bps + 1, ch[0])) return -13;
      if (!decode_subframe(br, blocksize, frame_bps, ch[1])) return -13;
      for (int i = 0; i < blocksize; ++i) ch[0][i] = ch[1][i] + ch[0][i];
    } else if (ch_asgn == 10) {  // mid/side
      if (channels != 2) return -12;
      if (!decode_subframe(br, blocksize, frame_bps, ch[0])) return -13;
      if (!decode_subframe(br, blocksize, frame_bps + 1, ch[1])) return -13;
      for (int i = 0; i < blocksize; ++i) {
        int64_t mid = (ch[0][i] << 1) | (ch[1][i] & 1);
        int64_t side = ch[1][i];
        ch[0][i] = (mid + side) >> 1;
        ch[1][i] = (mid - side) >> 1;
      }
    } else {
      return -12;
    }

    br.align();
    br.read_bits(16);  // frame CRC-16 (not verified)
    if (!br.ok) return -14;

    for (int i = 0; i < blocksize; ++i)
      for (int c = 0; c < channels; ++c)
        pcm.push_back((int32_t)ch[c][i]);
    if (total && pcm.size() >= (size_t)total * channels) break;
  }

  if (total && pcm.size() > (size_t)total * channels)
    pcm.resize((size_t)total * channels);
  int64_t frames = (int64_t)(pcm.size() / channels);
  int32_t* out = (int32_t*)malloc(pcm.size() * sizeof(int32_t));
  if (!out) return -15;
  memcpy(out, pcm.data(), pcm.size() * sizeof(int32_t));
  *out_samples = out;
  *out_frames = frames;
  *out_channels = channels;
  *out_rate = rate;
  *out_bps = bps;
  return 0;
}

int flac_decode_file(const char* path, int32_t** out_samples,
                     int64_t* out_frames, int32_t* out_channels,
                     int32_t* out_rate, int32_t* out_bps) {
  // No C++ exception may escape the C ABI: a bad_alloc from a corrupt
  // header aborts the whole process otherwise (fuzz-found).
  try {
    return decode_file_impl(path, out_samples, out_frames, out_channels,
                            out_rate, out_bps);
  } catch (...) {
    return -16;
  }
}

void flac_free(int32_t* p) { free(p); }

}  // extern "C"

// ORC stream codecs of spark_rapids_tpu_torch (the port's copy of the
// JAX package's native/orc_decode.cpp, the GpuOrcScan.scala host-decode
// role, plus the writer's side). io/native_orc.py parses the protobuf
// metadata (postscript, footer, stripe footers) and io/orc_writer.py
// writes it; the byte loops run here, without the GIL (ctypes releases
// it):
//
//   orc_deframe     ORC's compression framing (3-byte chunk headers,
//                   original or compressed chunks) over ZLIB (raw
//                   deflate), SNAPPY and ZSTD (codecs.h)
//   orc_frame       the inverse, in chunks of the compression block
//   orc_bool_rle    boolean streams (PRESENT, BOOLEAN data): byte RLE of
//                   bytes whose bits are read MSB first
//   orc_byte_rle    byte RLE (BYTE columns)
//   orc_int_rle     integer RLE v1 (DIRECT / DICTIONARY encodings) and
//                   v2 (SHORT_REPEAT / DIRECT / DELTA / PATCHED_BASE of
//                   the *_V2 encodings), zigzag for signed streams
//   orc_decimal     DECIMAL data: unbounded zigzag varints up to 128 bits
//                   into two int64 limbs
//   orc_byte_rle_encode, orc_int_rle_v1_encode, orc_decimal_encode
//                   the writer's streams (RLE v1: runs of a fixed delta,
//                   literal groups otherwise)
//
// Return codes: the values decoded / bytes written, or -1 malformed,
// -2 outside the decoder, -3 a buffer too small, -4 a codec missing.

#include <cstdint>
#include <cstring>

#include "codecs.h"

namespace {

// ORC CompressionKind -> codecs.h id
int32_t codec_of(int32_t kind) {
  switch (kind) {
    case 0: return 0;   // NONE
    case 1: return 4;   // ZLIB: raw deflate
    case 2: return 1;   // SNAPPY
    case 5: return 3;   // ZSTD
    default: return -1;
  }
}

// RLEv2 bit widths: the 5-bit code W is W+1 for 0..23, then 26 ... 64
int rlev2_width(int enc) {
  static const int table[32] = {1,  2,  3,  4,  5,  6,  7,  8,
                                9,  10, 11, 12, 13, 14, 15, 16,
                                17, 18, 19, 20, 21, 22, 23, 24,
                                26, 28, 30, 32, 40, 48, 56, 64};
  if (enc < 0 || enc > 31) return -1;
  return table[enc];
}

struct BitReader {
  const uint8_t* p;
  int64_t n;
  int64_t i = 0;
  unsigned __int128 window = 0;
  int have = 0;

  bool read(int bits, uint64_t* out) {
    while (have < bits) {
      if (i >= n) return false;
      window = (window << 8) | p[i++];
      have += 8;
    }
    *out = bits == 0 ? 0
                     : (uint64_t)(window >> (have - bits)) &
                           (bits == 64 ? ~uint64_t(0)
                                       : ((uint64_t(1) << bits) - 1));
    have -= bits;
    return true;
  }
  void align() {
    have = 0;
    window = 0;
  }
};

int64_t unzigzag(uint64_t u) { return (int64_t)(u >> 1) ^ -(int64_t)(u & 1); }

bool read_varint(const uint8_t* p, int64_t n, int64_t* i, uint64_t* v) {
  uint64_t out = 0;
  int shift = 0;
  while (*i < n) {
    uint8_t b = p[(*i)++];
    out |= uint64_t(b & 0x7f) << shift;
    if (!(b & 0x80)) {
      *v = out;
      return true;
    }
    shift += 7;
    if (shift > 63) return false;
  }
  return false;
}

int64_t rlev1(const uint8_t* src, int64_t n, bool is_signed, int64_t* out,
              int64_t count) {
  int64_t i = 0;
  int64_t o = 0;
  while (i < n && o < count) {
    int8_t h = (int8_t)src[i++];
    if (h >= 0) {   // a run of h + 3 values: a delta byte, then the base
      int64_t run = (int64_t)h + 3;
      if (i >= n) return -1;
      int64_t delta = (int8_t)src[i++];
      uint64_t u;
      if (!read_varint(src, n, &i, &u)) return -1;
      int64_t v = is_signed ? unzigzag(u) : (int64_t)u;
      for (int64_t k = 0; k < run && o < count; k++) out[o++] = v + k * delta;
    } else {        // -h literal varints
      int64_t lit = -(int64_t)h;
      for (int64_t k = 0; k < lit && o < count; k++) {
        uint64_t u;
        if (!read_varint(src, n, &i, &u)) return -1;
        out[o++] = is_signed ? unzigzag(u) : (int64_t)u;
      }
    }
  }
  return o;
}

int64_t rlev2(const uint8_t* src, int64_t n, bool is_signed, int64_t* out,
              int64_t count) {
  int64_t i = 0;
  int64_t o = 0;
  while (i < n && o < count) {
    uint8_t h0 = src[i++];
    int kind = h0 >> 6;
    if (kind == 0) {  // SHORT_REPEAT
      int width = ((h0 >> 3) & 7) + 1;
      int64_t run = (h0 & 7) + 3;
      if (i + width > n) return -1;
      uint64_t v = 0;
      for (int k = 0; k < width; k++) v = (v << 8) | src[i++];
      int64_t sv = is_signed ? unzigzag(v) : (int64_t)v;
      for (int64_t k = 0; k < run && o < count; k++) out[o++] = sv;
    } else if (kind == 1) {  // DIRECT
      if (i >= n) return -1;
      uint8_t h1 = src[i++];
      int width = rlev2_width((h0 >> 1) & 0x1f);
      if (width <= 0) return -1;
      int64_t len = (((int64_t)(h0 & 1)) << 8 | h1) + 1;
      BitReader br{src + i, n - i};
      for (int64_t k = 0; k < len; k++) {
        uint64_t v;
        if (!br.read(width, &v)) return -1;
        if (o < count) out[o++] = is_signed ? unzigzag(v) : (int64_t)v;
      }
      i += br.i;
    } else if (kind == 3) {  // DELTA
      if (i >= n) return -1;
      uint8_t h1 = src[i++];
      int enc_w = (h0 >> 1) & 0x1f;
      int width = enc_w == 0 ? 0 : rlev2_width(enc_w);
      if (width < 0) return -1;
      int64_t len = (((int64_t)(h0 & 1)) << 8 | h1) + 1;
      uint64_t uv;
      if (!read_varint(src, n, &i, &uv)) return -1;
      int64_t base = is_signed ? unzigzag(uv) : (int64_t)uv;
      if (!read_varint(src, n, &i, &uv)) return -1;
      int64_t delta0 = unzigzag(uv);  // the delta base is always signed
      if (o < count) out[o++] = base;
      int64_t prev = base;
      int64_t emitted = 1;
      if (emitted < len) {
        prev += delta0;
        if (o < count) out[o++] = prev;
        emitted++;
      }
      if (width == 0) {
        while (emitted < len) {
          prev += delta0;
          if (o < count) out[o++] = prev;
          emitted++;
        }
      } else {
        BitReader br{src + i, n - i};
        int64_t sign = delta0 < 0 ? -1 : 1;
        while (emitted < len) {
          uint64_t d;
          if (!br.read(width, &d)) return -1;
          prev += sign * (int64_t)d;
          if (o < count) out[o++] = prev;
          emitted++;
        }
        i += br.i;
      }
    } else {  // PATCHED_BASE
      if (i + 3 > n) return -1;
      uint8_t h1 = src[i++];
      uint8_t h2 = src[i++];
      uint8_t h3 = src[i++];
      int width = rlev2_width((h0 >> 1) & 0x1f);
      if (width <= 0) return -1;
      int64_t len = (((int64_t)(h0 & 1)) << 8 | h1) + 1;
      int bw = ((h2 >> 5) & 7) + 1;      // base value bytes
      int pw = rlev2_width(h2 & 0x1f);   // patch width
      int pgw = ((h3 >> 5) & 7) + 1;     // patch gap width
      int64_t pll = h3 & 0x1f;           // patch list length
      if (pw <= 0) return -1;
      if (i + bw > n) return -1;
      // the base: big-endian, the first byte's top bit its sign
      uint64_t braw = 0;
      for (int k = 0; k < bw; k++) braw = (braw << 8) | src[i++];
      uint64_t sign_mask = uint64_t(1) << (bw * 8 - 1);
      int64_t base = (braw & sign_mask) ? -(int64_t)(braw & (sign_mask - 1))
                                        : (int64_t)braw;
      BitReader br{src + i, n - i};
      int64_t start = o;
      for (int64_t k = 0; k < len; k++) {
        uint64_t v;
        if (!br.read(width, &v)) return -1;
        if (o < count) out[o++] = (int64_t)v;
      }
      br.align();
      // patch list: (gap << pw) | patch at the closest fixed width of
      // pgw + pw bits
      int combined = pgw + pw;
      int entry_bits = combined;
      for (int e = 0; e < 32; e++) {
        if (rlev2_width(e) >= combined) {
          entry_bits = rlev2_width(e);
          break;
        }
      }
      int64_t idx = 0;
      for (int64_t k = 0; k < pll; k++) {
        uint64_t entry;
        if (!br.read(entry_bits, &entry)) return -1;
        uint64_t gap = entry >> pw;
        uint64_t patch =
            pw == 64 ? entry : (entry & ((uint64_t(1) << pw) - 1));
        idx += (int64_t)gap;
        if (gap == 255 && patch == 0) continue;  // a gap longer than 255
        int64_t pos = start + idx;
        if (pos < start || pos >= o) return -1;
        out[pos] = (int64_t)((uint64_t)out[pos] | (patch << width));
      }
      for (int64_t k = start; k < o; k++) out[k] += base;
      i += br.i;
    }
  }
  return o;
}

struct Out {
  uint8_t* p;
  int64_t cap;
  int64_t o = 0;
  bool ok = true;
  void byte(uint8_t v) {
    if (o >= cap) {
      ok = false;
      return;
    }
    p[o++] = v;
  }
  void varint(uint64_t v) {
    while (v >= 0x80) {
      byte(uint8_t(v | 0x80));
      v >>= 7;
    }
    byte(uint8_t(v));
  }
};

}  // namespace

extern "C" int64_t orc_deframe(const uint8_t* src, int64_t n, int32_t kind,
                               uint8_t* dst, int64_t dst_cap) {
  const int32_t codec = codec_of(kind);
  if (codec < 0) return -2;
  if (!srt_codecs::available(codec)) return -4;
  if (codec == 0) {
    if (n > dst_cap) return -3;
    std::memcpy(dst, src, n);
    return n;
  }
  int64_t i = 0;
  int64_t o = 0;
  while (i < n) {
    if (i + 3 > n) return -1;
    uint32_t hdr = src[i] | (uint32_t(src[i + 1]) << 8) |
                   (uint32_t(src[i + 2]) << 16);
    i += 3;
    bool original = hdr & 1;
    int64_t clen = hdr >> 1;
    if (clen > n - i) return -1;
    if (original) {
      if (clen > dst_cap - o) return -3;
      std::memcpy(dst + o, src + i, clen);
      o += clen;
    } else {
      int64_t got = 0;
      if (!srt_codecs::decompress_codec(codec, src + i, clen, dst + o,
                                        dst_cap - o, &got))
        return dst_cap - o < 1 ? -3 : -1;
      o += got;
    }
    i += clen;
  }
  return o;
}

// The inverse of orc_deframe: chunks of at most `block` bytes, each
// compressed unless that does not make it smaller.
extern "C" int64_t orc_frame(const uint8_t* src, int64_t n, int32_t kind,
                             int64_t block, uint8_t* dst, int64_t dst_cap) {
  const int32_t codec = codec_of(kind);
  if (codec < 0 || block <= 0 || block >= (1 << 23)) return -2;
  if (!srt_codecs::available(codec)) return -4;
  if (codec == 0) {
    if (n > dst_cap) return -3;
    std::memcpy(dst, src, n);
    return n;
  }
  int64_t i = 0;
  int64_t o = 0;
  while (i < n) {
    int64_t len = n - i < block ? n - i : block;
    if (o + 3 > dst_cap) return -3;
    int64_t room = dst_cap - o - 3;
    int64_t clen = -3;
    if (room >= srt_codecs::compress_bound(len))
      clen = srt_codecs::compress_codec(codec, src + i, len, dst + o + 3,
                                        room);
    if (clen < 0 && clen != -3) return clen;
    uint32_t hdr;
    if (clen >= 0 && clen < len) {
      hdr = (uint32_t)clen << 1;
    } else {
      if (len > room) return -3;
      std::memcpy(dst + o + 3, src + i, len);
      clen = len;
      hdr = ((uint32_t)len << 1) | 1;
    }
    dst[o] = uint8_t(hdr);
    dst[o + 1] = uint8_t(hdr >> 8);
    dst[o + 2] = uint8_t(hdr >> 16);
    o += 3 + clen;
    i += len;
  }
  return o;
}

// Boolean stream: byte RLE over bytes read MSB first; one byte (0 / 1)
// per value out.
extern "C" int64_t orc_bool_rle(const uint8_t* src, int64_t n,
                                uint8_t* out, int64_t count) {
  int64_t i = 0;
  int64_t o = 0;
  while (i < n && o < count) {
    int8_t h = (int8_t)src[i++];
    if (h >= 0) {
      int64_t run = (int64_t)h + 3;
      if (i >= n) return -1;
      uint8_t byte = src[i++];
      for (int64_t k = 0; k < run && o < count; k++)
        for (int b = 7; b >= 0 && o < count; b--) out[o++] = (byte >> b) & 1;
    } else {
      int64_t lit = -(int64_t)h;
      if (lit > n - i) return -1;
      for (int64_t k = 0; k < lit && o < count; k++) {
        uint8_t byte = src[i + k];
        for (int b = 7; b >= 0 && o < count; b--) out[o++] = (byte >> b) & 1;
      }
      i += lit;
    }
  }
  return o;
}

// Byte RLE: runs of 3-130 equal bytes, literal groups of 1-128.
extern "C" int64_t orc_byte_rle(const uint8_t* src, int64_t n, uint8_t* out,
                                int64_t count) {
  int64_t i = 0;
  int64_t o = 0;
  while (i < n && o < count) {
    int8_t h = (int8_t)src[i++];
    if (h >= 0) {
      int64_t run = (int64_t)h + 3;
      if (i >= n) return -1;
      uint8_t byte = src[i++];
      for (int64_t k = 0; k < run && o < count; k++) out[o++] = byte;
    } else {
      int64_t lit = -(int64_t)h;
      if (lit > n - i) return -1;
      for (int64_t k = 0; k < lit && o < count; k++) out[o++] = src[i + k];
      i += lit;
    }
  }
  return o;
}

// Integer RLE, version 1 or 2, into int64 out[count].
extern "C" int64_t orc_int_rle(const uint8_t* src, int64_t n,
                               int32_t version, int32_t is_signed,
                               int64_t* out, int64_t count) {
  if (version == 1) return rlev1(src, n, is_signed != 0, out, count);
  if (version == 2) return rlev2(src, n, is_signed != 0, out, count);
  return -2;
}

// DECIMAL data: zigzag varints of up to 128 bits -> (hi, lo) limbs.
extern "C" int64_t orc_decimal(const uint8_t* src, int64_t n, int64_t* hi,
                               int64_t* lo, int64_t count) {
  int64_t i = 0;
  for (int64_t o = 0; o < count; o++) {
    unsigned __int128 v = 0;
    int shift = 0;
    while (true) {
      if (i >= n) return -1;
      uint8_t b = src[i++];
      if (shift < 128) v |= (unsigned __int128)(b & 0x7f) << shift;
      if (!(b & 0x80)) break;
      shift += 7;
      if (shift > 133) return -2;
    }
    __int128 s = (__int128)(v >> 1) ^ -(__int128)(v & 1);
    hi[o] = (int64_t)(s >> 64);
    lo[o] = (int64_t)(uint64_t)s;
  }
  return count;
}

extern "C" int64_t orc_byte_rle_encode(const uint8_t* src, int64_t n,
                                       uint8_t* dst, int64_t cap) {
  Out w{dst, cap};
  int64_t i = 0;
  while (i < n) {
    int64_t j = i;
    while (j < n && j - i < 130 && src[j] == src[i]) j++;
    if (j - i >= 3) {
      w.byte(uint8_t(j - i - 3));
      w.byte(src[i]);
      i = j;
      continue;
    }
    // literals until a run of 3 starts (at most 128)
    int64_t start = i;
    while (i < n && i - start < 128) {
      if (i + 2 < n && src[i] == src[i + 1] && src[i] == src[i + 2]) break;
      i++;
    }
    w.byte(uint8_t(0) - uint8_t(i - start));
    for (int64_t k = start; k < i; k++) w.byte(src[k]);
  }
  return w.ok ? w.o : -3;
}

// Integer RLE v1: runs of 3-130 values with a fixed delta in [-128, 127]
// as (count - 3, delta, base varint), the rest as literal groups of at
// most 128 varints; zigzag for signed streams.
extern "C" int64_t orc_int_rle_v1_encode(const int64_t* src, int64_t n,
                                         int32_t is_signed, uint8_t* dst,
                                         int64_t cap) {
  Out w{dst, cap};
  auto put = [&](int64_t v) {
    w.varint(is_signed ? (((uint64_t)v << 1) ^ (uint64_t)(v >> 63))
                       : (uint64_t)v);
  };
  auto run_at = [&](int64_t i) -> int64_t {  // the run's length from i
    if (i + 2 >= n) return 1;
    __int128 d = (__int128)src[i + 1] - src[i];
    if (d < -128 || d > 127) return 1;
    int64_t j = i + 1;
    while (j < n && j - i < 130 && (__int128)src[j] - src[j - 1] == d) j++;
    return j - i;
  };
  int64_t i = 0;
  while (i < n) {
    int64_t run = run_at(i);
    if (run >= 3) {
      w.byte(uint8_t(run - 3));
      w.byte(uint8_t((int8_t)(src[i + 1] - src[i])));
      put(src[i]);
      i += run;
      continue;
    }
    int64_t start = i;
    while (i < n && i - start < 128 && (i == start || run_at(i) < 3)) i++;
    w.byte(uint8_t(0) - uint8_t(i - start));
    for (int64_t k = start; k < i; k++) put(src[k]);
  }
  return w.ok ? w.o : -3;
}

// DECIMAL data: each (hi, lo) value as a zigzag varint.
extern "C" int64_t orc_decimal_encode(const int64_t* hi, const int64_t* lo,
                                      int64_t n, uint8_t* dst, int64_t cap) {
  Out w{dst, cap};
  for (int64_t k = 0; k < n; k++) {
    __int128 s = ((__int128)hi[k] << 64) | (unsigned __int128)(uint64_t)lo[k];
    unsigned __int128 u = ((unsigned __int128)s << 1) ^
                          (unsigned __int128)(s >> 127);
    while (u >= 0x80) {
      w.byte(uint8_t(u | 0x80));
      u >>= 7;
    }
    w.byte(uint8_t(u));
  }
  return w.ok ? w.o : -3;
}

// Parquet column-chunk encoder of spark_rapids_tpu_torch (the Parquet
// lane of the writer; the JAX package writes through pyarrow): one
// column chunk's v1 data pages -- the RLE / bit-packed hybrid of the
// definition levels, PLAIN values, each page compressed (codecs.h) and
// preceded by its thrift-compact PageHeader -- into a caller-provided
// buffer, without the GIL (ctypes releases it), so a writer pool
// encodes columns in parallel. The footer is written in Python
// (io/thrift.py).
//
// Value layouts in:
//   kind 0  BOOLEAN: one byte per row (0 / 1), bit-packed on the page
//   kind 1  fixed width: `elem` bytes per row, copied as they are
//           (little-endian numbers, or a decimal's big-endian bytes)
//   kind 2  BYTE_ARRAY: int32 offsets[num_rows + 1] into `values`
// Null rows keep a slot in the input and are left out of the page.

#include <cstdint>
#include <cstring>
#include <vector>

#include "codecs.h"

namespace {

struct Buf {
  std::vector<uint8_t> b;
  void byte(uint8_t v) { b.push_back(v); }
  void varint(uint64_t v) {
    while (v >= 0x80) {
      b.push_back(uint8_t(v | 0x80));
      v >>= 7;
    }
    b.push_back(uint8_t(v));
  }
  void le32(uint32_t v) {
    for (int k = 0; k < 4; k++) b.push_back(uint8_t(v >> (8 * k)));
  }
  void bytes(const uint8_t* p, int64_t n) { b.insert(b.end(), p, p + n); }
};

// thrift compact protocol: the fields a data PageHeader needs
struct TWriter {
  Buf& out;
  int16_t last = 0;
  int16_t saved = 0;
  void field(int16_t id, uint8_t type) {
    int delta = id - last;
    if (delta > 0 && delta <= 15) {
      out.byte(uint8_t((delta << 4) | type));
    } else {
      out.byte(type);
      out.varint((uint16_t)((id << 1) ^ (id >> 15)));
    }
    last = id;
  }
  void i32(int16_t id, int32_t v) {
    field(id, 5);
    out.varint((uint32_t)((uint32_t(v) << 1) ^ uint32_t(v >> 31)));
  }
  void begin(int16_t id) {
    field(id, 12);
    saved = last;
    last = 0;
  }
  void end() {
    out.byte(0);
    last = saved;
  }
};

// RLE / bit-packed hybrid of 0/1 levels (bit width 1): runs of 16 or
// more equal levels as RLE runs, the rest as literal groups of 8.
void encode_levels(const uint8_t* lv, int64_t n, Buf& out) {
  int64_t i = 0;
  while (i < n) {
    int64_t j = i;
    while (j < n && lv[j] == lv[i]) j++;
    if (j - i >= 16) {
      out.varint(uint64_t(j - i) << 1);
      out.byte(lv[i]);
      i = j;
      continue;
    }
    // literal groups until a long run starts at a group boundary
    int64_t start = i;
    int64_t groups = 0;
    while (i < n) {
      int64_t k = i;
      while (k < n && lv[k] == lv[i] && k - i < 16) k++;
      if (k - i >= 16 && groups > 0) break;
      i += 8;
      groups++;
    }
    out.varint((uint64_t(groups) << 1) | 1);
    for (int64_t g = 0; g < groups; g++) {
      uint8_t byte = 0;
      for (int k = 0; k < 8; k++) {
        int64_t at = start + g * 8 + k;
        if (at < n && lv[at]) byte |= uint8_t(1 << k);
      }
      out.byte(byte);
    }
    if (i > n) i = n;
  }
}

// The RLE / bit-packed hybrid of levels at bit width w (nested
// columns): runs of 16 or more equal levels as RLE runs, the rest as
// literal groups of 8 values packed LSB first.
void encode_levels_w(const uint8_t* lv, int64_t n, int w, Buf& out) {
  const int vbytes = (w + 7) / 8;
  int64_t i = 0;
  while (i < n) {
    int64_t j = i;
    while (j < n && lv[j] == lv[i]) j++;
    if (j - i >= 16) {
      out.varint(uint64_t(j - i) << 1);
      for (int k = 0; k < vbytes; k++) out.byte(uint8_t(lv[i] >> (8 * k)));
      i = j;
      continue;
    }
    int64_t start = i;
    int64_t groups = 0;
    while (i < n) {
      int64_t k = i;
      while (k < n && lv[k] == lv[i] && k - i < 16) k++;
      if (k - i >= 16 && groups > 0) break;
      i += 8;
      groups++;
    }
    out.varint((uint64_t(groups) << 1) | 1);
    uint64_t acc = 0;
    int bits = 0;
    for (int64_t at = start; at < start + groups * 8; at++) {
      acc |= uint64_t(at < n ? lv[at] : 0) << bits;
      bits += w;
      while (bits >= 8) {
        out.byte(uint8_t(acc));
        acc >>= 8;
        bits -= 8;
      }
    }
    if (i > n) i = n;
  }
}

int level_width(int max_level) {
  int w = 0;
  while ((1 << w) <= max_level) w++;
  return w;
}

}  // namespace

// bit c is set when codec c (0 none, 1 snappy, 2 gzip, 3 zstd, 4 raw
// deflate) is in this build
extern "C" int32_t srt_codec_mask() {
  int32_t m = 0;
  for (int c = 0; c < 5; c++)
    if (srt_codecs::available(c)) m |= 1 << c;
  return m;
}

extern "C" int64_t srt_compress_bound(int64_t n) {
  return srt_codecs::compress_bound(n);
}

// -> compressed size, or -3 (dst too small), -4 (codec not in the build)
extern "C" int64_t srt_compress(int32_t codec, const uint8_t* src, int64_t n,
                                uint8_t* dst, int64_t dst_cap) {
  return srt_codecs::compress_codec(codec, src, n, dst, dst_cap);
}

// -> 1 and the decompressed size in *out_len, or 0 (corrupt or too big)
extern "C" int32_t srt_decompress(int32_t codec, const uint8_t* src,
                                  int64_t n, uint8_t* dst, int64_t dst_cap,
                                  int64_t* out_len) {
  if (codec == 0) {
    if (n > dst_cap) return 0;
    std::memcpy(dst, src, n);
    *out_len = n;
    return 1;
  }
  return srt_codecs::decompress_codec(codec, src, n, dst, dst_cap, out_len)
             ? 1 : 0;
}

// The rows of the smallest and the largest valid string (unsigned
// bytewise order, parquet's for BYTE_ARRAY); -1 when none is valid.
extern "C" void srt_string_minmax(const int32_t* offsets,
                                  const uint8_t* bytes, const uint8_t* valid,
                                  int64_t n, int64_t* out) {
  int64_t lo = -1, hi = -1;
  auto less = [&](int64_t a, int64_t b) {
    int64_t la = offsets[a + 1] - offsets[a];
    int64_t lb = offsets[b + 1] - offsets[b];
    int c = std::memcmp(bytes + offsets[a], bytes + offsets[b],
                        la < lb ? la : lb);
    return c < 0 || (c == 0 && la < lb);
  };
  for (int64_t k = 0; k < n; k++) {
    if (valid != nullptr && !valid[k]) continue;
    if (lo < 0 || less(k, lo)) lo = k;
    if (hi < 0 || less(hi, k)) hi = k;
  }
  out[0] = lo;
  out[1] = hi;
}

// Encodes one column chunk as v1 DATA_PAGEs of about `page_bytes`
// uncompressed bytes each. A nested leaf passes its definition and
// repetition levels (one byte per level entry; num_rows is then the
// entry count and `valid` marks the entries at max_def_level); its pages
// start at a record (repetition level 0). info[0] gets the chunk's uncompressed size
// (page headers included, as ColumnMetaData counts it), info[1] the
// number of pages. Returns the bytes written to out, or
//   -2 bad arguments  -3 out too small  -4 the codec is not in the build
extern "C" int64_t parquet_encode_chunk(
    int32_t kind, const uint8_t* values, int32_t elem,
    const int32_t* offsets, const uint8_t* valid, int64_t num_rows,
    int32_t max_def_level, int32_t codec, int64_t page_bytes,
    uint8_t* out, int64_t out_cap, int64_t* info,
    const uint8_t* def_levels, const uint8_t* rep_levels,
    int32_t max_rep_level) {
  if (kind < 0 || kind > 2 || (kind == 1 && elem <= 0) || page_bytes <= 0)
    return -2;
  if (!srt_codecs::available(codec)) return -4;
  if (valid != nullptr && max_def_level == 0) return -2;
  if ((max_def_level > 1 || max_rep_level > 0) && def_levels == nullptr)
    return -2;
  if (max_rep_level > 0 && rep_levels == nullptr) return -2;
  int64_t o = 0;
  int64_t uncompressed = 0;
  int64_t pages = 0;
  int64_t r0 = 0;
  Buf raw;
  std::vector<uint8_t> comp;
  do {
    // rows of this page: about page_bytes of values
    // (BOOLEAN counts bits)
    const int64_t target = kind == 0 ? page_bytes * 8 : page_bytes;
    int64_t r1 = r0;
    int64_t vbytes = 0;
    while (r1 < num_rows && (r1 == r0 || vbytes < target)) {
      if (valid == nullptr || valid[r1]) {
        vbytes += kind == 0 ? 1 : kind == 1
            ? elem : 4 + (int64_t)(offsets[r1 + 1] - offsets[r1]);
      }
      r1++;
    }
    // a record does not straddle two pages
    while (rep_levels != nullptr && r1 < num_rows && rep_levels[r1] != 0) {
      if (valid == nullptr || valid[r1]) {
        vbytes += kind == 0 ? 1 : kind == 1
            ? elem : 4 + (int64_t)(offsets[r1 + 1] - offsets[r1]);
      }
      r1++;
    }
    const int64_t nvals = r1 - r0;
    raw.b.clear();
    if (max_rep_level > 0) {
      Buf lv;
      encode_levels_w(rep_levels + r0, nvals, level_width(max_rep_level),
                      lv);
      raw.le32((uint32_t)lv.b.size());
      raw.bytes(lv.b.data(), (int64_t)lv.b.size());
    }
    if (def_levels != nullptr) {
      Buf lv;
      encode_levels_w(def_levels + r0, nvals, level_width(max_def_level),
                      lv);
      raw.le32((uint32_t)lv.b.size());
      raw.bytes(lv.b.data(), (int64_t)lv.b.size());
    } else if (max_def_level > 0) {
      Buf lv;
      if (valid == nullptr) {
        if (nvals > 0) {
          lv.varint(uint64_t(nvals) << 1);
          lv.byte(1);
        }
      } else {
        encode_levels(valid + r0, nvals, lv);
      }
      raw.le32((uint32_t)lv.b.size());
      raw.bytes(lv.b.data(), (int64_t)lv.b.size());
    }
    if (kind == 0) {
      uint8_t byte = 0;
      int bit = 0;
      for (int64_t r = r0; r < r1; r++) {
        if (valid != nullptr && !valid[r]) continue;
        if (values[r]) byte |= uint8_t(1 << bit);
        if (++bit == 8) {
          raw.byte(byte);
          byte = 0;
          bit = 0;
        }
      }
      if (bit) raw.byte(byte);
    } else if (kind == 1) {
      if (valid == nullptr) {
        raw.bytes(values + r0 * elem, nvals * elem);
      } else {
        for (int64_t r = r0; r < r1; r++)
          if (valid[r]) raw.bytes(values + r * elem, elem);
      }
    } else {
      for (int64_t r = r0; r < r1; r++) {
        if (valid != nullptr && !valid[r]) continue;
        int64_t len = offsets[r + 1] - offsets[r];
        raw.le32((uint32_t)len);
        raw.bytes(values + offsets[r], len);
      }
    }
    const int64_t raw_len = (int64_t)raw.b.size();
    comp.resize(srt_codecs::compress_bound(raw_len));
    int64_t clen = srt_codecs::compress_codec(codec, raw.b.data(), raw_len,
                                              comp.data(),
                                              (int64_t)comp.size());
    if (clen < 0) return clen;
    Buf hdr;
    TWriter t{hdr};
    t.i32(1, 0);                         // type: DATA_PAGE
    t.i32(2, (int32_t)raw_len);          // uncompressed_page_size
    t.i32(3, (int32_t)clen);             // compressed_page_size
    t.begin(5);                          // data_page_header
    t.i32(1, (int32_t)nvals);            //   num_values
    t.i32(2, 0);                         //   encoding: PLAIN
    t.i32(3, 3);                         //   definition_level_encoding: RLE
    t.i32(4, 3);                         //   repetition_level_encoding: RLE
    t.end();
    hdr.byte(0);                         // stop
    const int64_t hlen = (int64_t)hdr.b.size();
    if (o + hlen + clen > out_cap) return -3;
    std::memcpy(out + o, hdr.b.data(), hlen);
    std::memcpy(out + o + hlen, comp.data(), clen);
    o += hlen + clen;
    uncompressed += hlen + raw_len;
    pages++;
    r0 = r1;
  } while (r0 < num_rows);
  info[0] = uncompressed;
  info[1] = pages;
  return o;
}

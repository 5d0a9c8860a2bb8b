// Parquet column-chunk decoder of spark_rapids_tpu_torch (the port's
// copy of native/parquet_decode.cpp, the GpuParquetScan.scala:2624
// Table.readParquet role, host stage): decodes one column chunk's pages
// -- Snappy / GZIP / ZSTD or uncompressed; PLAIN, RLE_DICTIONARY,
// DELTA_BINARY_PACKED, BYTE_STREAM_SPLIT; v1 AND v2 data pages -- into
// caller-provided values and byte-validity buffers, without the GIL
// (ctypes releases it). Beyond the JAX package's copy it decodes
// BOOLEAN (bit-packed PLAIN, and RLE in v2 pages) and
// FIXED_LEN_BYTE_ARRAY of any width, and the repetition and
// definition levels of nested columns (page_levels), which
// io/parquet_nested.py assembles into list / struct / map lanes. The
// footer is parsed in Python (io/thrift.py); only PAGE headers are
// parsed here.
//
// Page header thrift-compact subset:
//   PageHeader{1:type 2:uncompressed_size 3:compressed_size
//              5:DataPageHeader{1:num_values 2:encoding
//                               3:def_level_encoding ...}
//              7:DictionaryPageHeader{1:num_values 2:encoding}
//              8:DataPageHeaderV2{1:num_values 2:num_nulls 3:num_rows
//                                 4:encoding 5:def_len 6:rep_len
//                                 7:is_compressed}}
// Unknown fields (statistics, crc) are skipped generically.
//
// zlib and zstd are linked by their runtime sonames where the machine
// has them (SRT_HAVE_ZLIB / SRT_HAVE_ZSTD, set by io/host_lib.py); the
// few symbols used are declared here, so no development headers are
// needed. A chunk in a codec the build lacks returns -4.

#include <cstdint>
#include <cstring>

#include "codecs.h"

namespace {

// ---------------------------------------------------------------------------
// thrift compact protocol (page headers only)
// ---------------------------------------------------------------------------

struct TReader {
  const uint8_t* p;
  int64_t n;
  int64_t i = 0;
  bool ok = true;

  uint64_t varint() {
    uint64_t v = 0;
    int shift = 0;
    while (i < n) {
      uint8_t b = p[i++];
      v |= uint64_t(b & 0x7f) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
      if (shift > 63) break;
    }
    ok = false;
    return 0;
  }
  int64_t zigzag() {
    uint64_t u = varint();
    return (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
  }
  void skip_bytes(int64_t k) {
    if (i + k > n) { ok = false; return; }
    i += k;
  }
  // skip one value of compact type t
  void skip_value(uint8_t t) {
    switch (t) {
      case 1: case 2: return;            // bool true/false (in field)
      case 3: skip_bytes(1); return;     // i8
      case 4: case 5: case 6: varint(); return;  // i16/i32/i64 zigzag
      case 7: skip_bytes(8); return;     // double
      case 8: {                          // binary/string
        uint64_t len = varint();
        skip_bytes((int64_t)len);
        return;
      }
      case 9: {                          // list
        uint8_t h = 0;
        if (i < n) h = p[i++]; else { ok = false; return; }
        uint64_t sz = h >> 4;
        uint8_t et = h & 0x0f;
        if (sz == 15) sz = varint();
        for (uint64_t k = 0; k < sz && ok; k++) skip_value(et);
        return;
      }
      case 12: skip_struct(); return;    // struct
      default: ok = false; return;
    }
  }
  void skip_struct() {
    int16_t fid = 0;
    while (ok) {
      if (i >= n) { ok = false; return; }
      uint8_t b = p[i++];
      if (b == 0) return;  // stop
      uint8_t t = b & 0x0f;
      uint8_t delta = b >> 4;
      if (delta == 0) fid = (int16_t)zigzag(); else fid += delta;
      if (t == 1 || t == 2) continue;  // bool packed in header
      skip_value(t);
    }
  }
};

struct PageHeader {
  int32_t type = -1;             // 0=DATA 2=DICT 3=DATA_V2
  int32_t uncompressed_size = 0;
  int32_t compressed_size = 0;
  int32_t num_values = 0;
  int32_t encoding = -1;         // 0=PLAIN 3=RLE 8=RLE_DICTIONARY ...
  int32_t def_encoding = -1;
  // v2-only fields
  int32_t num_nulls = 0;
  int32_t def_len = 0;
  int32_t rep_len = 0;
  bool v2_compressed = true;     // v2 default: values are compressed
};

// ---------------------------------------------------------------------------
// DELTA_BINARY_PACKED (encoding 5): zigzag first value, per-block
// min-delta + per-miniblock bit widths
// ---------------------------------------------------------------------------

struct DeltaReader {
  const uint8_t* p;
  int64_t n;
  int64_t i = 0;
  bool ok = true;

  uint64_t varint() {
    uint64_t v = 0;
    int shift = 0;
    while (i < n) {
      uint8_t b = p[i++];
      v |= uint64_t(b & 0x7f) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
      if (shift > 63) break;
    }
    ok = false;
    return 0;
  }
  int64_t zigzag() {
    uint64_t u = varint();
    return (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
  }
};

// Exact bit extraction for widths the 64-bit sliding window cannot
// hold together with residual bits (bw > 56): assemble value k's bits
// [k*bw, (k+1)*bw) from up to 9 bytes. Used by both delta decoders —
// the window fast path would shift by >= 64 (UB) or drop carry bits.
static inline uint64_t read_bits_at(const uint8_t* base, int64_t bit_pos,
                                    int bw) {
  uint64_t v = 0;
  int got = 0;
  int64_t byte = bit_pos >> 3;
  int off = (int)(bit_pos & 7);
  if (off) {
    v = (uint64_t)(base[byte] >> off);
    got = 8 - off;
    byte++;
  }
  while (got < bw) {
    v |= (uint64_t)base[byte++] << got;
    got += 8;
  }
  return bw == 64 ? v : (v & ((uint64_t(1) << bw) - 1));
}

// Decode ``count`` int64 values (INT32 files widen losslessly; the
// caller narrows) into out[]. Consumes one complete DELTA_BINARY_PACKED
// stream.
bool delta_binary_decode(const uint8_t* p, int64_t n, int64_t count,
                         int64_t* out) {
  DeltaReader r{p, n};
  int64_t block_size = (int64_t)r.varint();
  int64_t mb_per_block = (int64_t)r.varint();
  int64_t total = (int64_t)r.varint();
  int64_t first = r.zigzag();
  if (!r.ok || block_size <= 0 || mb_per_block <= 0) return false;
  if (block_size % (mb_per_block * 8) != 0) return false;
  if (total < count) return false;
  int64_t per_mb = block_size / mb_per_block;
  int64_t o = 0;
  if (o < count) out[o++] = first;
  int64_t prev = first;
  int64_t remaining = total - 1;
  while (o < count && remaining > 0 && r.ok) {
    int64_t min_delta = r.zigzag();
    if (r.i + mb_per_block > r.n) return false;
    const uint8_t* widths = r.p + r.i;
    r.i += mb_per_block;
    for (int64_t mb = 0; mb < mb_per_block; mb++) {
      int bw = widths[mb];
      if (bw > 64) return false;
      int64_t in_mb = per_mb;
      // every miniblock is fully present in the stream, but only
      // ``remaining`` of its values are real
      int64_t bytes = (per_mb * bw + 7) / 8;
      if (r.i + bytes > r.n) {
        // trailing miniblocks may be absent once all values are done
        if (remaining <= 0) break;
        return false;
      }
      const uint8_t* mbp = r.p + r.i;
      uint64_t window = 0;
      int have = 0;
      int64_t bi = 0;
      for (int64_t k = 0; k < in_mb; k++) {
        uint64_t uv = 0;
        if (bw > 56) {
          // window path would need have+bw > 64 bits in flight
          uv = read_bits_at(mbp, k * bw, bw);
        } else if (bw > 0) {
          while (have < bw) {
            window |= (uint64_t)mbp[bi++] << have;
            have += 8;
          }
          uv = window & ((uint64_t(1) << bw) - 1);
          window >>= bw;
          have -= bw;
        }
        if (remaining > 0) {
          prev = prev + min_delta + (int64_t)uv;
          remaining--;
          if (o < count) out[o++] = prev;
        }
      }
      r.i += bytes;
      if (remaining <= 0 && o >= count) break;
    }
  }
  return o == count;
}

// delta_binary_decode variant that decodes the stream's FULL value
// count and reports how many input bytes it consumed — required by
// DELTA_BYTE_ARRAY / DELTA_LENGTH_BYTE_ARRAY, whose pages concatenate
// delta blocks with byte payloads. Trailing empty miniblocks carry
// bit-width 0 in practice (parquet-mr and arrow writers), so walking
// the advertised widths lands exactly on the next section.
bool delta_binary_decode_ex(const uint8_t* p, int64_t n, int64_t count,
                            int64_t* out, int64_t* consumed) {
  DeltaReader r{p, n};
  int64_t block_size = (int64_t)r.varint();
  int64_t mb_per_block = (int64_t)r.varint();
  int64_t total = (int64_t)r.varint();
  int64_t first = r.zigzag();
  if (!r.ok || block_size <= 0 || mb_per_block <= 0) return false;
  if (block_size % (mb_per_block * 8) != 0) return false;
  if (total != count) return false;
  int64_t per_mb = block_size / mb_per_block;
  int64_t o = 0;
  if (o < count) out[o++] = first;
  int64_t prev = first;
  int64_t remaining = total - 1;
  while (remaining > 0 && r.ok) {
    int64_t min_delta = r.zigzag();
    if (r.i + mb_per_block > r.n) return false;
    const uint8_t* widths = r.p + r.i;
    r.i += mb_per_block;
    for (int64_t mb = 0; mb < mb_per_block; mb++) {
      int bw = widths[mb];
      if (bw > 64) return false;
      int64_t bytes = (per_mb * bw + 7) / 8;
      if (r.i + bytes > r.n) return false;
      const uint8_t* mbp = r.p + r.i;
      uint64_t window = 0;
      int have = 0;
      int64_t bi = 0;
      for (int64_t k = 0; k < per_mb; k++) {
        uint64_t uv = 0;
        if (bw > 56) {
          // window path would need have+bw > 64 bits in flight
          uv = read_bits_at(mbp, k * bw, bw);
        } else if (bw > 0) {
          while (have < bw) {
            window |= (uint64_t)mbp[bi++] << have;
            have += 8;
          }
          uv = window & ((uint64_t(1) << bw) - 1);
          window >>= bw;
          have -= bw;
        }
        if (remaining > 0) {
          prev = prev + min_delta + (int64_t)uv;
          remaining--;
          if (o < count) out[o++] = prev;
        }
      }
      r.i += bytes;
    }
  }
  if (!r.ok || o != count) return false;
  *consumed = r.i;
  return true;
}

// parse one PageHeader starting at r.i; leaves r.i just past it
bool parse_page_header(TReader& r, PageHeader* h) {
  int16_t fid = 0;
  while (r.ok) {
    if (r.i >= r.n) return false;
    uint8_t b = r.p[r.i++];
    if (b == 0) break;  // stop field
    uint8_t t = b & 0x0f;
    uint8_t delta = b >> 4;
    if (delta == 0) fid = (int16_t)r.zigzag(); else fid += delta;
    if (t == 1 || t == 2) continue;  // packed bool
    switch (fid) {
      case 1: h->type = (int32_t)r.zigzag(); break;
      case 2: h->uncompressed_size = (int32_t)r.zigzag(); break;
      case 3: h->compressed_size = (int32_t)r.zigzag(); break;
      case 5: case 7: {  // DataPageHeader / DictionaryPageHeader
        if (t != 12) { r.skip_value(t); break; }
        int16_t sfid = 0;
        while (r.ok) {
          if (r.i >= r.n) return false;
          uint8_t sb = r.p[r.i++];
          if (sb == 0) break;
          uint8_t st = sb & 0x0f;
          uint8_t sdelta = sb >> 4;
          if (sdelta == 0) sfid = (int16_t)r.zigzag();
          else sfid += sdelta;
          if (st == 1 || st == 2) continue;
          switch (sfid) {
            case 1: h->num_values = (int32_t)r.zigzag(); break;
            case 2: h->encoding = (int32_t)r.zigzag(); break;
            case 3:
              if (fid == 5) h->def_encoding = (int32_t)r.zigzag();
              else r.skip_value(st);
              break;
            default: r.skip_value(st); break;
          }
        }
        break;
      }
      case 8: {  // DataPageHeaderV2
        if (t != 12) { r.skip_value(t); break; }
        int16_t sfid = 0;
        while (r.ok) {
          if (r.i >= r.n) return false;
          uint8_t sb = r.p[r.i++];
          if (sb == 0) break;
          uint8_t st = sb & 0x0f;
          uint8_t sdelta = sb >> 4;
          if (sdelta == 0) sfid = (int16_t)r.zigzag();
          else sfid += sdelta;
          if (st == 1 || st == 2) {  // bool packed in type nibble
            if (sfid == 7) h->v2_compressed = (st == 1);
            continue;
          }
          switch (sfid) {
            case 1: h->num_values = (int32_t)r.zigzag(); break;
            case 2: h->num_nulls = (int32_t)r.zigzag(); break;
            case 4: h->encoding = (int32_t)r.zigzag(); break;
            case 5: h->def_len = (int32_t)r.zigzag(); break;
            case 6: h->rep_len = (int32_t)r.zigzag(); break;
            default: r.skip_value(st); break;
          }
        }
        break;
      }
      default: r.skip_value(t); break;
    }
  }
  return r.ok;
}

// ---------------------------------------------------------------------------
// RLE/bit-packed hybrid (def levels + dictionary indices)
// ---------------------------------------------------------------------------

// Decodes a whole RLE/bit-packed hybrid stream into a u32 index array
// in one pass: RLE runs become typed fills, literal groups unpack 8
// values at a time from a 64-bit window. ~two orders of magnitude
// faster than per-value extraction — this path runs once per VALUE of
// every dictionary-encoded/nullable column.
static bool rle_decode_all(const uint8_t* p, int64_t n, int bit_width,
                           uint32_t* out, int64_t count) {
  if (bit_width == 0) {
    std::memset(out, 0, sizeof(uint32_t) * count);
    return true;
  }
  if (bit_width > 32) return false;
  const uint32_t mask =
      bit_width == 32 ? 0xffffffffu : ((1u << bit_width) - 1);
  int64_t i = 0;
  int64_t o = 0;
  while (o < count) {
    if (i >= n) return false;
    uint64_t hdr = 0;
    int shift = 0;
    while (i < n) {
      uint8_t b = p[i++];
      hdr |= uint64_t(b & 0x7f) << shift;
      if (!(b & 0x80)) break;
      shift += 7;
      if (shift > 35) return false;
    }
    if (hdr & 1) {  // literal: (hdr>>1) groups of 8 bit-packed values
      int64_t groups = (int64_t)(hdr >> 1);
      int64_t vals = groups * 8;
      int64_t bytes = (int64_t)groups * bit_width;  // 8*bw bits
      if (i + bytes > n) return false;
      int64_t take = vals < (count - o) ? vals : (count - o);
      // unpack via a sliding 64-bit window
      uint64_t window = 0;
      int have = 0;
      int64_t bi = i;
      for (int64_t k = 0; k < take; k++) {
        while (have < bit_width) {
          window |= (uint64_t)p[bi++] << have;
          have += 8;
        }
        out[o + k] = (uint32_t)(window & mask);
        window >>= bit_width;
        have -= bit_width;
      }
      i += bytes;
      o += take;
    } else {  // RLE run
      int64_t run = (int64_t)(hdr >> 1);
      if (run == 0) return false;
      int bytes = (bit_width + 7) / 8;
      if (i + bytes > n) return false;
      uint32_t v = 0;
      for (int k = 0; k < bytes; k++) v |= (uint32_t)p[i++] << (8 * k);
      int64_t take = run < (count - o) ? run : (count - o);
      for (int64_t k = 0; k < take; k++) out[o + k] = v;
      o += take;
    }
  }
  return true;
}

int bit_width_for(int max_level) {
  int w = 0;
  while ((1 << w) <= max_level) w++;
  return w;  // levels in [0, max_level] need ceil(log2(max+1)) bits
}

// Decodes one data page's levels: for a v1 page the repetition, then
// the definition levels, each an RLE hybrid run behind a 4-byte length;
// for a v2 page the two sections whose lengths its header gives.
// valid[k] = (def == max_def); where def / rep are given they get the
// levels, one byte each. *used gets the bytes the levels took and
// *non_null the values present. Returns false for malformed data.
bool page_levels(const uint8_t* p, int64_t n, bool v2, int32_t rep_len,
                 int32_t def_len, int max_def, int max_rep, int64_t nvals,
                 uint8_t* valid, uint8_t* def, uint8_t* rep, int64_t* used,
                 int64_t* non_null) {
  uint32_t* lv = new uint32_t[nvals > 0 ? nvals : 1];
  int64_t i = 0;
  *non_null = nvals;
  auto section = [&](int max_level, int64_t v2_len, bool is_def) -> bool {
    if (max_level == 0) {
      if (is_def) {
        std::memset(valid, 1, nvals);
        if (def != nullptr) std::memset(def, 0, nvals);
      } else if (rep != nullptr) {
        std::memset(rep, 0, nvals);
      }
      return !v2 || v2_len == 0;
    }
    int64_t len = v2_len;
    if (!v2) {
      if (i + 4 > n) return false;
      len = p[i] | (int64_t(p[i + 1]) << 8) | (int64_t(p[i + 2]) << 16) |
            (int64_t(p[i + 3]) << 24);
      i += 4;
    }
    if (len < 0 || len > n - i) return false;
    if (!rle_decode_all(p + i, len, bit_width_for(max_level), lv, nvals))
      return false;
    i += len;
    if (is_def) {
      int64_t nn = 0;
      for (int64_t k = 0; k < nvals; k++) {
        if (lv[k] > (uint32_t)max_level) return false;
        uint8_t v = lv[k] == (uint32_t)max_level;
        valid[k] = v;
        nn += v;
        if (def != nullptr) def[k] = (uint8_t)lv[k];
      }
      *non_null = nn;
    } else if (rep != nullptr) {
      for (int64_t k = 0; k < nvals; k++) {
        if (lv[k] > (uint32_t)max_level) return false;
        rep[k] = (uint8_t)lv[k];
      }
    }
    return true;
  };
  bool ok = section(max_rep, rep_len, false) &&
            section(max_def, def_len, true);
  delete[] lv;
  *used = i;
  return ok;
}

// typed inner loops (elem size known at compile time -> plain movs);
// E == 0 takes the width at run time (FIXED_LEN_BYTE_ARRAY)
template <int E>
void scatter_plain(uint8_t* dst, const uint8_t* src,
                   const uint8_t* valid, int64_t nvals, int64_t w = E) {
  const int64_t e = E ? E : w;
  int64_t s = 0;
  for (int64_t k = 0; k < nvals; k++) {
    if (valid[k]) {
      std::memcpy(dst + k * e, src + s * e, E ? E : e);
      s++;
    } else {
      std::memset(dst + k * e, 0, E ? E : e);
    }
  }
}

template <int E>
bool gather_dict(uint8_t* dst, const uint8_t* dict, int64_t dict_count,
                 const uint32_t* idx, const uint8_t* valid,
                 int64_t nvals, int64_t w = E) {
  const int64_t e = E ? E : w;
  int64_t s = 0;
  for (int64_t k = 0; k < nvals; k++) {
    if (valid == nullptr || valid[k]) {
      uint32_t ix = idx[s++];
      if ((int64_t)ix >= dict_count) return false;
      std::memcpy(dst + k * e, dict + (int64_t)ix * e, E ? E : e);
    } else {
      std::memset(dst + k * e, 0, E ? E : e);
    }
  }
  return true;
}

void scatter_any(int elem, uint8_t* dst, const uint8_t* src,
                 const uint8_t* valid, int64_t nvals) {
  if (elem == 4) scatter_plain<4>(dst, src, valid, nvals);
  else if (elem == 8) scatter_plain<8>(dst, src, valid, nvals);
  else scatter_plain<0>(dst, src, valid, nvals, elem);
}

bool gather_any(int elem, uint8_t* dst, const uint8_t* dict,
                int64_t dict_count, const uint32_t* idx,
                const uint8_t* valid, int64_t nvals) {
  if (elem == 4)
    return gather_dict<4>(dst, dict, dict_count, idx, valid, nvals);
  if (elem == 8)
    return gather_dict<8>(dst, dict, dict_count, idx, valid, nvals);
  return gather_dict<0>(dst, dict, dict_count, idx, valid, nvals, elem);
}

// BOOLEAN values of one page into one byte per row: PLAIN is bit-packed
// LSB first from the page's first byte; RLE (v2 pages) is the hybrid
// at bit width 1 behind a 4-byte length. Null rows get 0.
bool decode_bools(int32_t encoding, const uint8_t* body, int64_t body_len,
                  int64_t non_null, const uint8_t* valid, int64_t nvals,
                  uint8_t* dst) {
  uint8_t* packed = new uint8_t[non_null > 0 ? non_null : 1];
  bool ok = true;
  if (encoding == 0) {
    if ((non_null + 7) / 8 > body_len) ok = false;
    for (int64_t k = 0; ok && k < non_null; k++)
      packed[k] = (body[k >> 3] >> (k & 7)) & 1;
  } else if (encoding == 3) {
    if (body_len < 4) {
      ok = false;
    } else {
      uint32_t len = body[0] | (uint32_t(body[1]) << 8) |
                     (uint32_t(body[2]) << 16) | (uint32_t(body[3]) << 24);
      if (4 + (int64_t)len > body_len) {
        ok = false;
      } else {
        uint32_t* idx = new uint32_t[non_null > 0 ? non_null : 1];
        ok = rle_decode_all(body + 4, len, 1, idx, non_null);
        for (int64_t k = 0; ok && k < non_null; k++)
          packed[k] = (uint8_t)idx[k];
        delete[] idx;
      }
    }
  } else {
    delete[] packed;
    return false;
  }
  if (ok) {
    if (valid == nullptr || non_null == nvals) {
      std::memcpy(dst, packed, nvals);
    } else {
      scatter_plain<1>(dst, packed, valid, nvals);
    }
  }
  delete[] packed;
  return ok;
}

}  // namespace

// the level outputs of the page that starts at value `row`
#define LEVEL_OUT(p) ((p) == nullptr ? nullptr : (p) + row)

// ---------------------------------------------------------------------------
// entry point
// ---------------------------------------------------------------------------
// phys_type: 0=BOOLEAN 1=INT32 2=INT64 3=INT96 4=FLOAT 5=DOUBLE
//            7=FIXED_LEN_BYTE_ARRAY (type_length bytes)  (parquet Type ids)
// codec: 0=UNCOMPRESSED 1=SNAPPY 2=GZIP 3=ZSTD
// Writes num_rows values of the physical width (one byte for BOOLEAN)
// into out_values. A nested column (max_def_level > 1 or
// max_rep_level > 0) passes out_def / out_rep (one byte per value): its
// num_rows is then the chunk's level count (ColumnMetaData.num_values),
// each level entry gets a value slot, and out_valid marks the entries
// whose definition level is the maximum (a value present). Returns the number of ROWS decoded, or a negative
// error:
//   -1 malformed  -2 unsupported feature  -3 buffer overflow
//   -4 the codec is not in this build
extern "C" int64_t parquet_decode_chunk(
    const uint8_t* chunk, int64_t chunk_len, int32_t codec,
    int32_t phys_type, int32_t type_length, int64_t num_rows,
    int32_t max_def_level, int32_t max_rep_level,
    uint8_t* out_values, int64_t out_values_cap,
    uint8_t* out_valid,          // one byte per row (1=non-null)
    uint8_t* out_def, uint8_t* out_rep,
    uint8_t* scratch, int64_t scratch_cap) {
  const int elem =
      phys_type == 0 ? 1 : phys_type == 1 ? 4 : phys_type == 2 ? 8 :
      phys_type == 3 ? 12 : phys_type == 4 ? 4 : phys_type == 5 ? 8 :
      phys_type == 7 ? type_length : 0;
  if (elem <= 0) return -2;
  // nested columns (max_def > 1 or any repetition) need the levels out
  if ((max_def_level > 1 || max_rep_level > 0) && out_def == nullptr)
    return -2;
  if (!srt_codecs::available(codec)) return -4;

  // decoded dictionary (values array), if a dictionary page appears;
  // it lives at the TAIL of scratch, and data pages may only
  // decompress into the remaining head
  uint8_t* dict = nullptr;
  int64_t dict_count = 0;
  int64_t dict_bytes = 0;

  int64_t row = 0;       // rows emitted
  int64_t i = 0;         // cursor into chunk
  while (i < chunk_len && row < num_rows) {
    TReader tr{chunk + i, chunk_len - i};
    PageHeader h;
    if (!parse_page_header(tr, &h)) return -1;
    // corrupt/crafted headers must FAIL (-1), not drive negative sizes
    // into memset/new or walk the cursor backward
    if (h.num_values < 0 || h.compressed_size < 0 ||
        h.uncompressed_size < 0)
      return -1;
    i += tr.i;
    if (i + h.compressed_size > chunk_len) return -1;
    const uint8_t* page = chunk + i;
    int64_t page_len = h.compressed_size;
    i += h.compressed_size;

    // decompress into the scratch HEAD if needed (tail holds the dict).
    // v2 pages keep their level sections UNCOMPRESSED ahead of the
    // (possibly compressed) values; split before inflating.
    const int64_t head_cap = scratch_cap - dict_bytes;
    const uint8_t* body = page;
    int64_t body_len = page_len;
    int64_t nvals = h.num_values;
    int64_t non_null = nvals;
    uint8_t* dst = nullptr;

    if (h.type == 3) {  // v2 data page
      if (h.def_len < 0 || h.rep_len < 0 ||
          (int64_t)h.def_len + h.rep_len > page_len)
        return -1;
      if (row + nvals > num_rows) return -1;
      // levels first (always uncompressed)
      int64_t used = 0;
      if (!page_levels(page, page_len, true, h.rep_len, h.def_len,
                       max_def_level, max_rep_level, nvals,
                       out_valid + row, LEVEL_OUT(out_def),
                       LEVEL_OUT(out_rep), &used, &non_null))
        return -1;
      body = page + used;
      body_len = page_len - used;
      if (codec != 0 && h.v2_compressed) {
        int64_t got = 0;
        int64_t want = h.uncompressed_size - h.def_len - h.rep_len;
        if (want < 0 || want > head_cap) return want < 0 ? -1 : -3;
        if (!srt_codecs::decompress_codec(codec, body, body_len, scratch,
                                          head_cap, &got) ||
            got != want)
          return -1;
        body = scratch;
        body_len = got;
      }
    } else {
      if (codec != 0) {
        int64_t got = 0;
        if (h.uncompressed_size > head_cap) return -3;
        if (!srt_codecs::decompress_codec(codec, page, page_len, scratch,
                                          head_cap, &got) ||
            got != h.uncompressed_size)
          return -1;
        page = scratch;
        page_len = got;
      }

      if (h.type == 2) {  // dictionary page: PLAIN values
        if (h.encoding != 0 && h.encoding != 2) return -2;
        if (phys_type == 0) return -2;  // no boolean dictionaries
        int64_t bytes = (int64_t)h.num_values * elem;
        if (bytes > page_len) return -1;
        if (bytes * 2 > scratch_cap) return -3;
        // park at the END of scratch so data pages reuse the head
        dict = scratch + scratch_cap - bytes;
        std::memmove(dict, page, bytes);
        dict_count = h.num_values;
        dict_bytes = bytes;
        continue;
      }
      if (h.type != 0) return -2;

      // v1 data page: [def levels (if max_def>0): u32 len+RLE][values]
      body = page;
      body_len = page_len;
      if (row + nvals > num_rows) return -1;
      if (max_def_level > 0 && h.def_encoding != 3) return -2;  // RLE only
      int64_t used = 0;
      if (!page_levels(body, body_len, false, 0, 0, max_def_level,
                       max_rep_level, nvals, out_valid + row,
                       LEVEL_OUT(out_def), LEVEL_OUT(out_rep), &used,
                       &non_null))
        return -1;
      body += used;
      body_len -= used;
    }

    // values: PLAIN(0), RLE_DICTIONARY(8)/PLAIN_DICTIONARY(2),
    // DELTA_BINARY_PACKED(5) for integer types, BYTE_STREAM_SPLIT(9),
    // and for BOOLEAN the RLE hybrid (3)
    if ((row + nvals) * elem > out_values_cap) return -3;
    dst = out_values + row * elem;
    const uint8_t* vmask =
        (max_def_level > 0 && non_null != nvals) ? out_valid + row : nullptr;
    if (phys_type == 0) {
      if (!decode_bools(h.encoding, body, body_len, non_null, vmask, nvals,
                        dst))
        return h.encoding == 0 || h.encoding == 3 ? -1 : -2;
    } else if (h.encoding == 0) {
      if (non_null * elem > body_len) return -1;
      if (vmask == nullptr) {
        std::memcpy(dst, body, nvals * elem);
      } else {
        scatter_any(elem, dst, body, vmask, nvals);
      }
    } else if (h.encoding == 8 || h.encoding == 2) {
      if (dict == nullptr) return -1;
      if (body_len < 1) return -1;
      int bw = body[0];
      if (bw < 0 || bw > 32) return -1;
      uint32_t* idx = new uint32_t[non_null > 0 ? non_null : 1];
      if (!rle_decode_all(body + 1, body_len - 1, bw, idx, non_null)) {
        delete[] idx;
        return -1;
      }
      bool ok = gather_any(elem, dst, dict, dict_count, idx, vmask, nvals);
      delete[] idx;
      if (!ok) return -1;
    } else if (h.encoding == 5) {
      if (phys_type != 1 && phys_type != 2) return -2;  // ints only
      int64_t* deltas = new int64_t[non_null > 0 ? non_null : 1];
      if (!delta_binary_decode(body, body_len, non_null, deltas)) {
        delete[] deltas;
        return -1;
      }
      int64_t s = 0;
      if (elem == 4) {
        int32_t* d32 = reinterpret_cast<int32_t*>(dst);
        for (int64_t k = 0; k < nvals; k++)
          d32[k] = (max_def_level == 0 || out_valid[row + k])
                       ? (int32_t)deltas[s++] : 0;
      } else {
        int64_t* d64 = reinterpret_cast<int64_t*>(dst);
        for (int64_t k = 0; k < nvals; k++)
          d64[k] = (max_def_level == 0 || out_valid[row + k])
                       ? deltas[s++] : 0;
      }
      delete[] deltas;
    } else if (h.encoding == 9) {
      // BYTE_STREAM_SPLIT: k-th byte of every value stored together
      if (non_null * elem > body_len) return -1;
      uint8_t* packed = new uint8_t[(non_null > 0 ? non_null : 1) * elem];
      for (int j = 0; j < elem; j++)
        for (int64_t k = 0; k < non_null; k++)
          packed[k * elem + j] = body[j * non_null + k];
      if (vmask == nullptr) {
        std::memcpy(dst, packed, nvals * elem);
      } else {
        scatter_any(elem, dst, packed, vmask, nvals);
      }
      delete[] packed;
    } else {
      return -2;
    }
    row += nvals;
  }
  return row;
}

// ---------------------------------------------------------------------------
// BYTE_ARRAY (string/binary) chunk decoder
// ---------------------------------------------------------------------------
// Encodings: PLAIN(0), PLAIN_DICTIONARY(2)/RLE_DICTIONARY(8),
// DELTA_LENGTH_BYTE_ARRAY(6), DELTA_BYTE_ARRAY(7); v1 + v2 pages, all
// supported codecs. Output: out_offsets[num_rows+1] (int32, offset 0
// pre-seeded by caller) + out_bytes; null rows get empty slices.
// Returns rows decoded or the same negative codes as
// parquet_decode_chunk (-3 also covers out_bytes overflow — the caller
// can retry with a bigger buffer).
extern "C" int64_t parquet_decode_chunk_binary(
    const uint8_t* chunk, int64_t chunk_len, int32_t codec,
    int64_t num_rows, int32_t max_def_level, int32_t max_rep_level,
    int32_t* out_offsets, uint8_t* out_bytes, int64_t out_bytes_cap,
    uint8_t* out_valid, uint8_t* out_def, uint8_t* out_rep,
    uint8_t* scratch, int64_t scratch_cap) {
  if ((max_def_level > 1 || max_rep_level > 0) && out_def == nullptr)
    return -2;
  if (!srt_codecs::available(codec)) return -4;

  // decoded dictionary parked at the TAIL of scratch:
  // [int32 ends[dict_count]] [bytes...] (ends are cumulative)
  int32_t* dict_ends = nullptr;
  const uint8_t* dict_bytes_p = nullptr;
  int64_t dict_count = 0;
  int64_t dict_tail = 0;  // bytes reserved at scratch tail

  int64_t row = 0;
  int64_t out_pos = 0;
  out_offsets[0] = 0;
  int64_t i = 0;
  while (i < chunk_len && row < num_rows) {
    TReader tr{chunk + i, chunk_len - i};
    PageHeader h;
    if (!parse_page_header(tr, &h)) return -1;
    if (h.num_values < 0 || h.compressed_size < 0 ||
        h.uncompressed_size < 0)
      return -1;
    i += tr.i;
    if (i + h.compressed_size > chunk_len) return -1;
    const uint8_t* page = chunk + i;
    int64_t page_len = h.compressed_size;
    i += h.compressed_size;

    const int64_t head_cap = scratch_cap - dict_tail;
    const uint8_t* body = page;
    int64_t body_len = page_len;
    int64_t nvals = h.num_values;
    int64_t non_null = nvals;

    if (h.type == 3) {  // v2 data page
      if (h.def_len < 0 || h.rep_len < 0 ||
          (int64_t)h.def_len + h.rep_len > page_len)
        return -1;
      if (row + nvals > num_rows) return -1;
      // levels first (always uncompressed)
      int64_t used = 0;
      if (!page_levels(page, page_len, true, h.rep_len, h.def_len,
                       max_def_level, max_rep_level, nvals,
                       out_valid + row, LEVEL_OUT(out_def),
                       LEVEL_OUT(out_rep), &used, &non_null))
        return -1;
      body = page + used;
      body_len = page_len - used;
      if (codec != 0 && h.v2_compressed) {
        int64_t got = 0;
        int64_t want = h.uncompressed_size - h.def_len - h.rep_len;
        if (want < 0 || want > head_cap) return want < 0 ? -1 : -3;
        if (!srt_codecs::decompress_codec(codec, body, body_len, scratch, head_cap,
                              &got) ||
            got != want)
          return -1;
        body = scratch;
        body_len = got;
      }
    } else {
      if (codec != 0) {
        int64_t got = 0;
        if (h.uncompressed_size > head_cap) return -3;
        if (!srt_codecs::decompress_codec(codec, page, page_len, scratch, head_cap,
                              &got) ||
            got != h.uncompressed_size)
          return -1;
        page = scratch;
        page_len = got;
      }

      if (h.type == 2) {  // dictionary page: PLAIN byte arrays
        if (h.encoding != 0 && h.encoding != 2) return -2;
        // first pass: total bytes
        int64_t total_b = 0;
        {
          int64_t p2 = 0;
          for (int64_t k = 0; k < h.num_values; k++) {
            if (p2 + 4 > page_len) return -1;
            uint32_t len = page[p2] | (uint32_t(page[p2 + 1]) << 8) |
                           (uint32_t(page[p2 + 2]) << 16) |
                           (uint32_t(page[p2 + 3]) << 24);
            p2 += 4;
            if (p2 + (int64_t)len > page_len) return -1;
            p2 += len;
            total_b += len;
          }
        }
        int64_t need = (int64_t)h.num_values * 4 + total_b;
        // dict must survive page decompression into the head
        if (need * 2 > scratch_cap) return -3;
        // the tail build memmoves from `page` (which may itself live in
        // the scratch head after decompression): the source must end
        // before the tail begins, or the copy corrupts the dictionary
        if (page_len > scratch_cap - need) return -3;
        dict_tail = need;
        uint8_t* tail = scratch + scratch_cap - need;
        dict_ends = reinterpret_cast<int32_t*>(tail);
        uint8_t* db = tail + (int64_t)h.num_values * 4;
        int64_t p2 = 0, off = 0;
        for (int64_t k = 0; k < h.num_values; k++) {
          uint32_t len = page[p2] | (uint32_t(page[p2 + 1]) << 8) |
                         (uint32_t(page[p2 + 2]) << 16) |
                         (uint32_t(page[p2 + 3]) << 24);
          p2 += 4;
          std::memmove(db + off, page + p2, len);
          p2 += len;
          off += len;
          dict_ends[k] = (int32_t)off;
        }
        dict_bytes_p = db;
        dict_count = h.num_values;
        continue;
      }
      if (h.type != 0) return -2;

      body = page;
      body_len = page_len;
      if (row + nvals > num_rows) return -1;
      if (max_def_level > 0 && h.def_encoding != 3) return -2;  // RLE only
      int64_t used = 0;
      if (!page_levels(body, body_len, false, 0, 0, max_def_level,
                       max_rep_level, nvals, out_valid + row,
                       LEVEL_OUT(out_def), LEVEL_OUT(out_rep), &used,
                       &non_null))
        return -1;
      body += used;
      body_len -= used;
    }

    // emit one value's bytes; returns false on overflow
    auto emit = [&](const uint8_t* src, int64_t len) -> bool {
      // len is attacker-controlled (decoded from the page): compare
      // without forming out_pos+len (int64 wrap would skip the check),
      // and keep offsets representable in the int32 output array
      if (len < 0 || len > out_bytes_cap - out_pos) return false;
      if (out_pos + len > (int64_t)0x7fffffff) return false;
      std::memcpy(out_bytes + out_pos, src, len);
      out_pos += len;
      return true;
    };

    if (h.encoding == 0) {  // PLAIN: [u32 len][bytes] per value
      int64_t p2 = 0;
      int64_t s = 0;
      for (int64_t k = 0; k < nvals; k++) {
        bool valid = max_def_level == 0 || out_valid[row + k];
        if (valid) {
          if (p2 + 4 > body_len) return -1;
          uint32_t len = body[p2] | (uint32_t(body[p2 + 1]) << 8) |
                         (uint32_t(body[p2 + 2]) << 16) |
                         (uint32_t(body[p2 + 3]) << 24);
          p2 += 4;
          if ((int64_t)len > body_len - p2) return -1;
          if (!emit(body + p2, len)) return -3;
          p2 += len;
          s++;
        }
        out_offsets[row + k + 1] = (int32_t)out_pos;
      }
      (void)s;
    } else if (h.encoding == 8 || h.encoding == 2) {  // dictionary
      if (dict_ends == nullptr) return -1;
      if (body_len < 1) return -1;
      int bw = body[0];
      if (bw < 0 || bw > 32) return -1;
      uint32_t* idx = new uint32_t[non_null > 0 ? non_null : 1];
      if (!rle_decode_all(body + 1, body_len - 1, bw, idx, non_null)) {
        delete[] idx;
        return -1;
      }
      int64_t s = 0;
      for (int64_t k = 0; k < nvals; k++) {
        bool valid = max_def_level == 0 || out_valid[row + k];
        if (valid) {
          uint32_t ix = idx[s++];
          if ((int64_t)ix >= dict_count) {
            delete[] idx;
            return -1;
          }
          int32_t start = ix == 0 ? 0 : dict_ends[ix - 1];
          int32_t len = dict_ends[ix] - start;
          if (!emit(dict_bytes_p + start, len)) {
            delete[] idx;
            return -3;
          }
        }
        out_offsets[row + k + 1] = (int32_t)out_pos;
      }
      delete[] idx;
    } else if (h.encoding == 6) {  // DELTA_LENGTH_BYTE_ARRAY
      int64_t* lens = new int64_t[non_null > 0 ? non_null : 1];
      int64_t consumed = 0;
      if (non_null > 0 &&
          !delta_binary_decode_ex(body, body_len, non_null, lens,
                                  &consumed)) {
        delete[] lens;
        return -1;
      }
      int64_t p2 = consumed;
      int64_t s = 0;
      bool bad = false;
      for (int64_t k = 0; k < nvals && !bad; k++) {
        bool valid = max_def_level == 0 || out_valid[row + k];
        if (valid) {
          int64_t len = lens[s++];
          if (len < 0 || len > body_len - p2) { bad = true; break; }
          if (!emit(body + p2, len)) {
            delete[] lens;
            return -3;
          }
          p2 += len;
        }
        out_offsets[row + k + 1] = (int32_t)out_pos;
      }
      delete[] lens;
      if (bad) return -1;
    } else if (h.encoding == 7) {  // DELTA_BYTE_ARRAY (prefix sharing)
      int64_t* pre = new int64_t[non_null > 0 ? non_null : 1];
      int64_t* suf = new int64_t[non_null > 0 ? non_null : 1];
      int64_t c1 = 0, c2 = 0;
      bool ok = non_null == 0 ||
                (delta_binary_decode_ex(body, body_len, non_null, pre,
                                        &c1) &&
                 delta_binary_decode_ex(body + c1, body_len - c1,
                                        non_null, suf, &c2));
      if (!ok) {
        delete[] pre;
        delete[] suf;
        return -1;
      }
      int64_t p2 = c1 + c2;
      int64_t s = 0;
      int64_t prev_start = -1, prev_len = 0;
      bool bad = false;
      for (int64_t k = 0; k < nvals && !bad; k++) {
        bool valid = max_def_level == 0 || out_valid[row + k];
        if (valid) {
          int64_t pl = pre[s], sl = suf[s];
          s++;
          if (pl < 0 || sl < 0 || pl > prev_len ||
              (pl > 0 && prev_start < 0) || sl > body_len - p2) {
            bad = true;
            break;
          }
          if (pl > out_bytes_cap - out_pos ||
              sl > out_bytes_cap - out_pos - pl ||
              out_pos + pl + sl > (int64_t)0x7fffffff) {
            delete[] pre;
            delete[] suf;
            return -3;
          }
          int64_t start = out_pos;
          // prefix copies from the PREVIOUS decoded value in out_bytes
          std::memmove(out_bytes + out_pos, out_bytes + prev_start, pl);
          out_pos += pl;
          std::memcpy(out_bytes + out_pos, body + p2, sl);
          out_pos += sl;
          p2 += sl;
          prev_start = start;
          prev_len = pl + sl;
        }
        out_offsets[row + k + 1] = (int32_t)out_pos;
      }
      delete[] pre;
      delete[] suf;
      if (bad) return -1;
    } else {
      return -2;
    }
    row += nvals;
  }
  return row;
}

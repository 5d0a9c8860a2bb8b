// Page codecs of the port's Parquet host library: Snappy in both
// directions (the port's own code: a block decoder, and a greedy
// hash-table matcher for the writer), and GZIP / ZSTD through the
// machine's zlib and libzstd where the build links them.
//
// The zlib and zstd symbols are declared here rather than taken from
// <zlib.h> / <zstd.h>: a machine may ship the runtime libraries without
// their headers. io/host_lib.py links each runtime soname that
// `ldconfig -p` lists and defines SRT_HAVE_ZLIB / SRT_HAVE_ZSTD for it.
//
// Codec ids (the decoder's own, not parquet.thrift's):
//   0 = UNCOMPRESSED, 1 = SNAPPY, 2 = GZIP, 3 = ZSTD, 4 = DEFLATE (raw,
//   no wrapper: ORC's ZLIB).

#pragma once

#include <cstdint>
#include <cstring>

#ifdef SRT_HAVE_ZLIB
extern "C" {
// zlib's z_stream, whose layout zlib keeps stable across 1.x (it checks
// sizeof(z_stream) and the major version at init)
struct srt_z_stream {
  const unsigned char* next_in;
  unsigned avail_in;
  unsigned long total_in;
  unsigned char* next_out;
  unsigned avail_out;
  unsigned long total_out;
  const char* msg;
  void* state;
  void* zalloc;
  void* zfree;
  void* opaque;
  int data_type;
  unsigned long adler;
  unsigned long reserved;
};
int inflateInit2_(srt_z_stream* strm, int window_bits, const char* version,
                  int stream_size);
int inflate(srt_z_stream* strm, int flush);
int inflateEnd(srt_z_stream* strm);
int deflateInit2_(srt_z_stream* strm, int level, int method,
                  int window_bits, int mem_level, int strategy,
                  const char* version, int stream_size);
int deflate(srt_z_stream* strm, int flush);
int deflateEnd(srt_z_stream* strm);
}
#endif

#ifdef SRT_HAVE_ZSTD
extern "C" {
size_t ZSTD_decompress(void* dst, size_t dst_capacity, const void* src,
                       size_t src_size);
size_t ZSTD_compress(void* dst, size_t dst_capacity, const void* src,
                     size_t src_size, int level);
size_t ZSTD_compressBound(size_t src_size);
unsigned ZSTD_isError(size_t code);
}
#endif

namespace srt_codecs {

inline bool available(int32_t codec) {
  switch (codec) {
    case 0: case 1: return true;
#ifdef SRT_HAVE_ZLIB
    case 2: case 4: return true;
#endif
#ifdef SRT_HAVE_ZSTD
    case 3: return true;
#endif
    default: return false;
  }
}

// ---------------------------------------------------------------------------
// snappy block format: varint length, then literal / copy tags
// ---------------------------------------------------------------------------

inline bool snappy_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                              int64_t dst_cap, int64_t* out_len) {
  int64_t i = 0;
  uint64_t ulen = 0;
  int shift = 0;
  while (i < n) {
    uint8_t b = src[i++];
    ulen |= uint64_t(b & 0x7f) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
    if (shift > 35) return false;
  }
  if ((int64_t)ulen > dst_cap) return false;
  int64_t o = 0;
  while (i < n) {
    uint8_t tag = src[i++];
    uint32_t kind = tag & 3u;
    if (kind == 0) {  // literal
      int64_t len = (tag >> 2) + 1;
      if ((tag >> 2) >= 60) {  // 60..63 = 1..4 extra length bytes
        int extra = (tag >> 2) - 59;
        if (i + extra > n) return false;
        uint32_t l = 0;
        for (int k = 0; k < extra; k++) l |= uint32_t(src[i + k]) << (8 * k);
        len = int64_t(l) + 1;
        i += extra;
      }
      if (i + len > n || o + len > dst_cap) return false;
      std::memcpy(dst + o, src + i, len);
      i += len;
      o += len;
      continue;
    }
    int64_t len, off;
    if (kind == 1) {
      if (i >= n) return false;
      len = ((tag >> 2) & 7) + 4;
      off = (int64_t(tag >> 5) << 8) | src[i++];
    } else if (kind == 2) {
      if (i + 2 > n) return false;
      len = (tag >> 2) + 1;
      off = src[i] | (int64_t(src[i + 1]) << 8);
      i += 2;
    } else {
      if (i + 4 > n) return false;
      len = (tag >> 2) + 1;
      off = src[i] | (int64_t(src[i + 1]) << 8) |
            (int64_t(src[i + 2]) << 16) | (int64_t(src[i + 3]) << 24);
      i += 4;
    }
    if (off <= 0 || off > o || o + len > dst_cap) return false;
    uint8_t* d = dst + o;
    const uint8_t* from = d - off;
    if (off >= len) {
      std::memcpy(d, from, len);
    } else if (off >= 8) {
      // overlapping, but each 8-byte step reads bytes already written
      for (int64_t k = 0; k < len; k += 8)
        std::memcpy(d + k, from + k, len - k < 8 ? len - k : 8);
    } else {
      // a run shorter than 8: byte by byte (run-length semantics)
      for (int64_t k = 0; k < len; k++) d[k] = from[k];
    }
    o += len;
  }
  *out_len = o;
  return (int64_t)ulen == o;
}

inline int64_t snappy_max_compressed(int64_t n) { return 32 + n + n / 6; }

inline uint8_t* snappy_literal(uint8_t* op, const uint8_t* src, int64_t len) {
  int64_t n = len - 1;
  if (n < 60) {
    *op++ = uint8_t(n << 2);
  } else {
    int bytes = n < (1 << 8) ? 1 : n < (1 << 16) ? 2 : n < (1 << 24) ? 3 : 4;
    *op++ = uint8_t((59 + bytes) << 2);
    for (int k = 0; k < bytes; k++) *op++ = uint8_t(n >> (8 * k));
  }
  std::memcpy(op, src, len);
  return op + len;
}

inline uint8_t* snappy_copy(uint8_t* op, int64_t offset, int64_t len) {
  // copies of at most 64 bytes; keep the last piece at 4 or more
  while (len >= 68) {
    *op++ = uint8_t(2 | (63 << 2));
    *op++ = uint8_t(offset);
    *op++ = uint8_t(offset >> 8);
    len -= 64;
  }
  if (len > 64) {
    *op++ = uint8_t(2 | (59 << 2));
    *op++ = uint8_t(offset);
    *op++ = uint8_t(offset >> 8);
    len -= 60;
  }
  if (len <= 11 && offset < 2048) {
    *op++ = uint8_t(1 | ((len - 4) << 2) | ((offset >> 8) << 5));
    *op++ = uint8_t(offset);
  } else {
    *op++ = uint8_t(2 | ((len - 1) << 2));
    *op++ = uint8_t(offset);
    *op++ = uint8_t(offset >> 8);
  }
  return op;
}

inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

// Greedy single-pass matcher: a 2^14-entry table of the last position
// of each 4-byte hash; matches of 4+ bytes within 64 KiB back become
// copies. Returns the compressed size (dst holds snappy_max_compressed(n)).
inline int64_t snappy_compress(const uint8_t* src, int64_t n, uint8_t* dst) {
  uint8_t* op = dst;
  uint64_t v = (uint64_t)n;
  while (v >= 0x80) {
    *op++ = uint8_t(v | 0x80);
    v >>= 7;
  }
  *op++ = uint8_t(v);
  constexpr int kBits = 14;
  int32_t table[1 << kBits];
  for (int k = 0; k < (1 << kBits); k++) table[k] = -1;
  int64_t ip = 0, lit = 0;
  const int64_t limit = n - 4;
  int64_t skip = 32;
  while (ip <= limit) {
    uint32_t cur = load32(src + ip);
    uint32_t h = (cur * 0x1e35a7bdu) >> (32 - kBits);
    int64_t cand = table[h];
    table[h] = (int32_t)ip;
    if (cand >= 0 && ip - cand < 65536 && load32(src + cand) == cur) {
      int64_t len = 4;
      while (ip + len < n && src[cand + len] == src[ip + len]) len++;
      if (ip > lit) op = snappy_literal(op, src + lit, ip - lit);
      op = snappy_copy(op, ip - cand, len);
      // seed the table inside the match so the next one finds it
      if (ip + len - 1 <= limit) {
        int64_t q = ip + len - 1;
        table[(load32(src + q) * 0x1e35a7bdu) >> (32 - kBits)] = (int32_t)q;
      }
      ip += len;
      lit = ip;
      skip = 32;
    } else {
      // step faster through input that does not match
      ip += skip >> 5;
      skip++;
    }
  }
  if (n > lit) op = snappy_literal(op, src + lit, n - lit);
  return op - dst;
}

// ---------------------------------------------------------------------------
// gzip / zstd
// ---------------------------------------------------------------------------

inline bool gzip_inflate(const uint8_t* src, int64_t n, uint8_t* dst,
                         int64_t dst_cap, int64_t* out_len) {
#ifdef SRT_HAVE_ZLIB
  srt_z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  // 15+32: accept both zlib and gzip wrappers (parquet uses gzip)
  if (inflateInit2_(&zs, 15 + 32, "1", (int)sizeof(zs)) != 0) return false;
  zs.next_in = src;
  zs.avail_in = (unsigned)n;
  zs.next_out = dst;
  zs.avail_out = (unsigned)dst_cap;
  int rc = inflate(&zs, 4 /* Z_FINISH */);
  *out_len = (int64_t)zs.total_out;
  inflateEnd(&zs);
  return rc == 1 /* Z_STREAM_END */;
#else
  (void)src; (void)n; (void)dst; (void)dst_cap; (void)out_len;
  return false;
#endif
}

inline int64_t gzip_deflate(const uint8_t* src, int64_t n, uint8_t* dst,
                            int64_t dst_cap) {
#ifdef SRT_HAVE_ZLIB
  srt_z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  // level 6 (zlib's default), deflate, 15+16 = a gzip wrapper
  if (deflateInit2_(&zs, 6, 8, 15 + 16, 8, 0, "1", (int)sizeof(zs)) != 0)
    return -1;
  zs.next_in = src;
  zs.avail_in = (unsigned)n;
  zs.next_out = dst;
  zs.avail_out = (unsigned)dst_cap;
  int rc = deflate(&zs, 4 /* Z_FINISH */);
  int64_t out = (int64_t)zs.total_out;
  deflateEnd(&zs);
  return rc == 1 ? out : -3;
#else
  (void)src; (void)n; (void)dst; (void)dst_cap;
  return -4;
#endif
}

// raw deflate streams (window bits -15), ORC's ZLIB codec
inline bool raw_inflate(const uint8_t* src, int64_t n, uint8_t* dst,
                        int64_t dst_cap, int64_t* out_len) {
#ifdef SRT_HAVE_ZLIB
  srt_z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit2_(&zs, -15, "1", (int)sizeof(zs)) != 0) return false;
  zs.next_in = src;
  zs.avail_in = (unsigned)n;
  zs.next_out = dst;
  zs.avail_out = (unsigned)dst_cap;
  int rc = inflate(&zs, 4 /* Z_FINISH */);
  *out_len = (int64_t)zs.total_out;
  inflateEnd(&zs);
  return rc == 1 /* Z_STREAM_END */;
#else
  (void)src; (void)n; (void)dst; (void)dst_cap; (void)out_len;
  return false;
#endif
}

inline int64_t raw_deflate(const uint8_t* src, int64_t n, uint8_t* dst,
                           int64_t dst_cap) {
#ifdef SRT_HAVE_ZLIB
  srt_z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (deflateInit2_(&zs, 6, 8, -15, 8, 0, "1", (int)sizeof(zs)) != 0)
    return -1;
  zs.next_in = src;
  zs.avail_in = (unsigned)n;
  zs.next_out = dst;
  zs.avail_out = (unsigned)dst_cap;
  int rc = deflate(&zs, 4 /* Z_FINISH */);
  int64_t out = (int64_t)zs.total_out;
  deflateEnd(&zs);
  return rc == 1 ? out : -3;
#else
  (void)src; (void)n; (void)dst; (void)dst_cap;
  return -4;
#endif
}

inline bool zstd_inflate(const uint8_t* src, int64_t n, uint8_t* dst,
                         int64_t dst_cap, int64_t* out_len) {
#ifdef SRT_HAVE_ZSTD
  size_t got = ZSTD_decompress(dst, (size_t)dst_cap, src, (size_t)n);
  if (ZSTD_isError(got)) return false;
  *out_len = (int64_t)got;
  return true;
#else
  (void)src; (void)n; (void)dst; (void)dst_cap; (void)out_len;
  return false;
#endif
}

inline int64_t zstd_deflate(const uint8_t* src, int64_t n, uint8_t* dst,
                            int64_t dst_cap) {
#ifdef SRT_HAVE_ZSTD
  size_t got = ZSTD_compress(dst, (size_t)dst_cap, src, (size_t)n, 1);
  return ZSTD_isError(got) ? -3 : (int64_t)got;
#else
  (void)src; (void)n; (void)dst; (void)dst_cap;
  return -4;
#endif
}

// codec: 0=UNCOMPRESSED 1=SNAPPY 2=GZIP 3=ZSTD
inline bool decompress_codec(int32_t codec, const uint8_t* src, int64_t n,
                             uint8_t* dst, int64_t dst_cap, int64_t* out_len) {
  switch (codec) {
    case 1: return snappy_decompress(src, n, dst, dst_cap, out_len);
    case 2: return gzip_inflate(src, n, dst, dst_cap, out_len);
    case 3: return zstd_inflate(src, n, dst, dst_cap, out_len);
    case 4: return raw_inflate(src, n, dst, dst_cap, out_len);
    default: return false;
  }
}

// an upper bound of any codec's output for n input bytes
inline int64_t compress_bound(int64_t n) {
  return snappy_max_compressed(n) + (n >> 8) + 1024;
}

// -> compressed size, or -3 (dst too small), -4 (codec not in the build)
inline int64_t compress_codec(int32_t codec, const uint8_t* src, int64_t n,
                              uint8_t* dst, int64_t dst_cap) {
  switch (codec) {
    case 0:
      if (n > dst_cap) return -3;
      std::memcpy(dst, src, n);
      return n;
    case 1:
      if (snappy_max_compressed(n) > dst_cap) return -3;
      return snappy_compress(src, n, dst);
    case 2: return gzip_deflate(src, n, dst, dst_cap);
    case 3: return zstd_deflate(src, n, dst, dst_cap);
    case 4: return raw_deflate(src, n, dst, dst_cap);
    default: return -4;
  }
}

}  // namespace srt_codecs

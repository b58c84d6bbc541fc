// LZ4 raw-block codec (compress + decompress), C++17, no dependencies.
//
// Implements the LZ4 block format (lz4.org block spec) as used by the
// reference compress_lz4 (mptrac.c:1740): each 3-D met field is one block
// prefixed by a size_t length.  The compressor is a greedy single-probe
// hash matcher (LZ4-fast style); its output decodes with any conforming
// LZ4 decoder.
//
// Built into the loader library with metloader.cc; bound through ctypes
// by mptrac_tpu_torch/met/lz4.py.

#include <cstdint>
#include <cstring>
#include <cstddef>

namespace {

constexpr int MINMATCH = 4;
constexpr int MFLIMIT = 12;     // last 12 bytes: literals only
constexpr int LASTLITERALS = 5; // last 5 bytes of the block

inline uint32_t read32(const uint8_t *p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint32_t hash32(uint32_t v) {
  return (v * 2654435761u) >> 18;  // 14-bit table
}

}  // namespace

extern "C" {

// Worst-case compressed size (mirrors LZ4_compressBound).
size_t mt_lz4_bound(size_t n) { return n + n / 255 + 16; }

// Compress src[0..n) into dst (capacity >= mt_lz4_bound(n)).
// Returns compressed size, or 0 on error.
size_t mt_lz4_compress(const uint8_t *src, size_t n, uint8_t *dst) {
  if (n == 0) return 0;
  uint32_t table[1 << 14];
  std::memset(table, 0, sizeof table);

  const uint8_t *ip = src;
  const uint8_t *anchor = src;
  const uint8_t *const iend = src + n;
  const uint8_t *const mflimit =
      (n >= (size_t)MFLIMIT) ? iend - MFLIMIT : src;
  uint8_t *op = dst;

  auto emit = [&](const uint8_t *lit_end, size_t mlen, size_t offset) {
    size_t litlen = (size_t)(lit_end - anchor);
    uint8_t *token = op++;
    if (litlen >= 15) {
      *token = (uint8_t)(15 << 4);
      size_t rem = litlen - 15;
      while (rem >= 255) { *op++ = 255; rem -= 255; }
      *op++ = (uint8_t)rem;
    } else {
      *token = (uint8_t)(litlen << 4);
    }
    std::memcpy(op, anchor, litlen);
    op += litlen;
    if (mlen) {
      *op++ = (uint8_t)(offset & 0xff);
      *op++ = (uint8_t)(offset >> 8);
      size_t m = mlen - MINMATCH;
      if (m >= 15) {
        *token |= 15;
        m -= 15;
        while (m >= 255) { *op++ = 255; m -= 255; }
        *op++ = (uint8_t)m;
      } else {
        *token |= (uint8_t)m;
      }
    }
  };

  if (n >= (size_t)MFLIMIT + 1) {
    while (ip < mflimit) {
      uint32_t h = hash32(read32(ip));
      const uint8_t *match = src + table[h];
      table[h] = (uint32_t)(ip - src);
      if (match < ip && (size_t)(ip - match) <= 65535 &&
          read32(match) == read32(ip)) {
        // extend match forward (respect end-of-block literal rules)
        const uint8_t *limit = iend - LASTLITERALS;
        size_t mlen = MINMATCH;
        while (ip + mlen < limit && match[mlen] == ip[mlen]) ++mlen;
        emit(ip, mlen, (size_t)(ip - match));
        ip += mlen;
        anchor = ip;
      } else {
        ++ip;
      }
    }
  }
  // final literals
  anchor = anchor;
  {
    size_t litlen = (size_t)(iend - anchor);
    uint8_t *token = op++;
    if (litlen >= 15) {
      *token = (uint8_t)(15 << 4);
      size_t rem = litlen - 15;
      while (rem >= 255) { *op++ = 255; rem -= 255; }
      *op++ = (uint8_t)rem;
    } else {
      *token = (uint8_t)(litlen << 4);
    }
    std::memcpy(op, anchor, litlen);
    op += litlen;
  }
  return (size_t)(op - dst);
}

// Decompress src[0..clen) into dst[0..dlen).  Returns bytes written,
// or 0 on malformed input / overflow.
size_t mt_lz4_decompress(const uint8_t *src, size_t clen, uint8_t *dst,
                         size_t dlen) {
  const uint8_t *ip = src, *const iend = src + clen;
  uint8_t *op = dst, *const oend = dst + dlen;
  while (ip < iend) {
    uint8_t token = *ip++;
    size_t litlen = token >> 4;
    if (litlen == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return 0;
        b = *ip++;
        litlen += b;
      } while (b == 255);
    }
    if ((size_t)(iend - ip) < litlen || (size_t)(oend - op) < litlen)
      return 0;
    std::memcpy(op, ip, litlen);
    ip += litlen;
    op += litlen;
    if (ip >= iend) break;  // last sequence has no match
    if ((size_t)(iend - ip) < 2) return 0;
    size_t offset = (size_t)ip[0] | ((size_t)ip[1] << 8);
    ip += 2;
    if (offset == 0 || offset > (size_t)(op - dst)) return 0;
    size_t mlen = (token & 15);
    if (mlen == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return 0;
        b = *ip++;
        mlen += b;
      } while (b == 255);
    }
    mlen += MINMATCH;
    if ((size_t)(oend - op) < mlen) return 0;
    const uint8_t *mp = op - offset;
    for (size_t i = 0; i < mlen; ++i) op[i] = mp[i];  // may overlap
    op += mlen;
  }
  return (size_t)(op - dst);
}

}  // extern "C"

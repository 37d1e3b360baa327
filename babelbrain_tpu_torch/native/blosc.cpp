// LZ4 block decoder for BLOSC1-compressed HDF5 chunks.
//
// The reference persists every HDF5 payload through H5pySimple with the
// BLOSC filter (SURVEY.md section 2.9; `InformationForDrivingSystems.md:12-16`),
// so files produced by the reference (DataForSim.h5, MapPichardo.h5,
// thermal outputs) carry filter id 32001. This image has no blosc/lz4
// codec, so we decode natively: the Python side (native/__init__.py
// blosc_decompress) parses the 16-byte BLOSC1 chunk header + block starts
// and calls this safe LZ4 block decompressor per stream.
//
// LZ4 block format: sequences of
//   [token][literal-length ext*][literals][2-byte LE offset][match-length ext*]
// where token = (litlen<<4)|matchlen, 15 escapes to 255-run extension bytes,
// and match length is stored minus the 4-byte minimum.

#include <cstdint>
#include <cstring>

extern "C" {

// Returns number of bytes written to dst, or -1 on malformed input.
int64_t lz4_decompress_block(const uint8_t *src, int64_t src_len,
                             uint8_t *dst, int64_t dst_cap) {
  const uint8_t *ip = src;
  const uint8_t *iend = src + src_len;
  uint8_t *op = dst;
  uint8_t *oend = dst + dst_cap;

  while (ip < iend) {
    unsigned token = *ip++;
    // literals
    int64_t lit = token >> 4;
    if (lit == 15) {
      unsigned b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        lit += b;
      } while (b == 255);
    }
    if (ip + lit > iend || op + lit > oend) return -1;
    std::memcpy(op, ip, (size_t)lit);
    ip += lit;
    op += lit;
    if (ip >= iend) break;  // last sequence carries no match

    // match
    if (ip + 2 > iend) return -1;
    int64_t offset = (int64_t)ip[0] | ((int64_t)ip[1] << 8);
    ip += 2;
    if (offset == 0 || op - dst < offset) return -1;
    int64_t mlen = token & 0xF;
    if (mlen == 15) {
      unsigned b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        mlen += b;
      } while (b == 255);
    }
    mlen += 4;
    if (op + mlen > oend) return -1;
    const uint8_t *mp = op - offset;
    // byte-wise copy: overlapping matches are the RLE case and must
    // propagate bytes written earlier in this same copy
    for (int64_t i = 0; i < mlen; i++) op[i] = mp[i];
    op += mlen;
  }
  return op - dst;
}

// Byte-unshuffle: src holds `typesize` planes of n/typesize bytes each;
// dst gets the interleaved original. (BLOSC applies shuffle per block.)
void blosc_unshuffle(const uint8_t *src, uint8_t *dst, int64_t n,
                     int64_t typesize) {
  int64_t per = n / typesize;
  for (int64_t t = 0; t < typesize; t++) {
    const uint8_t *s = src + t * per;
    uint8_t *d = dst + t;
    for (int64_t i = 0; i < per; i++) d[i * typesize] = s[i];
  }
}

// Byte-shuffle (the compression-side transpose of blosc_unshuffle).
void blosc_shuffle(const uint8_t *src, uint8_t *dst, int64_t n,
                   int64_t typesize) {
  int64_t per = n / typesize;
  for (int64_t t = 0; t < typesize; t++) {
    const uint8_t *s = src + t;
    uint8_t *d = dst + t * per;
    for (int64_t i = 0; i < per; i++) d[i] = s[i * typesize];
  }
}

// Greedy LZ4 block compressor (hash-table matcher), spec-compliant output:
//  * matches never start within the last 12 bytes (MFLIMIT),
//  * matches never extend into the last 5 bytes,
//  * final sequence is literals-only.
// Returns compressed size, or -1 when dst_cap would be exceeded (caller
// stores the block raw instead, which the BLOSC container supports).
int64_t lz4_compress_block(const uint8_t *src, int64_t n, uint8_t *dst,
                           int64_t dst_cap) {
  static const int64_t MFLIMIT = 12;
  static const int HASH_BITS = 16;
  int32_t htab[1 << HASH_BITS];
  for (int64_t i = 0; i < (1 << HASH_BITS); i++) htab[i] = -1;

  const uint8_t *ip = src;
  const uint8_t *anchor = src;
  uint8_t *op = dst;
  uint8_t *oend = dst + dst_cap;

  auto emit_len = [&](int64_t len) -> bool {
    while (len >= 255) {
      if (op >= oend) return false;
      *op++ = 255;
      len -= 255;
    }
    if (op >= oend) return false;
    *op++ = (uint8_t)len;
    return true;
  };
  auto emit_seq = [&](int64_t lit, const uint8_t *lits, int64_t mlen,
                      int64_t offset) -> bool {
    // token
    if (op >= oend) return false;
    uint8_t *token = op++;
    int64_t lcode = lit < 15 ? lit : 15;
    int64_t mcode = 0;
    if (mlen > 0) {
      mcode = (mlen - 4) < 15 ? (mlen - 4) : 15;
    }
    *token = (uint8_t)((lcode << 4) | mcode);
    if (lit >= 15 && !emit_len(lit - 15)) return false;
    if (op + lit > oend) return false;
    std::memcpy(op, lits, (size_t)lit);
    op += lit;
    if (mlen > 0) {
      if (op + 2 > oend) return false;
      *op++ = (uint8_t)(offset & 0xFF);
      *op++ = (uint8_t)(offset >> 8);
      if ((mlen - 4) >= 15 && !emit_len(mlen - 4 - 15)) return false;
    }
    return true;
  };

  if (n > MFLIMIT) {
    const uint8_t *mlimit = src + n - MFLIMIT;
    const uint8_t *match_end_limit = src + n - 5;
    while (ip < mlimit) {
      uint32_t seq;
      std::memcpy(&seq, ip, 4);
      uint32_t h = (seq * 2654435761u) >> (32 - HASH_BITS);
      int64_t cand = htab[h];
      htab[h] = (int32_t)(ip - src);
      uint32_t cseq;
      if (cand >= 0 && (ip - src) - cand <= 65535 &&
          (std::memcpy(&cseq, src + cand, 4), cseq == seq)) {
        const uint8_t *m = src + cand;
        const uint8_t *p = ip + 4;
        const uint8_t *q = m + 4;
        while (p < match_end_limit && *p == *q) {
          p++;
          q++;
        }
        int64_t mlen = p - ip;
        if (!emit_seq(ip - anchor, anchor, mlen, ip - m)) return -1;
        ip = p;
        anchor = p;
      } else {
        ip++;
      }
    }
  }
  if (!emit_seq((src + n) - anchor, anchor, 0, 0)) return -1;
  return op - dst;
}

}  // extern "C"

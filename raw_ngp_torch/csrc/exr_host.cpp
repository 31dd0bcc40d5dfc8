// The serial parts of raw_ngp_torch/data/exr.py and exr_dwa.py: the
// Huffman decode of a PIZ chunk (OpenEXR's hufUncompress), which a DWA
// chunk's STATIC_HUFFMAN AC values use too, and the expansion of a DWA
// chunk's AC runs. The bitmap, the LUT, the wavelet, the reordering and
// the DWA blocks' arithmetic are numpy in those modules, whose pure-Python
// loops are the oracles of these functions: the same values.
//
// The stream: im, iM, the table's length, the number of bits and a
// reserved word (five little-endian int32), the code lengths of symbols im
// to iM as 6-bit fields (59-62 a run of 2-5 unused symbols, 63 and 8 bits
// a run of 6-261), padded to a byte, then the codes, MSB first. Codes are
// canonical: the codes of one length are consecutive in symbol order, and
// a shorter code, padded with zeros, is numerically above every longer
// one. The symbol iM repeats the last value the number in the next 8 bits
// of times.
//
// Built with g++ at first use by raw_ngp_torch/native.py and bound with
// ctypes; a plain C interface, no dependency beyond the C++ library.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum {
  kOk = 0,
  kTruncated = 1,
  kBadTable = 2,
  kBadCode = 3,
  kBadCount = 4,
  kAcShort = 5,
  kAcRun = 6
};

constexpr int kEncSize = (1 << 16) + 1;
constexpr int kDecBits = 14;
constexpr int kDecSize = 1 << kDecBits;
constexpr int kDecMask = kDecSize - 1;

int32_t read_i32(const uint8_t* p) {
  uint32_t v = static_cast<uint32_t>(p[0]) |
               (static_cast<uint32_t>(p[1]) << 8) |
               (static_cast<uint32_t>(p[2]) << 16) |
               (static_cast<uint32_t>(p[3]) << 24);
  int32_t out;
  std::memcpy(&out, &v, 4);
  return out;
}

// the code lengths of symbols im..iM into `len`; `pos` moves past the
// table's last byte
int unpack_lengths(const uint8_t* data, int64_t size, int64_t* pos, int im,
                   int iM, std::vector<uint8_t>* len) {
  uint64_t c = 0;
  int lc = 0;
  int64_t p = *pos;
  for (int i = im; i <= iM;) {
    if (lc < 6) {
      if (p >= size) return kTruncated;
      c = (c << 8) | data[p++];
      lc += 8;
    }
    lc -= 6;
    int l = static_cast<int>((c >> lc) & 63);
    if (l >= 59) {
      int run;
      if (l == 63) {
        if (lc < 8) {
          if (p >= size) return kTruncated;
          c = (c << 8) | data[p++];
          lc += 8;
        }
        lc -= 8;
        run = static_cast<int>((c >> lc) & 255) + 6;
      } else {
        run = l - 59 + 2;
      }
      if (i + run > iM + 1) return kBadTable;
      i += run;
      continue;
    }
    (*len)[i++] = static_cast<uint8_t>(l);
  }
  *pos = p;
  return kOk;
}

struct Decoder {
  const uint8_t* data;
  int64_t size;
  int64_t pos;
  uint64_t c = 0;
  int lc = 0;
  uint16_t* out;
  int64_t n_out;
  int64_t at = 0;
  int rlc;

  int emit(int sym) {
    if (sym != rlc) {
      if (at >= n_out) return kBadCount;
      out[at++] = static_cast<uint16_t>(sym);
      return kOk;
    }
    if (lc < 8) {
      if (pos >= size) return kTruncated;
      c = (c << 8) | data[pos++];
      lc += 8;
    }
    lc -= 8;
    int run = static_cast<int>((c >> lc) & 255);
    if (at + run > n_out || at == 0) return kBadCount;
    uint16_t v = out[at - 1];
    for (int k = 0; k < run; ++k) out[at++] = v;
    return kOk;
  }
};

}  // namespace

extern "C" {

int exr_host_version() { return 1; }

// Decodes the PIZ Huffman stream data[0:size] into out[0:n_out]; returns 0,
// or 1 (the stream ends early), 2 (a malformed code table), 3 (an
// undefined code) or 4 (the wrong number of values).
int piz_huf_decode(const uint8_t* data, int64_t size, uint16_t* out,
                   int64_t n_out) {
  if (size < 20) return kTruncated;
  const int im = read_i32(data);
  const int iM = read_i32(data + 4);
  const int nbits = read_i32(data + 12);
  if (im < 0 || im >= kEncSize || iM < 0 || iM >= kEncSize || nbits < 0)
    return kBadTable;
  std::vector<uint8_t> len(kEncSize, 0);
  int64_t pos = 20;
  int rc = unpack_lengths(data, size, &pos, im, iM, &len);
  if (rc) return rc;
  if (nbits > 8 * (size - pos)) return kTruncated;

  // canonical codes
  uint64_t first[59] = {0};
  int64_t count[59] = {0};
  for (int i = 0; i < kEncSize; ++i) count[len[i]] += 1;
  uint64_t cc = 0;
  for (int l = 58; l > 0; --l) {
    uint64_t next = (cc + count[l]) >> 1;
    first[l] = cc;
    cc = next;
  }
  std::vector<uint64_t> code(kEncSize, 0);
  for (int i = 0; i < kEncSize; ++i)
    if (len[i]) code[i] = first[len[i]]++;

  // the 14-bit table: (length, symbol) of short codes; long codes listed
  // under the entry of their first 14 bits
  std::vector<uint8_t> short_len(kDecSize, 0);
  std::vector<int32_t> short_sym(kDecSize, 0);
  std::vector<std::vector<int32_t>> long_syms(kDecSize);
  for (int s = im; s <= iM; ++s) {
    const int l = len[s];
    const uint64_t k = code[s];
    if (l == 0) continue;
    if (k >> l) return kBadTable;
    if (l > kDecBits) {
      const uint64_t e = k >> (l - kDecBits);
      if (short_len[e]) return kBadTable;
      long_syms[e].push_back(s);
    } else {
      const uint64_t e = k << (kDecBits - l);
      for (uint64_t j = e; j < e + (1u << (kDecBits - l)); ++j) {
        if (short_len[j] || !long_syms[j].empty()) return kBadTable;
        short_len[j] = static_cast<uint8_t>(l);
        short_sym[j] = s;
      }
    }
  }

  Decoder d{data, size, pos};
  d.out = out;
  d.n_out = n_out;
  d.rlc = iM;
  const int64_t end = pos + (static_cast<int64_t>(nbits) + 7) / 8;
  while (d.pos < end) {
    d.c = (d.c << 8) | data[d.pos++];
    d.lc += 8;
    while (d.lc >= kDecBits) {
      const int e = static_cast<int>((d.c >> (d.lc - kDecBits)) & kDecMask);
      if (short_len[e]) {
        d.lc -= short_len[e];
        rc = d.emit(short_sym[e]);
        if (rc) return rc;
        continue;
      }
      bool found = false;
      for (int32_t s : long_syms[e]) {
        const int l = len[s];
        while (d.lc < l && d.pos < end) {
          d.c = (d.c << 8) | data[d.pos++];
          d.lc += 8;
        }
        if (d.lc >= l &&
            ((d.c >> (d.lc - l)) & ((uint64_t(1) << l) - 1)) == code[s]) {
          d.lc -= l;
          rc = d.emit(s);
          if (rc) return rc;
          found = true;
          break;
        }
      }
      if (!found) return kBadCode;
    }
  }
  const int pad = (8 - nbits) & 7;
  d.c >>= pad;
  d.lc -= pad;
  while (d.lc > 0) {
    const int e = static_cast<int>((d.c << (kDecBits - d.lc)) & kDecMask);
    if (!short_len[e] || short_len[e] > d.lc) return kBadCode;
    d.lc -= short_len[e];
    rc = d.emit(short_sym[e]);
    if (rc) return rc;
  }
  return d.at == n_out ? kOk : kBadCount;
}

// Expands the run-length code of a DWA chunk's AC values ac[0:n_ac] for
// n_blocks component blocks in stream order: each block's 63 AC halves
// (zig-zag positions 1-63) into out[64 k + 1 .. 64 k + 63], which the
// caller zeroes (position 0, the DC, is left alone), and the zig-zag index
// of its last literal into last[k] (0 for none). 0xff00 ends a block,
// 0xffnn (nn > 0) skips nn zeros, any other value is a literal. Returns 0
// with *used the number of values read, or 5 (the stream ends inside a
// block) or 6 (a run past the end of its block).
int dwa_unrle_ac(const uint16_t* ac, int64_t n_ac, int64_t n_blocks,
                 uint16_t* out, uint8_t* last, int64_t* used) {
  int64_t p = 0;
  for (int64_t k = 0; k < n_blocks; ++k) {
    uint16_t* block = out + 64 * k;
    int comp = 1, last_nonzero = 0;
    while (comp < 64) {
      if (p >= n_ac) return kAcShort;
      const uint16_t v = ac[p++];
      if (v == 0xff00) {
        comp = 64;
      } else if ((v >> 8) == 0xff) {
        comp += v & 0xff;
        if (comp > 64) return kAcRun;
      } else {
        last_nonzero = comp;
        block[comp++] = v;
      }
    }
    last[k] = static_cast<uint8_t>(last_nonzero);
  }
  *used = p;
  return kOk;
}

}  // extern "C"

// The serial parts of raw_ngp_torch/data/jpeg.py and data/dng.py: the
// Huffman entropy decode of one JPEG scan into the coefficient array
// (libjpeg-turbo's jdhuff.c and jdphuff.c), the entropy encode of
// quantised blocks (jchuff.c), and the entropy decode and prediction of a
// lossless JPEG scan (T.81 process 14). Everything else (markers, tables,
// the IDCT, upsampling, colour) is numpy in jpeg.py and dng.py, whose
// pure-Python decoders and encoder are the oracles of these functions:
// the same coefficients, samples and bytes.
//
// Built with g++ at first use by raw_ngp_torch/native.py and bound with
// ctypes; a plain C interface, no dependency beyond the C++ library.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

// jutils.c jpeg_natural_order, with 16 extra entries so that a corrupt run
// cannot index past the block
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

enum { kSequential, kDcFirst, kDcRefine, kAcFirst, kAcRefine };
enum { kOk = 0, kTruncated = 1, kBadCode = 2, kBadRestart = 3 };

// libjpeg's bit reader (jpeg_fill_bit_buffer): FF 00 is a data FF, FF
// fill bytes before a marker are skipped, and past a marker or the end of
// the data zero bits are fed and counted in `pad`; a read that takes a
// padding bit leaves cnt < pad.
struct BitReader {
  const uint8_t* data;
  int64_t size;
  int64_t pos;
  uint64_t buf = 0;
  int cnt = 0;
  int pad = 0;
  bool marker = false;

  void fill() {
    while (cnt <= 56) {
      int c = 0;
      if (marker || pos >= size) {
        marker = true;
        pad += 8;
      } else {
        c = data[pos];
        if (c == 0xFF) {
          int64_t p = pos + 1;
          while (p < size && data[p] == 0xFF) ++p;
          if (p < size && data[p] == 0) {
            pos = p + 1;
          } else {
            c = 0;
            marker = true;
            pad += 8;
          }
        } else {
          ++pos;
        }
      }
      buf = (buf << 8) | static_cast<uint64_t>(c);
      cnt += 8;
    }
  }

  uint32_t get(int k) {
    if (k == 0) return 0;
    if (cnt < k) fill();
    cnt -= k;
    return static_cast<uint32_t>(buf >> cnt) & ((1u << k) - 1);
  }

  // the symbol of the next code of a 16-bit lookahead table, or -1
  int decode(const uint16_t* lut) {
    if (cnt < 16) fill();
    uint16_t e = lut[(buf >> (cnt - 16)) & 0xFFFF];
    if (e == 0) return -1;
    cnt -= e >> 8;
    return e & 0xFF;
  }

  void restart() {
    buf = 0;
    cnt = pad = 0;
    marker = false;
  }
};

// tables: 16 code counts then up to 256 symbols (Annex C canonical codes);
// entry (length << 8) | symbol for every 16-bit window a code starts
void build_lut(const uint8_t* table, uint16_t* lut) {
  std::memset(lut, 0, 65536 * sizeof(uint16_t));
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < table[len - 1]; ++i, ++k, ++code) {
      int lo = code << (16 - len), hi = (code + 1) << (16 - len);
      uint16_t e = static_cast<uint16_t>((len << 8) | table[16 + k]);
      for (int w = lo; w < hi; ++w) lut[w] = e;
    }
    code <<= 1;
  }
}

inline int extend(uint32_t v, int s) {
  return v < (1u << (s - 1)) ? static_cast<int>(v) - (1 << s) + 1
                             : static_cast<int>(v);
}

// jdmarker.c next_marker from `pos`: the marker code, `pos` after it
int next_marker(const uint8_t* data, int64_t size, int64_t* pos) {
  int64_t p = *pos;
  for (;;) {
    while (p < size && data[p] != 0xFF) ++p;
    while (p < size && data[p] == 0xFF) ++p;
    if (p >= size) return -1;
    int c = data[p++];
    if (c != 0) {
      *pos = p;
      return c;
    }
  }
}

}  // namespace

extern "C" {

int jpeg_host_version() { return 1; }

// Decodes one scan. comp: n_comp rows of (h, v, stride, offset, dc table,
// ac table) in the scan's order; h, v are the blocks an MCU holds (1, 1
// in a one-component scan), stride and offset in blocks of 64 int16
// coefficients in natural order. tables: 8 slots (DC 0-3, AC 4-7) of 16
// counts and 256 symbols. Returns 0 and the position after the scan's
// data in *end_pos, or an error code.
int jpeg_decode_scan(const uint8_t* data, int64_t size, int64_t pos,
                     int n_comp, const int32_t* comp, const uint8_t* tables,
                     int mcux, int mcuy, int ss, int se, int al, int mode,
                     int restart_interval, int16_t* coef, int64_t* end_pos) {
  bool need_dc = mode == kSequential || mode == kDcFirst;
  bool need_ac = mode == kSequential || mode == kAcFirst || mode == kAcRefine;
  uint16_t* luts = static_cast<uint16_t*>(
      std::malloc(sizeof(uint16_t) * 65536 * 2 * n_comp));
  if (luts == nullptr) return kTruncated;
  for (int c = 0; c < n_comp; ++c) {
    if (need_dc) build_lut(tables + 272 * comp[6 * c + 4], luts + 65536 * (2 * c));
    if (need_ac)
      build_lut(tables + 272 * comp[6 * c + 5], luts + 65536 * (2 * c + 1));
  }
  BitReader br{data, size, pos};
  int last_dc[4] = {0, 0, 0, 0};
  int eobrun = 0;
  int todo = restart_interval, next_rst = 0;
  const int p1 = 1 << al, m1 = -(1 << al);
  int rc = kOk;
  for (int my = 0; my < mcuy && rc == kOk; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      if (restart_interval) {
        if (todo == 0) {
          int64_t p = br.pos;
          int code = next_marker(data, size, &p);
          if (code != 0xD0 + next_rst) {
            rc = code < 0 ? kTruncated : kBadRestart;
            break;
          }
          br.pos = p;
          br.restart();
          next_rst = (next_rst + 1) & 7;
          last_dc[0] = last_dc[1] = last_dc[2] = last_dc[3] = 0;
          eobrun = 0;
          todo = restart_interval;
        }
        --todo;
      }
      for (int c = 0; c < n_comp && rc == kOk; ++c) {
        const int32_t* ci = comp + 6 * c;
        const int h = ci[0], v = ci[1], stride = ci[2];
        const int64_t offset = ci[3];
        const uint16_t* dcl = luts + 65536 * (2 * c);
        const uint16_t* acl = luts + 65536 * (2 * c + 1);
        for (int yi = 0; yi < v && rc == kOk; ++yi) {
          for (int xi = 0; xi < h; ++xi) {
            int16_t* blk = coef + 64 * (offset +
                                        static_cast<int64_t>(my * v + yi) * stride +
                                        mx * h + xi);
            if (mode == kSequential || mode == kDcFirst) {
              int s = br.decode(dcl);
              if (s < 0) { rc = kBadCode; break; }
              if (s) s = extend(br.get(s), s);
              s += last_dc[c];
              last_dc[c] = s;
              if (mode == kDcFirst) {
                blk[0] = static_cast<int16_t>(s * (1 << al));
                continue;
              }
              blk[0] = static_cast<int16_t>(s);
              for (int k = 1; k < 64; ++k) {
                int rs = br.decode(acl);
                if (rs < 0) { rc = kBadCode; break; }
                int r = rs >> 4;
                s = rs & 15;
                if (s) {
                  k += r;
                  blk[kNatural[k]] = static_cast<int16_t>(extend(br.get(s), s));
                } else {
                  if (r != 15) break;
                  k += 15;
                }
              }
              if (rc != kOk) break;
            } else if (mode == kDcRefine) {
              if (br.get(1)) blk[0] = static_cast<int16_t>(blk[0] | p1);
            } else if (mode == kAcFirst) {
              if (eobrun > 0) {
                --eobrun;
                continue;
              }
              for (int k = ss; k <= se; ++k) {
                int rs = br.decode(acl);
                if (rs < 0) { rc = kBadCode; break; }
                int r = rs >> 4, s = rs & 15;
                if (s) {
                  k += r;
                  blk[kNatural[k]] =
                      static_cast<int16_t>(extend(br.get(s), s) * (1 << al));
                } else if (r == 15) {
                  k += 15;
                } else {
                  eobrun = 1 << r;
                  if (r) eobrun += static_cast<int>(br.get(r));
                  --eobrun;
                  break;
                }
              }
              if (rc != kOk) break;
            } else {  // kAcRefine
              int k = ss;
              if (eobrun == 0) {
                for (; k <= se; ++k) {
                  int rs = br.decode(acl);
                  if (rs < 0) { rc = kBadCode; break; }
                  int r = rs >> 4, s = rs & 15;
                  if (s) {
                    s = br.get(1) ? p1 : m1;
                  } else if (r != 15) {
                    eobrun = 1 << r;
                    if (r) eobrun += static_cast<int>(br.get(r));
                    break;
                  }
                  do {
                    int16_t* t = blk + kNatural[k];
                    if (*t != 0) {
                      if (br.get(1) && (*t & p1) == 0)
                        *t = static_cast<int16_t>(*t + (*t >= 0 ? p1 : m1));
                    } else {
                      if (--r < 0) break;
                    }
                    ++k;
                  } while (k <= se);
                  if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
                }
                if (rc != kOk) break;
              }
              if (eobrun > 0) {
                for (; k <= se; ++k) {
                  int16_t* t = blk + kNatural[k];
                  if (*t != 0 && br.get(1) && (*t & p1) == 0)
                    *t = static_cast<int16_t>(*t + (*t >= 0 ? p1 : m1));
                }
                --eobrun;
              }
            }
          }
        }
      }
      if (rc == kOk && br.cnt < br.pad) rc = kTruncated;
      if (rc != kOk) break;
    }
  }
  std::free(luts);
  *end_pos = br.pos;
  return rc;
}

// Encodes the band [ss, se] of n blocks (natural order) in order, block i
// with the tables of component owner[i] (tables: n_tables x [dc, ac] x
// [code, length] x 256 uint32): the DC (ss == 0) predicted from the
// component's previous block, the AC coefficients of the band in runs
// with an EOB after the band's last non-zero one; then flushes with one
// bits. 0xFF bytes are stuffed. [0, 63] is a sequential scan; [0, 0] and
// [1, 63] a progressive first scan (Al 0) with EOB runs of one. Returns
// the byte count, or -1 when `cap` bytes do not hold the output.
int64_t jpeg_encode_blocks(const int16_t* blocks, const int32_t* owner,
                           int64_t n, const uint32_t* tables, int n_tables,
                           int ss, int se, uint8_t* out, int64_t cap) {
  uint64_t acc = 0;
  int nacc = 0;
  int64_t len = 0;
  bool overflow = false;
  int last_dc[4] = {0, 0, 0, 0};
  auto emit = [&](uint32_t value, int nbits) {
    if (nbits == 0) return;
    acc = (acc << nbits) | (value & ((1u << nbits) - 1));
    nacc += nbits;
    while (nacc >= 8) {
      nacc -= 8;
      uint8_t byte = static_cast<uint8_t>(acc >> nacc);
      if (len + 2 > cap) {
        overflow = true;
        continue;
      }
      out[len++] = byte;
      if (byte == 0xFF) out[len++] = 0;
    }
  };
  for (int64_t i = 0; i < n && !overflow; ++i) {
    const int ci = owner[i];
    if (ci < 0 || ci >= n_tables || ci >= 4) return -2;
    const uint32_t* dc_code = tables + ci * 1024;
    const uint32_t* dc_size = dc_code + 256;
    const uint32_t* ac_code = dc_code + 512;
    const uint32_t* ac_size = dc_code + 768;
    const int16_t* blk = blocks + 64 * i;
    int mag, nbits;
    if (ss == 0) {
      int diff = blk[0] - last_dc[ci];
      last_dc[ci] = blk[0];
      mag = diff < 0 ? -diff : diff;
      nbits = 0;
      while (mag) { ++nbits; mag >>= 1; }
      emit(dc_code[nbits], static_cast<int>(dc_size[nbits]));
      emit(static_cast<uint32_t>(diff < 0 ? diff - 1 : diff), nbits);
    }
    int run = 0;
    for (int k = ss > 0 ? ss : 1; k <= se; ++k) {
      int v = blk[kNatural[k]];
      if (v == 0) {
        ++run;
        continue;
      }
      while (run > 15) {
        emit(ac_code[0xF0], static_cast<int>(ac_size[0xF0]));
        run -= 16;
      }
      mag = v < 0 ? -v : v;
      nbits = 1;
      while (mag >>= 1) ++nbits;
      int sym = (run << 4) | nbits;
      emit(ac_code[sym], static_cast<int>(ac_size[sym]));
      emit(static_cast<uint32_t>(v < 0 ? v - 1 : v), nbits);
      run = 0;
    }
    if (run > 0) emit(ac_code[0], static_cast<int>(ac_size[0]));
  }
  if (nacc > 0) emit(0x7F, 8 - nacc);
  return overflow ? -1 : len;
}

// Decodes the scan of one lossless JPEG stream (T.81 process 14, the
// entropy decode of jdlhuff.c and the prediction of jdlossls.c) into out
// [height, width * n_comp] uint16, the components interleaved along each
// line in the scan's order. table_of: each component's DC table slot
// (0-3) in `tables` (the 8-slot layout of jpeg_decode_scan). The first
// line, and the first line after each restart (restart_interval MCUs, a
// whole number of lines), is predicted by 2^(precision - pt - 1) at its
// first sample and by Ra after; every other line by Rb at its first
// sample and by `predictor` (1-7) after. Values are modulo 2^16, stored
// shifted left by pt. Returns 0 and the position after the scan's data in
// *end_pos, or an error code.
int lj92_decode_scan(const uint8_t* data, int64_t size, int64_t pos,
                     int n_comp, const int32_t* table_of,
                     const uint8_t* tables, int width, int height,
                     int predictor, int pt, int precision,
                     int restart_interval, uint16_t* out, int64_t* end_pos) {
  uint16_t* luts = static_cast<uint16_t*>(
      std::malloc(sizeof(uint16_t) * 65536 * n_comp));
  int32_t* buf = static_cast<int32_t*>(
      std::malloc(sizeof(int32_t) * 2 * width * n_comp));
  if (luts == nullptr || buf == nullptr) {
    std::free(luts);
    std::free(buf);
    return kTruncated;
  }
  for (int c = 0; c < n_comp; ++c)
    build_lut(tables + 272 * table_of[c], luts + 65536 * c);
  const int64_t n = static_cast<int64_t>(width) * n_comp;
  int32_t* prev = buf;
  int32_t* row = buf + n;
  const int half = 1 << (precision - pt - 1);
  const int lines = restart_interval ? restart_interval / width : 0;
  BitReader br{data, size, pos};
  int next_rst = 0;
  bool first = true;
  int rc = kOk;
  for (int y = 0; y < height && rc == kOk; ++y) {
    if (lines && y && y % lines == 0) {
      int64_t p = br.pos;
      int code = next_marker(data, size, &p);
      if (code != 0xD0 + next_rst) {
        rc = code < 0 ? kTruncated : kBadRestart;
        break;
      }
      br.pos = p;
      br.restart();
      next_rst = (next_rst + 1) & 7;
      first = true;
    }
    for (int64_t i = 0; i < n; ++i) {
      const int t = br.decode(luts + 65536 * (i % n_comp));
      if (t < 0) {
        rc = kBadCode;
        break;
      }
      int d = 0;
      if (t == 16) {
        d = 32768;
      } else if (t) {
        d = extend(br.get(t), t);
      }
      int px;
      if (first) {
        px = i < n_comp ? half : row[i - n_comp];
      } else if (i < n_comp) {
        px = prev[i];
      } else {
        const int ra = row[i - n_comp], rb = prev[i], rc_ = prev[i - n_comp];
        switch (predictor) {
          case 1: px = ra; break;
          case 2: px = rb; break;
          case 3: px = rc_; break;
          case 4: px = ra + rb - rc_; break;
          case 5: px = ra + ((rb - rc_) >> 1); break;
          case 6: px = rb + ((ra - rc_) >> 1); break;
          default: px = (ra + rb) >> 1; break;
        }
      }
      row[i] = (px + d) & 0xFFFF;
    }
    if (rc != kOk) break;
    if (br.cnt < br.pad) {
      rc = kTruncated;
      break;
    }
    uint16_t* o = out + static_cast<int64_t>(y) * n;
    for (int64_t i = 0; i < n; ++i)
      o[i] = static_cast<uint16_t>(static_cast<uint32_t>(row[i]) << pt);
    int32_t* t = prev;
    prev = row;
    row = t;
    first = false;
  }
  std::free(buf);
  std::free(luts);
  *end_pos = br.pos;
  return rc;
}

}  // extern "C"

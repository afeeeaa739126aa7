// Sequential-Huffman JPEG decoder with libjpeg-turbo's arithmetic, so that
// its output equals cv2.imread's (libjpeg-turbo, default decompression
// parameters) bit for bit:
//
//   * baseline and extended sequential Huffman frames (SOF0 / SOF1), 8-bit
//     samples, 1 or 3 components, any sampling factors, interleaved or
//     not, several scans; restart intervals (DC predictors reset, the
//     decoder's resync rules for a missing or misplaced RSTn), byte
//     stuffing, fill bytes; a segment that runs out of data is padded
//     with zero bits, and the MCUs after the one that needed the padding
//     stay zero (uniform gray) until the next restart (jdhuff.c);
//   * progressive Huffman frames (SOF2) as jdphuff.c decodes them: DC
//     first and refinement scans, AC first scans with EOB runs, AC
//     refinement scans (correction bits, the zero-run rules), spectral
//     selection and successive approximation, restart intervals in every
//     scan type (the EOB run reset too), the MCUs after a segment ran out
//     left as they were. The whole file is read before the IDCT, as
//     jpeg_start_decompress reads a multi-scan file; libjpeg smooths the
//     blocks (jdcoefct.c) only where coefficients 1-9 of a component are
//     not yet complete at that point, and such a file raises here;
//   * dequantisation and the accurate integer IDCT, jidctint.c's
//     jpeg_idct_islow (CONST_BITS 13, PASS1_BITS 2), clamped to 0..255
//     after the +128 level shift;
//   * "fancy" upsampling (jdsample.c): h2v1 and h2v2 triangular filters
//     for components wider than 2 samples, h1v2, plain replication for
//     every other integral ratio; the row above the first and below the
//     last real row replicate them (jdmainct.c's context pointers);
//   * YCbCr -> RGB through jdcolor.c's fixed-point tables (SCALEBITS 16),
//     RGB -> Y (rgb_gray_convert), Y passed through for a gray read, a
//     gray file replicated for a colour read.
//
// The colour space is named by the caller (jpeg.py guesses it from the
// markers as libjpeg's default_decompress_parms does), and so is EXIF
// orientation, which jpeg.py applies. Plain C interface for ctypes;
// nothing here touches Python, so ctypes releases the GIL for the call.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

constexpr int kErrLen = 256;

// jpeg_natural_order plus the 16 guard entries libjpeg keeps for corrupt
// data that runs a block past its 64th coefficient
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Failure {
  char msg[kErrLen];
};

[[noreturn]] void fail(const char* fmt, int a = 0, int b = 0) {
  Failure f;
  std::snprintf(f.msg, sizeof f.msg, fmt, a, b);
  throw f;
}

// jdhuff.c's derived table: maxcode / valoffset per code length
struct Huff {
  bool defined = false;
  uint8_t vals[256] = {};
  long maxcode[18] = {};
  long valoffset[18] = {};
  // 9-bit lookahead: (length << 8) | symbol, length 0 when longer than 9
  uint16_t look[512] = {};
};

void build_huff(Huff& h, const uint8_t* bits, const uint8_t* vals, int n,
                bool dc) {
  int huffsize[257];
  unsigned huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < bits[l - 1]; i++) huffsize[p++] = l;
  huffsize[p] = 0;
  unsigned code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1u << si)) fail("bad Huffman table");
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (bits[l - 1]) {
      h.valoffset[l] = (long)p - (long)huffcode[p];
      p += bits[l - 1];
      h.maxcode[l] = huffcode[p - 1];
    } else {
      h.maxcode[l] = -1;
    }
  }
  h.valoffset[17] = 0;
  h.maxcode[17] = 0xFFFFFL;
  std::memset(h.vals, 0, sizeof h.vals);
  std::memcpy(h.vals, vals, n);
  if (dc)
    for (int i = 0; i < n; i++)
      if (vals[i] > 15) fail("bad Huffman table");
  std::memset(h.look, 0, sizeof h.look);
  p = 0;
  for (int l = 1; l <= 9; l++) {
    for (int i = 0; i < bits[l - 1]; i++, p++) {
      int lookbits = huffcode[p] << (9 - l);
      for (int ctr = 1 << (9 - l); ctr > 0; ctr--)
        h.look[lookbits++] = (uint16_t)((l << 8) | vals[p]);
    }
  }
  h.defined = true;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  // bits of each coefficient not yet sent by a progressive scan (the
  // last scan's Al), -1 before any scan (libjpeg's coef_bits)
  int coef_bits[64];
  int bw = 0, bh = 0;    // block grid (padded to whole MCUs)
  int dw = 0, dh = 0;    // downsampled size (real samples)
  bool latched = false;  // quant table copied at the first scan
  uint16_t q[64] = {};   // natural order
  std::vector<int16_t> coef;  // bw * bh blocks of 64, natural order
};

// Entropy-coded segment reader with libjpeg's semantics: a marker or the
// end of the data stops the byte stream; bits past it read as zero, and
// consuming one sets `insufficient` (jpeg_fill_bit_buffer).
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;  // left-aligned
  int nbits = 0;     // bits in buf (real ones first)
  int real = 0;      // real bits in buf
  int marker = 0;    // the marker that stopped the stream, 0 none
  const uint8_t* mark = nullptr;  // its 0xFF, or `end` at the end of data
  bool insufficient = false;

  // a marker code just read at p[-1] (or the end of the data: fake EOI)
  int found(int code, bool eof) {
    marker = code;
    mark = eof ? end : p - 2;
    return code;
  }

  void fill() {
    while (nbits <= 56 && marker == 0) {
      if (p >= end) {
        found(0xD9, true);  // the stdio source's fake EOI
        break;
      }
      int c = *p++;
      if (c == 0xFF) {
        while (p < end && *p == 0xFF) p++;
        if (p >= end) {
          found(0xD9, true);
          break;
        }
        int c2 = *p++;
        if (c2 != 0) {
          found(c2, false);
          break;
        }
      }
      buf |= (uint64_t)c << (56 - nbits);
      nbits += 8;
      real += 8;
    }
  }
  unsigned peek(int n) {
    if (nbits < n) {
      fill();
      if (nbits < n) nbits = n;  // zero padding
    }
    return (unsigned)(buf >> (64 - n));
  }
  void skip(int n) {
    if (n > real) {
      insufficient = true;
      real = 0;
    } else {
      real -= n;
    }
    buf <<= n;
    nbits -= n;
  }
  unsigned get(int n) {
    if (n == 0) return 0;
    unsigned v = peek(n);
    skip(n);
    return v;
  }
  int decode(const Huff& h) {
    unsigned look = peek(9);
    int e = h.look[look];
    if (e >> 8) {
      skip(e >> 8);
      return e & 0xFF;
    }
    // slow path, bit by bit as jpeg_huff_decode
    long code = get(1);
    int l = 1;
    while (code > h.maxcode[l]) {
      code = (code << 1) | get(1);
      l++;
    }
    if (l > 16) return 0;  // bad code: libjpeg fakes a zero
    return h.vals[(int)(code + h.valoffset[l])];
  }
  // jdmarker.c's next_marker from the current byte: skip to 0xFF, past
  // fill bytes, over stuffed zeros
  int next_marker() {
    for (;;) {
      while (p < end && *p != 0xFF) p++;
      while (p < end && *p == 0xFF) p++;
      if (p >= end) return found(0xD9, true);
      int c = *p++;
      if (c != 0) return found(c, false);
    }
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// jdmarker.c's jpeg_resync_to_restart
void resync(Bits& br, int desired) {
  for (;;) {
    int m = br.marker;
    int action;
    if (m < 0xC0) {
      action = 2;
    } else if (m < 0xD0 || m > 0xD7) {
      action = 3;
    } else if (m == 0xD0 + ((desired + 1) & 7) ||
               m == 0xD0 + ((desired + 2) & 7)) {
      action = 3;
    } else if (m == 0xD0 + ((desired - 1) & 7) ||
               m == 0xD0 + ((desired - 2) & 7)) {
      action = 2;
    } else {
      action = 1;
    }
    if (action == 1) {
      br.marker = 0;
      return;
    }
    if (action == 3) return;
    br.next_marker();
  }
}

struct Decoder {
  const uint8_t* data;
  long size;
  long pos = 0;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int mcux = 0, mcuy = 0;
  bool frame = false, progressive = false;
  int restart_interval = 0;
  Component comp[4];
  uint16_t qt[4][64];
  bool qt_defined[4] = {};
  Huff dc[4], ac[4];

  int byte() {
    if (pos >= size) fail("the file ends inside a marker segment");
    return data[pos++];
  }
  int word() {
    int a = byte();
    return (a << 8) | byte();
  }

  void read_dqt(long end) {
    while (pos < end) {
      int pq = byte();
      int t = pq & 15, prec = pq >> 4;
      if (t > 3) fail("bad quantization table id %d", t);
      for (int i = 0; i < 64; i++)
        qt[t][kNatural[i]] = (uint16_t)(prec ? word() : byte());
      qt_defined[t] = true;
    }
  }

  void read_dht(long end) {
    while (pos < end) {
      int tc = byte();
      int cls = tc >> 4, t = tc & 15;
      if (cls > 1 || t > 3) fail("bad Huffman table id 0x%02x", tc);
      uint8_t bits[16], vals[256];
      int n = 0;
      for (int i = 0; i < 16; i++) n += bits[i] = (uint8_t)byte();
      if (n > 256) fail("bad Huffman table");
      for (int i = 0; i < n; i++) vals[i] = (uint8_t)byte();
      build_huff(cls ? ac[t] : dc[t], bits, vals, n, cls == 0);
    }
  }

  void read_sof(long end, bool prog) {
    if (frame) fail("two frame headers");
    progressive = prog;
    int precision = byte();
    height = word();
    width = word();
    ncomp = byte();
    if (precision != 8) fail("%d-bit samples", precision);
    if (height <= 0 || width <= 0) fail("empty image");
    if (ncomp != 1 && ncomp != 3) fail("%d components", ncomp);
    if (pos + 3 * ncomp > end) fail("bad frame header");
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("bad sampling factors or table of component %d", i);
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = (int)(((long)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((long)height * c.v + vmax - 1) / vmax);
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
    }
    frame = true;
  }

  void decode_block(Bits& br, int16_t* blk, int& pred, const Huff& hd,
                    const Huff& ha) {
    int s = br.decode(hd);
    int diff = s ? extend((int)br.get(s), s) : 0;
    pred += diff;
    blk[0] = (int16_t)pred;
    for (int k = 1; k < 64; k++) {
      int rs = br.decode(ha);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = (int16_t)extend((int)br.get(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // jdphuff.c's four progressive block decoders
  static void dc_first(Bits& br, int16_t* blk, int& pred, const Huff& hd,
                       int al) {
    int s = br.decode(hd);
    pred += s ? extend((int)br.get(s), s) : 0;
    blk[0] = (int16_t)((unsigned)pred << al);
  }

  static void dc_refine(Bits& br, int16_t* blk, int al) {
    if (br.get(1)) blk[0] = (int16_t)(blk[0] | (1 << al));
  }

  static void ac_first(Bits& br, int16_t* blk, const Huff& ha, int ss,
                       int se, int al, int& eobrun) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    for (int k = ss; k <= se; k++) {
      int rs = br.decode(ha);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        int v = extend((int)br.get(s), s);
        blk[kNatural[k]] = (int16_t)((unsigned)v << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += (int)br.get(r);
        eobrun--;
        break;
      }
    }
  }

  // a correction bit raises the magnitude of a coefficient already
  // nonzero by one in bit al, unless an earlier pass of this scan did
  static void correct(Bits& br, int16_t& c, int p1, int m1) {
    if (br.get(1) && (c & p1) == 0) c = (int16_t)(c + (c >= 0 ? p1 : m1));
  }

  static void ac_refine(Bits& br, int16_t* blk, const Huff& ha, int ss,
                        int se, int al, int& eobrun) {
    int p1 = 1 << al, m1 = (int)(~0u << al);
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; k++) {
        int rs = br.decode(ha);
        int r = rs >> 4, s = rs & 15;
        if (s) {  // a newly nonzero coefficient: its sign (size 1)
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += (int)br.get(r);
          break;  // the band's rest is the EOB run's
        }
        // over the nonzero coefficients (a correction bit each) and r
        // zero ones, to the zero one that takes s
        do {
          int16_t& c = blk[kNatural[k]];
          if (c != 0) {
            correct(br, c, p1, m1);
          } else if (--r < 0) {
            break;
          }
          k++;
        } while (k <= se);
        if (s) blk[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t& c = blk[kNatural[k]];
        if (c != 0) correct(br, c, p1, m1);
      }
      eobrun--;
    }
  }

  // one scan; `pos` is just past its header
  void read_scan(long hdr_end) {
    if (!frame) fail("a scan before the frame header");
    int ns = byte();
    if (ns < 1 || ns > 4) fail("bad scan header");
    int idx[4], td[4], ta[4];
    for (int i = 0; i < ns; i++) {
      int cid = byte(), t = byte();
      idx[i] = -1;
      for (int j = 0; j < ncomp; j++)
        if (comp[j].id == cid) idx[i] = j;
      if (idx[i] < 0) fail("scan names an unknown component %d", cid);
      td[i] = t >> 4;
      ta[i] = t & 15;
      if (td[i] > 3 || ta[i] > 3) fail("bad Huffman table id");
    }
    int ss = byte(), se = byte(), ahl = byte();
    int ah = ahl >> 4, al = ahl & 15;
    pos = hdr_end;  // a sequential scan's Ss, Se, Ah / Al mean nothing
    bool dc_band = ss == 0;
    if (progressive) {
      // jdphuff.c start_pass_phuff_decoder: the legal progressions
      bool bad = dc_band ? se != 0 : (ss > se || se > 63 || ns != 1);
      if ((ah != 0 && al != ah - 1) || al > 13 || bad)
        fail("bad progression: Ss %d Se %d", ss, se);
    }
    for (int i = 0; i < ns; i++) {
      bool need_dc = !progressive || (dc_band && ah == 0);
      bool need_ac = !progressive || !dc_band;
      if ((need_dc && !dc[td[i]].defined) || (need_ac && !ac[ta[i]].defined))
        fail("scan uses an undefined Huffman table");
      if (progressive)
        for (int k = ss; k <= se; k++) comp[idx[i]].coef_bits[k] = al;
    }
    for (int i = 0; i < ns; i++) {
      Component& c = comp[idx[i]];
      if (!c.latched) {
        if (!qt_defined[c.tq]) fail("undefined quantization table %d", c.tq);
        std::memcpy(c.q, qt[c.tq], sizeof c.q);
        c.latched = true;
      }
    }
    int blocks_in_mcu = 0;
    for (int i = 0; i < ns; i++) blocks_in_mcu += comp[idx[i]].h * comp[idx[i]].v;
    if (ns > 1 && blocks_in_mcu > 10) fail("too many blocks in an MCU");

    Bits br;
    br.p = data + pos;
    br.end = data + size;
    int pred[4] = {0, 0, 0, 0};
    int eobrun = 0;
    int next_rst = 0;
    int togo = restart_interval;
    // non-interleaved: one block per MCU over the component's own grid
    int units_x, units_y;
    if (ns == 1) {
      units_x = (comp[idx[0]].dw + 7) / 8;
      units_y = (comp[idx[0]].dh + 7) / 8;
    } else {
      units_x = mcux;
      units_y = mcuy;
    }
    long total = (long)units_x * units_y;
    for (long m = 0; m < total; m++) {
      if (restart_interval) {
        if (togo == 0) {
          // process_restart: drop the buffered bits, read RSTn
          br.buf = 0;
          br.nbits = br.real = 0;
          if (br.marker == 0) br.next_marker();
          if (br.marker == 0xD0 + next_rst) {
            br.marker = 0;
          } else {
            resync(br, next_rst);
          }
          next_rst = (next_rst + 1) & 7;
          for (int& x : pred) x = 0;
          eobrun = 0;
          togo = restart_interval;
          if (br.marker == 0) br.insufficient = false;
        }
        togo--;
      }
      // out of data: a sequential MCU stays zero, a progressive one as
      // the earlier scans left it
      if (br.insufficient) continue;
      int mx = (int)(m % units_x), my = (int)(m / units_x);
      for (int i = 0; i < ns; i++) {
        Component& c = comp[idx[i]];
        int reps_y = ns == 1 ? 1 : c.v, reps_x = ns == 1 ? 1 : c.h;
        for (int yy = 0; yy < reps_y; yy++)
          for (int xx = 0; xx < reps_x; xx++) {
            int bx = mx * reps_x + xx, by = my * reps_y + yy;
            int16_t* blk = &c.coef[((size_t)by * c.bw + bx) * 64];
            if (!progressive)
              decode_block(br, blk, pred[i], dc[td[i]], ac[ta[i]]);
            else if (dc_band && ah == 0)
              dc_first(br, blk, pred[i], dc[td[i]], al);
            else if (dc_band)
              dc_refine(br, blk, al);
            else if (ah == 0)
              ac_first(br, blk, ac[ta[i]], ss, se, al, eobrun);
            else
              ac_refine(br, blk, ac[ta[i]], ss, se, al, eobrun);
          }
      }
    }
    // marker parsing resumes at the marker that ended the segment
    pos = (br.marker ? br.mark : br.p) - data;
  }

  void run() {
    if (size < 4 || data[0] != 0xFF || data[1] != 0xD8) fail("no SOI marker");
    pos = 2;
    for (;;) {
      // next marker (jdmarker.c next_marker: skip garbage and fill bytes)
      while (pos < size && data[pos] != 0xFF) pos++;
      while (pos < size && data[pos] == 0xFF) pos++;
      if (pos >= size) break;  // the stdio source's fake EOI
      int m = data[pos++];
      if (m == 0x00) continue;
      if (m == 0xD9) break;
      if (m >= 0xD0 && m <= 0xD7) continue;
      if (m == 0x01) continue;
      long len = word();
      if (len < 2) fail("bad marker length");
      long end = pos + len - 2;
      if (end > size) fail("the file ends inside marker 0x%02x", m);
      switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
          read_sof(end, m == 0xC2);
          break;
        case 0xC4:
          read_dht(end);
          break;
        case 0xDB:
          read_dqt(end);
          break;
        case 0xDD:
          restart_interval = word();
          break;
        case 0xDA:
          read_scan(end);
          continue;  // pos is at the marker after the scan
        case 0xC3: case 0xC5: case 0xC6: case 0xC7: case 0xC9:
        case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF: case 0xCC:
          fail("unsupported frame type SOF marker 0x%02x", m);
        default:
          break;  // APPn, COM, DNL, ...: skipped
      }
      pos = end;
    }
    if (!frame) fail("no frame header");
    // jdcoefct.c smoothing_ok: libjpeg smooths the blocks of a file whose
    // scans left coefficients 1-9 of a component short, when every
    // component has a DC scan and nonzero quantizers for them
    bool smooth = progressive, useful = false;
    for (int i = 0; i < ncomp; i++) {
      const Component& c = comp[i];
      if (!c.latched || c.coef_bits[0] < 0) smooth = false;
      for (int k = 0; k < 10; k++) {
        if (c.latched && c.q[kNatural[k]] == 0) smooth = false;
        if (k && c.coef_bits[k] != 0) useful = true;
      }
    }
    if (smooth && useful)
      fail("progressive scans end before the first 10 coefficients are "
           "complete (libjpeg's block smoothing is not ported)");
  }
};

// jidctint.c jpeg_idct_islow, output clamped to 0..255
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr long F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
               F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
               F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

inline long descale(long x, int n) { return (x + (1L << (n - 1))) >> n; }
inline uint8_t clamp255(long x) {
  return (uint8_t)(x < 0 ? 0 : (x > 255 ? 255 : x));
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
        !ip[56]) {
      int dcval = (int)((long)ip[0] * (int16_t)qp[0] * (1 << kPass1Bits));
      for (int r = 0; r < 8; r++) wp[8 * r] = dcval;
      continue;
    }
    long z2 = (long)ip[16] * (int16_t)qp[16];
    long z3 = (long)ip[48] * (int16_t)qp[48];
    long z1 = (z2 + z3) * F0541;
    long tmp2 = z1 + z3 * (-F1847);
    long tmp3 = z1 + z2 * F0765;
    z2 = (long)ip[0] * (int16_t)qp[0];
    z3 = (long)ip[32] * (int16_t)qp[32];
    long tmp0 = (z2 + z3) * (1L << kConstBits);
    long tmp1 = (z2 - z3) * (1L << kConstBits);
    long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (long)ip[56] * (int16_t)qp[56];
    tmp1 = (long)ip[40] * (int16_t)qp[40];
    tmp2 = (long)ip[24] * (int16_t)qp[24];
    tmp3 = (long)ip[8] * (int16_t)qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    long z4 = tmp1 + tmp3;
    long z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    wp[0] = (int)descale(tmp10 + tmp3, sh);
    wp[56] = (int)descale(tmp10 - tmp3, sh);
    wp[8] = (int)descale(tmp11 + tmp2, sh);
    wp[48] = (int)descale(tmp11 - tmp2, sh);
    wp[16] = (int)descale(tmp12 + tmp1, sh);
    wp[40] = (int)descale(tmp12 - tmp1, sh);
    wp[24] = (int)descale(tmp13 + tmp0, sh);
    wp[32] = (int)descale(tmp13 - tmp0, sh);
  }
  for (int r = 0; r < 8; r++) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + (size_t)r * stride;
    const int sh = kConstBits + kPass1Bits + 3;
    long z2 = wp[2], z3 = wp[6];
    long z1 = (z2 + z3) * F0541;
    long tmp2 = z1 + z3 * (-F1847);
    long tmp3 = z1 + z2 * F0765;
    long tmp0 = ((long)wp[0] + wp[4]) * (1L << kConstBits);
    long tmp1 = ((long)wp[0] - wp[4]) * (1L << kConstBits);
    long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    long z4 = tmp1 + tmp3;
    long z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = clamp255(descale(tmp10 + tmp3, sh) + 128);
    op[7] = clamp255(descale(tmp10 - tmp3, sh) + 128);
    op[1] = clamp255(descale(tmp11 + tmp2, sh) + 128);
    op[6] = clamp255(descale(tmp11 - tmp2, sh) + 128);
    op[2] = clamp255(descale(tmp12 + tmp1, sh) + 128);
    op[5] = clamp255(descale(tmp12 - tmp1, sh) + 128);
    op[3] = clamp255(descale(tmp13 + tmp0, sh) + 128);
    op[4] = clamp255(descale(tmp13 - tmp0, sh) + 128);
  }
}

// one component's samples, (bh * 8) x (bw * 8)
std::vector<uint8_t> component_plane(const Component& c) {
  int stride = c.bw * 8;
  std::vector<uint8_t> plane((size_t)stride * c.bh * 8, 0);
  int nbx = (c.dw + 7) / 8, nby = (c.dh + 7) / 8;
  for (int by = 0; by < nby; by++)
    for (int bx = 0; bx < nbx; bx++)
      idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], c.q,
                 &plane[(size_t)by * 8 * stride + bx * 8], stride);
  return plane;
}

// jdsample.c: the component upsampled to (height, width)
void upsample(const Component& c, int hmax, int vmax, int width, int height,
              uint8_t* out) {
  std::vector<uint8_t> plane = component_plane(c);
  const int stride = c.bw * 8;
  const int dw = c.dw, dh = c.dh;
  auto row = [&](int y) {  // context rows replicate the edges
    y = std::max(0, std::min(y, dh - 1));
    return &plane[(size_t)y * stride];
  };
  std::vector<uint8_t> wide((size_t)2 * dw + 8);
  if (c.h == hmax && c.v == vmax) {
    for (int y = 0; y < height; y++)
      std::memcpy(out + (size_t)y * width, row(y), width);
  } else if (2 * c.h == hmax && c.v == vmax && dw > 2) {  // h2v1 fancy
    for (int y = 0; y < height; y++) {
      const uint8_t* in = row(y);
      uint8_t* o = wide.data();
      int iv = in[0];
      *o++ = (uint8_t)iv;
      *o++ = (uint8_t)((iv * 3 + in[1] + 2) >> 2);
      for (int i = 1; i < dw - 1; i++) {
        iv = in[i] * 3;
        *o++ = (uint8_t)((iv + in[i - 1] + 1) >> 2);
        *o++ = (uint8_t)((iv + in[i + 1] + 2) >> 2);
      }
      iv = in[dw - 1];
      *o++ = (uint8_t)((iv * 3 + in[dw - 2] + 1) >> 2);
      *o++ = (uint8_t)iv;
      std::memcpy(out + (size_t)y * width, wide.data(), width);
    }
  } else if (c.h == hmax && 2 * c.v == vmax) {  // h1v2 fancy
    for (int y = 0; y < height; y++) {
      int in_row = y / 2, v = y & 1;
      const uint8_t* near = row(in_row);
      const uint8_t* far = row(v ? in_row + 1 : in_row - 1);
      int bias = v ? 2 : 1;
      uint8_t* o = out + (size_t)y * width;
      for (int x = 0; x < width; x++)
        o[x] = (uint8_t)((near[x] * 3 + far[x] + bias) >> 2);
    }
  } else if (2 * c.h == hmax && 2 * c.v == vmax && dw > 2) {  // h2v2 fancy
    for (int y = 0; y < height; y++) {
      int in_row = y / 2, v = y & 1;
      const uint8_t* i0 = row(in_row);
      const uint8_t* i1 = row(v ? in_row + 1 : in_row - 1);
      uint8_t* o = wide.data();
      int this_sum = i0[0] * 3 + i1[0];
      int next_sum = i0[1] * 3 + i1[1];
      *o++ = (uint8_t)((this_sum * 4 + 8) >> 4);
      *o++ = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
      int last_sum = this_sum;
      this_sum = next_sum;
      for (int i = 2; i < dw; i++) {
        next_sum = i0[i] * 3 + i1[i];
        *o++ = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
        *o++ = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
      }
      *o++ = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
      *o++ = (uint8_t)((this_sum * 4 + 7) >> 4);
      std::memcpy(out + (size_t)y * width, wide.data(), width);
    }
  } else if (hmax % c.h == 0 && vmax % c.v == 0) {  // replication
    int hr = hmax / c.h, vr = vmax / c.v;
    // the replicated rows come from the decoded plane, padding included
    for (int y = 0; y < height; y++) {
      const uint8_t* in = &plane[(size_t)(y / vr) * stride];
      uint8_t* o = out + (size_t)y * width;
      for (int x = 0; x < width; x++) o[x] = in[x / hr];
    }
  } else {
    fail("fractional sampling factors are not supported");
  }
}

// jdcolor.c's tables
constexpr int kScaleBits = 16;
constexpr long kHalf = 1L << (kScaleBits - 1);
inline long fix(double x) { return (long)(x * (1L << kScaleBits) + 0.5); }

void ycc_to_rgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                size_t n, uint8_t* out) {
  int cr_r[256], cb_b[256];
  long cr_g[256], cb_g[256];
  for (int i = 0; i < 256; i++) {
    long x = i - 128;
    cr_r[i] = (int)((fix(1.40200) * x + kHalf) >> kScaleBits);
    cb_b[i] = (int)((fix(1.77200) * x + kHalf) >> kScaleBits);
    cr_g[i] = -fix(0.71414) * x;
    cb_g[i] = -fix(0.34414) * x + kHalf;
  }
  for (size_t i = 0; i < n; i++) {
    int yy = y[i];
    out[3 * i] = clamp255(yy + cr_r[cr[i]]);
    out[3 * i + 1] = clamp255(yy + (int)((cb_g[cb[i]] + cr_g[cr[i]]) >>
                                         kScaleBits));
    out[3 * i + 2] = clamp255(yy + cb_b[cb[i]]);
  }
}

void rgb_to_gray(const uint8_t* r, const uint8_t* g, const uint8_t* b,
                 size_t n, uint8_t* out) {
  long ry[256], gy[256], by[256];
  for (int i = 0; i < 256; i++) {
    ry[i] = fix(0.29900) * i;
    gy[i] = fix(0.58700) * i;
    by[i] = fix(0.11400) * i + kHalf;
  }
  for (size_t i = 0; i < n; i++)
    out[i] = (uint8_t)((ry[r[i]] + gy[g[i]] + by[b[i]]) >> kScaleBits);
}

}  // namespace

extern "C" {

// Decode `data` into `out`: (height, width) for gray != 0, else
// (height, width, 3) RGB. `rgb_space` != 0 says that a 3-component file
// holds RGB (libjpeg's JCS_RGB), else YCbCr. height / width must be the
// frame's. Returns 0, or 1 with a message in `err` (256 bytes).
int sigma_jpeg_decode(const uint8_t* data, long size, int gray,
                      int rgb_space, uint8_t* out, int height, int width,
                      char* err) {
  try {
    Decoder d;
    d.data = data;
    d.size = size;
    d.run();
    if (d.height != height || d.width != width)
      fail("frame size %dx%d differs from the header's", d.width, d.height);
    size_t n = (size_t)height * width;
    if (d.ncomp == 1) {
      std::vector<uint8_t> y(n);
      upsample(d.comp[0], d.hmax, d.vmax, width, height, y.data());
      if (gray) {
        std::memcpy(out, y.data(), n);
      } else {
        for (size_t i = 0; i < n; i++)
          out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
      }
      return 0;
    }
    if (gray && !rgb_space) {  // JCS_GRAYSCALE from YCbCr: Y alone
      upsample(d.comp[0], d.hmax, d.vmax, width, height, out);
      return 0;
    }
    std::vector<uint8_t> planes(3 * n);
    for (int i = 0; i < 3; i++)
      upsample(d.comp[i], d.hmax, d.vmax, width, height, &planes[i * n]);
    const uint8_t *p0 = &planes[0], *p1 = &planes[n], *p2 = &planes[2 * n];
    if (gray) {
      rgb_to_gray(p0, p1, p2, n, out);
    } else if (rgb_space) {
      for (size_t i = 0; i < n; i++) {
        out[3 * i] = p0[i];
        out[3 * i + 1] = p1[i];
        out[3 * i + 2] = p2[i];
      }
    } else {
      ycc_to_rgb(p0, p1, p2, n, out);
    }
    return 0;
  } catch (const Failure& f) {
    std::snprintf(err, kErrLen, "%s", f.msg);
  } catch (const std::bad_alloc&) {
    std::snprintf(err, kErrLen, "out of memory");
  }
  return 1;
}

}  // extern "C"

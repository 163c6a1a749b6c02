// JPEG entropy decoder — the HOST half of the hybrid decode path.
// Huffman-decodes quantized DCT coefficients and stops: the dequantize
// + IDCT + chroma upsample + YCbCr→RGB math runs on the TPU as 8x8
// matmuls inside the jitted pipeline graph (ops/jpeg.py).
//
// Why: the reference decodes JPEGs fully on the host (cv2.imdecode,
// reference backend/app.py:433) and ships raw pixels to the device. On
// a link-bound serving topology the coefficients ARE the compact
// representation (~10-20x smaller than the pixels for photographic
// inputs), so entropy-decode is the only work that must stay on the
// CPU ("Accelerating JPEG Decompression on GPUs", arxiv 2111.09219,
// splits the codec at exactly this point).
//
// Supported: baseline sequential (SOF0), extended sequential (SOF1)
// and progressive (SOF2) Huffman JPEGs — interleaved and
// non-interleaved scans, spectral selection, successive approximation
// (DC/AC first and refinement scans, EOB runs), restart intervals —
// 8-bit precision, 1 or 3 components. Anything else (arithmetic
// coding, lossless/hierarchical SOFs, 12-bit, CMYK) returns
// IPC_JPEG_UNSUPPORTED and the caller falls back to the full host
// decode. The output is identical either way: per-component arrays of
// fully-reassembled quantized coefficients in natural order.
//
// C ABI for the ctypes binding in native/__init__.py.

#include <cstdint>
#include <cstring>

namespace {

constexpr int32_t IPC_JPEG_OK = 0;
constexpr int32_t IPC_JPEG_NOT_JPEG = -1;
constexpr int32_t IPC_JPEG_UNSUPPORTED = -2;
constexpr int32_t IPC_JPEG_CORRUPT = -3;

// Zigzag index -> natural (row-major) index.
constexpr uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
};

struct HuffTable {
  int32_t mincode[17];
  int32_t maxcode[18];
  int32_t valptr[17];
  uint8_t vals[256];
  // Fast path: 8-bit peek -> (symbol << 8) | code_length for codes of
  // <= 8 bits (the overwhelming majority by construction — Huffman
  // assigns short codes to frequent symbols). 0 = miss (length >= 1
  // makes every real entry nonzero even for symbol 0x00/EOB).
  uint16_t lut[256];
  bool present = false;

  // Returns false (and marks the table absent) when the declared code
  // counts overflow the canonical Huffman code space — e.g. counts
  // {255,1}: such a table cannot have been emitted by a conforming
  // encoder, and building the 8-bit LUT from it would index past
  // lut[256] (mincode[l]+c can exceed the l-bit space).
  bool build(const uint8_t counts[16], const uint8_t* symbols) {
    int code = 0, k = 0;
    present = false;
    std::memset(lut, 0, sizeof(lut));  // tables can be rebuilt mid-stream
    for (int l = 1; l <= 16; l++) {
      valptr[l] = k;
      mincode[l] = code;
      if (counts[l - 1]) {
        code += counts[l - 1];
        if (code > (1 << l)) return false;  // non-canonical: code space overflow
        maxcode[l] = code - 1;
      } else {
        maxcode[l] = -1;
      }
      k += counts[l - 1];
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    for (int i = 0; i < k && i < 256; i++) vals[i] = symbols[i];
    int idx = 0;
    for (int l = 1; l <= 8; l++) {
      for (int c = 0; c < counts[l - 1] && idx < 256; c++, idx++) {
        const int prefix = (mincode[l] + c) << (8 - l);
        const uint16_t entry =
            static_cast<uint16_t>((vals[idx] << 8) | l);
        for (int t = 0; t < (1 << (8 - l)); t++) lut[prefix + t] = entry;
      }
    }
    present = true;
    return true;
  }
};

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;  // MSB-first bit buffer; low `nbits` bits are valid
  int nbits = 0;
  int pending_marker = 0;  // 0xDn (or other) marker hit inside the stream

  // Pull entropy-coded bytes (0xFF00-unstuffed) into the bit buffer
  // until it holds > 56 bits or the stream ends / hits a marker. Never
  // reads past a marker, so buffered bits always belong to the current
  // entropy segment.
  void refill() {
    while (nbits <= 56) {
      if (pending_marker || p >= end) return;
      uint8_t b = *p++;
      if (b == 0xFF) {
        while (p < end && *p == 0xFF) p++;  // fill bytes
        if (p >= end) return;               // dangling 0xFF: end of data
        const uint8_t m = *p++;
        if (m != 0x00) {
          pending_marker = m;
          return;
        }
        // stuffed 0xFF00: b == 0xFF is entropy data
      }
      buf = (buf << 8) | b;
      nbits += 8;
    }
  }

  int next_bit() {
    if (nbits == 0) {
      refill();
      if (nbits == 0) return pending_marker ? -2 : -1;
    }
    nbits--;
    return (buf >> nbits) & 1;
  }

  // Read n (<= 16) bits MSB-first; negative on end/marker. The buffer
  // refill pulls every available byte, so nbits < n after refill means
  // the stream genuinely cannot supply n more bits (callers abort on
  // any negative, so partial consumption is irrelevant).
  int receive(int n) {
    if (n == 0) return 0;
    if (nbits < n) {
      refill();
      if (nbits < n) return pending_marker ? -2 : -1;
    }
    nbits -= n;
    return static_cast<int>((buf >> nbits) & ((1u << n) - 1));
  }
};

inline int extend(int v, int t) {
  if (t == 0) return 0;
  return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v;
}

int huff_decode(BitReader& br, const HuffTable& ht) {
  // Fast path: one 8-bit peek resolves any code of <= 8 bits.
  if (br.nbits < 8) br.refill();
  if (br.nbits >= 8) {
    const uint16_t e = ht.lut[(br.buf >> (br.nbits - 8)) & 0xFF];
    if (e) {
      br.nbits -= e & 15;
      return e >> 8;
    }
  }
  // Slow path: long codes (9-16 bits) and near-end-of-stream tails.
  int code = br.next_bit();
  if (code < 0) return -100;
  int l = 1;
  while (code > ht.maxcode[l]) {
    int b = br.next_bit();
    if (b < 0) return -100;
    code = (code << 1) | b;
    if (++l > 16) return -101;
  }
  int idx = ht.valptr[l] + code - ht.mincode[l];
  if (idx < 0 || idx > 255) return -101;
  return ht.vals[idx];
}

// ---- per-block decoders ----------------------------------------------
// All write into a 64-int16 block in NATURAL order, pre-zeroed by the
// caller before the FIRST scan touches it (later scans refine in place).

// Sequential: full 0..63 band in one pass (T.81 F.2.2).
int seq_block(BitReader& br, const HuffTable& dc, const HuffTable& ac,
              int& pred, int16_t* out) {
  int t = huff_decode(br, dc);
  if (t < 0) return t;
  if (t > 15) return -101;
  int diff = 0;
  if (t) {
    int v = br.receive(t);
    if (v < 0) return -100;
    diff = extend(v, t);
  }
  pred += diff;
  out[0] = static_cast<int16_t>(pred);
  int k = 1;
  while (k < 64) {
    int rs = huff_decode(br, ac);
    if (rs < 0) return rs;
    int r = rs >> 4, s = rs & 15;
    if (s == 0) {
      if (r == 15) {
        k += 16;
        continue;
      }
      break;  // EOB
    }
    k += r;
    if (k > 63) return -101;
    int v = br.receive(s);
    if (v < 0) return -100;
    out[kZigzag[k]] = static_cast<int16_t>(extend(v, s));
    k++;
  }
  return 0;
}

// Progressive DC, first scan (Ah=0): diff coded as usual, scaled by Al
// (T.81 G.2.1).
int dc_first_block(BitReader& br, const HuffTable& dc, int al, int& pred,
                   int16_t* out) {
  int t = huff_decode(br, dc);
  if (t < 0) return t;
  if (t > 15) return -101;
  int diff = 0;
  if (t) {
    int v = br.receive(t);
    if (v < 0) return -100;
    diff = extend(v, t);
  }
  pred += diff;
  out[0] = static_cast<int16_t>(pred * (1 << al));
  return 0;
}

// Progressive DC refinement (Ah>0): one raw bit per block adds
// precision at position Al. No Huffman tables involved.
int dc_refine_block(BitReader& br, int al, int16_t* out) {
  int b = br.next_bit();
  if (b < 0) return -100;
  if (b) out[0] = static_cast<int16_t>(out[0] | (1 << al));
  return 0;
}

// Progressive AC, first scan of a band (Ah=0): run-length coding with
// end-of-band runs spanning blocks (T.81 G.2.2 first stage).
int ac_first_block(BitReader& br, const HuffTable& ac, int ss, int se,
                   int al, int& eobrun, int16_t* out) {
  if (eobrun > 0) {
    eobrun--;
    return 0;
  }
  int k = ss;
  while (k <= se) {
    int rs = huff_decode(br, ac);
    if (rs < 0) return rs;
    int r = rs >> 4, s = rs & 15;
    if (s == 0) {
      if (r != 15) {
        eobrun = (1 << r) - 1;
        if (r) {
          int v = br.receive(r);
          if (v < 0) return -100;
          eobrun += v;
        }
        break;  // this block is the first of the EOB run
      }
      k += 16;  // ZRL
      continue;
    }
    k += r;
    if (k > se) return -101;
    int v = br.receive(s);
    if (v < 0) return -100;
    out[kZigzag[k]] = static_cast<int16_t>(extend(v, s) * (1 << al));
    k++;
  }
  return 0;
}

// Progressive AC refinement (Ah>0): each already-nonzero coefficient in
// the band gets a correction bit; zero-history positions are created by
// (run, ±1<<Al) symbols; EOB runs carry correction bits for the rest of
// the band (T.81 G.2.2 subsequent stages; structured like libjpeg's
// decode_mcu_AC_refine).
int ac_refine_block(BitReader& br, const HuffTable& ac, int ss, int se,
                    int al, int& eobrun, int16_t* out) {
  const int p1 = 1 << al;
  int k = ss;
  if (eobrun == 0) {
    while (k <= se) {
      int rs = huff_decode(br, ac);
      if (rs < 0) return rs;
      int r = rs >> 4, s = rs & 15;
      int newval = 0;
      if (s == 0) {
        if (r != 15) {
          eobrun = 1 << r;
          if (r) {
            int v = br.receive(r);
            if (v < 0) return -100;
            eobrun += v;
          }
          break;  // correction bits for the tail run below
        }
        // r == 15: sixteen zero-history coefficients, no new value.
      } else {
        if (s != 1) return -101;
        int b = br.next_bit();
        if (b < 0) return -100;
        newval = b ? p1 : -p1;
      }
      // Advance past r zero-history coefficients, emitting correction
      // bits for every nonzero-history coefficient passed on the way.
      while (k <= se) {
        int16_t* coef = &out[kZigzag[k]];
        if (*coef != 0) {
          int b = br.next_bit();
          if (b < 0) return -100;
          if (b && (*coef & p1) == 0)
            *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : -p1));
        } else {
          if (r == 0) break;
          r--;
        }
        k++;
      }
      if (newval != 0) {
        if (k > se) return -101;
        out[kZigzag[k]] = static_cast<int16_t>(newval);
      }
      k++;
    }
  }
  if (eobrun > 0) {
    // Inside an EOB run: only correction bits for nonzero history.
    while (k <= se) {
      int16_t* coef = &out[kZigzag[k]];
      if (*coef != 0) {
        int b = br.next_bit();
        if (b < 0) return -100;
        if (b && (*coef & p1) == 0)
          *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : -p1));
      }
      k++;
    }
    eobrun--;
  }
  return 0;
}

// ---- frame / scan state ----------------------------------------------

struct Frame {
  bool progressive = false;
  int width = 0, height = 0, ncomp = 0;
  int comp_id[3] = {0, 0, 0};
  int h[3] = {1, 1, 1}, v[3] = {1, 1, 1};
  int tq[3] = {0, 0, 0};
  uint16_t qtab[4][64] = {};  // natural order
  bool qtab_present[4] = {};
  HuffTable dc_tab[4], ac_tab[4];
  int restart_interval = 0;
  int hmax = 1, vmax = 1;
  int mcus_x = 0, mcus_y = 0;
  int bw[3] = {0, 0, 0};   // MCU-padded block dims (the output layout)
  int bh[3] = {0, 0, 0};
  int nbw[3] = {0, 0, 0};  // non-interleaved block dims (ceil comp/8)
  int nbh[3] = {0, 0, 0};
};

struct Scan {
  int ns = 0;
  int comp[3] = {0, 0, 0};  // component indices into Frame arrays
  int td[3] = {0, 0, 0}, ta[3] = {0, 0, 0};
  int ss = 0, se = 63, ah = 0, al = 0;
};

inline int u16be(const uint8_t* p) { return (p[0] << 8) | p[1]; }

// Byte-align and consume the expected RSTn marker mid-scan. Discarded
// buffered bits are the interval's byte-alignment padding: refill never
// reads past a marker, so the buffer cannot hold the next interval's
// data.
int consume_rst(BitReader& br, int& next_rst) {
  br.nbits = 0;
  br.buf = 0;
  if (!br.pending_marker) {
    while (br.p < br.end && *br.p == 0xFF && br.p + 1 < br.end &&
           br.p[1] == 0xFF)
      br.p++;
    if (br.p + 1 < br.end && *br.p == 0xFF) {
      br.pending_marker = br.p[1];
      br.p += 2;
    }
  }
  if (br.pending_marker != 0xD0 + next_rst) return IPC_JPEG_CORRUPT;
  br.pending_marker = 0;
  next_rst = (next_rst + 1) & 7;
  return IPC_JPEG_OK;
}

// Decode one block of one scan (dispatch on scan type). `slot` indexes
// the scan's component list.
inline int scan_block(const Frame& F, const Scan& S, BitReader& br,
                      int slot, int pred[3], int& eobrun, int16_t* blk) {
  const int c = S.comp[slot];
  if (!F.progressive)
    return seq_block(br, F.dc_tab[S.td[slot]], F.ac_tab[S.ta[slot]], pred[c],
                     blk);
  if (S.ss == 0) {
    if (S.ah == 0)
      return dc_first_block(br, F.dc_tab[S.td[slot]], S.al, pred[c], blk);
    return dc_refine_block(br, S.al, blk);
  }
  if (S.ah == 0)
    return ac_first_block(br, F.ac_tab[S.ta[slot]], S.ss, S.se, S.al, eobrun,
                          blk);
  return ac_refine_block(br, F.ac_tab[S.ta[slot]], S.ss, S.se, S.al, eobrun,
                         blk);
}

// Decode a whole scan's entropy data. On success the BitReader is left
// at the first byte after the scan (pending_marker may hold a consumed
// marker).
int decode_scan(const Frame& F, const Scan& S, BitReader& br,
                int16_t* comp_out[3]) {
  // Table presence, by what this scan type actually reads.
  for (int s = 0; s < S.ns; s++) {
    const bool need_dc = !F.progressive || (S.ss == 0 && S.ah == 0);
    const bool need_ac = !F.progressive || S.ss > 0;
    if (need_dc && !F.dc_tab[S.td[s]].present) return IPC_JPEG_CORRUPT;
    if (need_ac && !F.ac_tab[S.ta[s]].present) return IPC_JPEG_CORRUPT;
  }
  int pred[3] = {0, 0, 0};
  int eobrun = 0;
  int next_rst = 0;
  const int ri = F.restart_interval;
  const int c0 = S.comp[0];
  // One "unit" is an MCU for interleaved scans, a single block for
  // non-interleaved scans (T.81 A.2: restart intervals count these).
  const int64_t units =
      S.ns == 1 ? static_cast<int64_t>(F.nbw[c0]) * F.nbh[c0]
                : static_cast<int64_t>(F.mcus_x) * F.mcus_y;
  for (int64_t u = 0; u < units; u++) {
    if (ri && u && u % ri == 0) {
      int rc = consume_rst(br, next_rst);
      if (rc != IPC_JPEG_OK) return rc;
      pred[0] = pred[1] = pred[2] = 0;
      eobrun = 0;
    }
    if (S.ns == 1) {
      const int64_t row = u / F.nbw[c0], col = u % F.nbw[c0];
      int16_t* blk = comp_out[c0] + (row * F.bw[c0] + col) * 64;
      if (scan_block(F, S, br, 0, pred, eobrun, blk) < 0)
        return IPC_JPEG_CORRUPT;
    } else {
      const int64_t mx = u % F.mcus_x, my = u / F.mcus_x;
      for (int s = 0; s < S.ns; s++) {
        const int c = S.comp[s];
        for (int by = 0; by < F.v[c]; by++) {
          for (int bx = 0; bx < F.h[c]; bx++) {
            const int64_t row = my * F.v[c] + by;
            const int64_t col = mx * F.h[c] + bx;
            int16_t* blk = comp_out[c] + (row * F.bw[c] + col) * 64;
            if (scan_block(F, S, br, s, pred, eobrun, blk) < 0)
              return IPC_JPEG_CORRUPT;
          }
        }
      }
    }
  }
  return IPC_JPEG_OK;
}

// ---- the marker-level driver ------------------------------------------
// want_coeffs=false (probe): parse headers, return OK at the first SOS.
// want_coeffs=true: decode every scan until EOI / end of data; comp_out
// must be pre-zeroed; qt_out[3*64] is snapshotted at the first SOS.
int run(const uint8_t* data, int64_t len, Frame& F, int16_t* comp_out[3],
        uint16_t* qt_out, bool want_coeffs) {
  if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) return IPC_JPEG_NOT_JPEG;
  const uint8_t* p = data + 2;
  const uint8_t* end = data + len;
  bool have_sof = false;
  int scans_done = 0;
  int pending = 0;  // marker already consumed by a scan's BitReader
  while (true) {
    int m;
    if (pending) {
      m = pending;
      pending = 0;
    } else {
      while (p < end && *p != 0xFF) {
        // Garbage between segments is only tolerable after a decoded
        // scan (some writers pad); before the first scan it's corrupt.
        if (scans_done == 0) return IPC_JPEG_CORRUPT;
        p++;
      }
      while (p < end && *p == 0xFF) p++;  // fill bytes
      if (p >= end) break;
      m = *p++;
      if (m == 0x00) continue;  // stuffed byte stray; ignore
    }
    if (m == 0xD8) continue;  // stray SOI
    if (m == 0xD9) break;     // EOI
    if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;  // standalone
    if (p + 2 > end) return IPC_JPEG_CORRUPT;
    const int L = u16be(p);
    if (L < 2 || p + L > end) return IPC_JPEG_CORRUPT;
    const uint8_t* seg = p + 2;
    const int seg_len = L - 2;
    switch (m) {
      case 0xC0:  // SOF0 baseline sequential
      case 0xC1:  // SOF1 extended sequential, Huffman
      case 0xC2:  // SOF2 progressive, Huffman
      {
        if (have_sof) return IPC_JPEG_CORRUPT;
        if (seg_len < 6) return IPC_JPEG_CORRUPT;
        F.progressive = (m == 0xC2);
        const int prec = seg[0];
        if (prec != 8) return IPC_JPEG_UNSUPPORTED;
        F.height = u16be(seg + 1);
        F.width = u16be(seg + 3);
        F.ncomp = seg[5];
        if (F.height <= 0 || F.width <= 0) return IPC_JPEG_UNSUPPORTED;
        if (F.ncomp != 1 && F.ncomp != 3) return IPC_JPEG_UNSUPPORTED;
        if (seg_len < 6 + 3 * F.ncomp) return IPC_JPEG_CORRUPT;
        for (int c = 0; c < F.ncomp; c++) {
          const uint8_t* cp = seg + 6 + 3 * c;
          F.comp_id[c] = cp[0];
          F.h[c] = cp[1] >> 4;
          F.v[c] = cp[1] & 15;
          F.tq[c] = cp[2];
          if (F.h[c] < 1 || F.h[c] > 4 || F.v[c] < 1 || F.v[c] > 4 ||
              F.tq[c] > 3)
            return IPC_JPEG_CORRUPT;
        }
        if (F.ncomp == 1) F.h[0] = F.v[0] = 1;  // libjpeg semantics
        F.hmax = F.vmax = 1;
        for (int c = 0; c < F.ncomp; c++) {
          if (F.h[c] > F.hmax) F.hmax = F.h[c];
          if (F.v[c] > F.vmax) F.vmax = F.v[c];
        }
        F.mcus_x = (F.width + 8 * F.hmax - 1) / (8 * F.hmax);
        F.mcus_y = (F.height + 8 * F.vmax - 1) / (8 * F.vmax);
        for (int c = 0; c < F.ncomp; c++) {
          F.bw[c] = F.mcus_x * F.h[c];
          F.bh[c] = F.mcus_y * F.v[c];
          const int cw = (F.width * F.h[c] + F.hmax - 1) / F.hmax;
          const int ch = (F.height * F.v[c] + F.vmax - 1) / F.vmax;
          F.nbw[c] = (cw + 7) / 8;
          F.nbh[c] = (ch + 7) / 8;
        }
        have_sof = true;
        break;
      }
      case 0xC3:
      case 0xC5:
      case 0xC6:
      case 0xC7:
      case 0xC9:
      case 0xCA:
      case 0xCB:
      case 0xCD:
      case 0xCE:
      case 0xCF:
        return IPC_JPEG_UNSUPPORTED;  // lossless/hierarchical/arithmetic
      case 0xC4: {  // DHT
        const uint8_t* q = seg;
        while (q + 17 <= seg + seg_len) {
          const int tc = q[0] >> 4, th = q[0] & 15;
          if (tc > 1 || th > 3) return IPC_JPEG_CORRUPT;
          int total = 0;
          for (int i = 1; i <= 16; i++) total += q[i];
          if (total > 256 || q + 17 + total > seg + seg_len)
            return IPC_JPEG_CORRUPT;
          if (!(tc == 0 ? F.dc_tab[th] : F.ac_tab[th]).build(q + 1, q + 17))
            return IPC_JPEG_CORRUPT;
          q += 17 + total;
        }
        break;
      }
      case 0xDB: {  // DQT
        const uint8_t* q = seg;
        while (q < seg + seg_len) {
          const int pq = q[0] >> 4, tq = q[0] & 15;
          if (tq > 3) return IPC_JPEG_CORRUPT;
          q++;
          const int need = pq ? 128 : 64;
          if (q + need > seg + seg_len) return IPC_JPEG_CORRUPT;
          for (int i = 0; i < 64; i++) {
            const uint16_t val = pq ? static_cast<uint16_t>(u16be(q + 2 * i))
                                    : static_cast<uint16_t>(q[i]);
            F.qtab[tq][kZigzag[i]] = val;
          }
          F.qtab_present[tq] = true;
          q += need;
        }
        break;
      }
      case 0xDD:  // DRI
        if (seg_len < 2) return IPC_JPEG_CORRUPT;
        F.restart_interval = u16be(seg);
        break;
      case 0xDA: {  // SOS
        if (!have_sof) return IPC_JPEG_CORRUPT;
        if (seg_len < 1) return IPC_JPEG_CORRUPT;
        Scan S;
        S.ns = seg[0];
        if (S.ns < 1 || S.ns > F.ncomp) return IPC_JPEG_CORRUPT;
        if (seg_len < 1 + 2 * S.ns + 3) return IPC_JPEG_CORRUPT;
        for (int s = 0; s < S.ns; s++) {
          const int cs = seg[1 + 2 * s];
          int found = -1;
          for (int c = 0; c < F.ncomp; c++)
            if (F.comp_id[c] == cs) found = c;
          if (found < 0) return IPC_JPEG_CORRUPT;
          for (int t = 0; t < s; t++)
            if (S.comp[t] == found) return IPC_JPEG_CORRUPT;
          S.comp[s] = found;
          S.td[s] = seg[2 + 2 * s] >> 4;
          S.ta[s] = seg[2 + 2 * s] & 15;
          if (S.td[s] > 3 || S.ta[s] > 3) return IPC_JPEG_CORRUPT;
        }
        const uint8_t* sp = seg + 1 + 2 * S.ns;
        S.ss = sp[0];
        S.se = sp[1];
        S.ah = sp[2] >> 4;
        S.al = sp[2] & 15;
        if (F.progressive) {
          if (S.ss == 0) {
            if (S.se != 0) return IPC_JPEG_CORRUPT;  // DC scans: band {0}
          } else {
            if (S.se < S.ss || S.se > 63 || S.ns != 1)
              return IPC_JPEG_CORRUPT;  // AC scans: single component
          }
          if (S.ah > 13 || S.al > 13) return IPC_JPEG_CORRUPT;
        } else {
          if (S.ss != 0 || S.se != 63 || S.ah != 0 || S.al != 0)
            return IPC_JPEG_UNSUPPORTED;
        }
        if (scans_done == 0) {
          for (int c = 0; c < F.ncomp; c++) {
            if (!F.qtab_present[F.tq[c]]) return IPC_JPEG_CORRUPT;
            if (qt_out)
              std::memcpy(qt_out + 64 * c, F.qtab[F.tq[c]],
                          64 * sizeof(uint16_t));
          }
        }
        if (!want_coeffs) return IPC_JPEG_OK;  // probe stops here
        for (int s = 0; s < S.ns; s++)
          if (comp_out[S.comp[s]] == nullptr) return IPC_JPEG_CORRUPT;
        BitReader br{p + L, end};
        const int rc = decode_scan(F, S, br, comp_out);
        if (rc != IPC_JPEG_OK) return rc;
        scans_done++;
        p = br.p;
        pending = br.pending_marker;
        continue;  // p already advanced past the scan
      }
      default:
        break;  // APPn, COM, DNL, others: skip
    }
    p += L;
  }
  if (!want_coeffs) return IPC_JPEG_CORRUPT;  // probe never saw SOS
  // Progressive streams may legally end early (fewer refinement scans
  // than the encoder planned); any decoded scan yields usable
  // coefficients, matching libjpeg's handling of truncated files.
  return scans_done > 0 ? IPC_JPEG_OK : IPC_JPEG_CORRUPT;
}

}  // namespace

extern "C" {

// info[14]: [0]=width [1]=height [2]=ncomp [3..5]=h_i [6..8]=v_i
//           [9..11]=quant-table index per comp [12]=Hmax [13]=Vmax
int32_t ipc_jpeg_probe(const uint8_t* data, int64_t len, int32_t* info) {
  Frame F;
  int16_t* none[3] = {nullptr, nullptr, nullptr};
  const int rc = run(data, len, F, none, nullptr, /*want_coeffs=*/false);
  if (rc != IPC_JPEG_OK) return rc;
  info[0] = F.width;
  info[1] = F.height;
  info[2] = F.ncomp;
  for (int c = 0; c < 3; c++) {
    info[3 + c] = c < F.ncomp ? F.h[c] : 0;
    info[6 + c] = c < F.ncomp ? F.v[c] : 0;
    info[9 + c] = c < F.ncomp ? F.tq[c] : 0;
  }
  info[12] = F.hmax;
  info[13] = F.vmax;
  return IPC_JPEG_OK;
}

// Decode quantized DCT coefficients. Caller allocates, per component c:
//   blocks = (ceil(h/(8*Vmax))*v_c) * (ceil(w/(8*Hmax))*h_c)
//   c{0,1,2}: int16[blocks*64], MUST be zero-initialized (EOB leaves
//   trailing coefficients untouched; progressive scans refine in
//   place). qt: uint16[3*64], the component's dequantization table in
//   natural order.
int32_t ipc_jpeg_coeffs(const uint8_t* data, int64_t len, int16_t* c0,
                        int16_t* c1, int16_t* c2, uint16_t* qt) {
  Frame F;
  int16_t* outs[3] = {c0, c1, c2};
  return run(data, len, F, outs, qt, /*want_coeffs=*/true);
}

// Split-sparse pack of one component's truncated coefficients — the hot
// loop of ops/jpeg_sparse.block_pack (which keeps the layout contract,
// the numpy oracle, and the tests). Input: nblocks consecutive
// k2-int16 blocks in natural order, DC at in-block position 0. Appends
// to the caller's streams at cursors *n_ac / *n_exc so multi-component
// images pack consecutively into shared buffers; exc_idx entries index
// the GLOBAL val stream (ascending). val holds the wrapped int8 image
// of each AC value; out-of-range entries are listed in (exc_idx,
// exc_val) and overwrite the wrapped byte device-side. cap / exc_cap
// are total buffer capacities; returns -1 on overflow (the caller
// sizes buffers to the dense AC capacity, so overflow is a caller
// bug), else 0.
int32_t ipc_jpeg_sparse_pack(const int16_t* coeffs, int64_t nblocks,
                             int32_t k2, uint8_t* counts, int16_t* dc,
                             uint8_t* pos, int8_t* val, int64_t cap,
                             int32_t* exc_idx, int16_t* exc_val,
                             int64_t exc_cap, int64_t* n_ac,
                             int64_t* n_exc) {
  // The zero test is data-dependent and unpredictable (~10-30% nonzero
  // density), so the loop is branchless: every candidate is staged at
  // the cursor and the cursor advances by (v != 0). That requires cap
  // to cover the DENSE AC capacity of the blocks being packed (the
  // wrapper sizes it so); a tight cap == nnz would false-fail.
  int64_t na = *n_ac, ne = *n_exc;
  if (cap - na < nblocks * (k2 - 1)) return -1;
  for (int64_t b = 0; b < nblocks; b++) {
    const int16_t* blk = coeffs + b * k2;
    dc[b] = blk[0];
    const int64_t na0 = na;
    for (int32_t j = 1; j < k2; j++) {
      const int16_t v = blk[j];
      pos[na] = static_cast<uint8_t>(j);
      val[na] = static_cast<int8_t>(v);  // wraps; exceptions overwrite
      if (__builtin_expect(v < -128 || v > 127, 0)) {
        if (ne >= exc_cap) return -1;
        exc_idx[ne] = static_cast<int32_t>(na);
        exc_val[ne] = v;
        ne++;
      }
      na += (v != 0);
    }
    counts[b] = static_cast<uint8_t>(na - na0);
  }
  *n_ac = na;
  *n_exc = ne;
  return 0;
}

}  // extern "C"

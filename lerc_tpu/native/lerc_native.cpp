// Native runtime helpers for the JAX LERC engine.
//
// The Lerc2 tile stream is a serial byte-cursor format: each micro-block
// record's length depends on its header bytes, so finding record offsets is
// an inherently sequential scan (Lerc2.cpp:1672-1713). Everything AFTER the
// scan (bit-unpack, dequantize, scatter) is embarrassingly parallel and runs
// on the device; this scanner runs on the host and feeds the device kernels
// with per-record descriptors.
//
// Build: g++ -O3 -shared -fPIC -o liblerc_native.so lerc_native.cpp
//
// Wire-format constants follow lerc/src/LercLib (BitStuffer2,
// Lerc2 ReadTile); implementation is original.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

struct RecordDesc {
  int64_t payload_pos;   // absolute byte offset of the bit-stuffed payload (mode 1/4) or raw values (mode 0)
  double offset;         // block offset (zMin) for modes 1/3/4
  int32_t mode;          // 0 raw, 1 stuff, 2 const0, 3 const-offset, 4 stuff-LUT, +8 if diff-encoded
  int32_t num_bits;      // bits per element (mode 1); bits per LUT entry (mode 4)
  int32_t num_elements;  // stuffed element count
  int64_t lut_pos;       // absolute offset of LUT table bytes (mode 4)
  int32_t n_lut;         // LUT size w/o the 0 (mode 4)
  int32_t nbits_lut;     // bits per index (mode 4)
};

// dt codes: 0 char,1 byte,2 short,3 ushort,4 int,5 uint,6 float,7 double
static const int DT_SIZE_TBL[8] = {1, 1, 2, 2, 4, 4, 4, 8};

static inline int dt_used(int dt, int tc) {
  switch (dt) {
    case 2: case 4: return dt - tc;
    case 3: case 5: return dt - 2 * tc;
    case 6: return tc == 0 ? 6 : (tc == 1 ? 2 : 1);
    case 7: return tc == 0 ? 7 : (7 - 2 * tc + 1);
    default: return dt;
  }
}

static inline double read_val(const uint8_t* p, int dtu) {
  switch (dtu) {
    case 0: return (double)(int8_t)p[0];
    case 1: return (double)p[0];
    case 2: { int16_t v; memcpy(&v, p, 2); return v; }
    case 3: { uint16_t v; memcpy(&v, p, 2); return v; }
    case 4: { int32_t v; memcpy(&v, p, 4); return v; }
    case 5: { uint32_t v; memcpy(&v, p, 4); return v; }
    case 6: { float v; memcpy(&v, p, 4); return v; }
    default: { double v; memcpy(&v, p, 8); return v; }
  }
}

static inline int bit_len_u32(uint32_t x) {
  int n = 0;
  while (x >> n) n++;
  return n;
}

// Scan the tile stream starting at buf[0]. Returns bytes consumed, or -1 on
// corruption. cnts[] has the per-BLOCK valid count; records iterate blocks
// outer, depth inner. j0s[] has the per-block j0 for the integrity check.
int64_t lerc_tile_scan(
    const uint8_t* buf, int64_t buf_len,
    const int32_t* cnts, const int32_t* j0s,
    int32_t n_blocks, int32_t n_depth,
    int32_t dt, int32_t version,
    RecordDesc* out) {
  const int size_t_ = DT_SIZE_TBL[dt];
  const bool dt_int = dt < 6;
  int64_t pos = 0;
  const int pattern = version >= 5 ? 14 : 15;
  for (int32_t b = 0; b < n_blocks; b++) {
    const int32_t cnt = cnts[b];
    for (int32_t d = 0; d < n_depth; d++) {
      RecordDesc& r = out[(int64_t)b * n_depth + d];
      if (pos >= buf_len) return -1;
      const uint8_t flag = buf[pos++];
      const bool bdiff = (version >= 5) && (flag & 4);
      if (bdiff && d == 0) return -1;  // Lerc2.cpp:2048: diff needs iDepth>0
      if (((flag >> 2) & pattern) != ((j0s[b] >> 3) & pattern)) return -1;
      const int code = flag & 3;
      const int bits67 = flag >> 6;
      r.mode = code + (bdiff ? 8 : 0);
      r.num_bits = 0; r.num_elements = 0; r.offset = 0;
      r.payload_pos = 0; r.lut_pos = 0; r.n_lut = 0; r.nbits_lut = 0;
      if (code == 2) continue;                      // const 0
      if (code == 0) {                              // raw
        r.payload_pos = pos;
        pos += (int64_t)cnt * size_t_;
        if (pos > buf_len) return -1;
        continue;
      }
      // codes 1 and 3: offset in reduced dtype
      const int base_dt = (bdiff && dt_int) ? 4 : dt;
      const int dtu = dt_used(base_dt, bits67);
      const int w = DT_SIZE_TBL[dtu];
      if (pos + w > buf_len) return -1;
      r.offset = read_val(buf + pos, dtu);
      pos += w;
      if (code == 3) { r.mode = 3 + (bdiff ? 8 : 0); continue; }
      // code 1: bit-stuffed section (BitStuffer2::Decode header)
      if (pos >= buf_len) return -1;
      const uint8_t nbb = buf[pos++];
      const int cw_code = nbb >> 6;
      const int cw = cw_code == 0 ? 4 : 3 - cw_code;
      const bool lut = nbb & (1 << 5);
      const int nb = nbb & 31;
      if (pos + cw > buf_len) return -1;
      uint32_t n_elem = 0;
      memcpy(&n_elem, buf + pos, cw);  // little-endian, low bytes
      pos += cw;
      if ((int64_t)n_elem > 64LL * 64) return -1;
      r.num_elements = (int32_t)n_elem;
      r.num_bits = nb;
      if (!lut) {
        r.mode = 1 + (bdiff ? 8 : 0);
        r.payload_pos = pos;
        pos += ((int64_t)n_elem * nb + 7) >> 3;
        if (pos > buf_len) return -1;
      } else {
        if (nb == 0 || pos >= buf_len) return -1;
        const int n_lut = buf[pos++] - 1;
        r.mode = 4 + (bdiff ? 8 : 0);
        r.n_lut = n_lut;
        r.lut_pos = pos;
        pos += ((int64_t)n_lut * nb + 7) >> 3;
        const int nbits_lut = bit_len_u32((uint32_t)n_lut);
        if (nbits_lut == 0) return -1;
        r.nbits_lut = nbits_lut;
        r.payload_pos = pos;
        pos += ((int64_t)n_elem * nbits_lut + 7) >> 3;
        if (pos > buf_len) return -1;
      }
    }
  }
  return pos;
}

// ---------------------------------------------------------------------------
// Fast canonical Huffman decode (serial, host) for the 8-bit image modes.
// codes/lengths indexed by symbol (size 256); stream is MSB-first in
// little-endian uint32 words. Returns bytes consumed (incl. the read-ahead
// pad word) or -1.
int64_t lerc_huffman_decode(
    const uint8_t* buf, int64_t buf_len,
    const int32_t* lengths, const uint32_t* codes, int32_t table_size,
    int32_t n_symbols, int32_t* out_symbols) {
  // build 12-bit LUT + per-length first-code tables
  int max_len = 0;
  for (int i = 0; i < table_size; i++)
    if (lengths[i] > max_len) max_len = lengths[i];
  if (max_len <= 0 || max_len > 32) return -1;
  const int lut_bits = max_len < 12 ? max_len : 12;
  const int lut_size = 1 << lut_bits;
  int16_t* lut_len = new int16_t[lut_size]();
  int16_t* lut_sym = new int16_t[lut_size];
  // long-code tables: for each length, first code and symbol list
  uint32_t first_code[33] = {0};
  int32_t first_rank[33];
  int32_t count_len[33] = {0};
  for (int i = 0; i < 33; i++) first_rank[i] = -1;
  // canonical order: length desc, index asc -> ranks
  int32_t* rank_sym = new int32_t[table_size];
  {
    int rank = 0;
    for (int len = max_len; len >= 1; len--) {
      for (int i = 0; i < table_size; i++) {
        if (lengths[i] == len) {
          if (first_rank[len] < 0) { first_rank[len] = rank; first_code[len] = codes[i]; }
          count_len[len]++;
          rank_sym[rank++] = i;
        }
      }
    }
  }
  for (int i = 0; i < table_size; i++) {
    const int len = lengths[i];
    if (len > 0 && len <= lut_bits) {
      const uint32_t base = codes[i] << (lut_bits - len);
      const uint32_t span = 1u << (lut_bits - len);
      for (uint32_t k = 0; k < span; k++) {
        lut_len[base + k] = (int16_t)len;
        lut_sym[base + k] = (int16_t)i;
      }
    }
  }
  // bit cursor
  int64_t bitpos = 0;
  const int64_t total_bits = (buf_len / 4) * 32;
  auto read_window = [&](int64_t p, int n) -> uint32_t {
    // read n (<=32) bits MSB-first starting at bit p over LE uint32 words
    uint32_t acc = 0;
    int64_t word = p >> 5;
    int off = (int)(p & 31);
    uint32_t w0, w1 = 0;
    memcpy(&w0, buf + word * 4, 4);
    if ((word + 2) * 4 <= buf_len) memcpy(&w1, buf + (word + 1) * 4, 4);
    uint64_t both = ((uint64_t)w0 << 32) | w1;
    acc = (uint32_t)((both << off) >> (64 - n));
    return acc;
  };
  bool ok = true;
  int32_t s_done = 0;
  // multi-symbol fast loop (8-bit tables): a 13-bit window decodes up to
  // 4 whole codes per lookup with a rolling 64-bit bit buffer -- the same
  // layout that makes the lengths-only scan 4-15x the per-symbol LUT walk.
  // Long codes / window tails drop to the exact per-symbol loop below.
  if (table_size <= 256) {
    const int MB = 13;
    uint8_t* multi = new uint8_t[1 << MB];
    uint8_t* msyms = new uint8_t[(1 << MB) * 4];
    for (uint32_t v = 0; v < (1u << MB); v++) {
      int tl = 0, ns = 0;
      while (tl < MB && ns < 4) {
        const int k = MB - tl;
        const int take = lut_bits < k ? lut_bits : k;
        uint32_t win = (v << tl) & ((1u << MB) - 1);
        win >>= (MB - take);
        win <<= (lut_bits - take);  // zero-pad to the LUT width
        const int len = lut_len[win];
        if (len == 0 || len > k) break;
        msyms[v * 4 + ns] = (uint8_t)lut_sym[win];
        tl += len;
        ns++;
      }
      multi[v] = (uint8_t)((ns << 4) | tl);
    }
    int64_t word = 0;
    uint32_t w0, w1;
    uint64_t cur = 0;
    int off = 0;
    auto reload = [&]() -> bool {  // window over [bitpos, bitpos + 64)
      word = bitpos >> 5;
      if ((word + 2) * 4 > buf_len) return false;
      memcpy(&w0, buf + word * 4, 4);
      memcpy(&w1, buf + word * 4 + 4, 4);
      cur = ((uint64_t)w0 << 32) | w1;
      off = (int)(bitpos & 31);
      return true;
    };
    // one exact symbol at bitpos (long code / resync); false on corruption
    auto slow_one = [&]() -> bool {
      if (bitpos + lut_bits > total_bits) return false;
      const uint32_t w = read_window(bitpos, lut_bits);
      int len = lut_len[w];
      int sym = lut_sym[w];
      if (len == 0) {
        uint32_t code = w;
        len = lut_bits;
        bool found = false;
        while (len < max_len) {
          len++;
          code = read_window(bitpos, len);
          if (first_rank[len] >= 0) {
            const uint32_t fc = first_code[len];
            if (code >= fc && code < fc + (uint32_t)count_len[len]) {
              sym = rank_sym[first_rank[len] + (code - fc)];
              found = true;
              break;
            }
          }
        }
        if (!found) return false;
      }
      out_symbols[s_done++] = sym;
      bitpos += len;
      return true;
    };
    bool have = reload();
    while (have && s_done + 4 <= n_symbols) {
      const uint32_t win = (uint32_t)((cur << off) >> (64 - MB));
      const uint8_t e = multi[win];
      const int ns = e >> 4;
      if (ns) {
        // 4 unconditional stores (entries past ns are overwritten later)
        out_symbols[s_done] = msyms[win * 4];
        out_symbols[s_done + 1] = msyms[win * 4 + 1];
        out_symbols[s_done + 2] = msyms[win * 4 + 2];
        out_symbols[s_done + 3] = msyms[win * 4 + 3];
        s_done += ns;
        const int tl = e & 15;
        off += tl;
        bitpos += tl;
        if (off >= 32) {
          word++;
          if ((word + 2) * 4 > buf_len) { have = false; break; }
          uint32_t wn;
          memcpy(&wn, buf + word * 4 + 4, 4);
          cur = (cur << 32) | wn;
          off -= 32;
        }
      } else {  // long code: one exact symbol, then resume the fast loop
        if (!slow_one()) { ok = false; break; }
        have = reload();
      }
    }
    delete[] multi; delete[] msyms;
    if (!ok) { delete[] lut_len; delete[] lut_sym; delete[] rank_sym; return -1; }
  }
  for (int32_t s = s_done; s < n_symbols; s++) {
    if (bitpos + lut_bits > total_bits) { ok = false; break; }
    const uint32_t win = read_window(bitpos, lut_bits);
    int len = lut_len[win];
    if (len > 0) {
      out_symbols[s] = lut_sym[win];
      bitpos += len;
      continue;
    }
    // long code
    uint32_t code = win;
    len = lut_bits;
    bool found = false;
    while (len < max_len) {
      len++;
      code = read_window(bitpos, len);
      if (first_rank[len] >= 0) {
        const uint32_t fc = first_code[len];
        if (code >= fc && code < fc + (uint32_t)count_len[len]) {
          out_symbols[s] = rank_sym[first_rank[len] + (code - fc)];
          bitpos += len;
          found = true;
          break;
        }
      }
    }
    if (!found) { ok = false; break; }
  }
  delete[] lut_len; delete[] lut_sym; delete[] rank_sym;
  if (!ok) return -1;
  const int64_t words = (bitpos + 31) / 32;
  return words * 4 + 4;  // + read-ahead pad word
}

// ---------------------------------------------------------------------------
// Speculative self-sync Huffman offsets scan (the "gap array" technique,
// single-core ILP edition). The stream splits into fixed bit chunks; a
// REFERENCE decode of every chunk starts blindly at the chunk's first bit
// -- four chunk cursors interleave in one loop, so the four independent
// load->shift->add dependency chains overlap on the superscalar core
// (measured ~3.5-4x one cursor). Each reference decode records every code
// start (a bitmap + an offset list; stores sit off the critical chain).
// The true decode enters chunk k at one of < 32 bit phases (codes are
// <= 32 bits); each candidate phase walks until it lands on a reference
// code start -- Huffman streams self-synchronize within a few codes -- so
// its exit state and symbol count follow from the reference suffix. A
// serial composition over chunks then picks the true phase chain, and
// group offsets read straight out of the recorded boundary lists.
// Falls back (caller runs the plain serial scan) on anything irregular:
// no sync before chunk end, invalid codes on a needed path, oversized
// prefixes. The device-side sidecar validation re-checks every offset
// against the decoded code lengths regardless.
}  // extern "C" (template members below need C++ linkage)

namespace spec_scan {

constexpr int64_t CB = 1 << 16;       // chunk size in bits (bitmap = 8 KB)
constexpr int WINDOW_CHUNKS = 64;     // reference scans ahead of the walker

struct Tables {
  const int16_t* lut_len;   // [1 << lut_bits] single-symbol lengths
  const uint8_t* multi;     // [1 << 13] (nSyms << 4) | totalLen
  const uint16_t* mlens;    // [1 << 13] first <= 4 lengths, 4-bit nibbles
  int lut_bits;
  int max_len;
  const uint32_t* first_code;
  const int32_t* count_len;
  const bool* has_len;
};

static inline uint32_t window(const uint8_t* buf, int64_t buf_len,
                              int64_t p, int n) {
  uint32_t w0, w1 = 0;
  const int64_t word = p >> 5;
  const int off = (int)(p & 31);
  memcpy(&w0, buf + word * 4, 4);
  if ((word + 2) * 4 <= buf_len) memcpy(&w1, buf + (word + 1) * 4, 4);
  const uint64_t both = ((uint64_t)w0 << 32) | w1;
  return (uint32_t)((both << off) >> (64 - n));
}

// exact single-symbol code length at bit pos; 0 = invalid / out of bits
static inline int sym_len(const uint8_t* buf, int64_t buf_len,
                          int64_t total_bits, const Tables& t, int64_t pos) {
  if (pos + t.lut_bits > total_bits) return 0;
  int len = t.lut_len[window(buf, buf_len, pos, t.lut_bits)];
  if (len) return len;
  len = t.lut_bits;
  while (len < t.max_len) {
    len++;
    if (pos + len > total_bits) return 0;
    const uint32_t code = window(buf, buf_len, pos, len);
    if (t.has_len[len] && code >= t.first_code[len]
        && code < t.first_code[len] + (uint32_t)t.count_len[len])
      return len;
  }
  return 0;
}

struct ChunkRef {
  std::vector<uint16_t> bounds;  // relative offsets of code starts < CB
  std::vector<uint64_t> bitmap;  // CB bits: is this a reference code start
};

// reference-decode chunks [c0, c1) four at a time: the four cursors'
// load->LUT->add chains are independent, so they overlap on the core
static void scan_refs(const uint8_t* buf, int64_t buf_len, int64_t total_bits,
                      const Tables& t, int64_t c0, int64_t c1,
                      std::vector<ChunkRef>& refs) {
  for (int64_t b = c0; b < c1; b += 4) {
    int64_t pos[4];
    int64_t base[4];
    ChunkRef* ref[4];
    bool act[4];
    const int nb = (int)((c1 - b) < 4 ? (c1 - b) : 4);
    for (int i = 0; i < nb; i++) {
      base[i] = (b + i) * CB;
      pos[i] = base[i];
      ref[i] = &refs[b + i];
      ref[i]->bounds.clear();
      ref[i]->bounds.reserve(CB / 4);
      ref[i]->bitmap.assign(CB / 64, 0);
      act[i] = base[i] < total_bits;
    }
    for (int i = nb; i < 4; i++) act[i] = false;
    bool any = act[0] || act[1] || act[2] || act[3];
    while (any) {
      any = false;
      for (int i = 0; i < 4; i++) {
        if (!act[i]) continue;
        int64_t rel = pos[i] - base[i];
        if (rel >= CB || pos[i] + 13 > total_bits) { act[i] = false; continue; }
        const uint32_t win = window(buf, buf_len, pos[i], 13);
        const uint8_t e = t.multi[win];
        const int ns = e >> 4;
        if (ns >= 1 && ns <= 4) {
          const uint16_t ls = t.mlens[win];
          for (int k = 0; k < ns && rel < CB; k++) {
            ref[i]->bounds.push_back((uint16_t)rel);
            ref[i]->bitmap[rel >> 6] |= 1ull << (rel & 63);
            rel += (ls >> (4 * k)) & 15;
          }
          pos[i] = base[i] + rel;
        } else {  // long code or > 4 tiny codes in the window
          const int len = sym_len(buf, buf_len, total_bits, t, pos[i]);
          if (!len) { act[i] = false; continue; }  // reference hit garbage
          ref[i]->bounds.push_back((uint16_t)rel);
          ref[i]->bitmap[rel >> 6] |= 1ull << (rel & 63);
          pos[i] += len;
        }
        any = true;
      }
    }
  }
}

// worker count: 0/1 = don't speculate. Speculation reference-decodes every
// chunk ON TOP of the true-path walk, so it only pays when those reference
// decodes run on OTHER cores; on a single core the plain serial multi-LUT
// walk is 5-6x faster than this path (measured 229 vs 41 Msym/s).
static int spec_threads() {
  if (const char* e = std::getenv("LERC_SPEC_THREADS")) {
    const int v = std::atoi(e);
    return v < 0 ? 0 : v;
  }
  const unsigned hc = std::thread::hardware_concurrency();
  return hc >= 2 ? (int)hc : 0;
}

// full speculative scan; returns bits consumed, or -1 (caller runs the
// plain serial scan -- covers both corrupt streams and bail-outs)
static int64_t run(const uint8_t* buf, int64_t buf_len, const Tables& t,
                   int64_t n_symbols, int32_t n_groups, int32_t group,
                   int32_t* out_offsets) {
  const int64_t total_bits = (buf_len / 4) * 32;
  const int64_t C = (total_bits + CB - 1) / CB;
  if (C < 8) return -1;  // small stream: serial is fine
  const int T = spec_threads();
  if (T < 2) return -1;  // single core: serial walk wins outright

  std::vector<ChunkRef> refs((size_t)C);
  std::vector<int64_t> pre;  // true-path starts found by walking
  pre.reserve(256);
  // a chunk's true path alternates walked stretches and reference
  // suffixes (a reference decode can end early on a garbage long-code
  // miss, in which case the walk resumes inside the same chunk)
  struct Seg { bool walked; int64_t a; int64_t n; };
  std::vector<Seg> segs;
  int64_t entry = 0;   // absolute bit of the next true code start
  int64_t s = 0;       // symbols consumed before the current chunk
  int32_t g = 0;
  int64_t scanned = 0;  // chunks with a reference decode so far

  for (int64_t k = 0; k < C && s < n_symbols; k++) {
    if (k >= scanned) {
      const int64_t hi = (k + WINDOW_CHUNKS < C) ? k + WINDOW_CHUNKS : C;
      // fan the reference decodes of [scanned, hi) across the cores;
      // each chunk slice is written by exactly one worker
      const int64_t span = hi - scanned;
      const int nw = (int)std::min<int64_t>(T, (span + 3) / 4);
      if (nw >= 2) {
        std::vector<std::thread> workers;
        workers.reserve(nw);
        const int64_t per = (span + nw - 1) / nw;
        for (int w = 0; w < nw; w++) {
          const int64_t a = scanned + w * per;
          const int64_t b = std::min(a + per, hi);
          if (a >= b) break;
          workers.emplace_back([&, a, b] {
            scan_refs(buf, buf_len, total_bits, t, a, b, refs);
          });
        }
        for (auto& th : workers) th.join();
      } else {
        scan_refs(buf, buf_len, total_bits, t, scanned, hi, refs);
      }
      scanned = hi;
    }
    const int64_t base = k * CB;
    ChunkRef& ref = refs[k];
    pre.clear();
    segs.clear();
    int64_t pos = entry;
    while (pos < base + CB) {
      // walk until the true path lands on a reference code start
      const int64_t w0 = (int64_t)pre.size();
      int64_t j = -1;
      while (pos < base + CB) {
        const int64_t rel = pos - base;
        if (ref.bitmap[rel >> 6] >> (rel & 63) & 1) {
          j = std::lower_bound(ref.bounds.begin(), ref.bounds.end(),
                               (uint16_t)rel) - ref.bounds.begin();
          break;
        }
        const int len = sym_len(buf, buf_len, total_bits, t, pos);
        if (!len) return -1;  // corrupt/truncated on the true path
        pre.push_back(pos);
        pos += len;
      }
      if ((int64_t)pre.size() > w0)
        segs.push_back({true, w0, (int64_t)pre.size() - w0});
      if (j < 0) break;  // crossed into chunk k + 1
      // follow the reference to its recorded end
      segs.push_back({false, j, (int64_t)ref.bounds.size() - j});
      const int64_t last = base + ref.bounds.back();
      const int len = sym_len(buf, buf_len, total_bits, t, last);
      if (!len) return -1;
      pos = last + len;  // < base + CB only if the reference ended early
    }
    entry = pos;
    int64_t count_k = 0;
    for (const Seg& sg : segs) count_k += sg.n;

    // boundary at true-path local index (within this chunk)
    auto bound_at = [&](int64_t local) -> int64_t {
      for (const Seg& sg : segs) {
        if (local < sg.n)
          return sg.walked ? pre[sg.a + local] : base + ref.bounds[sg.a + local];
        local -= sg.n;
      }
      return -1;
    };
    while (g < n_groups && (int64_t)g * group < s + count_k) {
      out_offsets[g] = (int32_t)bound_at((int64_t)g * group - s);
      g++;
    }
    if (s + count_k >= n_symbols) {
      // end of the final symbol = its start + its length
      const int64_t start = bound_at(n_symbols - 1 - s);
      const int len = sym_len(buf, buf_len, total_bits, t, start);
      if (!len || g != n_groups) return -1;
      return start + len;
    }
    s += count_k;
    // past chunks' memory is dead weight on big streams
    if (k >= 1) { refs[k - 1] = ChunkRef(); }
  }
  return -1;  // symbols exhausted the stream
}

}  // namespace spec_scan

extern "C" {

// ---------------------------------------------------------------------------
// Lengths-only Huffman scan: bit offset of each symbol group's first code.
// This is the cheap serial pass that makes FOREIGN 8-bit blobs (no encoder
// sidecar) device-decodable: the offsets feed the same device-parallel
// group decode as encoder-produced sidecars, and the device side re-checks
// them against the decoded code lengths, so a scan bug cannot produce
// silently wrong pixels. A 16-bit multi-symbol LUT (total length + count
// of the complete codes inside the window) advances ~2-4 symbols per
// lookup, several times faster than full decode (no symbol writes, no LUT
// misses on the hot path). group_counts[g] is the number of wire symbols
// in group g (64, a partial tail, or 0 for masked gap groups). Returns
// total bits consumed or -1.
int64_t lerc_huffman_group_offsets(
    const uint8_t* buf, int64_t buf_len,
    const int32_t* lengths, const uint32_t* codes, int32_t table_size,
    int32_t n_groups, const int32_t* group_counts, int32_t* out_offsets) {
  int max_len = 0;
  for (int i = 0; i < table_size; i++)
    if (lengths[i] > max_len) max_len = lengths[i];
  if (max_len <= 0 || max_len > 32) return -1;
  const int lut_bits = max_len < 12 ? max_len : 12;
  const int lut_size = 1 << lut_bits;
  int16_t* lut_len = new int16_t[lut_size]();
  uint32_t first_code[33] = {0};
  int32_t count_len[33] = {0};
  bool has_len[33] = {false};
  for (int i = 0; i < table_size; i++) {
    const int len = lengths[i];
    if (len <= 0) continue;
    if (!has_len[len]) { has_len[len] = true; first_code[len] = codes[i]; }
    else if (codes[i] < first_code[len]) first_code[len] = codes[i];
    count_len[len]++;
    if (len <= lut_bits) {
      const uint32_t base = codes[i] << (lut_bits - len);
      const uint32_t span = 1u << (lut_bits - len);
      for (uint32_t k = 0; k < span; k++) lut_len[base + k] = (int16_t)len;
    }
  }
  // 13-bit multi-symbol LUT, packed (nSyms << 4) | totalLen in one byte:
  // 8 KB stays L1-resident, which is what makes the hot loop fast (a
  // 16-bit table measured L2-bound at ~235 Msym/s; this layout ~3-4x).
  // With only k < lut_bits lookahead bits a zero-padded lookup is sound
  // iff the resolved length <= k (prefix property: the code is those top
  // bits themselves).
  const int MB = 13;
  uint8_t* multi = new uint8_t[1 << MB];
  uint16_t* mlens = new uint16_t[1 << MB];  // first <= 4 lengths, nibbles
  for (uint32_t v = 0; v < (1u << MB); v++) {
    int tl = 0, ns = 0;
    uint16_t ls = 0;
    while (tl < MB && ns < 15) {
      const int k = MB - tl;
      const int take = lut_bits < k ? lut_bits : k;
      uint32_t win = ((v << tl) & ((1u << MB) - 1)) >> (MB - take);
      win <<= (lut_bits - take);  // zero-pad to the LUT width
      const int len = lut_len[win];
      if (len == 0 || len > k) break;
      if (ns < 4) ls |= (uint16_t)(len << (4 * ns));
      tl += len;
      ns++;
    }
    multi[v] = (uint8_t)((ns << 4) | tl);
    mlens[v] = ls;
  }

  // uniform groups (every entry `G` except a tail; the unmasked whole-
  // image layout) on a sizable stream: speculative chunk-parallel scan
  {
    bool uniform = n_groups > 0;
    const int32_t G0 = group_counts[0];
    int64_t n_symbols = 0;
    for (int32_t g2 = 0; g2 < n_groups; g2++) {
      n_symbols += group_counts[g2];
      if (group_counts[g2] != G0 && g2 != n_groups - 1) uniform = false;
    }
    if (uniform && n_groups >= 2 && group_counts[n_groups - 1] <= G0
        && n_symbols > 0) {
      spec_scan::Tables t{lut_len, multi, mlens, lut_bits, max_len,
                          first_code, count_len, has_len};
      const int64_t r = spec_scan::run(buf, buf_len, t, n_symbols,
                                       n_groups, G0, out_offsets);
      if (r >= 0) {
        delete[] lut_len; delete[] multi; delete[] mlens;
        return r;
      }
    }
  }

  const int64_t total_bits = (buf_len / 4) * 32;
  auto read_window = [&](int64_t p, int n) -> uint32_t {
    uint32_t w0, w1 = 0;
    const int64_t word = p >> 5;
    const int off = (int)(p & 31);
    memcpy(&w0, buf + word * 4, 4);
    if ((word + 2) * 4 <= buf_len) memcpy(&w1, buf + (word + 1) * 4, 4);
    const uint64_t both = ((uint64_t)w0 << 32) | w1;
    return (uint32_t)((both << off) >> (64 - n));
  };

  int64_t bitpos = 0;
  bool ok = true;
  // rolling 64-bit window: bits [bitpos, bitpos + 32) live at the top of
  // (cur << off); refill crosses at most one word per multi step
  for (int32_t g = 0; g < n_groups && ok; g++) {
    out_offsets[g] = (int32_t)bitpos;
    const int32_t cnt = group_counts[g];
    int32_t s = 0;
    if (bitpos + 64 <= total_bits) {
      int64_t word = bitpos >> 5;
      uint32_t w0, w1;
      memcpy(&w0, buf + word * 4, 4);
      memcpy(&w1, buf + word * 4 + 4, 4);
      uint64_t cur = ((uint64_t)w0 << 32) | w1;
      int off = (int)(bitpos & 31);
      // fast path: whole multi steps while >= 32 lookahead bits remain
      while (s < cnt) {
        const uint32_t win = (uint32_t)((cur << off) >> (64 - MB));
        const uint8_t e = multi[win];
        const int ns = e >> 4;
        if (!ns || s + ns > cnt) break;  // long code or group boundary
        const int tl = e & 15;
        off += tl;
        bitpos += tl;
        s += ns;
        if (off >= 32) {
          word++;
          if ((word + 2) * 4 > buf_len) break;  // tail: exact path below
          uint32_t wn;
          memcpy(&wn, buf + word * 4 + 4, 4);
          cur = (cur << 32) | wn;
          off -= 32;
        }
      }
    }
    while (s < cnt) {
      if (bitpos + 16 <= total_bits) {
        const uint8_t e = multi[read_window(bitpos, MB)];
        const int ns = e >> 4;
        if (ns && s + ns <= cnt) { bitpos += (e & 15); s += ns; continue; }
      }
      // single-symbol step (window tail, long code, or group boundary)
      if (bitpos + lut_bits > total_bits) { ok = false; break; }
      int len = lut_len[read_window(bitpos, lut_bits)];
      if (len == 0) {
        uint32_t code;
        len = lut_bits;
        bool found = false;
        while (len < max_len) {
          len++;
          if (bitpos + len > total_bits) break;
          code = read_window(bitpos, len);
          if (has_len[len] && code >= first_code[len]
              && code < first_code[len] + (uint32_t)count_len[len]) {
            found = true;
            break;
          }
        }
        if (!found) { ok = false; break; }
      }
      bitpos += len;
      s++;
    }
  }
  delete[] lut_len; delete[] multi; delete[] mlens;
  return ok ? bitpos : -1;
}

// ---------------------------------------------------------------------------
// RLE codec (mask sections). Run-segmentation formulation of the wire's
// greedy rules, mirroring the Python codec in lerc_tpu/codec/rle.py: a
// maximal equal-byte run becomes a repeat segment iff it spans >= 5 bytes
// AND starts with lookahead room (start + 5 < n); bytes between repeat
// segments form one literal stretch; counts chunk at +/-32767; int16
// -32768 terminates the stream. Byte-identical to the reference encoder
// (verified against the oracle in tests/test_format_core.py).
int64_t lerc_rle_compress(const uint8_t* src, int64_t n, uint8_t* dst) {
  if (n <= 0) return -1;
  const int64_t kMinRepeat = 5, kCap = 32767;
  uint8_t* out = dst;
  auto put_count = [&](int16_t c) { memcpy(out, &c, 2); out += 2; };

  int64_t lit_from = 0;  // start of the pending literal stretch
  auto flush_literal = [&](int64_t end) {
    for (int64_t p = lit_from; p < end;) {
      int64_t take = (end - p < kCap) ? end - p : kCap;
      put_count((int16_t)take);
      memcpy(out, src + p, (size_t)take);
      out += take;
      p += take;
    }
  };

  for (int64_t i = 0; i < n;) {
    int64_t run = 1;
    while (i + run < n && src[i + run] == src[i]) run++;
    if (run >= kMinRepeat && i + kMinRepeat < n) {
      flush_literal(i);
      int64_t left = run;
      for (; left > kCap; left -= kCap) {
        put_count((int16_t)-kCap);
        *out++ = src[i];
      }
      put_count((int16_t)-left);
      *out++ = src[i];
      lit_from = i + run;
    }
    i += run;
  }
  flush_literal(n);
  put_count((int16_t)-32768);
  return out - dst;
}

int64_t lerc_rle_decompress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  int64_t pos = 0, o = 0;
  while (true) {
    if (pos + 2 > n) return -1;
    int16_t c;
    memcpy(&c, src + pos, 2);
    pos += 2;
    if (c == -32768) break;
    if (c > 0) {
      if (pos + c > n || o + c > cap) return -1;
      memcpy(dst + o, src + pos, c);
      pos += c; o += c;
    } else {
      if (pos + 1 > n || o - c > cap) return -1;
      memset(dst + o, src[pos], -c);
      pos += 1; o += -c;
    }
  }
  return o;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fletcher32 checksum, Lerc2 wire flavor: the message is read as big-endian
// 16-bit words (an odd trailing byte acts as b << 8), both running sums are
// seeded with 0xffff, and a single mod-65535 fold happens after every block
// of 359 words (the largest count that cannot overflow 32-bit accumulators)
// plus once at the end. Must be bit-identical to the reference checksum for
// interop; only the word/fold schedule above is wire-relevant.
extern "C" uint32_t lerc_fletcher32(const uint8_t* data, int64_t len) {
  uint64_t lo = 0xffff, hi = 0xffff;
  const int64_t kFoldEvery = 359;
  int64_t n_words = len >> 1;
  for (int64_t w = 0; w < n_words;) {
    int64_t stop = (n_words - w > kFoldEvery) ? w + kFoldEvery : n_words;
    for (; w < stop; ++w) {
      lo += ((uint32_t)data[2 * w] << 8) | data[2 * w + 1];
      hi += lo;
    }
    lo = (lo & 0xffff) + (lo >> 16);
    hi = (hi & 0xffff) + (hi >> 16);
  }
  if (len & 1) {
    lo += (uint32_t)data[len - 1] << 8;
    hi += lo;
  }
  lo = (lo & 0xffff) + (lo >> 16);
  hi = (hi & 0xffff) + (hi >> 16);
  return (uint32_t)((hi << 16) | lo);
}

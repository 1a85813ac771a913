// A Zstandard frame decoder (RFC 8878) and CRC-32C, for reading the JAX
// package's orbax checkpoints (OCDBT nodes and zarr v2 chunks) on machines
// that have neither `zstandard` nor `tensorstore`.
//
// The decoder reads untrusted bytes: every read of the source and every
// write of the destination is bounds-checked, and malformed input returns a
// negative error code (never a crash). Output goes into a buffer the caller
// sizes; writing past it returns RZ_E_DST_SMALL.
//
// C interface:
//   int64_t rz_decompress(src, n, dst, cap, stats)
//       decodes every frame in src (skippable frames are skipped) into dst;
//       returns the decoded byte count or a negative error code. `stats`
//       (RZ_N_STATS int64 counters, or NULL) accumulates the block, literal
//       and sequence modes met.
//   int rz_content_size(src, n, uint64_t* size)
//       1 and the summed Frame_Content_Size when every frame declares it,
//       0 when one does not, a negative error code on a malformed header.
//   uint32_t rz_crc32c(p, n)
//       CRC-32C (Castagnoli), as OCDBT's manifest and node trailers use.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

namespace {

enum : int {
  RZ_E_TRUNCATED = -1,
  RZ_E_CORRUPT = -2,
  RZ_E_DST_SMALL = -3,
  RZ_E_DICTIONARY = -4,
  RZ_E_CHECKSUM = -5,
  RZ_E_CONTENT_SIZE = -6,
  RZ_E_NO_FRAME = -7,
  RZ_E_NO_MEMORY = -8,
};

enum Stat : int {
  ST_FRAMES, ST_SKIPPABLE, ST_BLOCK_RAW, ST_BLOCK_RLE, ST_BLOCK_COMPRESSED,
  ST_LIT_RAW, ST_LIT_RLE, ST_LIT_HUF1, ST_LIT_HUF4, ST_LIT_TREELESS,
  ST_SEQ_PREDEFINED, ST_SEQ_RLE, ST_SEQ_FSE, ST_SEQ_REPEAT, ST_CHECKSUMS,
  ST_SEQUENCES, RZ_N_STATS
};

struct Fail {
  int code;
};

[[noreturn]] void fail(int code) { throw Fail{code}; }
[[noreturn]] void corrupt() { fail(RZ_E_CORRUPT); }

constexpr size_t kBlockMax = 128 * 1024;

inline uint32_t le32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
         uint32_t(p[3]) << 24;
}

inline uint64_t le64(const uint8_t* p) {
  return uint64_t(le32(p)) | uint64_t(le32(p + 4)) << 32;
}

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// ---------------------------------------------------------------- bit I/O

// Forward little-endian bit reader (FSE table descriptions).
struct FwdBits {
  const uint8_t* p;
  size_t n;
  uint64_t pos = 0;  // bits consumed
  uint32_t read(int nb) {
    uint32_t v = 0;
    for (int i = 0; i < nb; ++i, ++pos) {
      size_t byte = pos >> 3;
      if (byte >= n) fail(RZ_E_TRUNCATED);
      v |= uint32_t((p[byte] >> (pos & 7)) & 1) << i;
    }
    return v;
  }
  uint32_t peek(int nb) const {
    uint32_t v = 0;
    for (int i = 0; i < nb; ++i) {
      uint64_t q = pos + i;
      size_t byte = q >> 3;
      if (byte < n) v |= uint32_t((p[byte] >> (q & 7)) & 1) << i;
    }
    return v;
  }
  size_t bytes() const { return size_t((pos + 7) >> 3); }
};

// Backward bit reader (Huffman streams, FSE-coded weights and sequences):
// the stream's last byte holds a 1 above its first bit; bits are read from
// the top down. Bits below the start read as zeros; `pos` going negative
// means the stream was over-read.
struct BackBits {
  const uint8_t* p = nullptr;
  size_t n = 0;
  int64_t pos = 0;  // bits left
  void init(const uint8_t* src, size_t len) {
    if (len == 0) corrupt();
    uint8_t last = src[len - 1];
    if (last == 0) corrupt();
    p = src;
    n = len;
    pos = int64_t(len - 1) * 8 + highbit(last);
  }
  // The nb (<= 56) bits below pos, first-read bit highest.
  uint64_t peek(int nb) const {
    if (nb == 0 || pos <= 0) return 0;
    int64_t lo = pos - nb;
    int shift_up = 0;
    if (lo < 0) {
      shift_up = int(-lo);
      nb = int(pos);
      lo = 0;
    }
    size_t byte = size_t(lo >> 3);
    int sh = int(lo & 7);
    uint64_t v;
    if (byte + 8 <= n) {
      std::memcpy(&v, p + byte, 8);
    } else {
      v = 0;
      for (size_t i = 0; byte + i < n && i < 8; ++i)
        v |= uint64_t(p[byte + i]) << (8 * i);
    }
    v = (v >> sh) & ((uint64_t(1) << nb) - 1);
    return v << shift_up;
  }
  uint64_t read(int nb) {
    uint64_t v = peek(nb);
    pos -= nb;
    return v;
  }
};

// -------------------------------------------------------------------- FSE

struct FseCell {
  uint16_t symbol;
  uint8_t nbits;
  uint16_t base;
};

struct FseTable {
  int log = 0;
  std::vector<FseCell> cells;
  bool valid = false;
};

void build_fse(FseTable& t, const int16_t* norm, int nsym, int log) {
  const int size = 1 << log;
  t.log = log;
  t.cells.assign(size, FseCell{0, 0, 0});
  std::vector<uint16_t> next(nsym);
  int high = size - 1;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      if (high < 0) corrupt();
      t.cells[high--].symbol = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint16_t(norm[s] > 0 ? norm[s] : 0);
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3;
  const int mask = size - 1;
  int position = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t.cells[position].symbol = uint16_t(s);
      do {
        position = (position + step) & mask;
      } while (position > high);
    }
  }
  if (position != 0) corrupt();
  for (int u = 0; u < size; ++u) {
    FseCell& c = t.cells[u];
    uint32_t state = next[c.symbol]++;
    if (state == 0) corrupt();
    int nb = log - highbit(state);
    c.nbits = uint8_t(nb);
    c.base = uint16_t((state << nb) - size);
  }
  t.valid = true;
}

// Reads an FSE table description; returns the bytes it took.
size_t read_fse(FseTable& t, const uint8_t* src, size_t n, int max_log,
                int max_sym) {
  FwdBits br{src, n};
  int log = int(br.read(4)) + 5;
  if (log > max_log) corrupt();
  int16_t norm[256] = {0};
  int remaining = (1 << log) + 1;
  int threshold = 1 << log;
  int nbits = log + 1;
  int sym = 0;
  bool prev0 = false;
  while (remaining > 1 && sym <= max_sym) {
    if (prev0) {
      uint32_t rep;
      do {
        rep = br.read(2);
        sym += int(rep);
      } while (rep == 3);
      if (sym > max_sym) corrupt();
    }
    int max = (2 * threshold - 1) - remaining;
    int count;
    uint32_t low = br.peek(nbits - 1);
    if (int(low) < max) {
      count = int(low);
      br.read(nbits - 1);
    } else {
      count = int(br.read(nbits));
      if (count >= threshold) count -= max;
    }
    count -= 1;
    remaining -= count < 0 ? -count : count;
    if (remaining < 1) corrupt();
    norm[sym++] = int16_t(count);
    prev0 = count == 0;
    while (remaining < threshold) {
      nbits -= 1;
      threshold >>= 1;
    }
  }
  if (remaining != 1 || sym > max_sym + 1) corrupt();
  build_fse(t, norm, sym, log);
  return br.bytes();
}

void rle_fse(FseTable& t, uint8_t symbol) {
  t.log = 0;
  t.cells.assign(1, FseCell{symbol, 0, 0});
  t.valid = true;
}

struct FseState {
  const FseTable* t;
  uint32_t state;
  void init(BackBits& br, const FseTable& table) {
    t = &table;
    state = uint32_t(br.read(table.log));
  }
  uint16_t symbol() const { return t->cells[state].symbol; }
  void update(BackBits& br) {
    const FseCell& c = t->cells[state];
    state = c.base + uint32_t(br.read(c.nbits));
  }
};

// ---------------------------------------------------------------- Huffman

struct HufCell {
  uint8_t symbol;
  uint8_t nbits;
};

struct HufTable {
  int max_bits = 0;
  std::vector<HufCell> cells;
  bool valid = false;
};

// Reads a Huffman tree description; returns the bytes it took.
size_t read_huffman(HufTable& h, const uint8_t* src, size_t n) {
  if (n < 1) fail(RZ_E_TRUNCATED);
  uint8_t weights[256] = {0};
  int nweights;
  size_t used;
  int header = src[0];
  if (header >= 128) {
    nweights = header - 127;
    size_t bytes = size_t(nweights + 1) / 2;
    if (1 + bytes > n) fail(RZ_E_TRUNCATED);
    for (int i = 0; i < nweights; ++i) {
      uint8_t b = src[1 + i / 2];
      weights[i] = (i % 2 == 0) ? (b >> 4) : (b & 15);
    }
    used = 1 + bytes;
  } else {
    size_t csize = size_t(header);
    if (csize == 0) corrupt();
    if (1 + csize > n) fail(RZ_E_TRUNCATED);
    FseTable t;
    size_t desc = read_fse(t, src + 1, csize, 6, 255);
    if (desc >= csize) corrupt();
    BackBits br;
    br.init(src + 1 + desc, csize - desc);
    FseState s1, s2;
    s1.init(br, t);
    s2.init(br, t);
    if (br.pos < 0) corrupt();
    nweights = 0;
    for (;;) {
      if (nweights > 253) corrupt();
      weights[nweights++] = uint8_t(s1.symbol());
      s1.update(br);
      if (br.pos < 0) {
        weights[nweights++] = uint8_t(s2.symbol());
        break;
      }
      weights[nweights++] = uint8_t(s2.symbol());
      s2.update(br);
      if (br.pos < 0) {
        if (nweights > 254) corrupt();
        weights[nweights++] = uint8_t(s1.symbol());
        break;
      }
    }
    used = 1 + csize;
  }
  if (nweights > 255) corrupt();
  uint32_t sum = 0;
  for (int i = 0; i < nweights; ++i) {
    if (weights[i] > 11) corrupt();
    if (weights[i]) sum += uint32_t(1) << (weights[i] - 1);
  }
  if (sum == 0) corrupt();
  int max_bits = highbit(sum) + 1;
  uint32_t left = (uint32_t(1) << max_bits) - sum;
  if (left == 0 || (left & (left - 1))) corrupt();
  if (max_bits > 11) corrupt();
  weights[nweights] = uint8_t(highbit(left) + 1);
  int nsym = nweights + 1;
  if (nsym > 256) corrupt();
  h.max_bits = max_bits;
  h.cells.assign(size_t(1) << max_bits, HufCell{0, 0});
  uint32_t rank_start[13] = {0};
  uint32_t rank_count[13] = {0};
  for (int s = 0; s < nsym; ++s) rank_count[weights[s]]++;
  uint32_t next = 0;
  for (int w = 1; w <= max_bits; ++w) {
    rank_start[w] = next;
    next += rank_count[w] << (w - 1);
  }
  if (next != (uint32_t(1) << max_bits)) corrupt();
  for (int s = 0; s < nsym; ++s) {
    int w = weights[s];
    if (!w) continue;
    uint32_t len = uint32_t(1) << (w - 1);
    HufCell c{uint8_t(s), uint8_t(max_bits + 1 - w)};
    for (uint32_t i = 0; i < len; ++i) h.cells[rank_start[w] + i] = c;
    rank_start[w] += len;
  }
  h.valid = true;
  return used;
}

struct HufStream {
  BackBits br;
  uint8_t* out;
  size_t count;
  size_t i = 0;
};

// Four symbols from one 57-bit load, while the stream has that many bits
// left above its start (max_bits <= 11, so 4 codes take at most 44 bits).
inline bool huffman_fast4(HufStream& s, const HufCell* cells, int mb) {
  if (s.br.pos < 57 || s.i + 4 > s.count) return false;
  int64_t lo = s.br.pos - 57;
  uint64_t v;
  std::memcpy(&v, s.br.p + (lo >> 3), 8);
  v >>= (lo & 7);
  const uint64_t mask = (uint64_t(1) << mb) - 1;
  int used = 0;
  for (int k = 0; k < 4; ++k) {
    const HufCell c = cells[(v >> (57 - used - mb)) & mask];
    s.out[s.i++] = c.symbol;
    used += c.nbits;
  }
  s.br.pos -= used;
  return true;
}

// Decodes 1 or 4 streams, interleaved; each must end exactly at its start.
void huffman_streams(const HufTable& h, HufStream* streams, int k) {
  const int mb = h.max_bits;
  const HufCell* cells = h.cells.data();
  for (bool any = true; any;) {
    any = false;
    for (int j = 0; j < k; ++j) any |= huffman_fast4(streams[j], cells, mb);
  }
  for (int j = 0; j < k; ++j) {
    HufStream& s = streams[j];
    for (; s.i < s.count; ++s.i) {
      const HufCell& c = cells[s.br.peek(mb)];
      s.out[s.i] = c.symbol;
      s.br.pos -= c.nbits;
      if (s.br.pos < 0) corrupt();
    }
    if (s.br.pos != 0) corrupt();
  }
}

// -------------------------------------------------------------- sequences

const uint32_t kLLBase[36] = {
    0,    1,    2,     3,     4,     5,     6,     7,     8,    9,     10,   11,
    12,   13,   14,    15,    16,    18,    20,    22,    24,   28,    32,   40,
    48,   64,   128,   256,   512,   1024,  2048,  4096,  8192, 16384, 32768,
    65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2,  3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,   4,   5,    6,    7,    8,    9,    10,   11,    12,    13,
    14,  15,  16,   17,   18,   19,   20,   21,   22,    23,    24,
    25,  26,  27,   28,   29,   30,   31,   32,   33,    34,    35,
    37,  39,  41,   43,   47,   51,   59,   67,   83,    99,    131,
    259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1};

// Per-frame decoder state: tables and repeat offsets carry across blocks.
struct Frame {
  uint8_t* dst;       // frame output start
  size_t cap;         // bytes available from dst
  size_t out = 0;     // bytes written
  uint32_t rep[3] = {1, 4, 8};
  HufTable huf;
  FseTable ll, of, ml;
  std::vector<uint8_t> lit;
  int64_t* stats;

  void count(int what) {
    if (stats) stats[what]++;
  }
  void need(size_t bytes) {
    if (bytes > cap - out) fail(RZ_E_DST_SMALL);
  }

  // Literals section; returns the bytes it took, sets lit_ptr/lit_n.
  size_t literals(const uint8_t* src, size_t n, const uint8_t*& lit_ptr,
                  size_t& lit_n) {
    if (n < 1) fail(RZ_E_TRUNCATED);
    int type = src[0] & 3;
    int sf = (src[0] >> 2) & 3;
    if (type == 0 || type == 1) {
      size_t hsize, regen;
      if (sf == 0 || sf == 2) {
        hsize = 1;
        regen = src[0] >> 3;
      } else if (sf == 1) {
        if (n < 2) fail(RZ_E_TRUNCATED);
        hsize = 2;
        regen = (src[0] >> 4) + (size_t(src[1]) << 4);
      } else {
        if (n < 3) fail(RZ_E_TRUNCATED);
        hsize = 3;
        regen = (src[0] >> 4) + (size_t(src[1]) << 4) + (size_t(src[2]) << 12);
      }
      if (regen > kBlockMax) corrupt();
      if (type == 0) {
        count(ST_LIT_RAW);
        if (regen > n - hsize) fail(RZ_E_TRUNCATED);
        lit_ptr = src + hsize;
        lit_n = regen;
        return hsize + regen;
      }
      count(ST_LIT_RLE);
      if (n < hsize + 1) fail(RZ_E_TRUNCATED);
      lit.assign(regen, src[hsize]);
      lit_ptr = lit.data();
      lit_n = regen;
      return hsize + 1;
    }
    size_t hsize, regen, csize;
    int streams = sf == 0 ? 1 : 4;
    if (sf <= 1) {
      if (n < 3) fail(RZ_E_TRUNCATED);
      uint32_t h = src[0] | uint32_t(src[1]) << 8 | uint32_t(src[2]) << 16;
      hsize = 3;
      regen = (h >> 4) & 0x3FF;
      csize = (h >> 14) & 0x3FF;
    } else if (sf == 2) {
      if (n < 4) fail(RZ_E_TRUNCATED);
      uint32_t h = le32(src);
      hsize = 4;
      regen = (h >> 4) & 0x3FFF;
      csize = (h >> 18) & 0x3FFF;
    } else {
      if (n < 5) fail(RZ_E_TRUNCATED);
      uint64_t h = uint64_t(le32(src)) | uint64_t(src[4]) << 32;
      hsize = 5;
      regen = size_t((h >> 4) & 0x3FFFF);
      csize = size_t((h >> 22) & 0x3FFFF);
    }
    if (regen > kBlockMax) corrupt();
    if (csize > n - hsize) fail(RZ_E_TRUNCATED);
    const uint8_t* p = src + hsize;
    size_t left = csize;
    if (type == 2) {
      size_t used = read_huffman(huf, p, left);
      p += used;
      left -= used;
    } else {
      count(ST_LIT_TREELESS);
      if (!huf.valid) corrupt();
    }
    if (type == 2) count(streams == 1 ? ST_LIT_HUF1 : ST_LIT_HUF4);
    lit.resize(regen);
    HufStream hs[4];
    if (streams == 1) {
      hs[0].br.init(p, left);
      hs[0].out = lit.data();
      hs[0].count = regen;
      huffman_streams(huf, hs, 1);
    } else {
      if (left < 6) corrupt();
      size_t s1 = p[0] | size_t(p[1]) << 8;
      size_t s2 = p[2] | size_t(p[3]) << 8;
      size_t s3 = p[4] | size_t(p[5]) << 8;
      size_t body = left - 6;
      if (s1 + s2 + s3 > body) corrupt();
      size_t s4 = body - s1 - s2 - s3;
      size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) corrupt();
      const uint8_t* q = p + 6;
      const size_t sizes[4] = {s1, s2, s3, s4};
      for (int j = 0; j < 4; ++j) {
        hs[j].br.init(q, sizes[j]);
        hs[j].out = lit.data() + j * seg;
        hs[j].count = j < 3 ? seg : regen - 3 * seg;
        q += sizes[j];
      }
      huffman_streams(huf, hs, 4);
    }
    lit_ptr = lit.data();
    lit_n = regen;
    return hsize + csize;
  }

  size_t table(FseTable& t, int mode, const uint8_t* src, size_t n,
               const int16_t* dflt, int dflt_n, int dflt_log, int max_log,
               int max_sym) {
    switch (mode) {
      case 0:
        count(ST_SEQ_PREDEFINED);
        build_fse(t, dflt, dflt_n, dflt_log);
        return 0;
      case 1:
        count(ST_SEQ_RLE);
        if (n < 1) fail(RZ_E_TRUNCATED);
        if (src[0] > max_sym) corrupt();
        rle_fse(t, src[0]);
        return 1;
      case 2:
        count(ST_SEQ_FSE);
        return read_fse(t, src, n, max_log, max_sym);
      default:
        count(ST_SEQ_REPEAT);
        if (!t.valid) corrupt();
        return 0;
    }
  }

  void compressed_block(const uint8_t* src, size_t n) {
    const uint8_t* lit_ptr = nullptr;
    size_t lit_n = 0;
    size_t used = literals(src, n, lit_ptr, lit_n);
    const uint8_t* p = src + used;
    size_t left = n - used;
    if (left < 1) fail(RZ_E_TRUNCATED);
    size_t nseq;
    if (p[0] == 0) {
      nseq = 0;
      p += 1;
      left -= 1;
    } else if (p[0] < 128) {
      nseq = p[0];
      p += 1;
      left -= 1;
    } else if (p[0] < 255) {
      if (left < 2) fail(RZ_E_TRUNCATED);
      nseq = (size_t(p[0] - 128) << 8) + p[1];
      p += 2;
      left -= 2;
    } else {
      if (left < 3) fail(RZ_E_TRUNCATED);
      nseq = p[1] + (size_t(p[2]) << 8) + 0x7F00;
      p += 3;
      left -= 3;
    }
    size_t lit_pos = 0;
    if (nseq > 0) {
      if (left < 1) fail(RZ_E_TRUNCATED);
      int modes = p[0];
      if (modes & 3) corrupt();
      p += 1;
      left -= 1;
      size_t k;
      k = table(ll, (modes >> 6) & 3, p, left, kLLDefault, 36, 6, 9, 35);
      p += k;
      left -= k;
      k = table(of, (modes >> 4) & 3, p, left, kOFDefault, 29, 5, 8, 31);
      p += k;
      left -= k;
      k = table(ml, (modes >> 2) & 3, p, left, kMLDefault, 53, 6, 9, 52);
      p += k;
      left -= k;
      BackBits br;
      br.init(p, left);
      FseState sll, sof, sml;
      sll.init(br, ll);
      sof.init(br, of);
      sml.init(br, ml);
      for (size_t i = 0; i < nseq; ++i) {
        uint32_t ofc = sof.symbol();
        uint32_t mlc = sml.symbol();
        uint32_t llc = sll.symbol();
        if (ofc > 31 || mlc > 52 || llc > 35) corrupt();
        uint64_t ofv = (uint64_t(1) << ofc) + br.read(int(ofc));
        size_t mlen = kMLBase[mlc] + size_t(br.read(kMLBits[mlc]));
        size_t llen = kLLBase[llc] + size_t(br.read(kLLBits[llc]));
        if (i + 1 < nseq) {
          sll.update(br);
          sml.update(br);
          sof.update(br);
        }
        if (br.pos < 0) corrupt();
        uint64_t offset;
        if (ofv > 3) {
          offset = ofv - 3;
          rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = uint32_t(offset);
        } else {
          uint32_t idx = uint32_t(ofv) + (llen == 0 ? 1 : 0);
          if (idx == 1) {
            offset = rep[0];
          } else if (idx == 2) {
            offset = rep[1];
            rep[1] = rep[0];
            rep[0] = uint32_t(offset);
          } else if (idx == 3) {
            offset = rep[2];
            rep[2] = rep[1];
            rep[1] = rep[0];
            rep[0] = uint32_t(offset);
          } else {
            offset = uint64_t(rep[0]) - 1;
            if (offset == 0) corrupt();
            rep[2] = rep[1];
            rep[1] = rep[0];
            rep[0] = uint32_t(offset);
          }
        }
        if (llen > lit_n - lit_pos) corrupt();
        need(llen);
        std::memcpy(dst + out, lit_ptr + lit_pos, llen);
        out += llen;
        lit_pos += llen;
        if (offset == 0 || offset > out) corrupt();
        need(mlen);
        uint8_t* o = dst + out;
        const uint8_t* from = o - offset;
        if (offset >= mlen) {
          std::memcpy(o, from, mlen);
        } else {
          for (size_t j = 0; j < mlen; ++j) o[j] = from[j];
        }
        out += mlen;
      }
      if (br.pos != 0) corrupt();
      if (stats) stats[ST_SEQUENCES] += int64_t(nseq);
    } else if (left != 0) {
      corrupt();
    }
    size_t rest = lit_n - lit_pos;
    need(rest);
    if (rest) std::memcpy(dst + out, lit_ptr + lit_pos, rest);
    out += rest;
  }
};

// -------------------------------------------------------------- checksums

uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                 P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                 P5 = 2870177450012600261ULL;
  auto round = [&](uint64_t acc, uint64_t in) {
    acc += in * P2;
    acc = rotl64(acc, 31);
    return acc * P1;
  };
  auto merge = [&](uint64_t acc, uint64_t v) {
    acc ^= round(0, v);
    return acc * P1 + P4;
  };
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = round(v1, le64(p));
      v2 = round(v2, le64(p + 8));
      v3 = round(v3, le64(p + 16));
      v4 = round(v4, le64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = merge(h, v1);
    h = merge(h, v2);
    h = merge(h, v3);
    h = merge(h, v4);
  } else {
    h = P5;
  }
  h += uint64_t(n);
  while (p + 8 <= end) {
    h ^= round(0, le64(p));
    h = rotl64(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= uint64_t(le32(p)) * P1;
    h = rotl64(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= uint64_t(*p) * P5;
    h = rotl64(h, 11) * P1;
    ++p;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

struct Crc32cTable {
  uint32_t t[8][256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 255];
  }
};

const Crc32cTable kCrc;

// ------------------------------------------------------------------ frames

struct Header {
  size_t size;         // header bytes
  bool has_fcs;
  uint64_t fcs;
  bool checksum;
};

Header frame_header(const uint8_t* src, size_t n) {
  // src points just past the magic number
  if (n < 1) fail(RZ_E_TRUNCATED);
  uint8_t fhd = src[0];
  int fcs_flag = fhd >> 6;
  bool single = (fhd >> 5) & 1;
  if ((fhd >> 3) & 1) corrupt();  // reserved bit
  bool checksum = (fhd >> 2) & 1;
  int did_flag = fhd & 3;
  size_t pos = 1;
  if (!single) {
    if (n < pos + 1) fail(RZ_E_TRUNCATED);
    pos += 1;  // window descriptor: blocks are capped at 128 KB anyway
  }
  static const int kDidSize[4] = {0, 1, 2, 4};
  int did = kDidSize[did_flag];
  if (n < pos + did) fail(RZ_E_TRUNCATED);
  uint32_t dict = 0;
  for (int i = 0; i < did; ++i) dict |= uint32_t(src[pos + i]) << (8 * i);
  pos += did;
  if (dict != 0) fail(RZ_E_DICTIONARY);
  int fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : (1 << fcs_flag);
  if (n < pos + fcs_size) fail(RZ_E_TRUNCATED);
  uint64_t fcs = 0;
  for (int i = 0; i < fcs_size; ++i) fcs |= uint64_t(src[pos + i]) << (8 * i);
  if (fcs_size == 2) fcs += 256;
  pos += fcs_size;
  return Header{pos, fcs_size > 0, fcs, checksum};
}

// Decodes one frame at src (past its magic); returns the source bytes used.
size_t decode_frame(const uint8_t* src, size_t n, uint8_t* dst, size_t cap,
                    size_t& produced, int64_t* stats) {
  Header h = frame_header(src, n);
  size_t pos = h.size;
  Frame f;
  f.dst = dst;
  f.cap = cap;
  f.stats = stats;
  f.count(ST_FRAMES);
  for (;;) {
    if (n - pos < 3) fail(RZ_E_TRUNCATED);
    uint32_t bh = src[pos] | uint32_t(src[pos + 1]) << 8 |
                  uint32_t(src[pos + 2]) << 16;
    pos += 3;
    bool last = bh & 1;
    int type = (bh >> 1) & 3;
    size_t size = bh >> 3;
    if (type == 3) corrupt();
    if (size > kBlockMax) corrupt();
    if (type == 1) {
      f.count(ST_BLOCK_RLE);
      if (n - pos < 1) fail(RZ_E_TRUNCATED);
      f.need(size);
      std::memset(dst + f.out, src[pos], size);
      f.out += size;
      pos += 1;
    } else {
      if (size > n - pos) fail(RZ_E_TRUNCATED);
      if (type == 0) {
        f.count(ST_BLOCK_RAW);
        f.need(size);
        if (size) std::memcpy(dst + f.out, src + pos, size);
        f.out += size;
      } else {
        f.count(ST_BLOCK_COMPRESSED);
        size_t before = f.out;
        f.compressed_block(src + pos, size);
        if (f.out - before > kBlockMax) corrupt();
      }
      pos += size;
    }
    if (last) break;
  }
  if (h.has_fcs && h.fcs != f.out) fail(RZ_E_CONTENT_SIZE);
  if (h.checksum) {
    if (n - pos < 4) fail(RZ_E_TRUNCATED);
    uint32_t want = le32(src + pos);
    if (uint32_t(xxh64(dst, f.out)) != want) fail(RZ_E_CHECKSUM);
    f.count(ST_CHECKSUMS);
    pos += 4;
  }
  produced = f.out;
  return pos;
}

constexpr uint32_t kMagic = 0xFD2FB528u;

bool skippable(uint32_t magic) { return (magic & 0xFFFFFFF0u) == 0x184D2A50u; }

}  // namespace

extern "C" {

int rz_n_stats() { return RZ_N_STATS; }

int64_t rz_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap,
                      int64_t* stats) {
  try {
    size_t pos = 0, out = 0;
    bool frames = false;
    while (pos < n) {
      if (n - pos < 4) fail(RZ_E_TRUNCATED);
      uint32_t magic = le32(src + pos);
      if (skippable(magic)) {
        if (n - pos < 8) fail(RZ_E_TRUNCATED);
        uint32_t size = le32(src + pos + 4);
        if (size > n - pos - 8) fail(RZ_E_TRUNCATED);
        pos += 8 + size;
        if (stats) stats[ST_SKIPPABLE]++;
        continue;
      }
      if (magic != kMagic) corrupt();
      size_t produced = 0;
      pos += 4;
      pos += decode_frame(src + pos, n - pos, dst + out, cap - out, produced,
                          stats);
      out += produced;
      frames = true;
    }
    if (!frames) fail(RZ_E_NO_FRAME);
    return int64_t(out);
  } catch (const Fail& e) {
    return e.code;
  } catch (const std::bad_alloc&) {
    return RZ_E_NO_MEMORY;
  } catch (...) {
    return RZ_E_CORRUPT;
  }
}

int rz_content_size(const uint8_t* src, size_t n, uint64_t* size) {
  // Walks frame headers only: needs every block header to find the next
  // frame, so it reads block sizes but decodes nothing.
  try {
    size_t pos = 0;
    uint64_t total = 0;
    bool frames = false;
    while (pos < n) {
      if (n - pos < 4) fail(RZ_E_TRUNCATED);
      uint32_t magic = le32(src + pos);
      if (skippable(magic)) {
        if (n - pos < 8) fail(RZ_E_TRUNCATED);
        uint32_t s = le32(src + pos + 4);
        if (s > n - pos - 8) fail(RZ_E_TRUNCATED);
        pos += 8 + s;
        continue;
      }
      if (magic != kMagic) corrupt();
      pos += 4;
      Header h = frame_header(src + pos, n - pos);
      if (!h.has_fcs) return 0;
      total += h.fcs;
      frames = true;
      pos += h.size;
      for (;;) {
        if (n - pos < 3) fail(RZ_E_TRUNCATED);
        uint32_t bh = src[pos] | uint32_t(src[pos + 1]) << 8 |
                      uint32_t(src[pos + 2]) << 16;
        pos += 3;
        size_t bsize = (((bh >> 1) & 3) == 1) ? 1 : (bh >> 3);
        if (bsize > n - pos) fail(RZ_E_TRUNCATED);
        pos += bsize;
        if (bh & 1) break;
      }
      if (h.checksum) {
        if (n - pos < 4) fail(RZ_E_TRUNCATED);
        pos += 4;
      }
    }
    if (!frames) fail(RZ_E_NO_FRAME);
    *size = total;
    return 1;
  } catch (const Fail& e) {
    return e.code;
  } catch (...) {
    return RZ_E_CORRUPT;
  }
}

uint32_t rz_crc32c(const uint8_t* p, size_t n) {
  uint32_t c = 0xFFFFFFFFu;
  while (n >= 8) {
    uint32_t lo = c ^ le32(p);
    uint32_t hi = le32(p + 4);
    c = kCrc.t[7][lo & 255] ^ kCrc.t[6][(lo >> 8) & 255] ^
        kCrc.t[5][(lo >> 16) & 255] ^ kCrc.t[4][lo >> 24] ^
        kCrc.t[3][hi & 255] ^ kCrc.t[2][(hi >> 8) & 255] ^
        kCrc.t[1][(hi >> 16) & 255] ^ kCrc.t[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) c = (c >> 8) ^ kCrc.t[0][(c ^ *p++) & 255];
  return c ^ 0xFFFFFFFFu;
}

}  // extern "C"

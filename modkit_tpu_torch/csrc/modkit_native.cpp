// modkit_tpu_torch native runtime: BAM record decode + per-tile pileup
// event extraction, C++ implementation of the host hot loop.
//
// The port's own copy of the repository's native/modkit_native.cpp, which
// the JAX package keeps loading. It differs in the tile decode alone
// (mk_decode_tile): each read's alignment is walked as CIGAR runs clipped
// to the tile's window and, with a focus, to its focus columns, mapping
// only the calls that land there; no-calls and deletions are counted
// straight into per-thread tile histograms. Its output equals the
// original's, field for field (tests/test_torch_decode_walk.py). Its BGZF
// tile decode (mk_decode_tile_bgzf) takes a cache of inflated blocks that
// the tiles of a run share (BlockCache).
//
// The reference gets BAM decoding from C htslib (rust-htslib, Cargo.toml:49)
// and runs its per-read MM/ML decode + per-column aggregation in compiled
// Rust (mod_bam.rs, read_cache.rs, pileup/mod.rs). Here the same per-read
// work -- MM/ML/MN tag decode (mod_bam.rs:909 MmTagInfo::parse, :1213
// get_base_mod_probs incl. implicit-canonical inference), collapse
// (mod_bam.rs:530 into_collapsed), edge filter (mod_bam.rs:1635), aligned
// pairs (util.rs:122) and pileup event expansion (read_cache.rs:111
// add_record) -- runs in C++ threads, emitting flat columnar event arrays
// that Python ships straight to the device kernel.
//
// Semantics are kept bit-identical to the Python oracle implementation in
// modtags.py + pileup/events.py (which mirrors the reference). All
// probability arithmetic is float32 matching numpy's element order.

#include <algorithm>
#include <array>
#include <atomic>
#include <charconv>
#include <chrono>
#include <zlib.h>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <dlfcn.h>
#ifndef MK_NO_LZMA
#include <lzma.h>
#endif
#include <vector>

#if !defined(MK_NO_LIBDEFLATE) && __has_include(<libdeflate.h>)
#include <libdeflate.h>
#define MK_HAVE_LIBDEFLATE 1
#endif

namespace {

// ---------------------------------------------------------------- errors
// Index order must match modkit_tpu/native/__init__.py ERR_KINDS.
enum Err {
  E_MM_MISSING = 0,
  E_ML_MISSING = 1,
  E_INVALID_MM = 2,
  E_INVALID_ML = 3,
  E_INVALID_MN = 4,
  E_NON_PRIMARY_MN = 5,
  E_CONFLICT_GT1 = 6,
  E_CONFLICT_INF = 7,
  E_NO_MOD_INFO = 8,
  E_INVALID_IMPLICIT = 9,
  E_NKINDS = 10,
  E_OK = -1,
};

struct MkError {
  int kind;
};

#ifdef MK_HAVE_LIBDEFLATE
// A thread's libdeflate codecs, freed when the thread ends: the inflate
// pools start their threads per batch of blocks, so a codec held by a bare
// thread_local pointer leaked once per thread (about 0.5 MB a 100 kb tile).
struct ThreadCodecs {
  libdeflate_decompressor* dec = nullptr;
  libdeflate_compressor* comp = nullptr;
  int comp_level = -1;
  ~ThreadCodecs() {
    if (dec) libdeflate_free_decompressor(dec);
    if (comp) libdeflate_free_compressor(comp);
  }
  libdeflate_decompressor* decompressor() {
    if (dec == nullptr) dec = libdeflate_alloc_decompressor();
    return dec;
  }
};
thread_local ThreadCodecs thread_codecs;
#endif

// ---------------------------------------------------------------- tables
constexpr float kMaxProb = 1.01f;  // mod_bam.rs:26

// skip modes (mod_bam.rs:326): 0 = '?', 1 = '.', 2 = default(implicit)
constexpr int MODE_EXPLICIT = 0;
constexpr int MODE_IMPLICIT = 1;
constexpr int MODE_DEFAULT = 2;

inline bool mode_is_implicit(int m) { return m != MODE_EXPLICIT; }

static const char SEQ_NT16[] = "=ACMGRSVTWYHKDBN";

struct Tables {
  uint8_t nib_hi[256];
  uint8_t nib_lo[256];
  uint8_t compl_tab[256];
  int8_t base_lut[256];  // A0 C1 G2 T3 else -1
  Tables() {
    for (int i = 0; i < 256; ++i) {
      nib_hi[i] = (uint8_t)SEQ_NT16[i >> 4];
      nib_lo[i] = (uint8_t)SEQ_NT16[i & 0xF];
      compl_tab[i] = (uint8_t)i;
      base_lut[i] = -1;
    }
    compl_tab['A'] = 'T'; compl_tab['T'] = 'A';
    compl_tab['C'] = 'G'; compl_tab['G'] = 'C';
    compl_tab['a'] = 't'; compl_tab['t'] = 'a';
    compl_tab['c'] = 'g'; compl_tab['g'] = 'c';
    compl_tab['N'] = 'N'; compl_tab['n'] = 'n';
    compl_tab['U'] = 'A';
    base_lut['A'] = 0; base_lut['C'] = 1; base_lut['G'] = 2; base_lut['T'] = 3;
  }
};
static const Tables T;

inline int base_char_to_idx(char b) { return T.base_lut[(uint8_t)b]; }
constexpr int8_t IDX_COMPL[4] = {3, 2, 1, 0};

// mod code identity: >= 0 -> ChEBI numeric id, < 0 -> -(ASCII char code)
using Code = int64_t;
inline Code char_code(char c) { return -(int64_t)(uint8_t)c; }

// ------------------------------------------------------------- BAM record
struct Rec {
  const uint8_t* p;
  int64_t len;
  int32_t ref_id, pos;
  uint8_t l_read_name, mapq;
  uint16_t n_cigar, flag;
  uint32_t l_seq;

  void parse_head() {
    std::memcpy(&ref_id, p + 0, 4);
    std::memcpy(&pos, p + 4, 4);
    l_read_name = p[8];
    mapq = p[9];
    std::memcpy(&n_cigar, p + 12, 2);
    std::memcpy(&flag, p + 14, 2);
    std::memcpy(&l_seq, p + 16, 4);
  }
  bool is_unmapped() const { return flag & 0x4; }
  bool is_reverse() const { return flag & 0x10; }
  bool is_not_primary() const { return flag & 0xD00; }  // sec|sup|dup
  const uint8_t* cigar() const { return p + 32 + l_read_name; }
  const uint8_t* seq4() const { return cigar() + 4 * (size_t)n_cigar; }
  int64_t aux_off() const {
    return 32 + l_read_name + 4 * (int64_t)n_cigar + (l_seq + 1) / 2 + l_seq;
  }
  int64_t reference_span() const {
    const uint8_t* cg = cigar();
    int64_t span = 0;
    for (int i = 0; i < n_cigar; ++i) {
      uint32_t v;
      std::memcpy(&v, cg + 4 * i, 4);
      uint32_t op = v & 0xF, l = v >> 4;
      // ops consuming reference: M D N = X  (0 2 3 7 8)
      if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8) span += l;
    }
    return span;
  }
};

// aux scan results for the tags the decoder needs. MM/Mm and ML/Ml are
// tracked separately: the new-style upper-case tag wins when both exist
// (modtags.py:433 parse_raw_mod_tags tries "MM" before "Mm").
struct TagSlot {
  bool present = false;
  bool wrong_type = false;
  const char* z = nullptr;      // Z payload (MM)
  const uint8_t* b = nullptr;   // BC payload (ML)
  int64_t b_n = -1;
};

struct AuxTags {
  bool bad = false;  // malformed aux region
  TagSlot mm_up, mm_lo;  // MM / Mm
  TagSlot ml_up, ml_lo;  // ML / Ml
  bool mn_present = false;
  bool mn_wrong_type = false;
  int64_t mn_value = -1;
};

inline int aux_b_itemsize(char sub) {
  switch (sub) {
    case 'c': case 'C': return 1;
    case 's': case 'S': return 2;
    case 'i': case 'I': case 'f': return 4;
    default: return -1;
  }
}

AuxTags scan_aux(const Rec& r) {
  AuxTags out;
  const uint8_t* buf = r.p;
  int64_t p = r.aux_off(), end = r.len;
  while (p + 3 <= end) {
    char t0 = (char)buf[p], t1 = (char)buf[p + 1];
    char typ = (char)buf[p + 2];
    p += 3;
    TagSlot* mm = nullptr;
    TagSlot* ml = nullptr;
    bool is_mn = false;
    if (t0 == 'M') {
      if (t1 == 'M') mm = &out.mm_up;
      else if (t1 == 'm') mm = &out.mm_lo;
      else if (t1 == 'L') ml = &out.ml_up;
      else if (t1 == 'l') ml = &out.ml_lo;
      else if (t1 == 'N') is_mn = true;
    }
    switch (typ) {
      case 'A': case 'c': case 'C': {
        if (is_mn) {
          out.mn_present = true;
          if (typ == 'A') out.mn_wrong_type = true;
          else out.mn_value = (typ == 'C') ? buf[p] : (int64_t)(int8_t)buf[p];
        } else if (mm) { mm->present = true; mm->wrong_type = true; }
        else if (ml) { ml->present = true; ml->wrong_type = true; }
        p += 1;
        break;
      }
      case 's': case 'S': {
        if (is_mn) {
          out.mn_present = true;
          uint16_t v; std::memcpy(&v, buf + p, 2);
          out.mn_value = (typ == 's') ? (int64_t)(int16_t)v : (int64_t)v;
        } else if (mm) { mm->present = true; mm->wrong_type = true; }
        else if (ml) { ml->present = true; ml->wrong_type = true; }
        p += 2;
        break;
      }
      case 'i': case 'I': {
        if (is_mn) {
          out.mn_present = true;
          uint32_t v; std::memcpy(&v, buf + p, 4);
          out.mn_value = (typ == 'i') ? (int64_t)(int32_t)v : (int64_t)v;
        } else if (mm) { mm->present = true; mm->wrong_type = true; }
        else if (ml) { ml->present = true; ml->wrong_type = true; }
        p += 4;
        break;
      }
      case 'f': {
        if (is_mn) { out.mn_present = true; out.mn_wrong_type = true; }
        else if (mm) { mm->present = true; mm->wrong_type = true; }
        else if (ml) { ml->present = true; ml->wrong_type = true; }
        p += 4;
        break;
      }
      case 'Z': case 'H': {
        int64_t q = p;
        while (q < end && buf[q] != 0) ++q;
        if (q >= end) { out.bad = true; return out; }
        if (mm) {
          mm->present = true;
          if (typ == 'Z') mm->z = (const char*)(buf + p);
          else mm->wrong_type = true;
        } else if (ml) { ml->present = true; ml->wrong_type = true; }
        else if (is_mn) { out.mn_present = true; out.mn_wrong_type = true; }
        p = q + 1;
        break;
      }
      case 'B': {
        if (p + 5 > end) { out.bad = true; return out; }
        char sub = (char)buf[p];
        uint32_t n; std::memcpy(&n, buf + p + 1, 4);
        int isz = aux_b_itemsize(sub);
        if (isz < 0) { out.bad = true; return out; }
        if (ml) {
          ml->present = true;
          if (sub == 'C') { ml->b = buf + p + 5; ml->b_n = n; }
          else { ml->wrong_type = true; }
        } else if (mm) { mm->present = true; mm->wrong_type = true; }
        else if (is_mn) { out.mn_present = true; out.mn_wrong_type = true; }
        p += 5 + (int64_t)n * isz;
        break;
      }
      default:
        out.bad = true;
        return out;
    }
  }
  return out;
}

// ------------------------------------------------------------ MM parsing
struct SubTag {
  char fundamental;  // A C G T U N
  int mod_strand;    // 0 '+', 1 '-'
  int mode;          // MODE_*
  std::vector<Code> codes;
  std::vector<int64_t> deltas;
  size_t stride() const { return codes.size(); }
  size_t size() const { return deltas.size() * codes.size(); }
};

// Parse one ';'-separated MM element (modtags.py:70 parse_mm_subtag,
// mod_bam.rs:909). Throws MkError{E_INVALID_MM}.
SubTag parse_mm_subtag(const char* s, const char* end) {
  const char* comma = s;
  while (comma < end && *comma != ',') ++comma;
  int64_t hlen = comma - s;
  if (hlen < 2) throw MkError{E_INVALID_MM};  // truncated header
  char base = s[0];
  if (!std::strchr("ACGTUN", base)) throw MkError{E_INVALID_MM};
  char strand_ch = s[1];
  int strand;
  if (strand_ch == '+') strand = 0;
  else if (strand_ch == '-') strand = 1;
  else throw MkError{E_INVALID_MM};

  SubTag st;
  st.fundamental = base;
  st.mod_strand = strand;
  st.mode = MODE_DEFAULT;
  const char* b = s + 2;
  const char* bend = comma;
  if (b < bend && *b >= '0' && *b <= '9') {
    // ChEBI numeric code; cannot be combined with char codes
    const char* j = b;
    int64_t v = 0;
    while (j < bend && *j >= '0' && *j <= '9') { v = v * 10 + (*j - '0'); ++j; }
    st.codes.push_back(v);
    while (j < bend) {
      char c = *j;
      if (c == '?') st.mode = MODE_EXPLICIT;
      else if (c == '.') st.mode = MODE_IMPLICIT;
      else throw MkError{E_INVALID_MM};  // 2nd ChEBI or mixing codes
      ++j;
    }
  } else {
    for (const char* j = b; j < bend; ++j) {
      char c = *j;
      if (c == '?') st.mode = MODE_EXPLICIT;
      else if (c == '.') st.mode = MODE_IMPLICIT;
      else if (c >= '0' && c <= '9') throw MkError{E_INVALID_MM};
      else st.codes.push_back(char_code(c));
    }
  }

  if (comma < end) {
    const char* t = comma + 1;
    while (t < end) {
      // strict decimal parse of one delta
      if (*t < '0' || *t > '9') throw MkError{E_INVALID_MM};
      int64_t v = 0;
      while (t < end && *t >= '0' && *t <= '9') { v = v * 10 + (*t - '0'); ++t; }
      st.deltas.push_back(v);
      if (t < end) {
        if (*t != ',') throw MkError{E_INVALID_MM};
        ++t;
        if (t == end) throw MkError{E_INVALID_MM};  // trailing comma
      }
    }
  }
  return st;
}

std::vector<SubTag> parse_mm_tag(const char* raw) {
  std::vector<SubTag> out;
  const char* s = raw;
  while (*s) {
    const char* e = s;
    while (*e && *e != ';') ++e;
    if (e > s) out.push_back(parse_mm_subtag(s, e));
    s = (*e == ';') ? e + 1 : e;
  }
  return out;
}

// --------------------------------------------------------- decoded groups
struct Piece {
  int mode;
  std::vector<Code> codes;
  std::vector<int32_t> pos;   // strictly increasing
  std::vector<float> probs;   // pos.size() x codes.size(), row-major
  bool inferred;
};

struct Group {
  char base;        // 'A'/'C'/'G'/'T'
  int mod_strand;
  int mode;
  std::vector<Code> codes;
  std::vector<int32_t> pos;       // sorted ascending
  std::vector<float> probs;       // n x m, -1 = absent
  std::vector<uint8_t> inferred;  // per position
  bool empty() const { return pos.empty(); }
};

inline float qual_to_prob(uint8_t q) { return ((float)q + 0.5f) / 256.0f; }

// combine_positions_to_probs / combine_checked (mod_bam.rs:626-658,
// 1041-1057; modtags.py:365 _merge_pieces)
Group merge_pieces(char base, int strand, std::vector<Piece>& plist) {
  Group g;
  g.base = base;
  g.mod_strand = strand;
  g.mode = plist[0].mode;
  for (auto& p : plist)
    if (p.mode != g.mode) { g.mode = MODE_IMPLICIT; break; }

  for (auto& p : plist)
    for (Code c : p.codes)
      if (std::find(g.codes.begin(), g.codes.end(), c) == g.codes.end())
        g.codes.push_back(c);
  size_t m = g.codes.size();

  if (plist.size() == 1) {
    Piece& p = plist[0];
    g.pos = std::move(p.pos);
    g.probs = std::move(p.probs);
    g.inferred.assign(g.pos.size(), p.inferred ? 1 : 0);
    return g;
  }

  // common nanopore layout: two sub-tags (e.g. C+h, C+m) over IDENTICAL
  // positions — the union is either list and the probs interleave
  // column-wise with no merge walk at all
  if (plist.size() == 2 && plist[0].pos == plist[1].pos &&
      plist[0].codes.size() == 1 && plist[1].codes.size() == 1 &&
      plist[0].inferred == plist[1].inferred && m == 2) {
    const Piece& a = plist[0];
    const Piece& b = plist[1];
    size_t n2 = a.pos.size();
    g.pos = a.pos;
    g.inferred.assign(n2, a.inferred ? 1 : 0);
    g.probs.resize(n2 * 2);
    size_t ca = (g.codes[0] == a.codes[0]) ? 0 : 1;
    for (size_t i = 0; i < n2; ++i) {
      float pa = a.probs[i];
      float pb = b.probs[i];
      g.probs[i * 2 + ca] = pa;
      g.probs[i * 2 + (1 - ca)] = pb;
      // shared-position sum check (combine_checked, mod_bam.rs:626)
      float sum = (pa > 0.0f ? pa : 0.0f) + (pb > 0.0f ? pb : 0.0f);
      if (sum > kMaxProb) throw MkError{E_CONFLICT_GT1};
    }
    return g;
  }

  // piece position lists are individually sorted (delta lists are
  // cumulative), so the union is a linear k-way merge — the previous
  // concat+sort was ~40% of decode_read_mods on 5 kb reads
  std::vector<int32_t> all = plist[0].pos;
  std::vector<int32_t> merged;
  for (size_t pi = 1; pi < plist.size(); ++pi) {
    const auto& b = plist[pi].pos;
    if (b.empty()) continue;
    if (!all.empty() && all.back() < b.front()) {
      all.insert(all.end(), b.begin(), b.end());
      continue;
    }
    merged.resize(all.size() + b.size());
    std::merge(all.begin(), all.end(), b.begin(), b.end(), merged.begin());
    all.swap(merged);
  }
  all.erase(std::unique(all.begin(), all.end()), all.end());
  size_t n = all.size();
  g.pos = all;
  g.probs.assign(n * m, -1.0f);
  g.inferred.assign(n, 0);
  std::vector<uint8_t> seen(n, 0), multi(n, 0);

  for (auto& p : plist) {
    if (p.pos.empty()) continue;
    size_t pm = p.codes.size();
    std::vector<size_t> cols(pm);
    for (size_t j = 0; j < pm; ++j)
      cols[j] = std::find(g.codes.begin(), g.codes.end(), p.codes[j]) -
                g.codes.begin();
    // two-pointer walk: p.pos is sorted and a subset of g.pos, so the
    // row cursor only moves forward (O(n) vs per-position lower_bound)
    size_t row = 0;
    for (size_t i = 0; i < p.pos.size(); ++i) {
      while (g.pos[row] < p.pos[i]) ++row;
      if (seen[row]) {
        // explicit/inferred flag mismatch at a shared position -> conflict
        if ((g.inferred[row] != 0) != p.inferred) throw MkError{E_CONFLICT_INF};
        multi[row] = 1;
      } else {
        g.inferred[row] = p.inferred ? 1 : 0;
        seen[row] = 1;
      }
      for (size_t j = 0; j < pm; ++j) {
        float cur = g.probs[row * m + cols[j]];
        float add = p.probs[i * pm + j];
        g.probs[row * m + cols[j]] = (cur < 0.0f) ? add : cur + add;
      }
    }
  }
  for (size_t row = 0; row < n; ++row) {
    if (!multi[row]) continue;
    float s = 0.0f;
    for (size_t j = 0; j < m; ++j) {
      float v = g.probs[row * m + j];
      s += (v > 0.0f) ? v : 0.0f;
    }
    if (s > kMaxProb) throw MkError{E_CONFLICT_GT1};
  }
  return g;
}

// ModBaseInfo::new equivalent (mod_bam.rs:1489-1566; modtags.py:267
// decode_read_mods). fwd is the forward (instrument-orientation) sequence.
struct ModInfo {
  // keys in first-seen order; iteration = strand 0 groups then strand 1
  std::vector<Group> groups;
};

ModInfo decode_read_mods(const std::vector<uint8_t>& fwd, const char* raw_mm,
                         const uint8_t* ml, int64_t ml_n) {
  std::vector<SubTag> subtags = parse_mm_tag(raw_mm);

  // base occurrence cache per fundamental base char ('U' matches 'T')
  std::vector<int32_t> occ_cache[6];
  bool occ_done[6] = {false, false, false, false, false, false};
  auto fb_slot = [](char fb) -> int {
    switch (fb) {
      case 'A': return 0; case 'C': return 1; case 'G': return 2;
      case 'T': return 3; case 'U': return 4; default: return 5;  // N
    }
  };
  auto base_positions = [&](char fb) -> const std::vector<int32_t>& {
    int s = fb_slot(fb);
    if (!occ_done[s]) {
      char want = (fb == 'U') ? 'T' : fb;
      auto& v = occ_cache[s];
      v.reserve(fwd.size() / 3);
      for (size_t i = 0; i < fwd.size(); ++i)
        if ((char)fwd[i] == want) v.push_back((int32_t)i);
      occ_done[s] = true;
    }
    return occ_cache[s];
  };

  // pieces per (base_char, strand) in first-seen key order
  std::vector<std::pair<char, int>> keys;
  std::vector<std::vector<Piece>> pieces;
  auto piece_list = [&](char b, int strand) -> std::vector<Piece>& {
    for (size_t i = 0; i < keys.size(); ++i)
      if (keys[i].first == b && keys[i].second == strand) return pieces[i];
    keys.emplace_back(b, strand);
    pieces.emplace_back();
    return pieces.back();
  };

  int64_t pointer = 0;
  for (auto& st : subtags) {
    char fb = st.fundamental;
    // deltas -> forward-seq positions (mod_bam.rs:694 to_positions)
    std::vector<int32_t> positions;
    if (!st.deltas.empty()) {
      if (fb == 'N') {
        int64_t cum = 0;
        positions.reserve(st.deltas.size());
        for (size_t i = 0; i < st.deltas.size(); ++i) {
          cum += st.deltas[i];
          int64_t pos = cum + (int64_t)i;
          if (pos >= (int64_t)fwd.size()) throw MkError{E_INVALID_MM};
          positions.push_back((int32_t)pos);
        }
      } else {
        const auto& bp = base_positions(fb);
        int64_t occ = -1;
        positions.reserve(st.deltas.size());
        for (int64_t d : st.deltas) {
          occ += d + 1;
          if (occ >= (int64_t)bp.size()) throw MkError{E_INVALID_MM};
          positions.push_back(bp[occ]);
        }
      }
    }
    int64_t endp = pointer + (int64_t)st.size();
    if (endp > ml_n) throw MkError{E_INVALID_ML};
    size_t stride = st.stride();
    // probs for this sub-tag, row-major [n, stride]
    std::vector<float> probs(positions.size() * stride);
    for (size_t i = 0; i < positions.size() * stride; ++i)
      probs[i] = qual_to_prob(ml[pointer + (int64_t)i]);
    pointer = endp;

    if (fb == 'N') {
      // group explicit positions by their actual sequence base, ACGT order
      size_t n_known = 0;
      for (char b : {'A', 'C', 'G', 'T'}) {
        std::vector<int64_t> sel;
        for (size_t i = 0; i < positions.size(); ++i)
          if ((char)fwd[positions[i]] == b) sel.push_back((int64_t)i);
        if (sel.empty()) continue;
        n_known += sel.size();
        Piece pc;
        pc.mode = st.mode;
        pc.codes = st.codes;
        pc.inferred = false;
        pc.pos.reserve(sel.size());
        pc.probs.reserve(sel.size() * stride);
        for (int64_t i : sel) {
          pc.pos.push_back(positions[i]);
          for (size_t j = 0; j < stride; ++j)
            pc.probs.push_back(probs[i * stride + j]);
        }
        piece_list(b, st.mod_strand).push_back(std::move(pc));
      }
      if (n_known != positions.size()) throw MkError{E_INVALID_MM};
    } else {
      char b = (fb == 'U') ? 'T' : fb;
      for (int64_t pos : positions)
        if ((char)fwd[pos] != b) throw MkError{E_INVALID_MM};
      Piece pc;
      pc.mode = st.mode;
      pc.codes = st.codes;
      pc.inferred = false;
      pc.pos = positions;
      pc.probs = std::move(probs);
      piece_list(b, st.mod_strand).push_back(std::move(pc));

      // implicit-canonical inference (mod_bam.rs:1265-1292)
      if (mode_is_implicit(st.mode)) {
        const auto& bp = base_positions(fb);
        std::vector<int32_t> inf;
        inf.reserve(bp.size());
        size_t k = 0;
        for (int32_t ap : bp) {
          while (k < positions.size() && positions[k] < ap) ++k;
          if (k < positions.size() && positions[k] == ap) continue;
          inf.push_back(ap);
        }
        if (!inf.empty()) {
          Piece ip;
          ip.mode = st.mode;
          ip.codes = st.codes;
          ip.inferred = true;
          ip.pos = std::move(inf);
          ip.probs.assign(ip.pos.size() * stride, 0.0f);
          piece_list(b, st.mod_strand).push_back(std::move(ip));
        }
      }
    }
  }

  ModInfo info;
  info.groups.reserve(keys.size());
  for (size_t i = 0; i < keys.size(); ++i)
    info.groups.push_back(
        merge_pieces(keys[i].first, keys[i].second, pieces[i]));
  return info;
}

// --------------------------------------------------------------- collapse
struct CollapseOp {
  int kind;  // 0 norm, 1 dist, 2 convert
  std::vector<Code> codes;
  bool has_to = false;
  Code to_code = 0;
};

// BaseModProbs::into_collapsed (mod_bam.rs:530; collapse.py apply_collapse)
void apply_collapse(std::vector<Code>& codes, std::vector<float>& probs,
                    size_t& m, size_t n, const CollapseOp& op) {
  std::vector<int> hit(m, 0);
  bool any = false;
  for (size_t j = 0; j < m; ++j)
    for (Code c : op.codes)
      if (codes[j] == c) { hit[j] = 1; any = true; }
  if (!any) return;
  std::vector<size_t> keep;
  for (size_t j = 0; j < m; ++j)
    if (!hit[j]) keep.push_back(j);
  size_t mk = keep.size();

  if (op.kind == 0 || op.kind == 1) {  // norm / dist
    std::vector<float> out(n * mk);
    for (size_t i = 0; i < n; ++i) {
      const float* row = &probs[i * m];
      if (op.kind == 0) {
        float live_sum = 0.0f;
        for (size_t j = 0; j < m; ++j)
          live_sum += (row[j] > 0.0f) ? row[j] : 0.0f;
        float canonical = 1.0f - live_sum;
        float kept_sum = 0.0f;
        for (size_t j : keep) kept_sum += (row[j] > 0.0f) ? row[j] : 0.0f;
        float denom = kept_sum + canonical;
        for (size_t jj = 0; jj < mk; ++jj) {
          float live = (row[keep[jj]] > 0.0f) ? row[keep[jj]] : 0.0f;
          out[i * mk + jj] = (row[keep[jj]] >= 0.0f) ? live / denom : -1.0f;
        }
      } else {
        float removed = 0.0f;
        for (size_t j = 0; j < m; ++j)
          if (hit[j]) removed += (row[j] > 0.0f) ? row[j] : 0.0f;
        float share = removed / (float)(mk + 1);
        for (size_t jj = 0; jj < mk; ++jj) {
          float live = (row[keep[jj]] > 0.0f) ? row[keep[jj]] : 0.0f;
          out[i * mk + jj] = (row[keep[jj]] >= 0.0f) ? live + share : -1.0f;
        }
      }
    }
    std::vector<Code> nc;
    for (size_t j : keep) nc.push_back(codes[j]);
    codes = std::move(nc);
    probs = std::move(out);
    m = mk;
    return;
  }

  // convert
  std::vector<Code> nc;
  for (size_t j : keep) nc.push_back(codes[j]);
  int64_t tcol = -1;
  for (size_t jj = 0; jj < mk; ++jj)
    if (op.has_to && nc[jj] == op.to_code) tcol = (int64_t)jj;
  std::vector<float> moved(n, 0.0f);
  std::vector<uint8_t> add_mask(n, 0);
  bool any_add = false;
  for (size_t i = 0; i < n; ++i) {
    const float* row = &probs[i * m];
    float mv = 0.0f;
    bool present = false;
    for (size_t j = 0; j < m; ++j)
      if (hit[j]) {
        mv += (row[j] > 0.0f) ? row[j] : 0.0f;
        if (row[j] >= 0.0f) present = true;
      }
    moved[i] = mv;
    add_mask[i] = (present && mv > 0.0f) ? 1 : 0;
    if (add_mask[i]) any_add = true;
  }
  size_t mo = mk + ((tcol < 0 && any_add) ? 1 : 0);
  std::vector<float> out(n * mo, -1.0f);
  for (size_t i = 0; i < n; ++i) {
    const float* row = &probs[i * m];
    for (size_t jj = 0; jj < mk; ++jj) {
      float v = row[keep[jj]];
      out[i * mo + jj] = (v >= 0.0f) ? ((v > 0.0f) ? v : 0.0f) : -1.0f;
    }
    if (tcol >= 0) {
      if (add_mask[i]) {
        float cur = out[i * mo + tcol];
        out[i * mo + tcol] = (cur < 0.0f) ? moved[i] : cur + moved[i];
      }
    } else if (any_add) {
      out[i * mo + mk] = add_mask[i] ? moved[i] : -1.0f;
    }
  }
  if (tcol < 0 && any_add) nc.push_back(op.to_code);
  m = nc.size();
  codes = std::move(nc);
  probs = std::move(out);
}

// ---------------------------------------------------------- per-read decode
// One read's share of one tile: the mod calls that land in the tile's
// window and pass its focus rule, the read's code columns and registered
// channels, and its covered intervals for the observed-code painting. Its
// no-calls and deletions go straight into the tile's histograms while the
// read is walked (TileWalk).
struct ReadEvents {
  bool failed = false;
  int err = E_OK;
  int aln_strand = 0;
  // kept mod calls: tile position (partition-folded), out strand, base
  std::vector<int32_t> mod_rpos;
  std::vector<int8_t> mod_out, mod_base;
  std::vector<float> mod_probs;  // n x codes.size()
  std::vector<Code> codes;
  // registered (out_strand_key, threshold_base) -> code, flattened triples
  std::vector<std::array<int64_t, 3>> registered;
  // merged M/D cover intervals
  std::vector<std::pair<int32_t, int32_t>> cover;
};

struct DecodeOpts {
  bool force_allow = false;
  bool has_edge = false;
  int64_t edge_start = 0, edge_end = 0;
  bool edge_inverted = false;
  std::vector<CollapseOp> collapse;
  bool has_convert = false;  // some collapse op is a convert
};

// The tile a decode thread walks reads for: the reference window, its focus
// and the thread's own histograms and scratch.
struct TileWalk {
  int64_t start = 0, end = 0;  // reference window [start, end)
  const int8_t* focus_rule = nullptr;  // per window position, or null
  // window positions whose rule is >= 0, ascending (with a focus)
  const int32_t* focus_cols = nullptr;
  size_t n_focus = 0;
  int32_t* nc = nullptr;   // [p_total, 2, 4]
  int32_t* del = nullptr;  // [p_total, 2]
  int64_t n_nc = 0, n_del = 0;
  // aligned columns of the walked reads, and the columns the walk visited
  int64_t aligned = 0, walked = 0;
  // window positions holding a call of the current read (cleared after it)
  std::vector<uint8_t> hit;
  std::vector<int32_t> hit_list;
  // --max-depth: window positions where the current read is admitted;
  // null without a cap
  const uint8_t* adm = nullptr;

  void reset_window(int64_t s, int64_t e) {
    start = s;
    end = e;
    hit.assign((size_t)(e - s), 0);
  }
  void clear_hits() {
    for (int32_t li : hit_list) hit[li] = 0;
    hit_list.clear();
  }
};

// aligned match columns with qf ascending (util.rs:122 + stable sort)
// forward-coord aligned (M/=/X) runs [a, b), ascending — membership tests
// (threshold sampling's only_mapped intersect) walk a handful of runs
// instead of expanding per-base qf/rp vectors
void aligned_runs_fwd(const Rec& r,
                      std::vector<std::pair<int32_t, int32_t>>& out) {
  const uint8_t* cg = r.cigar();
  int64_t q = 0;
  int64_t L = (int64_t)r.l_seq;
  bool rev = r.is_reverse();
  for (int i = 0; i < r.n_cigar; ++i) {
    uint32_t v;
    std::memcpy(&v, cg + 4 * i, 4);
    uint32_t op = v & 0xF;
    int64_t l = v >> 4;
    bool cq = (op == 0 || op == 1 || op == 4 || op == 7 || op == 8);
    if (op == 0 || op == 7 || op == 8) {
      if (rev)
        out.emplace_back((int32_t)(L - q - l), (int32_t)(L - q));
      else
        out.emplace_back((int32_t)q, (int32_t)(q + l));
    }
    if (cq) q += l;
  }
  if (rev) std::reverse(out.begin(), out.end());
}

// true iff sorted-ascending position p (with a persistent cursor k) lies
// in one of the ascending runs
inline bool runs_contain(const std::vector<std::pair<int32_t, int32_t>>& runs,
                         size_t& k, int32_t p) {
  while (k < runs.size() && runs[k].second <= p) ++k;
  return k < runs.size() && runs[k].first <= p;
}

void aligned_pairs_sorted(const Rec& r, std::vector<int32_t>& qf,
                          std::vector<int32_t>& rp) {
  struct Run { int64_t q, rr, len; };
  std::vector<Run> runs;
  const uint8_t* cg = r.cigar();
  int64_t q = 0, rr = r.pos;
  for (int i = 0; i < r.n_cigar; ++i) {
    uint32_t v;
    std::memcpy(&v, cg + 4 * i, 4);
    uint32_t op = v & 0xF;
    int64_t l = v >> 4;
    bool cq = (op == 0 || op == 1 || op == 4 || op == 7 || op == 8);
    bool cr = (op == 0 || op == 2 || op == 3 || op == 7 || op == 8);
    if (op == 0 || op == 7 || op == 8) runs.push_back({q, rr, l});
    if (cq) q += l;
    if (cr) rr += l;
  }
  size_t total = 0;
  for (auto& u : runs) total += (size_t)u.len;
  qf.reserve(total);
  rp.reserve(total);
  if (!r.is_reverse()) {
    for (auto& u : runs)
      for (int64_t j = 0; j < u.len; ++j) {
        qf.push_back(u.q + j);
        rp.push_back(u.rr + j);
      }
  } else {
    int64_t L = (int64_t)r.l_seq - 1;
    for (auto it = runs.rbegin(); it != runs.rend(); ++it)
      for (int64_t j = it->len - 1; j >= 0; --j) {
        qf.push_back(L - (it->q + j));
        rp.push_back(it->rr + j);
      }
  }
}

// A run of the alignment inside the window, in reference order: its first
// query position (alignment strand), reference position and length.
struct ARun {
  int32_t q, r, len;
};

// The read's M/=/X runs (`runs`) and D runs (`dels`, q unused) clipped to
// [start, end); returns the read's aligned columns, clipped or not.
int64_t clipped_runs(const Rec& r, int64_t start, int64_t end,
                     std::vector<ARun>& runs, std::vector<ARun>& dels) {
  const uint8_t* cg = r.cigar();
  int64_t q = 0, rr = r.pos, aligned = 0;
  for (int i = 0; i < r.n_cigar; ++i) {
    uint32_t v;
    std::memcpy(&v, cg + 4 * i, 4);
    uint32_t op = v & 0xF;
    int64_t l = v >> 4;
    bool match = (op == 0 || op == 7 || op == 8);
    if (match) aligned += l;
    if (match || op == 2) {
      int64_t a = std::max(rr, start), b = std::min(rr + l, end);
      if (a < b)
        (match ? runs : dels)
            .push_back({(int32_t)(q + (a - rr)), (int32_t)a, (int32_t)(b - a)});
    }
    if (op == 0 || op == 1 || op == 4 || op == 7 || op == 8) q += l;
    if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8) rr += l;
  }
  return aligned;
}

// merged reference intervals of M/D/=/X ops, split at N (events.py:94)
void covered_intervals(const Rec& r,
                       std::vector<std::pair<int32_t, int32_t>>& out) {
  const uint8_t* cg = r.cigar();
  int64_t rr = r.pos;
  for (int i = 0; i < r.n_cigar; ++i) {
    uint32_t v;
    std::memcpy(&v, cg + 4 * i, 4);
    uint32_t op = v & 0xF;
    int64_t l = v >> 4;
    bool present = (op == 0 || op == 2 || op == 7 || op == 8) && l > 0;
    if (present) {
      if (!out.empty() && out.back().second == rr)
        out.back().second = rr + l;
      else
        out.emplace_back(rr, rr + l);
    }
    if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8) rr += l;
  }
}

void forward_seq(const Rec& r, std::vector<uint8_t>& fwd) {
  const uint8_t* s4 = r.seq4();
  size_t n = r.l_seq;
  fwd.resize(n);
  if (!r.is_reverse()) {
    for (size_t i = 0; i < n; ++i) {
      uint8_t nb = s4[i / 2];
      fwd[i] = (i & 1) ? T.nib_lo[nb] : T.nib_hi[nb];
    }
  } else {
    for (size_t i = 0; i < n; ++i) {
      uint8_t nb = s4[i / 2];
      uint8_t b = (i & 1) ? T.nib_lo[nb] : T.nib_hi[nb];
      fwd[n - 1 - i] = T.compl_tab[b];
    }
  }
}

// Shortest round-trip f32 decimal with HALF-UP tie rounding, fixed
// notation — the exact algorithm of writers._format_float_cached (which
// matches Rust f32 Display/ryu; std::to_chars breaks decimal ties the
// other way, e.g. 78.5/256 -> "0.30664062" instead of "0.30664063").
static std::string format_f32_rust(float v) {
  if (v == 0.0f) return "0";
  if (std::isnan(v)) return "NaN";
  if (std::isinf(v)) return v > 0 ? "inf" : "-inf";
  bool neg = v < 0.0f;
  double d = std::fabs((double)v);
  int e2;
  double frac = std::frexp(d, &e2);
  // f32 mantissa fits far inside 2^53: M is exact
  int64_t M = (int64_t)std::ldexp(frac, 53);
  e2 -= 53;
  // exact decimal digits of |v| = M * 2^e2 as digitsInteger * 10^exp10
  std::vector<uint8_t> dig;
  for (int64_t m = M; m > 0; m /= 10) dig.push_back((uint8_t)(m % 10));
  std::reverse(dig.begin(), dig.end());
  auto mul_small = [&](int f) {
    int carry = 0;
    for (int i = (int)dig.size() - 1; i >= 0; --i) {
      int x = dig[i] * f + carry;
      dig[i] = (uint8_t)(x % 10);
      carry = x / 10;
    }
    while (carry) {
      dig.insert(dig.begin(), (uint8_t)(carry % 10));
      carry /= 10;
    }
  };
  int exp10 = 0;
  if (e2 > 0) {
    for (int i = 0; i < e2; ++i) mul_small(2);
  } else {
    for (int i = 0; i < -e2; ++i) mul_small(5);
    exp10 = e2;
  }
  // strip leading zeros (none expected) — adj = exponent of leading digit
  int adj = (int)dig.size() - 1 + exp10;
  char buf[128];
  for (int digits = 1; digits <= 12; ++digits) {
    // round to `digits` significant figures, half-up
    std::vector<uint8_t> kept(
        dig.begin(),
        dig.begin() + std::min((size_t)digits, dig.size()));
    while ((int)kept.size() < digits) kept.push_back(0);
    int kadj = adj;
    if ((size_t)digits < dig.size() && dig[digits] >= 5) {
      int i = digits - 1;
      for (; i >= 0; --i) {
        if (kept[i] == 9) {
          kept[i] = 0;
        } else {
          kept[i]++;
          break;
        }
      }
      if (i < 0) {
        kept.insert(kept.begin(), 1);
        kept.pop_back();
        kadj += 1;
      }
    }
    // normalize: strip trailing zeros
    int n = (int)kept.size();
    while (n > 1 && kept[n - 1] == 0) --n;
    // render fixed
    char* w = buf;
    if (neg) *w++ = '-';
    if (kadj >= 0) {
      for (int i = 0; i <= kadj; ++i)
        *w++ = (char)('0' + (i < n ? kept[i] : 0));
      if (n > kadj + 1) {
        *w++ = '.';
        for (int i = kadj + 1; i < n; ++i) *w++ = (char)('0' + kept[i]);
      }
    } else {
      *w++ = '0';
      *w++ = '.';
      for (int i = 0; i < -kadj - 1; ++i) *w++ = '0';
      for (int i = 0; i < n; ++i) *w++ = (char)('0' + kept[i]);
    }
    *w = '\0';
    if (strtof(buf, nullptr) == v) return std::string(buf, w);
  }
  // unreachable for finite f32 (9 significant digits always round-trip)
  snprintf(buf, sizeof(buf), "%.9g", (double)v);
  return buf;
}

// --partition-tag key for one record (engine.partition_key_for +
// util.rs:670 get_stringable_aux): join the stringable values of the
// requested tags with '_', "missing" for absent/array-typed; false when
// no tag matched (NoKey). Duplicate tags: the LAST occurrence wins
// (Python's _scan_aux dict). Floats format as f32 Rust Display.
static bool aux_partition_key(const Rec& r,
                              const std::vector<std::array<char, 2>>& tags,
                              std::string& key_out) {
  std::vector<std::string> vals(tags.size());
  std::vector<uint8_t> state(tags.size(), 0);  // 0 none, 1 value, 2 array
  const uint8_t* buf = r.p;
  int64_t p = r.aux_off(), end = r.len;
  char tmp[64];
  while (p + 3 <= end) {
    char t0 = (char)buf[p], t1 = (char)buf[p + 1];
    char typ = (char)buf[p + 2];
    p += 3;
    int ti = -1;
    for (size_t i = 0; i < tags.size(); ++i)
      if (tags[i][0] == t0 && tags[i][1] == t1) ti = (int)i;
    switch (typ) {
      case 'A':
        if (ti >= 0) { vals[ti] = std::string(1, (char)buf[p]); state[ti] = 1; }
        p += 1;
        break;
      case 'c':
        if (ti >= 0) {
          snprintf(tmp, sizeof(tmp), "%d", (int)(int8_t)buf[p]);
          vals[ti] = tmp; state[ti] = 1;
        }
        p += 1;
        break;
      case 'C':
        if (ti >= 0) {
          snprintf(tmp, sizeof(tmp), "%u", (unsigned)buf[p]);
          vals[ti] = tmp; state[ti] = 1;
        }
        p += 1;
        break;
      case 's': case 'S': {
        if (ti >= 0) {
          uint16_t v; std::memcpy(&v, buf + p, 2);
          if (typ == 's') snprintf(tmp, sizeof(tmp), "%d", (int)(int16_t)v);
          else snprintf(tmp, sizeof(tmp), "%u", (unsigned)v);
          vals[ti] = tmp; state[ti] = 1;
        }
        p += 2;
        break;
      }
      case 'i': case 'I': {
        if (ti >= 0) {
          uint32_t v; std::memcpy(&v, buf + p, 4);
          if (typ == 'i')
            snprintf(tmp, sizeof(tmp), "%d", (int)(int32_t)v);
          else
            snprintf(tmp, sizeof(tmp), "%u", (unsigned)v);
          vals[ti] = tmp; state[ti] = 1;
        }
        p += 4;
        break;
      }
      case 'f': {
        if (ti >= 0) {
          float v; std::memcpy(&v, buf + p, 4);
          vals[ti] = format_f32_rust(v); state[ti] = 1;
        }
        p += 4;
        break;
      }
      case 'Z': case 'H': {
        int64_t q = p;
        while (q < end && buf[q] != 0) ++q;
        if (q >= end) return false;
        if (ti >= 0) {
          vals[ti].assign((const char*)(buf + p), (size_t)(q - p));
          state[ti] = 1;
        }
        p = q + 1;
        break;
      }
      case 'B': {
        if (p + 5 > end) return false;
        char sub = (char)buf[p];
        uint32_t n; std::memcpy(&n, buf + p + 1, 4);
        int isz = aux_b_itemsize(sub);
        if (isz < 0) return false;
        if (ti >= 0) state[ti] = 2;  // array-valued: not stringable
        p += 5 + (int64_t)n * isz;
        break;
      }
      default:
        return false;
    }
  }
  bool got = false;
  std::string key;
  for (size_t i = 0; i < tags.size(); ++i) {
    if (i) key.push_back('_');
    if (state[i] == 1) {
      key += vals[i];
      got = true;
    } else {
      key += "missing";
    }
  }
  if (!got) return false;
  key_out = std::move(key);
  return true;
}

// Count the read's no-calls (aligned columns with a valid base and no call
// of the read on either strand) and deletions in the window into the
// thread's histograms: every column of the clipped runs, or with a focus
// only the focus columns among them, under the rule `rv == 2 || rv ==
// strand`. A failed read (events.py:114 skipped_read_events) has no calls.
void count_nocalls(const std::vector<ARun>& runs,
                   const std::vector<ARun>& dels,
                   const std::vector<uint8_t>& fwd, bool rev, int s,
                   int64_t off, TileWalk& w) {
  const int64_t last = (int64_t)fwd.size() - 1;
  const int32_t* fc = w.focus_cols;
  auto nocall = [&](int64_t li, int64_t q) {
    if (w.hit[li] || (w.adm && !w.adm[li])) return;
    int8_t b = T.base_lut[fwd[rev ? last - q : q]];
    if (b >= 0) {
      w.nc[((li + off) * 2 + s) * 4 + b]++;
      ++w.n_nc;
    }
  };
  auto deletion = [&](int64_t li) {
    if (w.adm && !w.adm[li]) return;
    w.del[(li + off) * 2 + s]++;
    ++w.n_del;
  };
  for (const ARun& u : runs) {
    int64_t li0 = u.r - w.start;
    if (w.focus_rule == nullptr) {
      for (int64_t j = 0; j < u.len; ++j) nocall(li0 + j, u.q + j);
      w.walked += u.len;
      continue;
    }
    for (const int32_t* k = std::lower_bound(fc, fc + w.n_focus, li0);
         k < fc + w.n_focus && *k < li0 + u.len; ++k) {
      ++w.walked;
      int8_t rv = w.focus_rule[*k];
      if (rv == 2 || rv == s) nocall(*k, u.q + (*k - li0));
    }
  }
  for (const ARun& u : dels) {
    int64_t li0 = u.r - w.start;
    if (w.focus_rule == nullptr) {
      for (int64_t j = 0; j < u.len; ++j) deletion(li0 + j);
      continue;
    }
    for (const int32_t* k = std::lower_bound(fc, fc + w.n_focus, li0);
         k < fc + w.n_focus && *k < li0 + u.len; ++k) {
      int8_t rv = w.focus_rule[*k];
      if (rv == 2 || rv == s) deletion(*k);
    }
  }
}

// A chain of norm/dist collapse ops applied one row at a time: their output
// codes follow from the input codes alone and each row from itself, so the
// rows a tile keeps come out as apply_collapse makes them over all rows.
struct RowCollapse {
  struct Step {
    int kind;
    size_t m;                  // input width
    std::vector<uint8_t> hit;  // input column removed
    std::vector<size_t> keep;  // input columns kept, in order
  };
  std::vector<Step> steps;
  std::vector<float> a, b;

  // codes: in, the group's codes; out, the chain's output codes
  void plan(const std::vector<CollapseOp>& ops, std::vector<Code>& codes) {
    steps.clear();
    for (const auto& op : ops) {
      Step st;
      st.kind = op.kind;
      st.m = codes.size();
      st.hit.assign(st.m, 0);
      bool any = false;
      for (size_t j = 0; j < st.m; ++j)
        for (Code c : op.codes)
          if (codes[j] == c) { st.hit[j] = 1; any = true; }
      if (!any) continue;  // apply_collapse leaves the group as it is
      std::vector<Code> nc;
      for (size_t j = 0; j < st.m; ++j)
        if (!st.hit[j]) { st.keep.push_back(j); nc.push_back(codes[j]); }
      codes = std::move(nc);
      steps.push_back(std::move(st));
    }
  }

  // the collapsed row (valid until the next call), same float order as
  // apply_collapse
  const float* row(const float* in) {
    const float* src = in;
    bool to_a = true;
    for (const Step& st : steps) {
      std::vector<float>& dst = to_a ? a : b;
      to_a = !to_a;
      size_t mk = st.keep.size();
      dst.resize(mk);
      if (st.kind == 0) {
        float live_sum = 0.0f;
        for (size_t j = 0; j < st.m; ++j)
          live_sum += (src[j] > 0.0f) ? src[j] : 0.0f;
        float canonical = 1.0f - live_sum;
        float kept_sum = 0.0f;
        for (size_t j : st.keep) kept_sum += (src[j] > 0.0f) ? src[j] : 0.0f;
        float denom = kept_sum + canonical;
        for (size_t jj = 0; jj < mk; ++jj) {
          float v = src[st.keep[jj]];
          float live = (v > 0.0f) ? v : 0.0f;
          dst[jj] = (v >= 0.0f) ? live / denom : -1.0f;
        }
      } else {
        float removed = 0.0f;
        for (size_t j = 0; j < st.m; ++j)
          if (st.hit[j]) removed += (src[j] > 0.0f) ? src[j] : 0.0f;
        float share = removed / (float)(mk + 1);
        for (size_t jj = 0; jj < mk; ++jj) {
          float v = src[st.keep[jj]];
          float live = (v > 0.0f) ? v : 0.0f;
          dst[jj] = (v >= 0.0f) ? live + share : -1.0f;
        }
      }
      src = dst.data();
    }
    return src;
  }
};

// read_to_events (events.py:135) for one tile: decode the read's mod calls
// whole, then walk its alignment as runs clipped to the tile's window
// (and its focus): only calls that land there are mapped, collapsed and
// kept; no-calls and deletions are counted in place. `off` folds the read's
// partition into the position axis.
ReadEvents decode_read(const Rec& r, const DecodeOpts& opts, TileWalk& w,
                       int64_t off) {
  ReadEvents ev;
  ev.aln_strand = r.is_reverse() ? 1 : 0;
  const bool rev = r.is_reverse();
  const int64_t L = (int64_t)r.l_seq;
  std::vector<uint8_t> fwd;
  forward_seq(r, fwd);
  std::vector<ARun> runs, dels;
  w.aligned += clipped_runs(r, w.start, w.end, runs, dels);
  covered_intervals(r, ev.cover);
  try {
    AuxTags aux = scan_aux(r);
    // parse_raw_mod_tags (mod_bam.rs:1455; modtags.py:433)
    if (aux.bad) throw MkError{E_INVALID_MM};
    const TagSlot& mm = aux.mm_up.present ? aux.mm_up : aux.mm_lo;
    if (!mm.present) throw MkError{E_MM_MISSING};
    if (mm.wrong_type || mm.z == nullptr) throw MkError{E_INVALID_MM};
    const TagSlot& ml = aux.ml_up.present ? aux.ml_up : aux.ml_lo;
    if (!ml.present) throw MkError{E_ML_MISSING};
    if (ml.wrong_type || ml.b == nullptr) throw MkError{E_INVALID_ML};
    if (aux.mn_present) {
      if (aux.mn_wrong_type) throw MkError{E_INVALID_MN};
      if (aux.mn_value != L) throw MkError{E_INVALID_MN};
    } else if (r.is_not_primary()) {
      throw MkError{E_NON_PRIMARY_MN};
    }

    ModInfo info = decode_read_mods(fwd, mm.z, ml.b, ml.b_n);
    bool empty = true;
    for (auto& g : info.groups)
      if (!g.empty()) { empty = false; break; }
    if (empty) throw MkError{E_NO_MOD_INFO};
    for (auto& g : info.groups)
      if (g.mode == MODE_DEFAULT && !opts.force_allow)
        throw MkError{E_INVALID_IMPLICIT};

    // the window's runs in forward-read order: forward position f, and its
    // reference position r + (f - f0) (forward read) or r - (f - f0)
    struct FRun { int32_t f, r, len; };
    std::vector<FRun> fr;
    fr.reserve(runs.size());
    if (!rev) {
      for (const ARun& u : runs) fr.push_back({u.q, u.r, u.len});
    } else {
      for (auto it = runs.rbegin(); it != runs.rend(); ++it)
        fr.push_back({(int32_t)(L - it->q - it->len), it->r + it->len - 1,
                      it->len});
    }
    const int32_t f_lo = fr.empty() ? 0 : fr.front().f;
    const int32_t f_hi = fr.empty() ? 0 : fr.back().f + fr.back().len;

    bool added_any = false;
    // event rows stored at final read-vocab width later; remember per-event
    // (group probs row base, group column map) via a staging buffer
    struct Staged {
      std::vector<int32_t> rpos;
      int8_t out_strand, base;
      std::vector<float> probs;  // n x gm
      std::vector<size_t> cols;  // gm -> read code col
      size_t gm;
    };
    std::vector<Staged> staged;
    RowCollapse rc;

    for (int strand_pass = 0; strand_pass < 2; ++strand_pass) {
      for (auto& g : info.groups) {
        if (g.mod_strand != strand_pass) continue;
        const std::vector<int32_t>* positions = &g.pos;
        const std::vector<float>* probs = &g.probs;
        // the rows the edge filter keeps (mod_bam.rs:1635): one or two
        // index ranges of the sorted positions
        size_t n = positions->size();
        std::pair<size_t, size_t> rng[2] = {{0, n}, {n, n}};
        if (opts.has_edge) {
          if (L <= opts.edge_start + opts.edge_end) continue;
          size_t a = std::lower_bound(positions->begin(), positions->end(),
                                      opts.edge_start) - positions->begin();
          size_t b = std::lower_bound(positions->begin(), positions->end(),
                                      L - opts.edge_end) - positions->begin();
          if (opts.edge_inverted) {
            rng[0] = {0, a};
            rng[1] = {b, n};
          } else {
            rng[0] = {a, b};
          }
          if (rng[0].second - rng[0].first + rng[1].second - rng[1].first ==
              0)
            continue;
        }
        std::vector<Code> gcodes = g.codes;
        size_t gm = gcodes.size();
        bool by_row = false;
        std::vector<int32_t> pos_c;
        std::vector<float> probs_c;
        if (opts.has_convert) {
          // a convert op's output width follows from every row: collapse
          // the kept rows whole
          for (auto& ab : rng) {
            pos_c.insert(pos_c.end(), positions->begin() + ab.first,
                         positions->begin() + ab.second);
            probs_c.insert(probs_c.end(), probs->begin() + ab.first * gm,
                           probs->begin() + ab.second * gm);
          }
          for (const auto& op : opts.collapse)
            apply_collapse(gcodes, probs_c, gm, pos_c.size(), op);
          positions = &pos_c;
          probs = &probs_c;
          rng[0] = {0, pos_c.size()};
          rng[1] = {pos_c.size(), pos_c.size()};
        } else if (!opts.collapse.empty()) {
          rc.plan(opts.collapse, gcodes);
          by_row = !rc.steps.empty();
          gm = gcodes.size();
        }
        const size_t stride = by_row ? rc.steps.front().m : gm;
        auto row_of = [&](size_t i) -> const float* {
          const float* in = probs->data() + i * stride;
          return by_row ? rc.row(in) : in;
        };

        // register read-local code columns
        std::vector<size_t> cols(gm);
        for (size_t j = 0; j < gm; ++j) {
          auto it = std::find(ev.codes.begin(), ev.codes.end(), gcodes[j]);
          if (it == ev.codes.end()) {
            cols[j] = ev.codes.size();
            ev.codes.push_back(gcodes[j]);
          } else {
            cols[j] = it - ev.codes.begin();
          }
        }

        int b_idx = base_char_to_idx(g.base);
        int threshold_b = (g.mod_strand == 0) ? b_idx : IDX_COMPL[b_idx];
        int out_strand_key = ev.aln_strand ^ g.mod_strand;
        // codes with a present class at >= 1 kept position register for the
        // read (read_cache.rs:170-195): every kept row counts, in the
        // window or not
        std::vector<uint8_t> present(gm, 0);
        size_t n_present = 0;
        for (auto& ab : rng)
          for (size_t i = ab.first; i < ab.second && n_present < gm; ++i) {
            const float* row = row_of(i);
            for (size_t j = 0; j < gm; ++j)
              if (!present[j] && row[j] >= 0.0f) {
                present[j] = 1;
                ++n_present;
              }
          }
        for (size_t j = 0; j < gm; ++j)
          if (present[j])
            ev.registered.push_back({(int64_t)out_strand_key,
                                     (int64_t)threshold_b,
                                     (int64_t)gcodes[j]});

        // map the kept calls inside the window's forward range onto its
        // runs (both ascending); each marks its column, and is kept where
        // the focus rule and the depth cap let it
        Staged sg;
        sg.out_strand = (int8_t)out_strand_key;
        sg.base = (int8_t)threshold_b;
        sg.cols = cols;
        sg.gm = gm;
        size_t k = 0;
        for (auto& ab : rng) {
          if (fr.empty()) break;
          auto first = std::lower_bound(positions->begin() + ab.first,
                                        positions->begin() + ab.second, f_lo);
          for (size_t i = first - positions->begin(); i < ab.second; ++i) {
            int32_t f = (*positions)[i];
            if (f >= f_hi) break;
            while (fr[k].f + fr[k].len <= f) ++k;
            if (f < fr[k].f) continue;
            int64_t li = (rev ? fr[k].r - (f - fr[k].f)
                              : fr[k].r + (f - fr[k].f)) - w.start;
            if (!w.hit[li]) {
              w.hit[li] = 1;
              w.hit_list.push_back((int32_t)li);
            }
            if (w.focus_rule != nullptr) {
              int8_t rv = w.focus_rule[li];
              if (!(rv == 2 || rv == out_strand_key)) continue;
            }
            if (w.adm && !w.adm[li]) continue;
            sg.rpos.push_back((int32_t)(li + off));
            const float* row = row_of(i);
            sg.probs.insert(sg.probs.end(), row, row + gm);
          }
        }
        added_any = true;
        if (!sg.rpos.empty()) staged.push_back(std::move(sg));
      }
    }
    if (!added_any) throw MkError{E_NO_MOD_INFO};

    // materialize events at final read-vocab width
    size_t m = ev.codes.size();
    size_t n_ev = 0;
    for (auto& sg : staged) n_ev += sg.rpos.size();
    ev.mod_rpos.reserve(n_ev);
    ev.mod_out.reserve(n_ev);
    ev.mod_base.reserve(n_ev);
    bool identity = true;
    for (auto& sg : staged) {
      if (sg.gm != m) { identity = false; break; }
      for (size_t j = 0; j < sg.gm; ++j)
        if (sg.cols[j] != j) { identity = false; break; }
      if (!identity) break;
    }
    if (identity) {
      // common case (one group / aligned column maps): probs blocks
      // concatenate verbatim
      ev.mod_probs.reserve(n_ev * m);
      for (auto& sg : staged) {
        ev.mod_rpos.insert(ev.mod_rpos.end(), sg.rpos.begin(),
                           sg.rpos.end());
        ev.mod_out.insert(ev.mod_out.end(), sg.rpos.size(), sg.out_strand);
        ev.mod_base.insert(ev.mod_base.end(), sg.rpos.size(), sg.base);
        ev.mod_probs.insert(ev.mod_probs.end(), sg.probs.begin(),
                            sg.probs.end());
      }
    } else {
      ev.mod_probs.assign(n_ev * m, -1.0f);
      size_t row = 0;
      for (auto& sg : staged) {
        for (size_t i = 0; i < sg.rpos.size(); ++i, ++row) {
          ev.mod_rpos.push_back(sg.rpos[i]);
          ev.mod_out.push_back(sg.out_strand);
          ev.mod_base.push_back(sg.base);
          for (size_t j = 0; j < sg.gm; ++j)
            ev.mod_probs[row * m + sg.cols[j]] = sg.probs[i * sg.gm + j];
        }
      }
    }
    count_nocalls(runs, dels, fwd, rev, ev.aln_strand, off, w);
    w.clear_hits();
    return ev;
  } catch (const MkError& e) {
    ReadEvents bad;
    bad.failed = true;
    bad.err = e.kind;
    bad.aln_strand = ev.aln_strand;
    bad.cover = std::move(ev.cover);
    w.clear_hits();
    count_nocalls(runs, dels, fwd, rev, bad.aln_strand, off, w);
    return bad;
  }
}

// -------------------------------------------------------------- tile output
struct TileBuffers {
  std::vector<int32_t> ev_rpos;
  std::vector<int8_t> ev_strand, ev_base;
  std::vector<float> ev_probs;
  std::vector<int32_t> nc_counts, del_counts;
  std::vector<uint8_t> observed;
  std::vector<int64_t> vocab;
  // --partition-tag: tile-local key list in first-seen order; nullptr
  // entries are the NoKey ("ungrouped") partition
  std::vector<std::string> part_key_store;
  std::vector<const char*> part_key_ptrs;
};

}  // namespace

extern "C" {

struct MkTileOut {
  int64_t n_events;
  int32_t m;
  const int32_t* ev_rpos;
  const int8_t* ev_strand;
  const int8_t* ev_base;
  const float* ev_probs;
  const int32_t* nc_counts;   // p*2*4
  const int32_t* del_counts;  // p*2
  const uint8_t* observed;    // p*2*4*m
  const int64_t* vocab;       // m
  int32_t n_used, n_skipped;
  int64_t n_nc, n_del;
  int64_t err_counts[16];
  void* handle;
  // --partition-tag: number of partitions (1 when unpartitioned) and the
  // key per partition (nullptr = NoKey/"ungrouped"); dense arrays above
  // are sized with p_total = n_parts * (end - start), key-major folds
  int32_t n_parts;
  const char* const* part_keys;
  // the aligned columns of the tile's decoded reads, and the columns their
  // walk clipped to the tile (and its focus) visited
  int64_t aligned_columns, walked_columns;
  // mk_decode_tile_bgzf: the BGZF blocks the tile's chunks needed, and
  // those a block cache served
  int64_t bgzf_blocks, bgzf_blocks_reused;
};

// Decode one genome tile's fetched (decompressed) BAM chunks into pileup
// event arrays. Returns 0 on success. Caller must mk_free_tile(out).
// ptags: n_ptags 2-char partition tags, flat (e.g. "HPRG"); 0 = off.
int32_t mk_decode_tile(const uint8_t** chunks, const int64_t* chunk_lens,
                       int32_t n_chunks, int32_t tid, int64_t start,
                       int64_t end, int64_t max_depth, int32_t force_allow,
                       int32_t has_edge, int64_t edge_start, int64_t edge_end,
                       int32_t edge_inverted, const int64_t* collapse_blob,
                       int32_t collapse_len, const int8_t* focus_rule,
                       const char* ptags, int32_t n_ptags,
                       int32_t n_threads, MkTileOut* out) {
  std::memset(out, 0, sizeof(MkTileOut));
  DecodeOpts opts;
  opts.force_allow = force_allow != 0;
  opts.has_edge = has_edge != 0;
  opts.edge_start = edge_start;
  opts.edge_end = edge_end;
  opts.edge_inverted = edge_inverted != 0;
  // collapse blob: per op [kind, n_codes, codes..., has_to, to_code]
  for (int32_t i = 0; i < collapse_len;) {
    CollapseOp op;
    op.kind = (int)collapse_blob[i++];
    int64_t nc = collapse_blob[i++];
    for (int64_t j = 0; j < nc; ++j) op.codes.push_back(collapse_blob[i++]);
    op.has_to = collapse_blob[i++] != 0;
    op.to_code = collapse_blob[i++];
    opts.has_convert |= op.kind == 2;
    opts.collapse.push_back(std::move(op));
  }

  // ---- collect record views (fetch filter, bam.py:402-422 semantics) ----
  std::vector<Rec> recs;
  bool stop = false;
  for (int32_t c = 0; c < n_chunks && !stop; ++c) {
    const uint8_t* buf = chunks[c];
    int64_t len = chunk_lens[c];
    int64_t p = 0;
    while (p + 4 <= len) {
      int32_t bs;
      std::memcpy(&bs, buf + p, 4);
      if (bs < 32 || p + 4 + bs > len) break;  // partial tail
      Rec r;
      r.p = buf + p + 4;
      r.len = bs;
      r.parse_head();
      p += 4 + bs;
      if (r.ref_id != tid || r.pos >= end) {
        if (r.ref_id > tid || (r.ref_id == tid && r.pos >= end)) {
          stop = true;
          break;
        }
        continue;
      }
      if (r.is_unmapped()) continue;
      if (r.pos + r.reference_span() <= start) continue;
      // pileup engine filter (engine.py:167)
      if (r.is_not_primary() || r.l_seq == 0) continue;
      recs.push_back(r);
    }
  }

  int64_t p_len = end - start;
  auto* bufs = new TileBuffers();
  out->handle = bufs;
  out->nc_counts = nullptr;
  out->del_counts = nullptr;
  out->n_parts = 1;
  out->part_keys = nullptr;

  if (recs.empty()) return 0;

  // --partition-tag: one key slot per kept record, first-seen key order
  // (engine.launch_tile partition path)
  int n_parts = 1;
  std::vector<int32_t> pkeys(recs.size(), 0);
  std::vector<uint8_t> part_nokey;
  if (n_ptags > 0) {
    std::vector<std::array<char, 2>> tag_list;
    for (int32_t i = 0; i < n_ptags; ++i)
      tag_list.push_back({ptags[2 * i], ptags[2 * i + 1]});
    for (size_t i = 0; i < recs.size(); ++i) {
      std::string key;
      bool has = aux_partition_key(recs[i], tag_list, key);
      int idx = -1;
      for (size_t j = 0; j < bufs->part_key_store.size(); ++j) {
        if (has ? (!part_nokey[j] && bufs->part_key_store[j] == key)
                : (bool)part_nokey[j]) {
          idx = (int)j;
          break;
        }
      }
      if (idx < 0) {
        idx = (int)bufs->part_key_store.size();
        bufs->part_key_store.push_back(has ? key : std::string());
        part_nokey.push_back(has ? 0 : 1);
      }
      pkeys[i] = idx;
    }
    n_parts = (int)bufs->part_key_store.size();
    for (size_t j = 0; j < bufs->part_key_store.size(); ++j)
      bufs->part_key_ptrs.push_back(
          part_nokey[j] ? nullptr : bufs->part_key_store[j].c_str());
    out->n_parts = n_parts;
    out->part_keys = bufs->part_key_ptrs.data();
  }

  int64_t p_total = (int64_t)n_parts * p_len;  // partition-folded axis
  bufs->nc_counts.assign((size_t)p_total * 2 * 4, 0);
  bufs->del_counts.assign((size_t)p_total * 2, 0);

  // the focus columns, ascending: the walk visits only these
  std::vector<int32_t> focus_cols;
  if (focus_rule != nullptr)
    for (int64_t li = 0; li < p_len; ++li)
      if (focus_rule[li] >= 0) focus_cols.push_back((int32_t)li);

  // --max-depth: per-column cap on contributing reads, first-in-file-order
  // (htslib set_max_depth semantics, pileup/mod.rs:755-758); only computed
  // when the tile's read count can exceed the cap. Admission follows each
  // read's covered intervals alone, so it is settled in file order before
  // the reads decode, as each read's admitted intervals.
  bool use_depth = max_depth > 0 && (int64_t)recs.size() > max_depth;
  std::vector<std::vector<std::pair<int32_t, int32_t>>> adm_iv;
  if (use_depth) {
    std::vector<int32_t> depth_cov((size_t)p_len, 0);
    std::vector<std::pair<int32_t, int32_t>> cov;
    adm_iv.resize(recs.size());
    for (size_t ri = 0; ri < recs.size(); ++ri) {
      cov.clear();
      covered_intervals(recs[ri], cov);
      auto& adm = adm_iv[ri];
      for (auto& iv : cov) {
        int64_t a2 = std::max((int64_t)iv.first - start, (int64_t)0);
        int64_t b2 = std::min((int64_t)iv.second - start, p_len);
        for (int64_t x = a2; x < b2; ++x) {
          if (depth_cov[x] >= max_depth) continue;
          depth_cov[x]++;
          if (!adm.empty() && adm.back().second == x)
            adm.back().second = (int32_t)x + 1;
          else
            adm.emplace_back((int32_t)x, (int32_t)x + 1);
        }
      }
    }
  }

  // ---- parallel per-read decode, deterministic order kept by index ----
  // each thread walks reads into histograms of its own (the first thread's
  // are the tile's), summed once at the end
  std::vector<ReadEvents> events(recs.size());
  int nt = n_threads > 0 ? n_threads : 1;
  if (recs.size() < 2) nt = 1;
  struct ThreadWalk {
    TileWalk w;
    std::vector<int32_t> nc, del;
    std::vector<uint8_t> adm;
  };
  std::vector<ThreadWalk> walks(nt);
  auto decode_range = [&](int t, std::atomic<size_t>& next) {
    ThreadWalk& tw = walks[t];
    TileWalk& w = tw.w;
    w.reset_window(start, end);
    w.focus_rule = focus_rule;
    w.focus_cols = focus_cols.data();
    w.n_focus = focus_cols.size();
    if (t == 0) {
      w.nc = bufs->nc_counts.data();
      w.del = bufs->del_counts.data();
    } else {
      tw.nc.assign(bufs->nc_counts.size(), 0);
      tw.del.assign(bufs->del_counts.size(), 0);
      w.nc = tw.nc.data();
      w.del = tw.del.data();
    }
    if (use_depth) {
      tw.adm.assign((size_t)p_len, 0);
      w.adm = tw.adm.data();
    }
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= recs.size()) return;
      if (use_depth)
        for (auto& iv : adm_iv[i])
          std::memset(tw.adm.data() + iv.first, 1, iv.second - iv.first);
      events[i] = decode_read(recs[i], opts, w, (int64_t)pkeys[i] * p_len);
      if (use_depth)
        for (auto& iv : adm_iv[i])
          std::memset(tw.adm.data() + iv.first, 0, iv.second - iv.first);
    }
  };
  std::atomic<size_t> next{0};
  if (nt > 1) {
    std::vector<std::thread> pool;
    for (int t = 0; t < nt; ++t) pool.emplace_back(decode_range, t, std::ref(next));
    for (auto& th : pool) th.join();
  } else {
    decode_range(0, next);
  }
  int64_t n_nc = 0, n_del = 0;
  for (int t = 0; t < nt; ++t) {
    const ThreadWalk& tw = walks[t];
    if (t > 0) {
      int32_t* nc = bufs->nc_counts.data();
      int32_t* del = bufs->del_counts.data();
      for (size_t i = 0; i < tw.nc.size(); ++i) nc[i] += tw.nc[i];
      for (size_t i = 0; i < tw.del.size(); ++i) del[i] += tw.del[i];
    }
    n_nc += tw.w.n_nc;
    n_del += tw.w.n_del;
    out->aligned_columns += tw.w.aligned;
    out->walked_columns += tw.w.walked;
  }

  // ---- sequential tile assembly (vocab + event arrays + observed) ----
  std::vector<Code>& vocab = bufs->vocab;
  auto vindex = [&](Code c) -> size_t {
    for (size_t i = 0; i < vocab.size(); ++i)
      if (vocab[i] == c) return i;
    vocab.push_back(c);
    return vocab.size() - 1;
  };
  for (auto& ev : events) {
    if (ev.failed) {
      out->err_counts[ev.err]++;
      out->n_skipped++;
    } else {
      out->n_used++;
      for (Code c : ev.codes) vindex(c);
    }
  }
  size_t m = std::max(vocab.size(), (size_t)1);

  // count events to reserve
  size_t n_ev_total = 0;
  for (auto& ev : events) n_ev_total += ev.mod_rpos.size();
  bufs->ev_rpos.reserve(n_ev_total);
  bufs->ev_strand.reserve(n_ev_total);
  bufs->ev_base.reserve(n_ev_total);
  bufs->ev_probs.assign(n_ev_total * m, -1.0f);
  bufs->observed.assign((size_t)p_total * 2 * 4 * m, 0);

  for (size_t ri = 0; ri < events.size(); ++ri) {
    auto& ev = events[ri];
    // partition fold: this read's events land at pos + part * p_len
    int64_t off = (int64_t)pkeys[ri] * p_len;
    size_t rm = ev.codes.size();
    std::vector<size_t> cols(rm);
    for (size_t j = 0; j < rm; ++j) cols[j] = vindex(ev.codes[j]);
    // the read's kept mod calls, already clipped to the tile, focus and cap
    for (size_t i = 0; i < ev.mod_rpos.size(); ++i) {
      bufs->ev_rpos.push_back(ev.mod_rpos[i]);
      bufs->ev_strand.push_back(ev.mod_out[i]);
      bufs->ev_base.push_back(ev.mod_base[i]);
      float* dst = bufs->ev_probs.data() + (bufs->ev_rpos.size() - 1) * m;
      const float* src = ev.mod_probs.data() + i * rm;
      for (size_t j = 0; j < rm; ++j) dst[cols[j]] = src[j];
    }
    // observed-code painting over covered intervals (read_cache.rs:298),
    // under a depth cap over the admitted ones
    if (!ev.registered.empty() && !ev.cover.empty()) {
      for (auto& reg : ev.registered) {
        int64_t sk = reg[0], tb = reg[1];
        size_t col = vindex(reg[2]);
        size_t chan = ((size_t)sk * 4 + tb) * m + col;
        size_t stride = 2 * 4 * m;
        uint8_t* obs = bufs->observed.data() + chan + (size_t)off * stride;
        if (use_depth) {
          for (auto& iv : adm_iv[ri])
            for (int64_t x = iv.first; x < iv.second; ++x)
              obs[(size_t)x * stride] = 1;
          continue;
        }
        for (auto& iv : ev.cover) {
          int64_t a2 = std::max(iv.first - start, (int64_t)0);
          int64_t b2 = std::min(iv.second - start, p_len);
          for (int64_t x = a2; x < b2; ++x) obs[(size_t)x * stride] = 1;
        }
      }
    }
  }

  out->n_events = (int64_t)bufs->ev_rpos.size();
  out->m = (int32_t)m;
  out->ev_rpos = bufs->ev_rpos.data();
  out->ev_strand = bufs->ev_strand.data();
  out->ev_base = bufs->ev_base.data();
  out->ev_probs = bufs->ev_probs.data();
  out->nc_counts = bufs->nc_counts.data();
  out->del_counts = bufs->del_counts.data();
  out->observed = bufs->observed.data();
  out->vocab = bufs->vocab.data();
  out->n_nc = n_nc;
  out->n_del = n_del;
  return 0;
}

void mk_free_tile(MkTileOut* out) {
  delete static_cast<TileBuffers*>(out->handle);
  out->handle = nullptr;
}

// ------------------------------------------------- BGZF inflate + decode
// Tile decode straight from the compressed BAM bytes: the BAI chunk spans
// are inflated here, block-parallel across the decode thread pool, with an
// EARLY STOP as soon as a complete record past the tile end appears — the
// Python fetch path inflated whole chunks (~2x the tile's share on
// WGS-style data, since big-bin chunks span many tiles). This is the host
// feed-ceiling attack of BASELINE.md (parallel BGZF inflation inside
// native decode).

static bool bgzf_block_info(const uint8_t* raw, int64_t len, int64_t off,
                            int64_t* bsize, int64_t* data_off,
                            int64_t* data_len) {
  if (off + 18 > len) return false;
  if (raw[off] != 0x1f || raw[off + 1] != 0x8b) return false;
  if (!(raw[off + 3] & 4)) return false;
  uint16_t xlen;
  std::memcpy(&xlen, raw + off + 10, 2);
  int64_t p = off + 12, extra_end = off + 12 + xlen;
  if (extra_end > len) return false;
  int64_t bs = -1;
  while (p + 4 <= extra_end) {
    uint8_t si1 = raw[p], si2 = raw[p + 1];
    uint16_t slen;
    std::memcpy(&slen, raw + p + 2, 2);
    if (si1 == 0x42 && si2 == 0x43 && slen == 2) {
      uint16_t v;
      std::memcpy(&v, raw + p + 4, 2);
      bs = (int64_t)v + 1;
    }
    p += 4 + slen;
  }
  if (bs < 0 || off + bs > len) return false;
  *bsize = bs;
  *data_off = extra_end;
  *data_len = off + bs - 8 - extra_end;
  return true;
}

static bool inflate_block_raw(const uint8_t* src, int64_t slen, uint8_t* dst,
                              int64_t dcap) {
#ifdef MK_HAVE_LIBDEFLATE
  // libdeflate decodes BGZF blocks ~2-3x faster than zlib inflate — the
  // same accelerated codec htslib links when available
  libdeflate_decompressor* dec = thread_codecs.decompressor();
  if (dec) {
    size_t actual = 0;
    enum libdeflate_result rc = libdeflate_deflate_decompress(
        dec, src, (size_t)slen, dst, (size_t)dcap, &actual);
    return rc == LIBDEFLATE_SUCCESS && (int64_t)actual == dcap;
  }
#endif
  z_stream zs{};
  if (inflateInit2(&zs, -15) != Z_OK) return false;
  zs.next_in = const_cast<Bytef*>(src);
  zs.avail_in = (uInt)slen;
  zs.next_out = dst;
  zs.avail_out = (uInt)dcap;
  int rc = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  return rc == Z_STREAM_END;
}

// One BGZF block (gzip header + raw deflate + crc/isize trailer) from up
// to 0xFF00 input bytes; returns the block size, 0 on failure. libdeflate
// when available (htslib's accelerated codec), zlib otherwise.
static size_t bgzf_compress_block(const uint8_t* src, size_t n, uint8_t* dst,
                                  int level) {
  size_t payload = 0;
  uint32_t crc = 0;
#ifdef MK_HAVE_LIBDEFLATE
  libdeflate_compressor*& comp = thread_codecs.comp;
  if (comp == nullptr || thread_codecs.comp_level != level) {
    if (comp) libdeflate_free_compressor(comp);
    comp = libdeflate_alloc_compressor(level);
    thread_codecs.comp_level = level;
  }
  if (comp) {
    payload = libdeflate_deflate_compress(comp, src, n, dst + 18,
                                          0x10000 - 26);
    if (payload == 0) return 0;
    crc = libdeflate_crc32(0, src, n);
  } else
#endif
  {
    z_stream zs{};
    if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8,
                     Z_DEFAULT_STRATEGY) != Z_OK)
      return 0;
    zs.next_in = const_cast<Bytef*>(src);
    zs.avail_in = (uInt)n;
    zs.next_out = dst + 18;
    zs.avail_out = 0x10000 - 26;
    int rc = deflate(&zs, Z_FINISH);
    payload = 0x10000 - 26 - zs.avail_out;
    deflateEnd(&zs);
    if (rc != Z_STREAM_END) return 0;
    crc = (uint32_t)crc32(0, src, n);
  }
  size_t bsize = payload + 26;
  static const uint8_t gz_head[12] = {0x1f, 0x8b, 0x08, 0x04, 0, 0,
                                      0,    0,    0,    0xff, 6, 0};
  std::memcpy(dst, gz_head, 12);
  dst[12] = 'B';
  dst[13] = 'C';
  dst[14] = 2;
  dst[15] = 0;
  uint16_t bs16 = (uint16_t)(bsize - 1);
  std::memcpy(dst + 16, &bs16, 2);
  uint32_t isize = (uint32_t)n;
  std::memcpy(dst + 18 + payload, &crc, 4);
  std::memcpy(dst + 22 + payload, &isize, 4);
  return bsize;
}

// Inflated BGZF blocks of one BAM, by compressed offset, shared by the tile
// decodes of a pileup run. A tile's chunks start at the BAI linear index
// offset of the first read that overlaps it, so most of a tile's blocks are
// also the previous tile's: each is inflated once and copied after that. A
// decode claims a block before it inflates it, and another decode that
// needs the block meanwhile waits for it (a claim is held only while its
// block inflates, so no wait waits on a wait). Each decode registers its
// lowest compressed offset while it inflates; the cache drops every block
// below the lowest registered offset and the most recently started
// decode's (tiles start in genome order, and a sorted BAM's linear index
// does not go backwards), and empties on a new contig or BAM. A block
// dropped too early is inflated again: the output never depends on the
// cache.
struct BlockCache {
  using Block = std::shared_ptr<const std::vector<uint8_t>>;
  std::mutex mu;
  std::condition_variable published;
  const uint8_t* raw = nullptr;
  int32_t tid = -1;
  int64_t last_start = 0;
  std::multiset<int64_t> live;  // lowest offsets of the decodes inflating
  std::set<int64_t> claimed;    // blocks a decode is inflating
  std::map<int64_t, Block> blocks;

  void drop_below_live() {
    int64_t lo = last_start;
    if (!live.empty()) lo = std::min(lo, *live.begin());
    blocks.erase(blocks.begin(), blocks.lower_bound(lo));
  }
  void begin(const uint8_t* bam, int32_t t, int64_t lo) {
    std::lock_guard<std::mutex> g(mu);
    if (bam != raw || t != tid) {
      blocks.clear();
      raw = bam;
      tid = t;
    }
    live.insert(lo);
    last_start = lo;
    drop_below_live();
  }
  void end(int64_t lo) {
    std::lock_guard<std::mutex> g(mu);
    live.erase(live.find(lo));
    drop_below_live();
  }
  // The block at off, once whoever claimed it has published it; null where
  // the caller has now claimed it, inflates it and publishes it.
  Block find_or_claim(int64_t off) {
    std::unique_lock<std::mutex> g(mu);
    for (;;) {
      auto it = blocks.find(off);
      if (it != blocks.end()) return it->second;
      if (claimed.insert(off).second) return nullptr;
      published.wait(g);
    }
  }
  // A claimed block's bytes (null where its inflate failed), and the claim
  // released.
  void publish(int64_t off, const uint8_t* data, int64_t n) {
    Block b;
    if (data) b = std::make_shared<const std::vector<uint8_t>>(data, data + n);
    {
      std::lock_guard<std::mutex> g(mu);
      if (b) blocks.emplace(off, std::move(b));
      claimed.erase(off);
    }
    published.notify_all();
  }
};

// BGZF voffset-chunk inflation with early stop at the first complete
// record past (tid, end) — shared by the tile decoder and the entropy
// batch engine. With a cache, each block is copied from it where an
// earlier or concurrent decode inflated it, and claimed, inflated and
// published otherwise; n_blocks / n_reused (where not null) count the blocks
// the chunks needed and those the cache served.
static void inflate_voffset_chunks(
    const uint8_t* raw, int64_t raw_len, const int64_t* vbeg,
    const int64_t* vend, int32_t n_chunks, int32_t tid, int64_t end,
    int nt, std::vector<std::vector<uint8_t>>& datas,
    std::vector<const uint8_t*>& ptrs, std::vector<int64_t>& lens,
    BlockCache* cache = nullptr, int64_t* n_blocks = nullptr,
    int64_t* n_reused = nullptr) {
  datas.assign((size_t)n_chunks, {});
  ptrs.assign((size_t)n_chunks, nullptr);
  lens.assign((size_t)n_chunks, 0);
  int64_t blocks = 0;
  std::atomic<int64_t> reused{0};
  int64_t lowest = INT64_MAX;
  for (int32_t c = 0; c < n_chunks; ++c)
    lowest = std::min<int64_t>(lowest, vbeg[c] >> 16);
  struct Registered {  // the decode's offset, held while it inflates
    BlockCache* cache;
    int64_t lo;
    ~Registered() {
      if (cache) cache->end(lo);
    }
  } registered{n_chunks > 0 ? cache : nullptr, lowest};
  if (registered.cache) cache->begin(raw, tid, lowest);
  bool stop = false;
  for (int32_t c = 0; c < n_chunks && !stop; ++c) {
    int64_t c0 = vbeg[c] >> 16, u0 = vbeg[c] & 0xFFFF;
    int64_t c1 = vend[c] >> 16, u1 = vend[c] & 0xFFFF;
    std::vector<uint8_t>& data = datas[c];
    int64_t off = c0;
    int64_t scan = u0;       // record-scan position (skips u_start prefix)
    int64_t last_block_out = -1;  // out-offset of the block at c1
    bool hit_span_end = false;
    while (off < raw_len && !hit_span_end && !stop) {
      struct B {
        int64_t coff, doff, dlen, out_off;
        uint32_t isize;
      };
      std::vector<B> batch;
      int64_t base = (int64_t)data.size();
      int64_t total = 0;
      while (off < raw_len && (int)batch.size() < nt * 8) {
        if (off > c1 || (off == c1 && u1 == 0)) {
          hit_span_end = true;
          break;
        }
        int64_t bs, doff, dlen;
        if (!bgzf_block_info(raw, raw_len, off, &bs, &doff, &dlen)) {
          hit_span_end = true;
          break;
        }
        uint32_t isize;
        std::memcpy(&isize, raw + off + bs - 4, 4);
        if (off == c1) last_block_out = base + total;
        batch.push_back({off, doff, dlen, base + total, isize});
        total += isize;
        if (off == c1) {
          off += bs;
          hit_span_end = true;
          break;
        }
        off += bs;
      }
      if (batch.empty()) break;
      blocks += (int64_t)batch.size();
      data.resize((size_t)(base + total));
      auto do_one = [&](const B& b) {
        if (!b.isize) return;
        uint8_t* dst = data.data() + b.out_off;
        BlockCache::Block hit = cache ? cache->find_or_claim(b.coff) : nullptr;
        if (hit && hit->size() == b.isize) {
          std::memcpy(dst, hit->data(), b.isize);
          reused.fetch_add(1, std::memory_order_relaxed);
          return;
        }
        bool ok = inflate_block_raw(raw + b.doff, b.dlen, dst, b.isize);
        if (cache && !hit) cache->publish(b.coff, ok ? dst : nullptr, b.isize);
      };
      if (nt > 1 && batch.size() > 1) {
        std::atomic<size_t> next{0};
        auto worker = [&]() {
          for (;;) {
            size_t i = next.fetch_add(1);
            if (i >= batch.size()) return;
            do_one(batch[i]);
          }
        };
        std::vector<std::thread> pool;
        int tc = std::min<int>(nt, (int)batch.size());
        for (int t = 0; t < tc; ++t) pool.emplace_back(worker);
        for (auto& th : pool) th.join();
      } else {
        for (auto& b : batch) do_one(b);
      }
      // early stop: first COMPLETE record at/past the tile end means the
      // decoder will scan no further — stop inflating
      int64_t avail = (int64_t)data.size();
      while (scan + 4 <= avail) {
        int32_t bs32;
        std::memcpy(&bs32, data.data() + scan, 4);
        if (bs32 < 32 || scan + 4 + bs32 > avail) break;
        int32_t r_ref, r_pos;
        std::memcpy(&r_ref, data.data() + scan + 4, 4);
        std::memcpy(&r_pos, data.data() + scan + 8, 4);
        scan += 4 + bs32;
        if (r_ref > tid || (r_ref == tid && (int64_t)r_pos >= end)) {
          stop = true;
          break;
        }
      }
    }
    // trim: skip the u_start prefix; cut the final block at u_end
    int64_t hi = (int64_t)data.size();
    if (u1 > 0 && last_block_out >= 0)
      hi = std::min<int64_t>(hi, last_block_out + u1);
    if (stop) hi = std::min<int64_t>(hi, scan);
    int64_t lo = std::min<int64_t>(u0, hi);
    ptrs[c] = data.data() + lo;
    lens[c] = hi - lo;
  }
  if (n_blocks) *n_blocks = blocks;
  if (n_reused) *n_reused = reused.load();
}

void* mk_block_cache_new() { return new BlockCache(); }

void mk_block_cache_free(void* cache) {
  delete static_cast<BlockCache*>(cache);
}

int32_t mk_decode_tile_bgzf(const uint8_t* raw, int64_t raw_len,
                            const int64_t* vbeg, const int64_t* vend,
                            int32_t n_chunks, int32_t tid, int64_t start,
                            int64_t end, int64_t max_depth,
                            int32_t force_allow, int32_t has_edge,
                            int64_t edge_start, int64_t edge_end,
                            int32_t edge_inverted,
                            const int64_t* collapse_blob,
                            int32_t collapse_len, const int8_t* focus_rule,
                            const char* ptags, int32_t n_ptags,
                            int32_t n_threads, void* block_cache,
                            MkTileOut* out) {
  int nt = n_threads > 0 ? n_threads : 1;
  std::vector<std::vector<uint8_t>> datas;
  std::vector<const uint8_t*> ptrs;
  std::vector<int64_t> lens;
  int64_t blocks = 0, reused = 0;
  inflate_voffset_chunks(raw, raw_len, vbeg, vend, n_chunks, tid, end, nt,
                         datas, ptrs, lens,
                         static_cast<BlockCache*>(block_cache), &blocks,
                         &reused);
  int32_t rc = mk_decode_tile(ptrs.data(), lens.data(), n_chunks, tid, start,
                              end, max_depth, force_allow, has_edge,
                              edge_start, edge_end, edge_inverted,
                              collapse_blob, collapse_len, focus_rule, ptags,
                              n_ptags, n_threads, out);
  out->bgzf_blocks = blocks;
  out->bgzf_blocks_reused = reused;
  return rc;
}

// Export the decoded tile's sparse events directly into caller-allocated
// buffers padded to (n_pad, m_pad): positions/strand/base zero-padded,
// probs -1-padded (rows beyond n_events and code columns beyond m). This
// matches the padding dispatch_modcall_counts applies, so the Python side
// ships the buffers straight to the device without numpy pad/copy passes.
void mk_export_events(const MkTileOut* out, int64_t n_pad, int32_t m_pad,
                      int32_t* rpos, int32_t* strand, int32_t* base,
                      float* probs) {
  const auto* bufs = static_cast<const TileBuffers*>(out->handle);
  int64_t n = out->n_events;
  int32_t m = out->m;
  std::memcpy(rpos, bufs->ev_rpos.data(), n * sizeof(int32_t));
  std::memset(rpos + n, 0, (n_pad - n) * sizeof(int32_t));
  for (int64_t i = 0; i < n; ++i) strand[i] = bufs->ev_strand[i];
  std::memset(strand + n, 0, (n_pad - n) * sizeof(int32_t));
  for (int64_t i = 0; i < n; ++i) base[i] = bufs->ev_base[i];
  std::memset(base + n, 0, (n_pad - n) * sizeof(int32_t));
  if (m_pad == m) {
    std::memcpy(probs, bufs->ev_probs.data(), n * m * sizeof(float));
    for (int64_t i = n * m; i < n_pad * m_pad; ++i) probs[i] = -1.0f;
  } else {
    for (int64_t i = 0; i < n; ++i) {
      std::memcpy(probs + i * m_pad, bufs->ev_probs.data() + i * m,
                  m * sizeof(float));
      for (int32_t j = m; j < m_pad; ++j) probs[i * m_pad + j] = -1.0f;
    }
    for (int64_t i = n * m_pad; i < n_pad * m_pad; ++i) probs[i] = -1.0f;
  }
}

// Export events as exact u8 qualities + presence/zero bitmasks when every
// probability is either 0.0 (implicit-canonical inference) or an ML-derived
// (q + 0.5)/256 value. Returns 1 on success, 0 when any probability is not
// exactly representable (post-collapse or merged sub-tag values) — the
// caller then falls back to the f32 export. Shrinks the host->device
// transfer 4x; the device kernel reconstructs bit-identical f32 probs.
int32_t mk_export_quals(const MkTileOut* out, int64_t n_pad, int32_t m_pad,
                        uint8_t* quals, uint8_t* present_bits,
                        uint8_t* zero_bits, uint8_t* base) {
  const auto* bufs = static_cast<const TileBuffers*>(out->handle);
  int64_t n = out->n_events;
  int32_t m = out->m;
  if (m > 8) return 0;  // bitmask width
  for (int64_t i = 0; i < n; ++i) {
    const float* row = bufs->ev_probs.data() + i * m;
    uint8_t pres = 0, zero = 0;
    for (int32_t j = 0; j < m; ++j) {
      float p = row[j];
      if (p < 0.0f) {
        quals[i * m_pad + j] = 0;
        continue;
      }
      pres |= (uint8_t)(1u << j);
      if (p == 0.0f) {
        zero |= (uint8_t)(1u << j);
        quals[i * m_pad + j] = 0;
        continue;
      }
      float scaled = p * 256.0f;
      int32_t q = (int32_t)scaled;  // floor for positive values
      if (q < 0 || q > 255 || (float)q + 0.5f != scaled) return 0;
      quals[i * m_pad + j] = (uint8_t)q;
    }
    for (int32_t j = m; j < m_pad; ++j) quals[i * m_pad + j] = 0;
    present_bits[i] = pres;
    zero_bits[i] = zero;
    base[i] = (uint8_t)bufs->ev_base[i];
  }
  std::memset(quals + n * m_pad, 0, (n_pad - n) * m_pad);
  std::memset(present_bits + n, 0, n_pad - n);
  std::memset(zero_bits + n, 0, n_pad - n);
  std::memset(base + n, 0, n_pad - n);
  return 1;
}

// Transposed (class-major) variant of mk_export_quals for the Pallas
// threshold-state kernel: quals_t is [m_pad, n_pad] so each mod class is a
// contiguous lane-tileable plane.
int32_t mk_export_quals_t(const MkTileOut* out, int64_t n_pad, int32_t m_pad,
                          uint8_t* quals_t, uint8_t* present_bits,
                          uint8_t* zero_bits, uint8_t* base) {
  const auto* bufs = static_cast<const TileBuffers*>(out->handle);
  int64_t n = out->n_events;
  int32_t m = out->m;
  if (m > 8) return 0;
  for (int64_t i = 0; i < n; ++i) {
    const float* row = bufs->ev_probs.data() + i * m;
    uint8_t pres = 0, zero = 0;
    for (int32_t j = 0; j < m; ++j) {
      float p = row[j];
      if (p < 0.0f) {
        quals_t[j * n_pad + i] = 0;
        continue;
      }
      pres |= (uint8_t)(1u << j);
      if (p == 0.0f) {
        zero |= (uint8_t)(1u << j);
        quals_t[j * n_pad + i] = 0;
        continue;
      }
      float scaled = p * 256.0f;
      int32_t q = (int32_t)scaled;
      if (q < 0 || q > 255 || (float)q + 0.5f != scaled) return 0;
      quals_t[j * n_pad + i] = (uint8_t)q;
    }
    present_bits[i] = pres;
    zero_bits[i] = zero;
    base[i] = (uint8_t)bufs->ev_base[i];
  }
  for (int32_t j = 0; j < m_pad; ++j)
    std::memset(quals_t + j * n_pad + (j < m ? n : 0), 0,
                j < m ? (n_pad - n) : n_pad);
  std::memset(present_bits + n, 0, n_pad - n);
  std::memset(zero_bits + n, 0, n_pad - n);
  std::memset(base + n, 0, n_pad - n);
  return 1;
}

// Histogram the device-computed per-event call states into the mod-call
// count tensor [p, 2, 1 + 4*(m_pad+1)] (layout of modcall_count_kernel,
// ops/pileup_counts.py): 0 = filtered, 1 + b*(m_pad+1) = canonical(b),
// +1+j = mod code j. The device does the threshold math (elementwise, one
// byte per event back over the link); this does the memory-bound scatter.
void mk_bincount_states(const MkTileOut* out, const uint8_t* states,
                        int32_t m_pad, int32_t* counts) {
  const auto* bufs = static_cast<const TileBuffers*>(out->handle);
  int64_t n = out->n_events;
  int32_t km = 1 + 4 * (m_pad + 1);
  for (int64_t i = 0; i < n; ++i) {
    uint8_t st = states[i];
    int32_t counter =
        (st == 0) ? 0 : 1 + (int32_t)bufs->ev_base[i] * (m_pad + 1) + (st - 1);
    int64_t flat =
        ((int64_t)bufs->ev_rpos[i] * 2 + bufs->ev_strand[i]) * km + counter;
    counts[flat]++;
  }
}

// Fused histogram straight into the FULL count-tensor layout
// [p, 2, 6 + 4*(m_pad+1)] (engine.assemble_counts without the numpy
// zeros + three slice copies): ch0 = deletes, ch1 = filtered,
// ch2..5 = per-base nocall, body at 6 + base*(m_pad+1) + state-1.
void mk_bincount_full(const MkTileOut* out, const uint8_t* states,
                      int32_t m_pad, int64_t p, int32_t* counts) {
  const auto* bufs = static_cast<const TileBuffers*>(out->handle);
  int32_t K = 6 + 4 * (m_pad + 1);
  std::memset(counts, 0, (size_t)p * 2 * K * sizeof(int32_t));
  int64_t n = out->n_events;
  for (int64_t i = 0; i < n; ++i) {
    uint8_t st = states[i];
    int32_t counter =
        (st == 0) ? 1
                  : 6 + (int32_t)bufs->ev_base[i] * (m_pad + 1) + (st - 1);
    counts[((int64_t)bufs->ev_rpos[i] * 2 + bufs->ev_strand[i]) * K +
           counter]++;
  }
  if (out->n_nc && !bufs->nc_counts.empty()) {
    for (int64_t x = 0; x < p * 2; ++x) {
      const int32_t* src = bufs->nc_counts.data() + x * 4;
      int32_t* dst = counts + x * K + 2;
      dst[0] = src[0];
      dst[1] = src[1];
      dst[2] = src[2];
      dst[3] = src[3];
    }
  }
  if (out->n_del && !bufs->del_counts.empty()) {
    for (int64_t x = 0; x < p * 2; ++x) counts[x * K] = bufs->del_counts[x];
  }
}

// Host-side threshold-call states over a decoded tile's events: the C++
// mirror of ops/pileup_counts.threshold_states (semantics of
// MultipleThresholdModCaller::call, threshold_mod_caller.rs:28) used by the
// pure-CPU baseline engine (no device). thr_mod: [m, 4] f32 row-major;
// thr_can: [4]. states_out: u8[n_events], 0 filtered / 1 canonical / 2+j.
void mk_threshold_states(const MkTileOut* out, const float* thr_mod,
                         const float* thr_can, uint8_t* states_out) {
  const auto* bufs = static_cast<const TileBuffers*>(out->handle);
  int64_t n = out->n_events;
  int32_t m = out->m;
  for (int64_t i = 0; i < n; ++i) {
    const float* row = bufs->ev_probs.data() + i * m;
    int b = bufs->ev_base[i];
    float live_sum = 0.0f;
    float best_p = -1.0f;
    int best_j = -1;
    for (int32_t j = 0; j < m; ++j) {
      float p = row[j];
      if (p < 0.0f) continue;
      live_sum += p;
      if (p >= thr_mod[j * 4 + b] && p >= best_p) {
        best_p = p;  // >= keeps the LAST max (Rust Iterator::max)
        best_j = j;
      }
    }
    float canon = 1.0f - live_sum;
    bool pass_can = canon >= thr_can[b];
    uint8_t st;
    if (pass_can && (best_j < 0 || canon >= best_p)) {
      st = 1;
    } else if (best_j >= 0) {
      st = (uint8_t)(2 + best_j);
    } else {
      st = 0;
    }
    states_out[i] = st;
  }
}

// ---------------------------------------------------------- row formatting
// Fused FeatureVector::decode + BedMethylWriter row emission for the
// no-focus pileup path (pileup/mod.rs:412 decode, writers.rs:94-156 row
// format; byte-identical to engine.decode_counts_columnar +
// writers.BedMethylWriter.write_columnar).
//
// counts: [p, 2, k] int32 with k = 6 + 4*(m_pad+1)
// observed: [p, 2, 4, m] uint8 (m = label count)
// labels: m NUL-terminated code label strings
// code_order: label indices sorted by mod-code order (ChEBI < char)
int32_t mk_format_rows(const int32_t* counts, int64_t p, int32_t k,
                       const uint8_t* observed, int32_t m,
                       const char** labels, const int32_t* code_order,
                       int64_t tile_start, const char* chrom,
                       int32_t combine_mods, char space_ch,
                       char** out_buf, int64_t* out_len, int64_t* out_rows) {
  int32_t m_pad = (k - 6) / 4 - 1;
  std::string buf;
  buf.reserve((size_t)p * 64);
  int64_t rows = 0;
  size_t chrom_len = std::strlen(chrom);
  static const char* ANY_MOD = "ACGT";  // any-mod code label per base

  // row tail is assembled in a local buffer with one append per row;
  // digits + separators + label bound stays far under the slack
  char line[512];
  auto put_u = [](char* q, int64_t v) -> char* {
    if (v == 0) {
      *q++ = '0';
      return q;
    }
    char d[20];
    int len = 0;
    while (v > 0) {
      d[len++] = (char)('0' + v % 10);
      v /= 10;
    }
    while (len) *q++ = d[--len];
    return q;
  };

  // percent strings repeat heavily at uniform coverage — memoize the
  // snprintf("%.2f") by (n_mod, valid) in a small direct-mapped cache
  struct PctSlot {
    uint64_t key = ~0ull;
    uint8_t len = 0;
    char s[15];
  };
  std::vector<PctSlot> pct(4096);
  auto put_pct = [&](char* q, int64_t n_mod, int64_t valid) -> char* {
    uint64_t key = ((uint64_t)n_mod << 32) | (uint64_t)(uint32_t)valid;
    PctSlot& c = pct[(key * 0x9E3779B97F4A7C15ull) >> 52];
    if (c.key != key) {
      float frac = ((float)n_mod / (float)valid) * 100.0f;
      c.len = (uint8_t)snprintf(c.s, sizeof(c.s), "%.2f", (double)frac);
      c.key = key;
    }
    std::memcpy(q, c.s, c.len);
    return q + c.len;
  };

  for (int64_t pi = 0; pi < p; ++pi) {
    const int32_t* row0 = counts + (pi * 2) * k;
    for (int s = 0; s < 2; ++s) {
      const int32_t* c = row0 + s * k;
      // per-base canonical / mod sums
      int64_t valid_b[4], can_b[4], modsum_b[4];
      int64_t total_valid = 0, total_nocall = 0;
      for (int b = 0; b < 4; ++b) {
        const int32_t* body = c + 6 + b * (m_pad + 1);
        can_b[b] = body[0];
        int64_t ms = 0;
        for (int32_t j = 0; j < m_pad; ++j) ms += body[1 + j];
        modsum_b[b] = ms;
        valid_b[b] = can_b[b] + ms;
        total_valid += valid_b[b];
        total_nocall += c[2 + b];
      }
      if (total_valid == 0) continue;
      int64_t n_del = c[0], n_filt = c[1];

      auto emit = [&](int64_t valid, const char* name, size_t name_len,
                      int64_t n_mod, int64_t n_can, int64_t n_other,
                      int64_t n_nocall) {
        int64_t n_diff =
            (total_valid - valid) + (total_nocall - n_nocall);
        buf.append(chrom, chrom_len);
        char* q = line;
        *q++ = '\t';
        q = put_u(q, tile_start + pi);
        *q++ = '\t';
        q = put_u(q, tile_start + pi + 1);
        *q++ = '\t';
        if (name_len > 64) name_len = 64;  // labels are short mod codes
        std::memcpy(q, name, name_len);
        q += name_len;
        *q++ = '\t';
        q = put_u(q, valid);
        *q++ = '\t';
        *q++ = (s == 0 ? '+' : '-');
        *q++ = '\t';
        q = put_u(q, tile_start + pi);
        *q++ = '\t';
        q = put_u(q, tile_start + pi + 1);
        *q++ = '\t';
        std::memcpy(q, "255,0,0\t", 8);
        q += 8;
        q = put_u(q, valid);
        *q++ = space_ch;
        q = put_pct(q, n_mod, valid);
        *q++ = space_ch;
        q = put_u(q, n_mod);
        *q++ = space_ch;
        q = put_u(q, n_can);
        *q++ = space_ch;
        q = put_u(q, n_other);
        *q++ = space_ch;
        q = put_u(q, n_del);
        *q++ = space_ch;
        q = put_u(q, n_filt);
        *q++ = space_ch;
        q = put_u(q, n_diff);
        *q++ = space_ch;
        q = put_u(q, n_nocall);
        *q++ = '\n';
        buf.append(line, (size_t)(q - line));
        ++rows;
      };

      if (combine_mods) {
        for (int b = 0; b < 4; ++b) {
          if (valid_b[b] == 0) continue;
          emit(valid_b[b], &ANY_MOD[b], 1, valid_b[b] - can_b[b], can_b[b],
               0, c[2 + b]);
        }
      } else {
        const uint8_t* obs = observed + ((pi * 2 + s) * 4) * (size_t)m;
        for (int32_t r = 0; r < m; ++r) {
          int32_t j = code_order[r];
          for (int b = 0; b < 4; ++b) {
            if (valid_b[b] == 0 || !obs[b * m + j]) continue;
            const int32_t* body = c + 6 + b * (m_pad + 1);
            int64_t n_mod = body[1 + j];
            emit(valid_b[b], labels[j], std::strlen(labels[j]), n_mod,
                 can_b[b], modsum_b[b] - n_mod, c[2 + b]);
          }
        }
      }
    }
  }
  char* mem = (char*)std::malloc(buf.size());
  if (mem == nullptr && !buf.empty()) return 1;
  std::memcpy(mem, buf.data(), buf.size());
  *out_buf = mem;
  *out_len = (int64_t)buf.size();
  *out_rows = rows;
  return 0;
}

void mk_free_buf(char* buf) { std::free(buf); }

// -------------------------------------------------------- per-read groups
// Native equivalent of thresholds.read_groups (mirrors reference
// read_ids_to_base_mod_probs.rs ReadIdsToBaseModProbs::process_records):
// decode one record into per-(threshold base) probability groups with the
// sampling path's transform order (edge filter -> aligned-column
// intersection when only_mapped -> collapse). Serves threshold estimation,
// summary, and sample-probs.
struct GroupsBuffers {
  std::vector<int8_t> tb;
  std::vector<int64_t> n_pos;
  std::vector<int32_t> n_codes;
  std::vector<int64_t> codes;
  std::vector<float> probs;
};

struct MkGroupsOut {
  int32_t rc;        // 0 ok, 1 decode error (err_kind set)
  int32_t err_kind;
  int32_t n_groups;
  const int8_t* tb;
  const int64_t* n_pos;
  const int32_t* n_codes;
  const int64_t* codes;
  const float* probs;
  int64_t total_codes;
  int64_t total_probs;
  void* handle;
};

int32_t mk_read_groups(const uint8_t* rec_buf, int64_t rec_len,
                       int32_t only_mapped, int32_t has_edge,
                       int64_t edge_start, int64_t edge_end,
                       int32_t edge_inverted, const int64_t* collapse_blob,
                       int32_t collapse_len, MkGroupsOut* out) {
  std::memset(out, 0, sizeof(MkGroupsOut));
  Rec r;
  r.p = rec_buf;
  r.len = rec_len;
  r.parse_head();
  auto* bufs = new GroupsBuffers();
  out->handle = bufs;

  std::vector<CollapseOp> collapse;
  for (int32_t i = 0; i < collapse_len;) {
    CollapseOp op;
    op.kind = (int)collapse_blob[i++];
    int64_t nc = collapse_blob[i++];
    for (int64_t j = 0; j < nc; ++j) op.codes.push_back(collapse_blob[i++]);
    op.has_to = collapse_blob[i++] != 0;
    op.to_code = collapse_blob[i++];
    collapse.push_back(std::move(op));
  }

  std::vector<uint8_t> fwd;
  forward_seq(r, fwd);
  try {
    AuxTags aux = scan_aux(r);
    if (aux.bad) throw MkError{E_INVALID_MM};
    const TagSlot& mm = aux.mm_up.present ? aux.mm_up : aux.mm_lo;
    if (!mm.present) throw MkError{E_MM_MISSING};
    if (mm.wrong_type || mm.z == nullptr) throw MkError{E_INVALID_MM};
    const TagSlot& ml = aux.ml_up.present ? aux.ml_up : aux.ml_lo;
    if (!ml.present) throw MkError{E_ML_MISSING};
    if (ml.wrong_type || ml.b == nullptr) throw MkError{E_INVALID_ML};
    if (aux.mn_present) {
      if (aux.mn_wrong_type) throw MkError{E_INVALID_MN};
      if (aux.mn_value != (int64_t)r.l_seq) throw MkError{E_INVALID_MN};
    } else if (r.is_not_primary()) {
      throw MkError{E_NON_PRIMARY_MN};
    }
    ModInfo info = decode_read_mods(fwd, mm.z, ml.b, ml.b_n);

    std::vector<int32_t> qf, rp;
    if (only_mapped) aligned_pairs_sorted(r, qf, rp);

    for (int strand_pass = 0; strand_pass < 2; ++strand_pass) {
      for (auto& g : info.groups) {
        if (g.mod_strand != strand_pass) continue;
        std::vector<int32_t> positions = g.pos;
        std::vector<float> probs = g.probs;
        std::vector<Code> gcodes = g.codes;
        size_t gm = gcodes.size();
        if (has_edge) {
          if ((int64_t)r.l_seq <= edge_start + edge_end) continue;
          int64_t lo = edge_start, hi = (int64_t)r.l_seq - edge_end;
          std::vector<int32_t> np_;
          std::vector<float> npr;
          for (size_t i = 0; i < positions.size(); ++i) {
            bool inside = positions[i] >= lo && positions[i] < hi;
            bool keepi = edge_inverted ? !inside : inside;
            if (keepi) {
              np_.push_back(positions[i]);
              for (size_t j = 0; j < gm; ++j) npr.push_back(probs[i * gm + j]);
            }
          }
          if (np_.empty()) continue;
          positions = std::move(np_);
          probs = std::move(npr);
        }
        if (only_mapped) {
          std::vector<int32_t> np_;
          std::vector<float> npr;
          size_t k = 0;
          for (size_t i = 0; i < positions.size(); ++i) {
            while (k < qf.size() && qf[k] < positions[i]) ++k;
            if (k < qf.size() && qf[k] == positions[i]) {
              np_.push_back(positions[i]);
              for (size_t j = 0; j < gm; ++j) npr.push_back(probs[i * gm + j]);
            }
          }
          if (np_.empty()) continue;
          positions = std::move(np_);
          probs = std::move(npr);
        }
        for (const auto& op : collapse)
          apply_collapse(gcodes, probs, gm, positions.size(), op);

        int b_idx = base_char_to_idx(g.base);
        int tb = (g.mod_strand == 0) ? b_idx : IDX_COMPL[b_idx];
        bufs->tb.push_back((int8_t)tb);
        bufs->n_pos.push_back((int64_t)positions.size());
        bufs->n_codes.push_back((int32_t)gm);
        bufs->codes.insert(bufs->codes.end(), gcodes.begin(), gcodes.end());
        bufs->probs.insert(bufs->probs.end(), probs.begin(), probs.end());
        out->n_groups++;
      }
    }
    out->tb = bufs->tb.data();
    out->n_pos = bufs->n_pos.data();
    out->n_codes = bufs->n_codes.data();
    out->codes = bufs->codes.data();
    out->probs = bufs->probs.data();
    out->total_codes = (int64_t)bufs->codes.size();
    out->total_probs = (int64_t)bufs->probs.size();
    return 0;
  } catch (const MkError& e) {
    out->rc = 1;
    out->err_kind = e.kind;
    return 1;
  }
}

void mk_free_groups(MkGroupsOut* out) {
  delete static_cast<GroupsBuffers*>(out->handle);
  out->handle = nullptr;
}

// ------------------------------------------------- streaming extract full
// Native fast path of `extract full` (engines/extract.py full_rows):
// spans of the compressed BAM stream decode + format in one call, records
// split across an internal thread pool, rows byte-identical to the Python
// path (tests/test_native_extract.py). Partial records at the span tail
// return as carry bytes for the next call.

static char* put_u_ex(char* q, int64_t v) {
  if (v < 0) {
    *q++ = '-';
    v = -v;
  }
  if (v == 0) {
    *q++ = '0';
    return q;
  }
  char d[20];
  int len = 0;
  while (v > 0) {
    d[len++] = (char)('0' + v % 10);
    v /= 10;
  }
  while (len) *q++ = d[--len];
  return q;
}

static char* put_code_ex(char* q, Code c) {
  if (c < 0) {
    *q++ = (char)(-c);
    return q;
  }
  return put_u_ex(q, c);
}

static char* put_f32_ex(char* q, float v) {
  // distinct probability values are few (raw ML bytes + collapse
  // arithmetic) — memoize by bit pattern in a direct-mapped cache
  struct Slot {
    uint32_t bits = 0xFFFFFFFFu;
    uint8_t len = 0;
    char s[48];
  };
  thread_local std::vector<Slot> memo(8192);
  uint32_t bits;
  std::memcpy(&bits, &v, 4);
  Slot& c = memo[(bits * 2654435761u) >> 19];
  if (c.bits != bits) {
    std::string s = format_f32_rust(v);
    if (s.size() > sizeof(c.s)) {  // huge magnitudes: bypass the cache
      std::memcpy(q, s.data(), s.size());
      return q + s.size();
    }
    c.len = (uint8_t)s.size();
    std::memcpy(c.s, s.data(), c.len);
    c.bits = bits;
  }
  std::memcpy(q, c.s, c.len);
  return q + c.len;
}

static char compl_ch(char b) {
  switch (b) {
    case 'A': return 'T';
    case 'C': return 'G';
    case 'G': return 'C';
    case 'T': return 'A';
    case '-': return '-';
    default: return b;
  }
}

struct ExtractOpts {
  DecodeOpts dec;  // edge + collapse (force_allow unused by extract)
  int32_t kmer_size = 5;
  bool mapped_only = false, allow_non_primary = false;
  // calls mode (engines/extract.py calls_rows + caller.ThresholdCaller):
  // thresholds carried as f64 so comparisons promote exactly like the
  // Python (np.float32 cmp float) path
  bool calls_mode = false, pass_only = false;
  // --ignore-implicit: drop inferred-canonical positions before row/union
  // derivation (read_ids_to_base_mod_probs.rs:765 remove_inferred)
  bool remove_inferred = false;
  std::vector<std::pair<Code, double>> per_mod;
  double fallback_mod[4] = {0, 0, 0, 0};  // chain after per_mod[code]
  double can_thr[4] = {0, 0, 0, 0};

  double mod_thr(Code c, int base_idx) const {
    for (auto& kv : per_mod)
      if (kv.first == c) return kv.second;
    return fallback_mod[base_idx];
  }
};

static int base_idx_of(char b) {
  switch (b) {
    case 'A': return 0;
    case 'C': return 1;
    case 'G': return 2;
    default: return 3;  // T
  }
}

// ModCodeRepr Ord: ChEbi(int) < Code(char); ints numerically, chars by
// codepoint (mod_base_code.rs:142-151; encoding: char -> -ord, int -> +v)
static bool code_less(Code a, Code b) {
  bool ac = a < 0, bc = b < 0;
  if (ac != bc) return bc;  // ints (non-char) first
  if (ac) return -a < -b;   // chars by codepoint
  return a < b;
}

// per-read row formatting (full_rows semantics)
static void extract_read_rows(
    const Rec& r, const ExtractOpts& opts,
    const std::vector<std::string>& tid_names,
    const char* const* ref_seqs, const int64_t* ref_lens, int32_t n_tids,
    std::string& out, int64_t err_counts[16]) {
  std::vector<uint8_t> fwd;
  forward_seq(r, fwd);
  ModInfo info;
  try {
    AuxTags aux = scan_aux(r);
    if (aux.bad) throw MkError{E_INVALID_MM};
    const TagSlot& mm = aux.mm_up.present ? aux.mm_up : aux.mm_lo;
    if (!mm.present) throw MkError{E_MM_MISSING};
    if (mm.wrong_type || mm.z == nullptr) throw MkError{E_INVALID_MM};
    const TagSlot& ml = aux.ml_up.present ? aux.ml_up : aux.ml_lo;
    if (!ml.present) throw MkError{E_ML_MISSING};
    if (ml.wrong_type || ml.b == nullptr) throw MkError{E_INVALID_ML};
    if (aux.mn_present) {
      if (aux.mn_wrong_type) throw MkError{E_INVALID_MN};
      if (aux.mn_value != (int64_t)r.l_seq) throw MkError{E_INVALID_MN};
    } else if (r.is_not_primary()) {
      throw MkError{E_NON_PRIMARY_MN};
    }
    info = decode_read_mods(fwd, mm.z, ml.b, ml.b_n);
  } catch (const MkError& e) {
    err_counts[e.kind]++;
    return;
  }

  // per-group post-processing (edge filter then collapse), keeping the
  // iter_groups order (strand 0 groups first-seen, then strand 1)
  struct GView {
    char base;
    int strand;
    std::vector<Code> codes;
    std::vector<int32_t> pos;
    std::vector<float> probs;
    std::vector<uint8_t> inferred;
  };
  std::vector<GView> gs;
  for (int strand_pass = 0; strand_pass < 2; ++strand_pass) {
    for (auto& g : info.groups) {
      if (g.mod_strand != strand_pass) continue;
      GView v;
      v.base = g.base;
      v.strand = g.mod_strand;
      v.codes = g.codes;
      v.pos = g.pos;
      v.probs = g.probs;
      v.inferred = g.inferred;
      size_t gm = v.codes.size();
      if (opts.dec.has_edge) {
        if ((int64_t)r.l_seq <=
            opts.dec.edge_start + opts.dec.edge_end)
          continue;
        int64_t lo = opts.dec.edge_start;
        int64_t hi = (int64_t)r.l_seq - opts.dec.edge_end;
        std::vector<int32_t> np_;
        std::vector<float> npr;
        std::vector<uint8_t> ninf;
        for (size_t i = 0; i < v.pos.size(); ++i) {
          bool inside = v.pos[i] >= lo && v.pos[i] < hi;
          bool keepi = opts.dec.edge_inverted ? !inside : inside;
          if (keepi) {
            np_.push_back(v.pos[i]);
            ninf.push_back(v.inferred[i]);
            for (size_t j = 0; j < gm; ++j)
              npr.push_back(v.probs[i * gm + j]);
          }
        }
        if (np_.empty()) continue;
        v.pos = std::move(np_);
        v.probs = std::move(npr);
        v.inferred = std::move(ninf);
      }
      for (const auto& op : opts.dec.collapse)
        apply_collapse(v.codes, v.probs, gm, v.pos.size(), op);
      gs.push_back(std::move(v));
    }
  }

  // merged entry order: stable sort by qpos (descending for reverse)
  struct Ent {
    int32_t qpos;
    uint32_t gi, pi;
  };
  std::vector<Ent> ents;
  for (uint32_t gi = 0; gi < gs.size(); ++gi)
    for (uint32_t pi = 0; pi < gs[gi].pos.size(); ++pi) {
      if (opts.remove_inferred && gs[gi].inferred[pi]) continue;
      ents.push_back({gs[gi].pos[pi], gi, pi});
    }
  bool rev = r.is_reverse();
  std::stable_sort(ents.begin(), ents.end(),
                   [rev](const Ent& a, const Ent& b) {
                     return rev ? a.qpos > b.qpos : a.qpos < b.qpos;
                   });
  if (ents.empty()) return;

  // alignment metadata
  bool unmapped = r.is_unmapped();
  int64_t clip_start = 0, clip_end = 0;
  std::vector<int32_t> refmap;
  if (!unmapped) {
    const uint8_t* cg = r.cigar();
    for (int i = 0; i < r.n_cigar; ++i) {
      uint32_t v;
      std::memcpy(&v, cg + 4 * i, 4);
      if ((v & 0xF) == 4)
        clip_start += v >> 4;
      else
        break;
    }
    for (int i = r.n_cigar - 1; i >= 0; --i) {
      uint32_t v;
      std::memcpy(&v, cg + 4 * i, 4);
      if ((v & 0xF) == 4)
        clip_end += v >> 4;
      else
        break;
    }
    if (rev) std::swap(clip_start, clip_end);
    std::vector<int32_t> qf, rp;
    aligned_pairs_sorted(r, qf, rp);
    refmap.assign(r.l_seq, -1);
    for (size_t i = 0; i < qf.size(); ++i) refmap[qf[i]] = rp[i];
  }
  const char* chrom = ".";
  size_t chrom_len = 1;
  const char* ref_seq = nullptr;
  int64_t ref_len = 0;
  if (!unmapped && r.ref_id >= 0 && r.ref_id < n_tids) {
    chrom = tid_names[r.ref_id].c_str();
    chrom_len = tid_names[r.ref_id].size();
    if (ref_seqs != nullptr && ref_seqs[r.ref_id] != nullptr) {
      ref_seq = ref_seqs[r.ref_id];
      ref_len = ref_lens[r.ref_id];
    }
  }
  const char* name = (const char*)r.p + 32;
  size_t name_len = r.l_read_name > 0 ? r.l_read_name - 1 : 0;
  const uint8_t* quals = r.seq4() + (r.l_seq + 1) / 2;
  bool primary_or_unmapped =
      (r.flag == 0 || r.flag == 16 || r.flag == 4);
  int ksz = opts.kmer_size;
  int kbefore = (ksz % 2 == 0) ? ksz / 2 - 1 : ksz / 2;

  // calls mode: observed codes per base across the read's emitted rows,
  // sorted by mod-code order (calls_rows codes_per_base)
  std::array<std::vector<Code>, 4> union_by_base;
  if (opts.calls_mode) {
    for (const Ent& e : ents) {
      const GView& g = gs[e.gi];
      int32_t qpos = e.qpos;
      if (!primary_or_unmapped &&
          !(qpos >= clip_start && qpos < (int64_t)r.l_seq - clip_end))
        continue;
      auto& u = union_by_base[base_idx_of(g.base)];
      size_t gm = g.codes.size();
      for (size_t j = 0; j < gm; ++j)
        if (g.probs[e.pi * gm + j] >= 0.0f &&
            std::find(u.begin(), u.end(), g.codes[j]) == u.end())
          u.push_back(g.codes[j]);
    }
    for (auto& u : union_by_base) std::sort(u.begin(), u.end(), code_less);
  }

  std::vector<char> linebuf(chrom_len + 640);  // room for any contig name
  char* line = linebuf.data();
  for (const Ent& e : ents) {
    const GView& g = gs[e.gi];
    int32_t qpos = e.qpos;
    if (!primary_or_unmapped &&
        !(qpos >= clip_start && qpos < (int64_t)r.l_seq - clip_end))
      continue;
    int32_t ref_pos = unmapped ? -1 : refmap[qpos];
    char mod_s = g.strand == 0 ? '+' : '-';
    char ref_s, ref_ms;
    if (unmapped) {
      ref_s = ref_ms = '.';
    } else {
      ref_s = rev ? '-' : '+';
      bool flip = (g.strand == 1) != rev;
      ref_ms = flip ? '-' : '+';
    }
    int64_t q = (qpos < (int64_t)r.l_seq)
                    ? quals[rev ? r.l_seq - 1 - qpos : qpos]
                    : 0;
    char mod_primary = g.strand == 1 ? compl_ch(g.base) : g.base;
    // query kmer (revcomp for '-' mod strand) and ref kmer
    char kq[64], kr[64];
    for (int i = 0; i < ksz; ++i) {
      int64_t off = qpos - kbefore + i;
      kq[i] = (off >= 0 && off < (int64_t)fwd.size())
                  ? (char)fwd[off]
                  : '-';
    }
    if (g.strand == 1) {
      for (int i = 0; i < ksz / 2; ++i) std::swap(kq[i], kq[ksz - 1 - i]);
      for (int i = 0; i < ksz; ++i) kq[i] = compl_ch(kq[i]);
    }
    bool have_ref_kmer = ref_seq != nullptr && ref_pos >= 0;
    if (have_ref_kmer)
      for (int i = 0; i < ksz; ++i) {
        int64_t off = ref_pos - kbefore + i;
        kr[i] = (off >= 0 && off < ref_len) ? ref_seq[off] : '-';
      }
    // the row splits into [prefix] prob \t code [suffix], where prefix
    // and suffix are constant across this entry's code loop — render
    // each once (10 ints + 2 kmers per entry instead of per row)
    char* w = line;
    *w++ = '\t';
    w = put_u_ex(w, qpos);
    *w++ = '\t';
    w = put_u_ex(w, ref_pos);
    *w++ = '\t';
    std::memcpy(w, chrom, chrom_len);
    w += chrom_len;
    *w++ = '\t';
    *w++ = mod_s;
    *w++ = '\t';
    *w++ = ref_s;
    *w++ = '\t';
    *w++ = ref_ms;
    *w++ = '\t';
    w = put_u_ex(w, clip_start);
    *w++ = '\t';
    w = put_u_ex(w, clip_end);
    *w++ = '\t';
    w = put_u_ex(w, r.l_seq);
    *w++ = '\t';
    size_t pref_len = (size_t)(w - line);

    if (opts.calls_mode) {
      // one thresholded call per entry (calls_rows)
      int bidx = base_idx_of(g.base);
      const auto& u = union_by_base[bidx];
      size_t gm = g.codes.size();
      std::vector<std::pair<Code, float>> probs;  // insertion order
      if (g.inferred[e.pi]) {
        for (Code c : u) probs.emplace_back(c, 0.0f);
      } else {
        for (size_t j = 0; j < gm; ++j) {
          float p = g.probs[e.pi * gm + j];
          if (p >= 0.0f) probs.emplace_back(g.codes[j], p);
        }
        for (Code c : u) {
          bool seen = false;
          for (auto& kv : probs)
            if (kv.first == c) {
              seen = true;
              break;
            }
          if (!seen) probs.emplace_back(c, 0.0f);
        }
      }
      float sum = 0.0f;  // f32 accumulate in candidate order
      for (auto& kv : probs) sum += kv.second;
      float canon = 1.0f - sum;
      bool any_pass = false;
      for (auto& kv : probs)
        if ((double)kv.second >= opts.mod_thr(kv.first, bidx))
          any_pass = true;
      if ((double)canon >= opts.can_thr[bidx]) any_pass = true;
      bool filtered = !any_pass;
      if (filtered && opts.pass_only) continue;
      bool has = false;
      float best_p = 0.0f;
      Code best_code = 0;
      for (auto& kv : probs)
        if (!has || kv.second >= best_p) {
          best_p = kv.second;
          best_code = kv.first;
          has = true;
        }
      bool dash = (!has) || !(best_p > canon);
      float call_prob = dash ? canon : best_p;
      bool within = !unmapped && qpos >= clip_start &&
                    qpos < (int64_t)r.l_seq - clip_end;
      char* w2 = w;
      w2 = put_f32_ex(w2, call_prob);
      *w2++ = '\t';
      if (dash)
        *w2++ = '-';
      else
        w2 = put_code_ex(w2, best_code);
      *w2++ = '\t';
      w2 = put_u_ex(w2, q);
      *w2++ = '\t';
      if (have_ref_kmer) {
        std::memcpy(w2, kr, ksz);
        w2 += ksz;
      } else {
        *w2++ = '.';
      }
      *w2++ = '\t';
      std::memcpy(w2, kq, ksz);
      w2 += ksz;
      *w2++ = '\t';
      *w2++ = g.base;
      *w2++ = '\t';
      *w2++ = mod_primary;
      *w2++ = '\t';
      auto put_bool = [&](bool b) {
        if (b) {
          std::memcpy(w2, "true", 4);
          w2 += 4;
        } else {
          std::memcpy(w2, "false", 5);
          w2 += 5;
        }
      };
      put_bool(filtered);
      *w2++ = '\t';
      put_bool(g.inferred[e.pi] != 0);
      *w2++ = '\t';
      put_bool(within);
      *w2++ = '\t';
      w2 = put_u_ex(w2, r.flag);
      *w2++ = '\n';
      out.append(name, name_len);
      out.append(line, (size_t)(w2 - line));
      continue;
    }

    char suf[192];
    char* s2 = suf;
    *s2++ = '\t';
    s2 = put_u_ex(s2, q);
    *s2++ = '\t';
    if (have_ref_kmer) {
      std::memcpy(s2, kr, ksz);
      s2 += ksz;
    } else {
      *s2++ = '.';
    }
    *s2++ = '\t';
    std::memcpy(s2, kq, ksz);
    s2 += ksz;
    *s2++ = '\t';
    *s2++ = g.base;
    *s2++ = '\t';
    *s2++ = mod_primary;
    *s2++ = '\t';
    if (g.inferred[e.pi]) {
      std::memcpy(s2, "true", 4);
      s2 += 4;
    } else {
      std::memcpy(s2, "false", 5);
      s2 += 5;
    }
    *s2++ = '\t';
    s2 = put_u_ex(s2, r.flag);
    *s2++ = '\n';
    size_t suf_len = (size_t)(s2 - suf);
    size_t gm = g.codes.size();
    char mid[80];
    for (size_t j = 0; j < gm; ++j) {
      float p = g.probs[e.pi * gm + j];
      if (p < 0.0f) continue;
      char* m2 = put_f32_ex(mid, p);
      *m2++ = '\t';
      m2 = put_code_ex(m2, g.codes[j]);
      out.append(name, name_len);
      out.append(line, pref_len);
      out.append(mid, (size_t)(m2 - mid));
      out.append(suf, suf_len);
    }
  }
}

struct MkExtractOut {
  char* text;
  int64_t text_len;
  uint8_t* carry;
  int64_t carry_len;
  int64_t next_off;
  int32_t n_reads;     // records that produced output (or empty row sets)
  int32_t eof;
  int64_t err_counts[16];
};

// Decode + format one span of the compressed BAM stream. start_off must
// be a BGZF block boundary; carry holds the partial record tail from the
// previous span. parse_header=1 skips the BAM header (first span only).
int32_t mk_extract_span(
    const uint8_t* raw, int64_t raw_len, int64_t start_off,
    int64_t max_comp, const uint8_t* carry, int64_t carry_len,
    int32_t parse_header, const char** tid_names_c, int32_t n_tids,
    const char** ref_seqs, const int64_t* ref_lens, int32_t kmer_size,
    int32_t mapped_only, int32_t allow_non_primary, int32_t has_edge,
    int64_t edge_start, int64_t edge_end, int32_t edge_inverted,
    const int64_t* collapse_blob, int32_t collapse_len,
    int32_t calls_mode, int32_t pass_only, int32_t ignore_implicit,
    const int64_t* pm_codes,
    const double* pm_vals, int32_t n_pm, const double* fallback_mod4,
    const double* can_thr4,
    int32_t n_threads, MkExtractOut* out) {
  std::memset(out, 0, sizeof(MkExtractOut));
  ExtractOpts opts;
  opts.kmer_size = kmer_size;
  opts.mapped_only = mapped_only != 0;
  opts.allow_non_primary = allow_non_primary != 0;
  opts.calls_mode = calls_mode != 0;
  opts.pass_only = pass_only != 0;
  opts.remove_inferred = ignore_implicit != 0;
  if (calls_mode) {
    for (int32_t i = 0; i < n_pm; ++i)
      opts.per_mod.emplace_back(pm_codes[i], pm_vals[i]);
    for (int b = 0; b < 4; ++b) {
      opts.fallback_mod[b] = fallback_mod4[b];
      opts.can_thr[b] = can_thr4[b];
    }
  }
  opts.dec.has_edge = has_edge != 0;
  opts.dec.edge_start = edge_start;
  opts.dec.edge_end = edge_end;
  opts.dec.edge_inverted = edge_inverted != 0;
  for (int32_t i = 0; i < collapse_len;) {
    CollapseOp op;
    op.kind = (int)collapse_blob[i++];
    int64_t nc = collapse_blob[i++];
    for (int64_t j = 0; j < nc; ++j) op.codes.push_back(collapse_blob[i++]);
    op.has_to = collapse_blob[i++] != 0;
    op.to_code = collapse_blob[i++];
    opts.dec.collapse.push_back(std::move(op));
  }
  std::vector<std::string> tid_names(n_tids);
  for (int32_t i = 0; i < n_tids; ++i) tid_names[i] = tid_names_c[i];

  // 1) walk blocks for this span
  struct Blk {
    int64_t data_off, data_len, isize;
  };
  std::vector<Blk> blks;
  int64_t off = start_off, comp_used = 0, total_isize = 0;
  while (off < raw_len && comp_used < max_comp) {
    int64_t bs, doff, dlen;
    if (!bgzf_block_info(raw, raw_len, off, &bs, &doff, &dlen)) break;
    uint32_t isize;
    std::memcpy(&isize, raw + off + bs - 4, 4);
    blks.push_back({doff, dlen, (int64_t)isize});
    total_isize += isize;
    comp_used += bs;
    off += bs;
  }
  out->next_off = off;
  out->eof = off >= raw_len ? 1 : 0;

  // 2) inflate in parallel into one contiguous buffer after the carry
  std::vector<uint8_t> data(carry_len + total_isize);
  if (carry_len) std::memcpy(data.data(), carry, carry_len);
  std::vector<int64_t> dst_off(blks.size());
  {
    int64_t c = carry_len;
    for (size_t i = 0; i < blks.size(); ++i) {
      dst_off[i] = c;
      c += blks[i].isize;
    }
  }
  int nt = n_threads > 0 ? n_threads : 1;
  std::atomic<size_t> next{0};
  std::atomic<bool> infl_ok{true};
  auto inflate_worker = [&]() {
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= blks.size()) return;
      if (blks[i].isize == 0) continue;
      if (!inflate_block_raw(raw + blks[i].data_off, blks[i].data_len,
                             data.data() + dst_off[i], blks[i].isize))
        infl_ok.store(false);
    }
  };
  if (nt > 1 && blks.size() > 1) {
    std::vector<std::thread> pool;
    for (int t = 0; t < nt; ++t) pool.emplace_back(inflate_worker);
    for (auto& th : pool) th.join();
  } else {
    inflate_worker();
  }
  if (!infl_ok.load()) return 2;

  // 3) optionally skip the BAM header (first span)
  int64_t p = 0, dlen_total = (int64_t)data.size();
  if (parse_header) {
    if (dlen_total < 12 || std::memcmp(data.data(), "BAM\1", 4) != 0)
      return 3;
    int32_t l_text;
    std::memcpy(&l_text, data.data() + 4, 4);
    p = 8 + l_text;
    if (p + 4 > dlen_total) return 3;
    int32_t n_ref;
    std::memcpy(&n_ref, data.data() + p, 4);
    p += 4;
    for (int32_t i = 0; i < n_ref; ++i) {
      if (p + 4 > dlen_total) return 3;
      int32_t l_name;
      std::memcpy(&l_name, data.data() + p, 4);
      p += 4 + l_name + 4;
    }
    if (p > dlen_total) return 3;
  }

  // 4) collect complete records; the tail becomes carry-out
  std::vector<Rec> recs;
  int64_t tail_start = p;
  while (p + 4 <= dlen_total) {
    int32_t bs;
    std::memcpy(&bs, data.data() + p, 4);
    if (bs < 32 || p + 4 + bs > dlen_total) break;
    Rec r;
    r.p = data.data() + p + 4;
    r.len = bs;
    r.parse_head();
    recs.push_back(r);
    p += 4 + bs;
    tail_start = p;
  }
  out->carry_len = dlen_total - tail_start;
  if (out->carry_len) {
    out->carry = (uint8_t*)std::malloc(out->carry_len);
    std::memcpy(out->carry, data.data() + tail_start, out->carry_len);
  }

  // 5) filter + format, records sharded contiguously across threads
  std::vector<const Rec*> keep;
  keep.reserve(recs.size());
  for (auto& r : recs) {
    if (!opts.allow_non_primary && r.is_not_primary()) continue;
    if (opts.mapped_only && r.is_unmapped()) continue;
    keep.push_back(&r);
  }
  int fnt = (nt > 1 && keep.size() > 1) ? nt : 1;
  std::vector<std::string> parts(fnt);
  std::vector<std::array<int64_t, 16>> errs(fnt);
  for (auto& a : errs) a.fill(0);
  auto fmt_worker = [&](int t) {
    size_t lo = keep.size() * t / fnt, hi = keep.size() * (t + 1) / fnt;
    for (size_t i = lo; i < hi; ++i)
      extract_read_rows(*keep[i], opts, tid_names, ref_seqs, ref_lens,
                        n_tids, parts[t], errs[t].data());
  };
  if (fnt > 1) {
    std::vector<std::thread> pool;
    for (int t = 0; t < fnt; ++t) pool.emplace_back(fmt_worker, t);
    for (auto& th : pool) th.join();
  } else {
    fmt_worker(0);
  }
  size_t total = 0;
  for (auto& s : parts) total += s.size();
  out->text = (char*)std::malloc(total ? total : 1);
  {
    char* w = out->text;
    for (auto& s : parts) {
      std::memcpy(w, s.data(), s.size());
      w += s.size();
    }
  }
  out->text_len = (int64_t)total;
  int64_t n_err = 0;
  for (int t = 0; t < fnt; ++t)
    for (int k = 0; k < 16; ++k) {
      out->err_counts[k] += errs[t][k];
      n_err += errs[t][k];
    }
  // n_reads mirrors the Python loop: errored reads tally in err_counts
  // and do not count as processed
  out->n_reads = (int32_t)(keep.size() - (size_t)n_err);
  return 0;
}

// ------------------------------------------- batched confidence sampling
// The threshold-estimation hot loop (thresholds.py sample_reads ->
// group_confidences): decode MANY records in one call and emit only the
// per-call argmax confidences per threshold base — no per-read ctypes
// round trips, no group marshalling. status[i]: 1 = record contributed
// groups (consumes sampling quota), 0 = decode error or no mod info.
int32_t mk_sample_confidences(
    const uint8_t** recs, const int64_t* lens, const uint8_t* only_mapped,
    int32_t n, int32_t has_edge, int64_t edge_start, int64_t edge_end,
    int32_t edge_inverted, const int64_t* collapse_blob,
    int32_t collapse_len, int32_t n_threads, float** out_conf,
    int8_t** out_tb, int32_t** out_rec, int64_t* out_n, uint8_t* status) {
  std::vector<CollapseOp> collapse;
  for (int32_t i = 0; i < collapse_len;) {
    CollapseOp op;
    op.kind = (int)collapse_blob[i++];
    int64_t nc = collapse_blob[i++];
    for (int64_t j = 0; j < nc; ++j) op.codes.push_back(collapse_blob[i++]);
    op.has_to = collapse_blob[i++] != 0;
    op.to_code = collapse_blob[i++];
    collapse.push_back(std::move(op));
  }
  int nt = n_threads > 0 ? n_threads : 1;
  if (nt > n) nt = n > 0 ? n : 1;
  std::vector<std::vector<float>> confs(nt);
  std::vector<std::vector<int8_t>> tbs(nt);
  std::vector<std::vector<int32_t>> recs_of(nt);

  auto one = [&](int t, int32_t ri) {
    status[ri] = 0;
    Rec r;
    r.p = recs[ri];
    r.len = lens[ri];
    r.parse_head();
    std::vector<uint8_t> fwd;
    forward_seq(r, fwd);
    ModInfo info;
    try {
      AuxTags aux = scan_aux(r);
      if (aux.bad) throw MkError{E_INVALID_MM};
      const TagSlot& mm = aux.mm_up.present ? aux.mm_up : aux.mm_lo;
      if (!mm.present) throw MkError{E_MM_MISSING};
      if (mm.wrong_type || mm.z == nullptr) throw MkError{E_INVALID_MM};
      const TagSlot& ml = aux.ml_up.present ? aux.ml_up : aux.ml_lo;
      if (!ml.present) throw MkError{E_ML_MISSING};
      if (ml.wrong_type || ml.b == nullptr) throw MkError{E_INVALID_ML};
      if (aux.mn_present) {
        if (aux.mn_wrong_type) throw MkError{E_INVALID_MN};
        if (aux.mn_value != (int64_t)r.l_seq) throw MkError{E_INVALID_MN};
      } else if (r.is_not_primary()) {
        throw MkError{E_NON_PRIMARY_MN};
      }
      info = decode_read_mods(fwd, mm.z, ml.b, ml.b_n);
    } catch (const MkError&) {
      return;
    }
    std::vector<std::pair<int32_t, int32_t>> runs;
    bool om = only_mapped[ri] != 0;
    if (om) aligned_runs_fwd(r, runs);
    bool any = false;
    bool mutate = has_edge || !collapse.empty();
    for (int strand_pass = 0; strand_pass < 2; ++strand_pass) {
      for (auto& g : info.groups) {
        if (g.mod_strand != strand_pass) continue;
        // common estimation path (no edge filter, no collapse) reads the
        // group's buffers in place — no per-group copies
        std::vector<int32_t>& positions = mutate ? *new std::vector<int32_t>(g.pos) : g.pos;
        std::vector<float>& probs = mutate ? *new std::vector<float>(g.probs) : g.probs;
        std::unique_ptr<std::vector<int32_t>> pos_own(
            mutate ? &positions : nullptr);
        std::unique_ptr<std::vector<float>> probs_own(
            mutate ? &probs : nullptr);
        std::vector<Code> gcodes = g.codes;
        size_t gm = gcodes.size();
        if (has_edge) {
          if ((int64_t)r.l_seq <= edge_start + edge_end) continue;
          int64_t lo = edge_start, hi = (int64_t)r.l_seq - edge_end;
          std::vector<int32_t> np_;
          std::vector<float> npr;
          np_.reserve(positions.size());
          npr.reserve(probs.size());
          for (size_t i = 0; i < positions.size(); ++i) {
            bool inside = positions[i] >= lo && positions[i] < hi;
            bool keepi = edge_inverted ? !inside : inside;
            if (keepi) {
              np_.push_back(positions[i]);
              for (size_t j = 0; j < gm; ++j)
                npr.push_back(probs[i * gm + j]);
            }
          }
          if (np_.empty()) continue;
          positions = std::move(np_);
          probs = std::move(npr);
        }
        for (const auto& op : collapse)
          apply_collapse(gcodes, probs, gm, positions.size(), op);
        // only_mapped: keep aligned positions (two-pointer intersect)
        size_t n_keep = positions.size();
        std::vector<size_t> keep_idx;
        if (om) {
          keep_idx.reserve(positions.size());
          size_t k = 0;
          for (size_t i = 0; i < positions.size(); ++i)
            if (runs_contain(runs, k, positions[i]))
              keep_idx.push_back(i);
          if (keep_idx.empty()) continue;
          n_keep = keep_idx.size();
        }
        int b_idx = base_char_to_idx(g.base);
        int tb = (g.mod_strand == 0) ? b_idx : IDX_COMPL[b_idx];
        for (size_t ki = 0; ki < n_keep; ++ki) {
          size_t i = om ? keep_idx[ki] : ki;
          const float* row = probs.data() + i * gm;
          float live_sum = 0.0f, best = -1.0f;
          bool present = false;
          for (size_t j = 0; j < gm; ++j) {
            float p = row[j];
            if (p < 0.0f) continue;
            live_sum += p;
            if (!present || p > best) best = p;
            present = true;
          }
          float canon = 1.0f - live_sum;
          float conf = (present && best > canon) ? best : canon;
          confs[t].push_back(conf);
          tbs[t].push_back((int8_t)tb);
          recs_of[t].push_back(ri);
        }
        any = true;
      }
    }
    if (any) status[ri] = 1;
  };

  if (nt > 1) {
    std::atomic<int32_t> next{0};
    auto worker = [&](int t) {
      for (;;) {
        int32_t i = next.fetch_add(1);
        if (i >= n) return;
        one(t, i);
      }
    };
    std::vector<std::thread> pool;
    for (int t = 0; t < nt; ++t) pool.emplace_back(worker, t);
    for (auto& th : pool) th.join();
  } else {
    for (int32_t i = 0; i < n; ++i) one(0, i);
  }
  int64_t total = 0;
  for (auto& v : confs) total += (int64_t)v.size();
  *out_conf = (float*)std::malloc(total ? total * 4 : 4);
  *out_tb = (int8_t*)std::malloc(total ? total : 1);
  *out_rec = (int32_t*)std::malloc(total ? total * 4 : 4);
  float* wf = *out_conf;
  int8_t* wt = *out_tb;
  int32_t* wr = *out_rec;
  for (int t = 0; t < nt; ++t) {
    std::memcpy(wf, confs[t].data(), confs[t].size() * 4);
    wf += confs[t].size();
    std::memcpy(wt, tbs[t].data(), tbs[t].size());
    wt += tbs[t].size();
    std::memcpy(wr, recs_of[t].data(), recs_of[t].size() * 4);
    wr += recs_of[t].size();
  }
  *out_n = total;
  return 0;
}

// ------------------------------------------- native region sampling
// The count-quota mapped sampling phase of threshold estimation
// (thresholds.py sample_reads: reader.fetch + batched flush_pending) in
// one native call per merged region: BGZF chunk inflate (parallel, early
// stop past the region end), record walk with the exact fetch semantics,
// quota/dedup accounting in record order, and pooled argmax confidences
// (reads_sampler/mod.rs:30 get_sampled_read_ids_to_base_mod_probs).
//
// seen_blob: '\n'-joined read names already consumed in prior regions;
// out_names returns the names newly consumed here (same framing).
int32_t mk_sample_region(
    const uint8_t* raw, int64_t raw_len, const int64_t* vbeg,
    const int64_t* vend, int32_t n_chunks, int32_t tid, int64_t start,
    int64_t end, int64_t max_take, int32_t only_mapped, int32_t has_edge,
    int64_t edge_start, int64_t edge_end, int32_t edge_inverted,
    const int64_t* collapse_blob, int32_t collapse_len,
    const char* seen_blob, int64_t seen_len, int32_t n_threads,
    float** out_conf, int8_t** out_tb, int64_t* out_n, char** out_names,
    int64_t* out_names_len, int64_t* out_consumed) {
  *out_conf = nullptr;
  *out_tb = nullptr;
  *out_n = 0;
  *out_names = nullptr;
  *out_names_len = 0;
  *out_consumed = 0;
  int nt = n_threads > 0 ? n_threads : 1;

  // quota/dedup state first: inflation is INCREMENTAL and stops as soon
  // as the region's quota is consumed (sampling touches ~quota reads of a
  // region, so inflating its whole chunk span wasted most of the work)
  std::unordered_set<std::string> seen;
  {
    const char* sp = seen_blob;
    const char* se = seen_blob + seen_len;
    while (sp < se) {
      const char* nl = sp;
      while (nl < se && *nl != '\n') ++nl;
      if (nl > sp) seen.emplace(sp, nl - sp);
      sp = nl + 1;
    }
  }
  std::vector<float> conf_out;
  std::vector<int8_t> tb_out;
  std::string names_out;
  int64_t consumed = 0;

  std::vector<CollapseOp> collapse;
  for (int32_t i = 0; i < collapse_len;) {
    CollapseOp op;
    op.kind = (int)collapse_blob[i++];
    int64_t nc = collapse_blob[i++];
    for (int64_t j = 0; j < nc; ++j) op.codes.push_back(collapse_blob[i++]);
    op.has_to = collapse_blob[i++] != 0;
    op.to_code = collapse_blob[i++];
    collapse.push_back(std::move(op));
  }

  std::vector<std::vector<uint8_t>> datas((size_t)n_chunks);
  std::vector<Rec> cands;  // pointers stay valid: buffers reserve upfront
  const size_t B = 256;  // the Python flush batch size
  size_t next_cand = 0;
  std::vector<uint8_t> status(B);
  std::vector<std::vector<float>> bconf(B);
  std::vector<std::vector<int8_t>> btb(B);

  // decode+quota drain over pending candidates: full batches only unless
  // flushing (mirrors the Python flush_pending batching exactly)
  auto drain = [&](bool flush) {
    while ((max_take < 0 || consumed < max_take) &&
           (cands.size() - next_cand >= B ||
            (flush && next_cand < cands.size()))) {
      size_t lo = next_cand;
      size_t hi = std::min(cands.size(), lo + B);
      next_cand = hi;
      size_t nb = hi - lo;
      auto one = [&](size_t bi) {
        const Rec& r = cands[lo + bi];
        status[bi] = 0;
        bconf[bi].clear();
        btb[bi].clear();
        std::vector<uint8_t> fwd;
        forward_seq(r, fwd);
        ModInfo info;
        try {
          AuxTags aux = scan_aux(r);
          if (aux.bad) throw MkError{E_INVALID_MM};
          const TagSlot& mm = aux.mm_up.present ? aux.mm_up : aux.mm_lo;
          if (!mm.present) throw MkError{E_MM_MISSING};
          if (mm.wrong_type || mm.z == nullptr) throw MkError{E_INVALID_MM};
          const TagSlot& ml = aux.ml_up.present ? aux.ml_up : aux.ml_lo;
          if (!ml.present) throw MkError{E_ML_MISSING};
          if (ml.wrong_type || ml.b == nullptr) throw MkError{E_INVALID_ML};
          if (aux.mn_present) {
            if (aux.mn_wrong_type) throw MkError{E_INVALID_MN};
            if (aux.mn_value != (int64_t)r.l_seq)
              throw MkError{E_INVALID_MN};
          } else if (r.is_not_primary()) {
            throw MkError{E_NON_PRIMARY_MN};
          }
          info = decode_read_mods(fwd, mm.z, ml.b, ml.b_n);
        } catch (const MkError&) {
          return;
        }
        std::vector<std::pair<int32_t, int32_t>> runs;
        bool om = only_mapped != 0;
        if (om) aligned_runs_fwd(r, runs);
        bool any = false;
        bool mutate = has_edge || !collapse.empty();
        for (int strand_pass = 0; strand_pass < 2; ++strand_pass) {
          for (auto& g : info.groups) {
            if (g.mod_strand != strand_pass) continue;
            std::vector<int32_t> pos_c;
            std::vector<float> probs_c;
            std::vector<int32_t>& positions =
                mutate ? (pos_c = g.pos, pos_c) : g.pos;
            std::vector<float>& probs =
                mutate ? (probs_c = g.probs, probs_c) : g.probs;
            std::vector<Code> gcodes = g.codes;
            size_t gm = gcodes.size();
            if (has_edge) {
              if ((int64_t)r.l_seq <= edge_start + edge_end) continue;
              int64_t elo = edge_start, ehi = (int64_t)r.l_seq - edge_end;
              std::vector<int32_t> np_;
              std::vector<float> npr;
              for (size_t i = 0; i < positions.size(); ++i) {
                bool inside = positions[i] >= elo && positions[i] < ehi;
                bool keepi = edge_inverted ? !inside : inside;
                if (keepi) {
                  np_.push_back(positions[i]);
                  for (size_t j = 0; j < gm; ++j)
                    npr.push_back(probs[i * gm + j]);
                }
              }
              if (np_.empty()) continue;
              positions = std::move(np_);
              probs = std::move(npr);
            }
            for (const auto& op : collapse)
              apply_collapse(gcodes, probs, gm, positions.size(), op);
            size_t n_keep = positions.size();
            std::vector<size_t> keep_idx;
            if (om) {
              keep_idx.reserve(positions.size());
              size_t k = 0;
              for (size_t i = 0; i < positions.size(); ++i)
                if (runs_contain(runs, k, positions[i]))
                  keep_idx.push_back(i);
              if (keep_idx.empty()) continue;
              n_keep = keep_idx.size();
            }
            int b_idx = base_char_to_idx(g.base);
            int tb = (g.mod_strand == 0) ? b_idx : IDX_COMPL[b_idx];
            for (size_t ki = 0; ki < n_keep; ++ki) {
              size_t i = om ? keep_idx[ki] : ki;
              const float* row = probs.data() + i * gm;
              float live_sum = 0.0f, best = -1.0f;
              bool present = false;
              for (size_t j = 0; j < gm; ++j) {
                float pj = row[j];
                if (pj < 0.0f) continue;
                live_sum += pj;
                if (!present || pj > best) best = pj;
                present = true;
              }
              float canon = 1.0f - live_sum;
              bconf[bi].push_back((present && best > canon) ? best : canon);
              btb[bi].push_back((int8_t)tb);
            }
            any = true;
          }
        }
        if (any) status[bi] = 1;
      };
      if (nt > 1 && nb > 1) {
        std::atomic<size_t> next{0};
        auto worker = [&]() {
          for (;;) {
            size_t i = next.fetch_add(1);
            if (i >= nb) return;
            one(i);
          }
        };
        std::vector<std::thread> pool;
        int tc = std::min<int>(nt, (int)nb);
        for (int t = 0; t < tc; ++t) pool.emplace_back(worker);
        for (auto& th : pool) th.join();
      } else {
        for (size_t i = 0; i < nb; ++i) one(i);
      }
      // serial quota/dedup walk, exactly the Python flush_pending order
      for (size_t bi = 0; bi < nb; ++bi) {
        if (max_take >= 0 && consumed >= max_take) break;
        const Rec& r = cands[lo + bi];
        std::string name((const char*)r.p + 32, (size_t)r.l_read_name - 1);
        if (seen.count(name)) {
          ++consumed;
          continue;
        }
        if (status[bi]) {
          seen.insert(name);
          names_out += name;
          names_out += '\n';
          ++consumed;
          conf_out.insert(conf_out.end(), bconf[bi].begin(),
                          bconf[bi].end());
          tb_out.insert(tb_out.end(), btb[bi].begin(), btb[bi].end());
        }
      }
    }
  };

  // incremental inflate + fetch-semantics candidate walk (io/bam.py:447):
  // stop at the first record past the region OR once quota is consumed
  bool done = false;
  for (int32_t c = 0; c < n_chunks && !done; ++c) {
    if (max_take >= 0 && consumed >= max_take) break;
    int64_t c0 = vbeg[c] >> 16, u0 = vbeg[c] & 0xFFFF;
    int64_t c1 = vend[c] >> 16, u1 = vend[c] & 0xFFFF;
    std::vector<uint8_t>& data = datas[c];
    // pre-walk block headers (cheap, no inflate) to reserve the buffer so
    // incremental appends never reallocate under live Rec pointers
    {
      int64_t off = c0, total = 0;
      while (off < raw_len) {
        if (off > c1 || (off == c1 && u1 == 0)) break;
        int64_t bs, doff, dlen;
        if (!bgzf_block_info(raw, raw_len, off, &bs, &doff, &dlen)) break;
        uint32_t isize;
        std::memcpy(&isize, raw + off + bs - 4, 4);
        total += isize;
        if (off == c1) break;
        off += bs;
      }
      data.reserve((size_t)total);
    }
    int64_t off = c0;
    int64_t scan = u0;
    int64_t chunk_limit = -1;  // set once the c1 block lands (u1 trim)
    bool hit_span_end = false;
    while (off < raw_len && !hit_span_end && !done &&
           (max_take < 0 || consumed < max_take)) {
      struct Blk {
        int64_t doff, dlen, out_off;
        uint32_t isize;
      };
      std::vector<Blk> batch;
      int64_t base = (int64_t)data.size();
      int64_t total = 0;
      while (off < raw_len && (int)batch.size() < nt * 8) {
        if (off > c1 || (off == c1 && u1 == 0)) {
          hit_span_end = true;
          break;
        }
        int64_t bs, doff, dlen;
        if (!bgzf_block_info(raw, raw_len, off, &bs, &doff, &dlen)) {
          hit_span_end = true;
          break;
        }
        uint32_t isize;
        std::memcpy(&isize, raw + off + bs - 4, 4);
        if (off == c1 && u1 > 0) chunk_limit = base + total + (int64_t)u1;
        batch.push_back({doff, dlen, base + total, isize});
        total += isize;
        if (off == c1) {
          off += bs;
          hit_span_end = true;
          break;
        }
        off += bs;
      }
      if (batch.empty()) break;
      data.resize((size_t)(base + total));
      auto do_one = [&](const Blk& b) {
        if (b.isize)
          inflate_block_raw(raw + b.doff, b.dlen, data.data() + b.out_off,
                            b.isize);
      };
      if (nt > 1 && batch.size() > 1) {
        std::atomic<size_t> next{0};
        auto worker = [&]() {
          for (;;) {
            size_t i = next.fetch_add(1);
            if (i >= batch.size()) return;
            do_one(batch[i]);
          }
        };
        std::vector<std::thread> pool;
        int tc = std::min<int>(nt, (int)batch.size());
        for (int t = 0; t < tc; ++t) pool.emplace_back(worker);
        for (auto& th : pool) th.join();
      } else {
        for (auto& b : batch) do_one(b);
      }
      // candidate extraction up to the inflated frontier
      int64_t limit = (int64_t)data.size();
      if (chunk_limit >= 0) limit = std::min(limit, chunk_limit);
      while (scan + 4 <= limit) {
        int32_t bs32;
        std::memcpy(&bs32, data.data() + scan, 4);
        if (bs32 < 32 || scan + 4 + bs32 > limit) break;
        Rec r;
        r.p = data.data() + scan + 4;
        r.len = bs32;
        r.parse_head();
        scan += 4 + bs32;
        if (r.ref_id != tid || (int64_t)r.pos >= end) {
          if (r.ref_id > tid ||
              (r.ref_id == tid && (int64_t)r.pos >= end)) {
            done = true;
            break;
          }
          continue;
        }
        if (r.is_unmapped()) continue;
        if (r.pos + r.reference_span() <= start) continue;
        if (r.is_not_primary()) continue;  // use_record
        cands.push_back(r);
      }
      drain(false);
    }
  }
  drain(true);

  *out_n = (int64_t)conf_out.size();
  *out_conf = (float*)std::malloc(conf_out.size() ? conf_out.size() * 4 : 4);
  std::memcpy(*out_conf, conf_out.data(), conf_out.size() * 4);
  *out_tb = (int8_t*)std::malloc(tb_out.size() ? tb_out.size() : 1);
  std::memcpy(*out_tb, tb_out.data(), tb_out.size());
  *out_names_len = (int64_t)names_out.size();
  *out_names = (char*)std::malloc(names_out.size() ? names_out.size() : 1);
  std::memcpy(*out_names, names_out.data(), names_out.size());
  *out_consumed = consumed;
  return 0;
}

// ----------------------------------------------------- native CRAM decode
// CRAM 3.0 container -> raw BAM records, mirroring io/cram.py SliceDecoder
// byte-for-byte (tests/test_cram.py native-vs-python). Python remains the
// oracle and the fallback for the rare block codecs (bzip2/lzma) and
// multi-reference (-2) containers: rc != 0 routes the container back to
// the Python path.

namespace cram {

struct CCur {
  const uint8_t* d;
  int64_t n, p = 0;
  bool fail = false;
  uint8_t u8() {
    if (p >= n) { fail = true; return 0; }
    return d[p++];
  }
  void skip(int64_t k) { p += k; if (p > n) fail = true; }
  const uint8_t* take(int64_t k) {
    const uint8_t* r = d + p;
    skip(k);
    return r;
  }
  int64_t itf8() {
    uint32_t b0 = u8();
    uint32_t v;
    if (b0 < 0x80) v = b0;
    else if (b0 < 0xC0) v = ((b0 & 0x7F) << 8) | u8();
    else if (b0 < 0xE0) { v = (b0 & 0x3F) << 16; v |= (uint32_t)u8() << 8; v |= u8(); }
    else if (b0 < 0xF0) { v = (b0 & 0x1F) << 24; v |= (uint32_t)u8() << 16; v |= (uint32_t)u8() << 8; v |= u8(); }
    else { v = (uint64_t)(b0 & 0x0F) << 28; v |= (uint32_t)u8() << 20; v |= (uint32_t)u8() << 12; v |= (uint32_t)u8() << 4; v |= u8() & 0x0F; }
    return (int32_t)v;  // ITF8 is a signed 32-bit value
  }
  int64_t ltf8() {
    uint32_t b0 = u8();
    int nb;
    if (b0 < 0x80) return (int64_t)b0;
    else if (b0 < 0xC0) nb = 1;
    else if (b0 < 0xE0) nb = 2;
    else if (b0 < 0xF0) nb = 3;
    else if (b0 < 0xF8) nb = 4;
    else if (b0 < 0xFC) nb = 5;
    else if (b0 < 0xFE) nb = 6;
    else if (b0 < 0xFF) nb = 7;
    else nb = 8;
    static const uint32_t mask[9] = {0xFF, 0x7F, 0x3F, 0x1F, 0x0F, 0x07, 0x03, 0x01, 0x00};
    uint64_t v = b0 & mask[nb];
    for (int i = 0; i < nb; ++i) v = (v << 8) | u8();
    return (int64_t)v;
  }
  std::vector<int64_t> array_itf8() {
    int64_t k = itf8();
    std::vector<int64_t> out;
    if (k < 0 || k > (1 << 24)) { fail = true; return out; }
    out.reserve((size_t)k);
    for (int64_t i = 0; i < k; ++i) out.push_back(itf8());
    return out;
  }
};

// ---- rANS 4x8 (order 0/1), CRAM 3.0 section 13 ----
constexpr uint32_t kRansLow = 1u << 23;

static bool rans_read_freq0(CCur& c, uint32_t* freqs) {
  std::memset(freqs, 0, 256 * 4);
  int sym = c.u8();
  int rle = 0;
  int last_sym = sym;
  for (;;) {
    if (c.fail || sym > 255) return false;
    freqs[sym] = (uint32_t)c.itf8();
    if (rle > 0) {
      rle -= 1;
      sym += 1;
    } else {
      int nxt = c.u8();
      if (c.fail) return false;
      if (nxt == 0) break;
      if (nxt == last_sym + 1) {
        rle = c.u8();
        sym = nxt;
      } else {
        sym = nxt;
      }
    }
    last_sym = sym;
  }
  return !c.fail;
}

static void rans_tables(const uint32_t* freqs, uint32_t* cum, uint8_t* lut) {
  cum[0] = 0;
  for (int s = 0; s < 256; ++s) cum[s + 1] = cum[s] + freqs[s];
  for (int s = 0; s < 256; ++s)
    if (freqs[s])
      for (uint32_t k = cum[s]; k < cum[s + 1] && k < 4096; ++k)
        lut[k] = (uint8_t)s;
}

static bool rans0_decode(CCur& c, int64_t n_out, std::vector<uint8_t>& out) {
  uint32_t freqs[256];
  if (!rans_read_freq0(c, freqs)) return false;
  uint32_t cum[257];
  std::vector<uint8_t> lut(4096, 0);
  rans_tables(freqs, cum, lut.data());
  if (c.p + 16 > c.n) return false;
  uint32_t st[4];
  std::memcpy(st, c.d + c.p, 16);
  int64_t p = c.p + 16;
  out.resize((size_t)n_out);
  for (int64_t i = 0; i < n_out; ++i) {
    int j = (int)(i & 3);
    uint32_t x = st[j];
    uint32_t slot = x & 0xFFF;
    uint8_t s = lut[slot];
    out[(size_t)i] = s;
    x = freqs[s] * (x >> 12) + slot - cum[s];
    while (x < kRansLow && p < c.n) x = (x << 8) | c.d[p++];
    st[j] = x;
  }
  return true;
}

static bool rans1_decode(CCur& c, int64_t n_out, std::vector<uint8_t>& out) {
  // 256 contexts, each an order-0 table
  std::vector<uint32_t> freqs(256 * 256, 0);
  int sym_i = c.u8();
  int rle_i = 0;
  for (;;) {
    if (c.fail || sym_i > 255) return false;
    // inner table for context sym_i
    int sym_j = c.u8();
    int rle_j = 0;
    for (;;) {
      if (c.fail || sym_j > 255) return false;
      freqs[(size_t)sym_i * 256 + sym_j] = (uint32_t)c.itf8();
      if (rle_j > 0) {
        rle_j -= 1;
        sym_j += 1;
      } else {
        int nxt = c.u8();
        if (c.fail) return false;
        if (nxt == 0) break;
        if (nxt == sym_j + 1) rle_j = c.u8();
        sym_j = nxt;
      }
    }
    if (rle_i > 0) {
      rle_i -= 1;
      sym_i += 1;
    } else {
      int nxt = c.u8();
      if (c.fail) return false;
      if (nxt == 0) break;
      if (nxt == sym_i + 1) rle_i = c.u8();
      sym_i = nxt;
    }
  }
  std::vector<uint32_t> cums(256 * 257, 0);
  std::vector<uint8_t> luts(256 * 4096, 0);
  for (int ctx = 0; ctx < 256; ++ctx) {
    const uint32_t* f = &freqs[(size_t)ctx * 256];
    bool any = false;
    for (int s = 0; s < 256; ++s)
      if (f[s]) { any = true; break; }
    uint32_t* cum = &cums[(size_t)ctx * 257];
    cum[0] = 0;
    for (int s = 0; s < 256; ++s) cum[s + 1] = cum[s] + f[s];
    if (!any) continue;
    uint8_t* lut = &luts[(size_t)ctx * 4096];
    for (int s = 0; s < 256; ++s)
      if (f[s])
        for (uint32_t k = cum[s]; k < cum[s + 1] && k < 4096; ++k)
          lut[k] = (uint8_t)s;
  }
  if (c.p + 16 > c.n) return false;
  uint32_t st[4];
  std::memcpy(st, c.d + c.p, 16);
  int64_t p = c.p + 16;
  out.resize((size_t)n_out);
  int64_t isz4 = n_out >> 2;
  int ctx[4] = {0, 0, 0, 0};
  for (int64_t i = 0; i < isz4; ++i) {
    for (int j = 0; j < 4; ++j) {
      int64_t idx = j * isz4 + i;
      uint32_t x = st[j];
      uint32_t slot = x & 0xFFF;
      uint8_t s = luts[(size_t)ctx[j] * 4096 + slot];
      out[(size_t)idx] = s;
      x = freqs[(size_t)ctx[j] * 256 + s] * (x >> 12) + slot -
          cums[(size_t)ctx[j] * 257 + s];
      while (x < kRansLow && p < c.n) x = (x << 8) | c.d[p++];
      st[j] = x;
      ctx[j] = s;
    }
  }
  for (int64_t idx = 4 * isz4; idx < n_out; ++idx) {
    uint32_t x = st[3];
    uint32_t slot = x & 0xFFF;
    uint8_t s = luts[(size_t)ctx[3] * 4096 + slot];
    out[(size_t)idx] = s;
    x = freqs[(size_t)ctx[3] * 256 + s] * (x >> 12) + slot -
        cums[(size_t)ctx[3] * 257 + s];
    while (x < kRansLow && p < c.n) x = (x << 8) | c.d[p++];
    st[3] = x;
    ctx[3] = s;
  }
  return true;
}

static bool rans4x8(const uint8_t* d, int64_t n, std::vector<uint8_t>& out) {
  if (n < 9) return false;
  int order = d[0];
  uint32_t raw_size;
  std::memcpy(&raw_size, d + 5, 4);
  CCur c{d, n};
  c.p = 9;
  if (order == 0) return rans0_decode(c, raw_size, out);
  return rans1_decode(c, raw_size, out);
}

// ---- block reader ----
struct CBlock {
  int content_type = -1;
  int64_t content_id = -1;
  std::vector<uint8_t> data;
};

// rc: 0 ok, -2 unsupported codec (python fallback), -1 corrupt
static int read_cblock(CCur& c, CBlock& b) {
  int method = c.u8();
  b.content_type = c.u8();
  b.content_id = c.itf8();
  int64_t comp_size = c.itf8();
  int64_t raw_size = c.itf8();
  if (c.fail || comp_size < 0 || c.p + comp_size > c.n) return -1;
  const uint8_t* payload = c.take(comp_size);
  c.skip(4);  // CRC
  if (c.fail) return -1;
  if (method == 0) {  // RAW
    b.data.assign(payload, payload + comp_size);
  } else if (method == 1) {  // GZIP
    b.data.resize((size_t)raw_size);
#ifdef MK_HAVE_LIBDEFLATE
    libdeflate_decompressor* dec = thread_codecs.decompressor();
    size_t actual = 0;
    if (dec == nullptr ||
        libdeflate_gzip_decompress(dec, payload, (size_t)comp_size,
                                   b.data.data(), (size_t)raw_size,
                                   &actual) != LIBDEFLATE_SUCCESS ||
        (int64_t)actual != raw_size)
      return -1;
#else
    z_stream zs{};
    if (inflateInit2(&zs, 15 + 16) != Z_OK) return -1;
    zs.next_in = const_cast<Bytef*>(payload);
    zs.avail_in = (uInt)comp_size;
    zs.next_out = b.data.data();
    zs.avail_out = (uInt)raw_size;
    int rc = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    if (rc != Z_STREAM_END) return -1;
#endif
  } else if (method == 4) {  // rANS 4x8
    if (!rans4x8(payload, comp_size, b.data)) return -1;
  } else if (method == 2) {  // bzip2 (via dlopen: no dev package here)
    typedef int (*Bz2Fn)(char*, unsigned int*, char*, unsigned int, int,
                         int);
    static Bz2Fn bz2 = []() -> Bz2Fn {
      void* h = dlopen("libbz2.so.1", RTLD_LAZY);
      if (h == nullptr) h = dlopen("libbz2.so", RTLD_LAZY);
      return h ? (Bz2Fn)dlsym(h, "BZ2_bzBuffToBuffDecompress") : nullptr;
    }();
    if (bz2 == nullptr) return -2;  // python fallback
    b.data.resize((size_t)raw_size);
    unsigned int dlen = (unsigned int)raw_size;
    if (bz2((char*)b.data.data(), &dlen, (char*)payload,
            (unsigned int)comp_size, 0, 0) != 0 ||
        (int64_t)dlen != raw_size)
      return -1;
  } else if (method == 3) {  // lzma (.xz stream, as htslib writes)
#ifdef MK_NO_LZMA
    return -2;
#else
    b.data.resize((size_t)raw_size);
    uint64_t memlimit = UINT64_MAX;
    size_t in_pos = 0, out_pos = 0;
    if (lzma_stream_buffer_decode(&memlimit, 0, nullptr, payload,
                                  &in_pos, (size_t)comp_size,
                                  b.data.data(), &out_pos,
                                  (size_t)raw_size) != LZMA_OK ||
        (int64_t)out_pos != raw_size)
      return -1;
#endif
  } else {
    return -2;  // rans-Nx16 etc: python fallback
  }
  if ((int64_t)b.data.size() != raw_size) return -1;
  return 0;
}

// ---- MSB-first bit reader ----
struct CBits {
  const uint8_t* d = nullptr;
  int64_t n = 0;
  int64_t bit = 0;
  bool fail = false;
  uint32_t read(int k) {
    uint32_t v = 0;
    for (int i = 0; i < k; ++i) {
      int64_t byte = bit >> 3;
      if (byte >= n) { fail = true; return v; }
      v = (v << 1) | ((d[byte] >> (7 - (bit & 7))) & 1);
      ++bit;
    }
    return v;
  }
};

// ---- encodings ----
struct CReader {
  int kind = 0;  // 1 external, 3 huffman, 4 byte_array_len, 5 stop, 6 beta
  CCur* ext = nullptr;       // external / stop share per-content-id cursors
  // huffman
  std::vector<int64_t> alphabet;
  std::vector<std::pair<uint64_t, int64_t>> codes;  // (len<<32|code) -> sym
  // beta
  int64_t offset = 0;
  int length = 0;
  // byte_array_len
  std::unique_ptr<CReader> len_r, val_r;
  // stop
  int stop = 0;
  CBits* core = nullptr;
  bool fail = false;

  int64_t read_int() {
    switch (kind) {
      case 1:
        if (ext == nullptr) { fail = true; return 0; }
        return ext->itf8();
      case 3: {
        if (codes.empty()) return alphabet.empty() ? (fail = true, 0) : alphabet[0];
        uint32_t code = 0;
        for (int L = 1; L <= 31; ++L) {
          code = (code << 1) | core->read(1);
          uint64_t key = ((uint64_t)L << 32) | code;
          for (auto& kv : codes)
            if (kv.first == key) return kv.second;
          if (core->fail) break;
        }
        fail = true;
        return 0;
      }
      case 6: return (int64_t)core->read(length) - offset;
      default: fail = true; return 0;
    }
  }
  int read_byte() {
    if (kind == 1) {
      if (ext == nullptr) { fail = true; return 0; }
      return ext->u8();
    }
    return (int)read_int();
  }
  bool read_bytes(std::vector<uint8_t>& out) {
    out.clear();
    if (kind == 4) {
      if (!len_r || !val_r) return false;
      int64_t k = len_r->read_int();
      if (k < 0 || len_r->fail) return false;
      if (val_r->kind == 1) {
        if (val_r->ext == nullptr) return false;
        if (val_r->ext->p + k > val_r->ext->n) return false;
        const uint8_t* p = val_r->ext->take(k);
        out.assign(p, p + k);
      } else {
        out.reserve((size_t)k);
        for (int64_t i = 0; i < k; ++i) out.push_back((uint8_t)val_r->read_byte());
      }
      return !val_r->fail;
    }
    if (kind == 5) {
      if (ext == nullptr) return false;
      CCur* c = ext;
      int64_t q = c->p;
      while (q < c->n && c->d[q] != stop) ++q;
      if (q >= c->n) return false;
      out.assign(c->d + c->p, c->d + q);
      c->p = q + 1;
      return true;
    }
    return false;
  }
};

struct CEncoding {
  int codec = -1;
  std::vector<uint8_t> params;
};

static bool parse_encoding(CCur& c, CEncoding& e) {
  e.codec = (int)c.itf8();
  int64_t k = c.itf8();
  if (c.fail || k < 0 || c.p + k > c.n) return false;
  const uint8_t* p = c.take(k);
  e.params.assign(p, p + k);
  return true;
}

// instantiate a reader; external cursors resolved via map
static bool make_reader(const CEncoding& e,
                        std::map<int64_t, CCur>& external, CBits* core,
                        CReader& r) {
  CCur p{e.params.data(), (int64_t)e.params.size()};
  r.core = core;
  if (e.codec == 1) {
    r.kind = 1;
    int64_t cid = p.itf8();
    auto it = external.find(cid);
    if (it == external.end()) return false;
    r.ext = &it->second;
    return !p.fail;
  }
  if (e.codec == 3) {
    r.kind = 3;
    r.alphabet = p.array_itf8();
    std::vector<int64_t> lengths = p.array_itf8();
    if (p.fail || lengths.size() != r.alphabet.size()) return false;
    if (r.alphabet.size() <= 1) return true;  // constant
    // canonical assignment ordered by (length, symbol value)
    std::vector<size_t> order(r.alphabet.size());
    for (size_t i = 0; i < order.size(); ++i) order[i] = i;
    std::sort(order.begin(), order.end(), [&](size_t a, size_t b) {
      if (lengths[a] != lengths[b]) return lengths[a] < lengths[b];
      return r.alphabet[a] < r.alphabet[b];
    });
    uint32_t code = 0;
    int64_t prev_len = 0;
    for (size_t i : order) {
      int64_t L = lengths[i];
      code <<= (L - prev_len);
      prev_len = L;
      r.codes.emplace_back(((uint64_t)L << 32) | code, r.alphabet[i]);
      code += 1;
    }
    return true;
  }
  if (e.codec == 4) {
    r.kind = 4;
    CEncoding le, ve;
    if (!parse_encoding(p, le) || !parse_encoding(p, ve)) return false;
    r.len_r = std::make_unique<CReader>();
    r.val_r = std::make_unique<CReader>();
    return make_reader(le, external, core, *r.len_r) &&
           make_reader(ve, external, core, *r.val_r);
  }
  if (e.codec == 5) {
    r.kind = 5;
    r.stop = p.u8();
    int64_t cid = p.itf8();
    auto it = external.find(cid);
    if (it == external.end()) return false;
    r.ext = &it->second;
    return !p.fail;
  }
  if (e.codec == 6) {
    r.kind = 6;
    r.offset = p.itf8();
    r.length = (int)p.itf8();
    return !p.fail;
  }
  return false;
}

// ---- compression header ----
struct CompHdr {
  bool rn_included = true, ap_delta = true, ref_required = true;
  uint8_t sub_matrix[5] = {0, 0, 0, 0, 0};
  // tag dict: lines of (tag2, type) triples
  std::vector<std::vector<std::array<char, 3>>> tag_dict;
  std::map<uint32_t, CEncoding> series;  // key = tag2 chars
  std::map<int64_t, CEncoding> tag_enc;
  char sub_code[5][4];  // [ref base ACGTN][code] -> substituted base

  bool parse(const std::vector<uint8_t>& data) {
    CCur c{data.data(), (int64_t)data.size()};
    tag_dict.push_back({});
    c.itf8();  // size
    int64_t n = c.itf8();
    for (int64_t i = 0; i < n; ++i) {
      if (c.p + 2 > c.n) return false;
      char k0 = (char)c.u8(), k1 = (char)c.u8();
      if (k0 == 'R' && k1 == 'N') rn_included = c.u8() != 0;
      else if (k0 == 'A' && k1 == 'P') ap_delta = c.u8() != 0;
      else if (k0 == 'R' && k1 == 'R') ref_required = c.u8() != 0;
      else if (k0 == 'S' && k1 == 'M') {
        if (c.p + 5 > c.n) return false;
        std::memcpy(sub_matrix, c.take(5), 5);
      } else if (k0 == 'T' && k1 == 'D') {
        int64_t bl = c.itf8();
        if (c.fail || c.p + bl > c.n) return false;
        const uint8_t* blob = c.take(bl);
        tag_dict.clear();
        // '\0'-separated lines; a trailing '\0' does not add a line
        int64_t s = 0;
        for (int64_t q = 0; q <= bl; ++q) {
          if (q == bl && s == q) break;
          if (q == bl || blob[q] == 0) {
            std::vector<std::array<char, 3>> line;
            for (int64_t t = s; t + 2 < q + 1 && t + 2 <= q - 0; t += 3) {
              if (t + 3 > q) break;
              line.push_back({(char)blob[t], (char)blob[t + 1],
                              (char)blob[t + 2]});
            }
            tag_dict.push_back(std::move(line));
            s = q + 1;
            if (q == bl) break;
          }
        }
      } else {
        return false;
      }
    }
    if (c.fail) return false;
    c.itf8();  // size
    n = c.itf8();
    for (int64_t i = 0; i < n; ++i) {
      if (c.p + 2 > c.n) return false;
      uint32_t key = ((uint32_t)c.u8() << 8) | c.u8();
      CEncoding e;
      if (!parse_encoding(c, e)) return false;
      series[key] = std::move(e);
    }
    c.itf8();  // size
    n = c.itf8();
    for (int64_t i = 0; i < n; ++i) {
      int64_t key = c.itf8();
      CEncoding e;
      if (!parse_encoding(c, e)) return false;
      tag_enc[key] = std::move(e);
    }
    if (c.fail) return false;
    // substitution matrix: per ref base, 2-bit codes for the other 4
    // bases in alphabetical order, highest bits first
    const char* bases = "ACGTN";
    for (int r_i = 0; r_i < 5; ++r_i) {
      char others[4];
      int oi = 0;
      for (int b = 0; b < 5; ++b)
        if (b != r_i) others[oi++] = bases[b];
      uint8_t byte = sub_matrix[r_i];
      for (int j = 0; j < 4; ++j)
        sub_code[r_i][(byte >> (6 - 2 * j)) & 3] = others[j];
    }
    return true;
  }
};

static int base5(char b) {
  switch (b) {
    case 'A': return 0; case 'C': return 1; case 'G': return 2;
    case 'T': return 3; default: return 4;
  }
}

// BAM reg2bin
static int reg2bin_c(int64_t beg, int64_t end) {
  --end;
  if (beg >> 14 == end >> 14) return (int)(((1 << 15) - 1) / 7 + (beg >> 14));
  if (beg >> 17 == end >> 17) return (int)(((1 << 12) - 1) / 7 + (beg >> 17));
  if (beg >> 20 == end >> 20) return (int)(((1 << 9) - 1) / 7 + (beg >> 20));
  if (beg >> 23 == end >> 23) return (int)(((1 << 6) - 1) / 7 + (beg >> 23));
  if (beg >> 26 == end >> 26) return (int)(((1 << 3) - 1) / 7 + (beg >> 26));
  return 0;
}

struct DecRec {
  std::vector<uint8_t> name;
  int64_t flag = 0, ref_id = -1, pos = -1, mapq = 0;
  std::vector<std::pair<int, int64_t>> cigar;  // (op, len)
  int64_t mate_ref = -1, mate_pos = -1, tlen = 0;
  std::vector<uint8_t> seq, quals, aux;
  int64_t nf = -1;
};

static int64_t ref_len_of(const std::vector<std::pair<int, int64_t>>& cig) {
  int64_t s = 0;
  for (auto& c : cig)
    if (c.first == 0 || c.first == 2 || c.first == 3 || c.first == 7 ||
        c.first == 8)
      s += c.second;
  return s;
}

}  // namespace cram

namespace cram {

struct NibTab {
  int8_t v[256];
  NibTab() {
    for (int i = 0; i < 256; ++i) v[i] = 15;
    const char* order = "=ACMGRSVTWYHKDBN";
    for (int i = 0; i < 16; ++i) v[(uint8_t)order[i]] = (int8_t)i;
  }
};
static const NibTab NIB;

static void encode_bam(const DecRec& f, std::string& out) {
  int64_t l_seq = (int64_t)f.seq.size();
  int64_t rec_start = (int64_t)out.size();
  out.append(4, '\0');
  int64_t end = f.pos;
  for (auto& c : f.cigar)
    if (c.first == 0 || c.first == 2 || c.first == 3 || c.first == 7 ||
        c.first == 8)
      end += c.second;
  if (end < f.pos + 1) end = f.pos + 1;
  int32_t i32;
  uint16_t u16;
  i32 = (int32_t)f.ref_id; out.append((char*)&i32, 4);
  i32 = (int32_t)f.pos; out.append((char*)&i32, 4);
  out.push_back((char)(uint8_t)(f.name.size() + 1));
  out.push_back((char)(uint8_t)f.mapq);
  u16 = (uint16_t)reg2bin_c(f.pos, end); out.append((char*)&u16, 2);
  u16 = (uint16_t)f.cigar.size(); out.append((char*)&u16, 2);
  u16 = (uint16_t)f.flag; out.append((char*)&u16, 2);
  i32 = (int32_t)l_seq; out.append((char*)&i32, 4);
  i32 = (int32_t)f.mate_ref; out.append((char*)&i32, 4);
  i32 = (int32_t)f.mate_pos; out.append((char*)&i32, 4);
  i32 = (int32_t)f.tlen; out.append((char*)&i32, 4);
  out.append((const char*)f.name.data(), f.name.size());
  out.push_back('\0');
  for (auto& c : f.cigar) {
    uint32_t v = ((uint32_t)c.second << 4) | (uint32_t)c.first;
    out.append((char*)&v, 4);
  }
  // 4-bit packed sequence
  size_t nib_start = out.size();
  out.append((size_t)((l_seq + 1) / 2), '\0');
  for (int64_t i = 0; i < l_seq; ++i) {
    uint8_t code = (uint8_t)NIB.v[f.seq[(size_t)i]];
    char& slot = out[nib_start + (size_t)(i >> 1)];
    if (i & 1) slot = (char)((uint8_t)slot | code);
    else slot = (char)(code << 4);
  }
  if ((int64_t)f.quals.size() == l_seq)
    out.append((const char*)f.quals.data(), f.quals.size());
  else
    out.append((size_t)l_seq, '\xff');
  out.append((const char*)f.aux.data(), f.aux.size());
  int32_t rec_len = (int32_t)(out.size() - rec_start - 4);
  std::memcpy(&out[(size_t)rec_start], &rec_len, 4);
}

}  // namespace cram

// Decode ONE CRAM container (at `off` in the file bytes) into a blob of
// <i32 len><raw BAM record> items. `ref`/`ref_len` is the container's
// reference sequence (uppercased by the caller), or NULL when absent.
// rg_blob: '\n'-joined read-group IDs. rc: 0 ok; 1 python-fallback
// (unsupported codec/layout); 2 corrupt.
typedef const char* (*MkRefCb)(int32_t tid, int64_t* len);

int32_t mk_cram_decode_container(
    const uint8_t* data, int64_t data_len, int64_t off, const char* ref,
    int64_t ref_len, const char* rg_blob, int64_t rg_blob_len,
    MkRefCb ref_cb,
    uint8_t** out_blob, int64_t* out_blob_len, int32_t* out_n) {
  using namespace cram;
  *out_blob = nullptr;
  *out_blob_len = 0;
  *out_n = 0;
  std::vector<std::string> rg_ids;
  {
    int64_t s = 0;
    for (int64_t q = 0; q <= rg_blob_len; ++q) {
      if (q == rg_blob_len || rg_blob[q] == '\n') {
        if (q > s) rg_ids.emplace_back(rg_blob + s, rg_blob + q);
        s = q + 1;
      }
    }
  }
  CCur c{data, data_len};
  c.p = off;
  if (c.p + 4 > c.n) return 2;
  int32_t length;
  std::memcpy(&length, data + c.p, 4);
  c.p += 4;
  int64_t cont_ref = c.itf8();
  c.itf8();  // start
  c.itf8();  // span
  int64_t nrec = c.itf8();
  c.ltf8();  // record counter
  c.ltf8();  // bases
  int64_t nblocks = c.itf8();
  c.array_itf8();  // landmarks
  c.skip(4);       // crc
  if (c.fail) return 2;
  if (nrec == 0) return 0;
  // multi-reference containers decode natively when a ref callback is
  // provided (per-record RI series resolves the reference lazily)
  if (cont_ref == -2 && ref_cb == nullptr) return 1;
  std::vector<CBlock> blocks((size_t)nblocks);
  for (int64_t i = 0; i < nblocks; ++i) {
    int rc = read_cblock(c, blocks[(size_t)i]);
    if (rc == -2) return 1;
    if (rc != 0) return 2;
  }
  CompHdr comp;
  if (blocks.empty() || !comp.parse(blocks[0].data)) return 2;

  std::string out;
  int32_t n_out = 0;

  // slice loop: slice header blocks are content type 2
  size_t bi = 1;
  while (bi < blocks.size()) {
    if (blocks[bi].content_type != 2) {
      ++bi;
      continue;
    }
    // ---- slice header ----
    CCur sh{blocks[bi].data.data(), (int64_t)blocks[bi].data.size()};
    int64_t s_ref = sh.itf8();
    int64_t s_start = sh.itf8();
    sh.itf8();  // span
    int64_t s_nrec = sh.itf8();
    sh.ltf8();  // record counter
    int64_t s_nblocks = sh.itf8();
    sh.array_itf8();  // content ids
    int64_t embedded_ref_id = sh.itf8();
    if (sh.fail) return 2;
    if (s_ref == -2 && ref_cb == nullptr) return 1;

    CBits core;
    std::map<int64_t, CCur> external;
    const uint8_t* sref = (const uint8_t*)ref;
    int64_t sref_len = ref_len;
    int64_t ref_offset = 0;
    for (size_t k = bi + 1; k < blocks.size() && k <= bi + (size_t)s_nblocks;
         ++k) {
      CBlock& b = blocks[k];
      if (b.content_type == 5) {  // core
        core.d = b.data.data();
        core.n = (int64_t)b.data.size();
      } else if (b.content_type == 4) {  // external
        external.emplace(
            b.content_id,
            CCur{b.data.data(), (int64_t)b.data.size()});
        if (embedded_ref_id >= 0 && b.content_id == embedded_ref_id) {
          sref = b.data.data();
          sref_len = (int64_t)b.data.size();
          ref_offset = s_start - 1;
        }
      }
    }
    if (sref == (const uint8_t*)ref && !(s_ref >= 0 && comp.ref_required))
      if (embedded_ref_id < 0 && s_ref < 0) { sref = nullptr; sref_len = 0; }
    if (s_ref >= 0 && comp.ref_required && sref == nullptr) {
      // single-reference slice inside a multi-ref (-2) container: the
      // caller passed no container-level ref — resolve via the callback
      // rather than silently decoding against 'N's
      if (ref_cb == nullptr) return 1;
      int64_t L = 0;
      const char* pr = ref_cb((int32_t)s_ref, &L);
      if (pr == nullptr) return 1;
      sref = (const uint8_t*)pr;
      sref_len = L;
      ref_offset = 0;
    }

    auto ref_base = [&](int64_t rpos0) -> char {
      int64_t i = rpos0 - ref_offset;
      if (sref != nullptr && i >= 0 && i < sref_len) {
        char ch = (char)sref[i];
        if (ch >= 'a' && ch <= 'z') ch -= 32;
        return ch;
      }
      return 'N';
    };

    // per-series readers, created lazily
    std::map<uint32_t, CReader> readers;
    std::map<int64_t, CReader> tag_readers;
    bool rfail = false;
    auto R = [&](const char* key2) -> CReader& {
      uint32_t key = ((uint32_t)(uint8_t)key2[0] << 8) | (uint8_t)key2[1];
      auto it = readers.find(key);
      if (it != readers.end()) return it->second;
      CReader& r = readers[key];
      auto se = comp.series.find(key);
      if (se == comp.series.end() ||
          !make_reader(se->second, external, &core, r))
        rfail = true;
      return r;
    };
    auto TR = [&](int64_t key) -> CReader& {
      auto it = tag_readers.find(key);
      if (it != tag_readers.end()) return it->second;
      CReader& r = tag_readers[key];
      auto te = comp.tag_enc.find(key);
      if (te == comp.tag_enc.end() ||
          !make_reader(te->second, external, &core, r))
        rfail = true;
      return r;
    };

    std::vector<DecRec> frecs;
    frecs.reserve((size_t)s_nrec);
    int64_t last_pos = s_start - 1;
    int64_t cur_rid = INT64_MIN;
    std::vector<uint8_t> tmp;
    for (int64_t ri = 0; ri < s_nrec; ++ri) {
      DecRec f;
      int64_t bf = R("BF").read_int();
      int64_t cf = R("CF").read_int();
      int64_t rid = (s_ref == -2) ? R("RI").read_int() : s_ref;
      if (s_ref == -2 && rid != cur_rid) {
        // multi-ref slice: resolve this record's reference lazily
        // (RR=0 files store sequences verbatim -> no lookup, matching
        // the slice-level reference_required guard)
        cur_rid = rid;
        sref = nullptr;
        sref_len = 0;
        ref_offset = 0;
        if (rid >= 0 && comp.ref_required) {
          int64_t L = 0;
          const char* pr = ref_cb((int32_t)rid, &L);
          if (pr == nullptr) return 1;  // ref unavailable: python path
          sref = (const uint8_t*)pr;
          sref_len = L;
        }
      }
      int64_t rl = R("RL").read_int();
      int64_t ap = R("AP").read_int();
      int64_t pos0;
      if (comp.ap_delta) {
        pos0 = last_pos + ap;
        last_pos = pos0;
      } else {
        pos0 = ap - 1;
      }
      int64_t rg = R("RG").read_int();
      if (comp.rn_included) {
        if (!R("RN").read_bytes(f.name)) rfail = true;
      }
      int64_t mate_ref = -1, mate_pos = -1, tlen = 0;
      if (cf & 0x2) {  // detached
        int64_t mf = R("MF").read_int();
        if (!comp.rn_included)
          if (!R("RN").read_bytes(f.name)) rfail = true;
        mate_ref = R("NS").read_int();
        mate_pos = R("NP").read_int() - 1;
        tlen = R("TS").read_int();
        if (mf & 1) bf |= 0x20;
        if (mf & 2) bf |= 0x8;
      } else if (cf & 0x4) {
        f.nf = R("NF").read_int();
      }
      int64_t tl = R("TL").read_int();
      if (rfail || tl < 0 || tl >= (int64_t)comp.tag_dict.size()) return 1;
      for (auto& td : comp.tag_dict[(size_t)tl]) {
        int64_t key = ((int64_t)(uint8_t)td[0] << 16) |
                      ((int64_t)(uint8_t)td[1] << 8) | (uint8_t)td[2];
        if (!TR(key).read_bytes(tmp)) rfail = true;
        f.aux.push_back((uint8_t)td[0]);
        f.aux.push_back((uint8_t)td[1]);
        f.aux.push_back((uint8_t)td[2]);
        f.aux.insert(f.aux.end(), tmp.begin(), tmp.end());
      }
      if (rg >= 0 && rg < (int64_t)rg_ids.size()) {
        const std::string& rgid = rg_ids[(size_t)rg];
        f.aux.push_back('R');
        f.aux.push_back('G');
        f.aux.push_back('Z');
        f.aux.insert(f.aux.end(), rgid.begin(), rgid.end());
        f.aux.push_back(0);
      }
      f.quals.assign((size_t)rl, 0xFF);
      int64_t mq = 0;
      if (!(bf & 4)) {  // mapped
        f.seq.assign((size_t)rl, 0);
        int64_t fn = R("FN").read_int();
        int64_t qpos = 0, rpos = pos0, fpos = 0;
        auto emit = [&](int op, int64_t len) {
          if (len <= 0) return;
          if (!f.cigar.empty() && f.cigar.back().first == op)
            f.cigar.back().second += len;
          else
            f.cigar.emplace_back(op, len);
        };
        auto advance_match = [&](int64_t n) {
          if (n <= 0) return;
          for (int64_t k = 0; k < n; ++k)
            f.seq[(size_t)(qpos + k)] = (uint8_t)ref_base(rpos + k);
          emit(0, n);
          qpos += n;
          rpos += n;
        };
        for (int64_t fi = 0; fi < fn && !rfail; ++fi) {
          int fc = R("FC").read_byte();
          fpos += R("FP").read_int();
          advance_match(fpos - 1 - qpos);
          if (qpos < 0 || qpos > rl) return 2;
          switch (fc) {
            case 'B':
              if (qpos >= rl) return 2;
              f.seq[(size_t)qpos] = (uint8_t)R("BA").read_byte();
              f.quals[(size_t)qpos] = (uint8_t)R("QS").read_byte();
              emit(0, 1);
              ++qpos;
              ++rpos;
              break;
            case 'X': {
              if (qpos >= rl) return 2;
              int64_t code = R("BS").read_int();
              f.seq[(size_t)qpos] = (uint8_t)
                  comp.sub_code[base5(ref_base(rpos))][code & 3];
              emit(0, 1);
              ++qpos;
              ++rpos;
              break;
            }
            case 'I': {
              if (!R("IN").read_bytes(tmp)) { rfail = true; break; }
              if (qpos + (int64_t)tmp.size() > rl) return 2;
              std::copy(tmp.begin(), tmp.end(), f.seq.begin() + qpos);
              emit(1, (int64_t)tmp.size());
              qpos += (int64_t)tmp.size();
              break;
            }
            case 'i':
              if (qpos >= rl) return 2;
              f.seq[(size_t)qpos] = (uint8_t)R("BA").read_byte();
              emit(1, 1);
              ++qpos;
              break;
            case 'S': {
              if (!R("SC").read_bytes(tmp)) { rfail = true; break; }
              if (qpos + (int64_t)tmp.size() > rl) return 2;
              std::copy(tmp.begin(), tmp.end(), f.seq.begin() + qpos);
              emit(4, (int64_t)tmp.size());
              qpos += (int64_t)tmp.size();
              break;
            }
            case 'D':
              { int64_t dl = R("DL").read_int(); emit(2, dl); rpos += dl; }
              break;
            case 'N':
              { int64_t rs = R("RS").read_int(); emit(3, rs); rpos += rs; }
              break;
            case 'P': emit(6, R("PD").read_int()); break;
            case 'H': emit(5, R("HC").read_int()); break;
            case 'Q':
              if (qpos >= rl) return 2;
              f.quals[(size_t)qpos] = (uint8_t)R("QS").read_byte();
              break;
            case 'b': {
              if (!R("BB").read_bytes(tmp)) { rfail = true; break; }
              if (qpos + (int64_t)tmp.size() > rl) return 2;
              std::copy(tmp.begin(), tmp.end(), f.seq.begin() + qpos);
              emit(0, (int64_t)tmp.size());
              qpos += (int64_t)tmp.size();
              rpos += (int64_t)tmp.size();
              break;
            }
            case 'q': {
              if (!R("QQ").read_bytes(tmp)) { rfail = true; break; }
              if (qpos + (int64_t)tmp.size() > rl) return 2;
              std::copy(tmp.begin(), tmp.end(), f.quals.begin() + qpos);
              break;
            }
            default:
              return 1;  // unknown feature: python fallback
          }
        }
        if (rfail) return 1;
        advance_match(rl - qpos);
        if (f.cigar.empty() && rl > 0) f.cigar.emplace_back(0, rl);
        // regenerate NM/MD when derivable and not stored
        bool has_nm = false, has_md = false;
        for (auto& td : comp.tag_dict[(size_t)tl]) {
          if (td[0] == 'N' && td[1] == 'M') has_nm = true;
          if (td[0] == 'M' && td[1] == 'D') has_md = true;
        }
        if (sref != nullptr && !(has_nm && has_md)) {
          std::string md;
          int64_t nm = 0, match_run = 0, q2 = 0, r2 = pos0;
          char buf[24];
          for (auto& cg : f.cigar) {
            int op = cg.first;
            int64_t ln = cg.second;
            if (op == 0 || op == 7 || op == 8) {
              for (int64_t k = 0; k < ln; ++k) {
                char rb = ref_base(r2 + k);
                if ((char)f.seq[(size_t)(q2 + k)] == rb) {
                  ++match_run;
                } else {
                  char* e = put_u_ex(buf, match_run);
                  md.append(buf, e - buf);
                  md.push_back(rb);
                  match_run = 0;
                  ++nm;
                }
              }
              q2 += ln;
              r2 += ln;
            } else if (op == 1) {
              nm += ln;
              q2 += ln;
            } else if (op == 4) {
              q2 += ln;
            } else if (op == 2) {
              char* e = put_u_ex(buf, match_run);
              md.append(buf, e - buf);
              match_run = 0;
              md.push_back('^');
              for (int64_t k = 0; k < ln; ++k) md.push_back(ref_base(r2 + k));
              nm += ln;
              r2 += ln;
            } else if (op == 3) {
              r2 += ln;
            }
          }
          char* e = put_u_ex(buf, match_run);
          md.append(buf, e - buf);
          if (!has_nm) {
            if (nm < 256) {
              f.aux.push_back('N'); f.aux.push_back('M');
              f.aux.push_back('C'); f.aux.push_back((uint8_t)nm);
            } else if (nm < 65536) {
              uint16_t v = (uint16_t)nm;
              f.aux.push_back('N'); f.aux.push_back('M');
              f.aux.push_back('S');
              f.aux.insert(f.aux.end(), (uint8_t*)&v, (uint8_t*)&v + 2);
            } else {
              uint32_t v = (uint32_t)nm;
              f.aux.push_back('N'); f.aux.push_back('M');
              f.aux.push_back('I');
              f.aux.insert(f.aux.end(), (uint8_t*)&v, (uint8_t*)&v + 4);
            }
          }
          if (!has_md) {
            f.aux.push_back('M'); f.aux.push_back('D');
            f.aux.push_back('Z');
            f.aux.insert(f.aux.end(), md.begin(), md.end());
            f.aux.push_back(0);
          }
        }
        mq = R("MQ").read_int();
        if (cf & 0x1) {
          CReader& q = R("QS");
          for (int64_t k = 0; k < rl; ++k)
            f.quals[(size_t)k] = (uint8_t)q.read_byte();
        }
      } else {  // unmapped
        mq = 0;
        CReader& ba = R("BA");
        f.seq.resize((size_t)rl);
        for (int64_t k = 0; k < rl; ++k)
          f.seq[(size_t)k] = (uint8_t)ba.read_byte();
        if (cf & 0x1) {
          CReader& q = R("QS");
          for (int64_t k = 0; k < rl; ++k)
            f.quals[(size_t)k] = (uint8_t)q.read_byte();
        }
        if (s_ref == -1) pos0 = -1;
      }
      if (rfail || core.fail) return 1;
      f.flag = bf;
      f.ref_id = rid;
      f.pos = pos0;
      f.mapq = (bf & 4) ? 0 : mq;
      f.mate_ref = mate_ref;
      f.mate_pos = mate_pos;
      f.tlen = tlen;
      frecs.push_back(std::move(f));
    }

    // resolve downstream mates (CF bit 0x4)
    for (size_t i = 0; i < frecs.size(); ++i) {
      DecRec& f = frecs[i];
      if (f.nf < 0) continue;
      size_t j = i + (size_t)f.nf + 1;
      if (j >= frecs.size()) return 2;
      DecRec& m = frecs[j];
      f.mate_ref = m.ref_id;
      f.mate_pos = m.pos;
      m.mate_ref = f.ref_id;
      m.mate_pos = f.pos;
      if (m.flag & 0x10) f.flag |= 0x20;
      if (f.flag & 0x10) m.flag |= 0x20;
      if (m.flag & 0x4) f.flag |= 0x8;
      if (f.flag & 0x4) m.flag |= 0x8;
      int64_t lo = std::min(f.pos, m.pos);
      int64_t hi = std::max(f.pos + ref_len_of(f.cigar),
                            m.pos + ref_len_of(m.cigar));
      if (f.pos <= m.pos) {
        f.tlen = hi - lo;
        m.tlen = lo - hi;
      } else {
        f.tlen = lo - hi;
        m.tlen = hi - lo;
      }
    }
    for (auto& f : frecs) {
      encode_bam(f, out);
      ++n_out;
    }
    bi += 1 + (size_t)s_nblocks;
  }
  (void)cont_ref;
  *out_blob = (uint8_t*)std::malloc(out.size() ? out.size() : 1);
  std::memcpy(*out_blob, out.data(), out.size());
  *out_blob_len = (int64_t)out.size();
  *out_n = n_out;
  return 0;
}


// staged decode micro-bench (perf tooling is absent in this image):
// stage 0 = scan_aux, 1 = +forward_seq, 2 = +parse_mm_tag,
// 3 = +decode_read_mods, 4 = +decode_read (full event assembly over
// the read's whole span).
// Returns reads/s single-threaded.
double mk_bench_decode(const uint8_t* rec_buf, int64_t rec_len,
                       int32_t reps, int32_t stage) {
  Rec r;
  r.p = rec_buf;
  r.len = rec_len;
  r.parse_head();
  auto t0 = std::chrono::steady_clock::now();
  volatile int64_t sink = 0;
  for (int32_t i = 0; i < reps; ++i) {
    AuxTags aux = scan_aux(r);
    sink += aux.mn_value;
    if (stage < 1) continue;
    std::vector<uint8_t> fwd;
    forward_seq(r, fwd);
    sink += fwd.size();
    if (stage < 2) continue;
    const TagSlot& mm = aux.mm_up.present ? aux.mm_up : aux.mm_lo;
    if (!mm.present || mm.z == nullptr) return -1.0;
    if (stage == 2) {
      try {
        auto tags = parse_mm_tag(mm.z);
        sink += (int64_t)tags.size();
      } catch (const MkError&) { return -1.0; }
      continue;
    }
    const TagSlot& ml = aux.ml_up.present ? aux.ml_up : aux.ml_lo;
    if (!ml.present || ml.b == nullptr) return -1.0;
    if (stage == 3) {
      try {
        ModInfo info = decode_read_mods(fwd, mm.z, ml.b, ml.b_n);
        sink += (int64_t)info.groups.size();
      } catch (const MkError&) { return -1.0; }
      continue;
    }
    DecodeOpts opts;
    TileWalk w;
    w.reset_window(r.pos, r.pos + r.reference_span());
    std::vector<int32_t> nc((size_t)(w.end - w.start) * 8, 0);
    std::vector<int32_t> del((size_t)(w.end - w.start) * 2, 0);
    w.nc = nc.data();
    w.del = del.data();
    ReadEvents ev = decode_read(r, opts, w, 0);
    sink += ev.mod_rpos.size() + w.n_nc;
  }
  auto t1 = std::chrono::steady_clock::now();
  double dt = std::chrono::duration<double>(t1 - t0).count();
  (void)sink;
  return reps / dt;
}

// direct test hook for the float formatter (tests/test_native_extract.py
// fuzzes it against writers.format_float)
void mk_format_f32(float v, char* out64) {
  std::string s = format_f32_rust(v);
  size_t n = s.size() < 63 ? s.size() : 63;
  std::memcpy(out64, s.data(), n);
  out64[n] = '\0';
}

void mk_free_extract(MkExtractOut* out) {
  std::free(out->text);
  std::free(out->carry);
  out->text = nullptr;
  out->carry = nullptr;
}

// ----------------------------------------------- native modBAM rewriters
// The adjust-mods / call-mods / update-tags hot loop (engines/adjust.py
// adjust_record_tags, reference src/adjust.rs:115 adjust_mod_probs +
// src/mod_bam.rs:1299 format_mm_ml_tag): decode -> transform (edge filter
// -> collapse/convert -> threshold call -> motif keep/discard -> mode
// change) -> re-encode MM/ML -> rebuild the record with the new tags.
// Spans of the compressed input stream process block-parallel like
// mk_extract_span; the rewritten records return as one length-prefixed
// blob that Python streams through its parallel BGZF writer.

struct SeqMotifC {
  int64_t offset;
  std::vector<uint8_t> masks;  // 4-bit base class per motif position
};

struct AdjustOpts {
  bool has_edge = false;
  int64_t edge_start = 0, edge_end = 0;
  bool edge_inverted = false;
  std::vector<CollapseOp> collapse;
  int caller_mode = 0;  // 0 none, 1 filter-only, 2 hard calls
  std::vector<std::pair<Code, float>> per_mod;
  float fallback_mod[4] = {0, 0, 0, 0};
  float can_thr[4] = {0, 0, 0, 0};
  bool has_motifs = false;
  std::vector<SeqMotifC> motifs;
  bool discard_motifs = false;
  int new_mode = -1;  // MODE_* or -1 = keep
  bool drop_implicit = false;
  bool force_mm_upper = false;  // force "MM"/"ML" output tags

  float mod_thr(Code c, int base_idx) const {
    for (auto& kv : per_mod)
      if (kv.first == c) return kv.second;
    return fallback_mod[base_idx];
  }
};

// Copy every aux item except MM/Mm/ML/Ml, preserving order (the Python
// BamRecord.with_replaced_aux walk, io/bam.py:286).
static bool copy_aux_except_mods(const Rec& r, std::string& out) {
  const uint8_t* buf = r.p;
  int64_t p = r.aux_off(), end = r.len;
  while (p + 3 <= end) {
    int64_t item = p;
    char t0 = (char)buf[p], t1 = (char)buf[p + 1];
    char typ = (char)buf[p + 2];
    p += 3;
    switch (typ) {
      case 'A': case 'c': case 'C': p += 1; break;
      case 's': case 'S': p += 2; break;
      case 'i': case 'I': case 'f': p += 4; break;
      case 'Z': case 'H': {
        while (p < end && buf[p] != 0) ++p;
        if (p >= end) return false;
        ++p;
        break;
      }
      case 'B': {
        if (p + 5 > end) return false;
        char sub = (char)buf[p];
        uint32_t n;
        std::memcpy(&n, buf + p + 1, 4);
        int isz = aux_b_itemsize(sub);
        if (isz < 0) return false;
        p += 5 + (int64_t)n * isz;
        break;
      }
      default:
        return false;
    }
    if (p > end) return false;
    bool is_mod = t0 == 'M' && (t1 == 'M' || t1 == 'm' || t1 == 'L' || t1 == 'l');
    if (!is_mod) out.append((const char*)(buf + item), p - item);
  }
  return true;
}

// prob -> ML byte (modtags.py:191 prob_to_qual; mod_bam.rs:798)
static inline uint8_t prob_to_qual_c(float p) {
  if (p == 1.0f) return 255;
  float q = std::floor(p * 256.0f);
  if (q < 0.0f) return 0;
  if (q > 255.0f) return 255;
  return (uint8_t)q;
}

// Rewrite one record's MM/ML; appends <i32 len><record bytes> to out.
// Throws MkError for records the reference drops (adjust.rs:239-258).
static void adjust_one_record(const Rec& r, const AdjustOpts& o,
                              std::string& out) {
  AuxTags at = scan_aux(r);
  if (at.bad) throw MkError{E_INVALID_MM};
  const TagSlot* mm = at.mm_up.present ? &at.mm_up : &at.mm_lo;
  bool mm_upper = at.mm_up.present;
  if (!mm->present) throw MkError{E_MM_MISSING};
  if (!mm->z) throw MkError{E_INVALID_MM};
  const TagSlot* ml = at.ml_up.present ? &at.ml_up : &at.ml_lo;
  bool ml_upper = at.ml_up.present;
  if (!ml->present) throw MkError{E_ML_MISSING};
  if (ml->b_n < 0) throw MkError{E_INVALID_ML};
  if (at.mn_present) {
    if (at.mn_wrong_type || at.mn_value != (int64_t)r.l_seq)
      throw MkError{E_INVALID_MN};
  } else if (r.is_not_primary()) {
    throw MkError{E_NON_PRIMARY_MN};
  }

  std::vector<uint8_t> fwd;
  forward_seq(r, fwd);
  ModInfo info = decode_read_mods(fwd, mm->z, ml->b, ml->b_n);

  // basecall-space motif positions (adjust.py SequenceMotifs: forward
  // pattern over the instrument-orientation sequence + offset)
  std::vector<int32_t> motif_pos;
  if (o.has_motifs) {
    for (auto& sm : o.motifs) {
      int64_t L = (int64_t)sm.masks.size();
      for (int64_t s = 0; s + L <= (int64_t)fwd.size(); ++s) {
        bool ok = true;
        for (int64_t j = 0; j < L; ++j) {
          int bi = T.base_lut[fwd[s + j]];
          if (bi < 0 || !((sm.masks[j] >> bi) & 1)) {
            ok = false;
            break;
          }
        }
        if (ok) motif_pos.push_back((int32_t)(s + sm.offset));
      }
    }
    std::sort(motif_pos.begin(), motif_pos.end());
    motif_pos.erase(std::unique(motif_pos.begin(), motif_pos.end()),
                    motif_pos.end());
  }

  // per-base occurrence cache for delta re-encoding
  std::vector<int32_t> occ_cache[4];
  bool occ_done[4] = {false, false, false, false};
  auto base_occ = [&](char b) -> const std::vector<int32_t>& {
    int s = base_idx_of(b);
    if (!occ_done[s]) {
      auto& v = occ_cache[s];
      v.reserve(fwd.size() / 3);
      for (size_t i = 0; i < fwd.size(); ++i)
        if ((char)fwd[i] == b) v.push_back((int32_t)i);
      occ_done[s] = true;
    }
    return occ_cache[s];
  };

  std::string mm_out;
  std::vector<uint8_t> ml_out;

  // iter_groups order: positive mod-strand groups then negative, each in
  // first-seen key order (modtags.py:259)
  for (int strand = 0; strand < 2; ++strand) {
    for (auto& g0 : info.groups) {
      if (g0.mod_strand != strand) continue;
      std::vector<int32_t> pos = g0.pos;
      std::vector<Code> codes = g0.codes;
      std::vector<float> probs = g0.probs;
      std::vector<uint8_t> inferred = g0.inferred;
      int mode = g0.mode;
      size_t m = codes.size();
      size_t n = pos.size();

      auto filter_rows = [&](const std::vector<uint8_t>& keep) {
        size_t w = 0;
        for (size_t i = 0; i < n; ++i) {
          if (!keep[i]) continue;
          if (w != i) {
            pos[w] = pos[i];
            inferred[w] = inferred[i];
            for (size_t j = 0; j < m; ++j) probs[w * m + j] = probs[i * m + j];
          }
          ++w;
        }
        n = w;
        pos.resize(n);
        inferred.resize(n);
        probs.resize(n * m);
      };

      if (o.has_edge) {
        // mod_bam.rs:1635 EdgeFilter; whole group skipped when the read
        // is too short to trim (adjust.py:78-86)
        if ((int64_t)r.l_seq <= o.edge_start + o.edge_end) continue;
        std::vector<uint8_t> keep(n);
        bool any = false;
        int64_t lo = o.edge_start, hi = (int64_t)r.l_seq - o.edge_end;
        for (size_t i = 0; i < n; ++i) {
          bool inside = pos[i] >= lo && pos[i] < hi;
          keep[i] = (o.edge_inverted ? !inside : inside) ? 1 : 0;
          any |= keep[i] != 0;
        }
        if (!any) continue;
        filter_rows(keep);
        mode = MODE_EXPLICIT;  // mod_bam.rs:1097 edge filter forces '?'
      }

      for (auto& op : o.collapse) apply_collapse(codes, probs, m, n, op);

      if (o.caller_mode) {
        int bidx = base_idx_of(g0.base);
        std::vector<float> thr(m);
        for (size_t j = 0; j < m; ++j) thr[j] = o.mod_thr(codes[j], bidx);
        float cth = o.can_thr[bidx];
        std::vector<uint8_t> keep(n);
        for (size_t i = 0; i < n; ++i) {
          float* row = m ? &probs[i * m] : nullptr;
          float live = 0.0f;
          for (size_t j = 0; j < m; ++j)
            live += (row[j] >= 0.0f) ? row[j] : 0.0f;
          float canon = 1.0f - live;
          float best = -std::numeric_limits<float>::infinity();
          int64_t rev = -1;
          bool any_mod = false;
          for (size_t j = 0; j < m; ++j) {
            float p = row[j];
            if (p >= 0.0f && p >= thr[j]) {
              any_mod = true;
              if (p >= best) {  // later code wins ties (adjust.py:102 rev)
                best = p;
                rev = (int64_t)j;
              }
            }
          }
          bool pass_can = canon >= cth;
          bool choose_can = pass_can && (!any_mod || canon >= best);
          bool filtered = !(choose_can || any_mod);
          keep[i] = filtered ? 0 : 1;
          if (keep[i] && o.caller_mode == 2) {
            // hard calls: winner -> 1.0, others present -> 0.0
            for (size_t j = 0; j < m; ++j)
              row[j] = (row[j] >= 0.0f) ? 0.0f : -1.0f;
            if (!choose_can) row[rev] = 1.0f;
          }
        }
        filter_rows(keep);
        mode = MODE_EXPLICIT;  // threshold_mod_caller.rs:121 forces '?'
      }

      if (o.has_motifs) {
        std::vector<uint8_t> keep(n);
        for (size_t i = 0; i < n; ++i) {
          bool hit = std::binary_search(motif_pos.begin(), motif_pos.end(),
                                        pos[i]);
          keep[i] = (o.discard_motifs ? !hit : hit) ? 1 : 0;
        }
        filter_rows(keep);
        mode = MODE_EXPLICIT;  // adjust.rs:110 forces '?'
      }

      if (o.new_mode >= 0) {
        if (o.drop_implicit && o.new_mode == MODE_EXPLICIT) {
          std::vector<uint8_t> keep(n);
          for (size_t i = 0; i < n; ++i) keep[i] = inferred[i] ? 0 : 1;
          filter_rows(keep);
          mode = MODE_EXPLICIT;
        } else {
          mode = o.new_mode;
        }
      }

      // ---- format_mm_ml (modtags.py:478; mod_bam.rs:1299) ----
      const auto& bp = base_occ(g0.base);
      const char* mode_label =
          mode == MODE_EXPLICIT ? "?" : (mode == MODE_IMPLICIT ? "." : "");
      bool implicit = mode_is_implicit(mode);
      char strand_ch = strand == 0 ? '+' : '-';
      std::vector<size_t> order(m);
      for (size_t j = 0; j < m; ++j) order[j] = j;
      std::stable_sort(order.begin(), order.end(), [&](size_t a, size_t b) {
        return code_less(codes[a], codes[b]);
      });
      bool any_entry = false;
      char tmp[24];
      for (size_t oi = 0; oi < m; ++oi) {
        size_t col = order[oi];
        bool any_present = false;
        for (size_t i = 0; i < n; ++i)
          if (probs[i * m + col] >= 0.0f) {
            any_present = true;
            break;
          }
        if (!any_present) continue;  // code absent everywhere: no sub-tag
        any_entry = true;
        mm_out += g0.base;
        mm_out += strand_ch;
        char* q = put_code_ex(tmp, codes[col]);
        mm_out.append(tmp, q - tmp);
        mm_out += mode_label;
        // written = present & ~(inferred & implicit); delta-encode via a
        // forward walk over the base occurrence list
        size_t k = 0;
        int64_t prev_occ = -1;
        bool wrote = false;
        for (size_t i = 0; i < n; ++i) {
          if (probs[i * m + col] < 0.0f) continue;
          if (implicit && inferred[i]) continue;
          while (k < bp.size() && bp[k] < pos[i]) ++k;
          // pos[i] is always an occurrence of the base
          mm_out += ',';
          q = put_u_ex(tmp, (int64_t)k - prev_occ - 1);
          mm_out.append(tmp, q - tmp);
          prev_occ = (int64_t)k;
          ml_out.push_back(prob_to_qual_c(probs[i * m + col]));
          wrote = true;
        }
        (void)wrote;
        mm_out += ';';
      }
      if (!any_entry) {
        // no codes at all: "any mod" char for the base (mod_bam.rs:1332)
        mm_out += g0.base;
        mm_out += strand_ch;
        mm_out += g0.base;  // any_mod_code(base) == the base char
        mm_out += mode_label;
        mm_out += ';';
      }
    }
  }

  // ---- rebuild the record with replaced MM/ML aux ----
  size_t rec_start = out.size();
  out.append(4, '\0');  // length prefix patched below
  out.append((const char*)r.p, r.aux_off());
  if (!copy_aux_except_mods(r, out)) throw MkError{E_INVALID_MM};
  bool out_upper = o.force_mm_upper || mm_upper;
  out += 'M';
  out += out_upper ? 'M' : 'm';
  out += 'Z';
  out += mm_out;
  out += '\0';
  out += 'M';
  out += (out_upper || ml_upper) ? 'L' : 'l';
  out += 'B';
  out += 'C';
  uint32_t nml = (uint32_t)ml_out.size();
  out.append((const char*)&nml, 4);
  out.append((const char*)ml_out.data(), ml_out.size());
  int32_t rec_len = (int32_t)(out.size() - rec_start - 4);
  std::memcpy(&out[rec_start], &rec_len, 4);
}

struct MkAdjustOut {
  uint8_t* blob;
  int64_t blob_len;
  uint8_t* carry;
  int64_t carry_len;
  int64_t next_off;
  int32_t n_written;
  int32_t eof;
  int64_t err_counts[16];
};

// Rewrite one span of the compressed BAM stream (mk_extract_span framing:
// start_off at a BGZF boundary, carry = partial record tail).
int32_t mk_adjust_span(
    const uint8_t* raw, int64_t raw_len, int64_t start_off, int64_t max_comp,
    const uint8_t* carry, int64_t carry_len, int32_t parse_header,
    int32_t has_edge, int64_t edge_start, int64_t edge_end,
    int32_t edge_inverted, const int64_t* collapse_blob, int32_t collapse_len,
    int32_t caller_mode, const int64_t* pm_codes, const float* pm_vals,
    int32_t n_pm, const float* fallback_mod4, const float* can_thr4,
    const int64_t* motif_blob, int32_t motif_len, int32_t discard_motifs,
    int32_t new_mode, int32_t drop_implicit, int32_t force_mm_upper,
    int32_t compress_level, int32_t n_threads, MkAdjustOut* out) {
  std::memset(out, 0, sizeof(MkAdjustOut));
  AdjustOpts opts;
  opts.has_edge = has_edge != 0;
  opts.edge_start = edge_start;
  opts.edge_end = edge_end;
  opts.edge_inverted = edge_inverted != 0;
  for (int32_t i = 0; i < collapse_len;) {
    CollapseOp op;
    op.kind = (int)collapse_blob[i++];
    int64_t nc = collapse_blob[i++];
    for (int64_t j = 0; j < nc; ++j) op.codes.push_back(collapse_blob[i++]);
    op.has_to = collapse_blob[i++] != 0;
    op.to_code = collapse_blob[i++];
    opts.collapse.push_back(std::move(op));
  }
  opts.caller_mode = caller_mode;
  if (caller_mode) {
    for (int32_t i = 0; i < n_pm; ++i)
      opts.per_mod.emplace_back(pm_codes[i], pm_vals[i]);
    for (int b = 0; b < 4; ++b) {
      opts.fallback_mod[b] = fallback_mod4[b];
      opts.can_thr[b] = can_thr4[b];
    }
  }
  // motif blob: [n_motifs, (offset, len, mask0..maskLen-1)...]
  if (motif_len > 0) {
    opts.has_motifs = true;
    int32_t i = 0;
    int64_t nm = motif_blob[i++];
    for (int64_t mi = 0; mi < nm; ++mi) {
      SeqMotifC sm;
      sm.offset = motif_blob[i++];
      int64_t L = motif_blob[i++];
      for (int64_t j = 0; j < L; ++j)
        sm.masks.push_back((uint8_t)motif_blob[i++]);
      opts.motifs.push_back(std::move(sm));
    }
    opts.discard_motifs = discard_motifs != 0;
  }
  opts.new_mode = new_mode;
  opts.drop_implicit = drop_implicit != 0;
  opts.force_mm_upper = force_mm_upper != 0;

  // 1) walk blocks for this span
  struct Blk {
    int64_t data_off, data_len, isize;
  };
  std::vector<Blk> blks;
  int64_t off = start_off, comp_used = 0, total_isize = 0;
  while (off < raw_len && comp_used < max_comp) {
    int64_t bs, doff, dlen;
    if (!bgzf_block_info(raw, raw_len, off, &bs, &doff, &dlen)) break;
    uint32_t isize;
    std::memcpy(&isize, raw + off + bs - 4, 4);
    blks.push_back({doff, dlen, (int64_t)isize});
    total_isize += isize;
    comp_used += bs;
    off += bs;
  }
  out->next_off = off;
  out->eof = off >= raw_len ? 1 : 0;

  // 2) inflate in parallel
  std::vector<uint8_t> data(carry_len + total_isize);
  if (carry_len) std::memcpy(data.data(), carry, carry_len);
  std::vector<int64_t> dst_off(blks.size());
  {
    int64_t c = carry_len;
    for (size_t i = 0; i < blks.size(); ++i) {
      dst_off[i] = c;
      c += blks[i].isize;
    }
  }
  int nt = n_threads > 0 ? n_threads : 1;
  std::atomic<size_t> next{0};
  std::atomic<bool> infl_ok{true};
  auto inflate_worker = [&]() {
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= blks.size()) return;
      if (blks[i].isize == 0) continue;
      if (!inflate_block_raw(raw + blks[i].data_off, blks[i].data_len,
                             data.data() + dst_off[i], blks[i].isize))
        infl_ok.store(false);
    }
  };
  if (nt > 1 && blks.size() > 1) {
    std::vector<std::thread> pool;
    for (int t = 0; t < nt; ++t) pool.emplace_back(inflate_worker);
    for (auto& th : pool) th.join();
  } else {
    inflate_worker();
  }
  if (!infl_ok.load()) return 2;

  // 3) optionally skip the BAM header (first span)
  int64_t p = 0, dlen_total = (int64_t)data.size();
  if (parse_header) {
    if (dlen_total < 12 || std::memcmp(data.data(), "BAM\1", 4) != 0)
      return 3;
    int32_t l_text;
    std::memcpy(&l_text, data.data() + 4, 4);
    p = 8 + l_text;
    if (p + 4 > dlen_total) return 3;
    int32_t n_ref;
    std::memcpy(&n_ref, data.data() + p, 4);
    p += 4;
    for (int32_t i = 0; i < n_ref; ++i) {
      if (p + 4 > dlen_total) return 3;
      int32_t l_name;
      std::memcpy(&l_name, data.data() + p, 4);
      p += 4 + l_name + 4;
    }
    if (p > dlen_total) return 3;
  }

  // 4) collect complete records; the tail becomes carry-out
  std::vector<Rec> recs;
  int64_t tail_start = p;
  while (p + 4 <= dlen_total) {
    int32_t bs;
    std::memcpy(&bs, data.data() + p, 4);
    if (bs < 32 || p + 4 + bs > dlen_total) break;
    Rec r;
    r.p = data.data() + p + 4;
    r.len = bs;
    r.parse_head();
    recs.push_back(r);
    p += 4 + bs;
    tail_start = p;
  }
  out->carry_len = dlen_total - tail_start;
  if (out->carry_len) {
    out->carry = (uint8_t*)std::malloc(out->carry_len);
    std::memcpy(out->carry, data.data() + tail_start, out->carry_len);
  }

  // 5) rewrite, records sharded contiguously across threads so the
  // concatenated parts keep input order
  int fnt = (nt > 1 && recs.size() > 1) ? nt : 1;
  std::vector<std::string> parts(fnt);
  std::vector<std::array<int64_t, 16>> errs(fnt);
  std::vector<int32_t> wrote(fnt, 0);
  for (auto& a : errs) a.fill(0);
  auto rw_worker = [&](int t) {
    size_t lo = recs.size() * t / fnt, hi = recs.size() * (t + 1) / fnt;
    for (size_t i = lo; i < hi; ++i) {
      try {
        adjust_one_record(recs[i], opts, parts[t]);
        ++wrote[t];
      } catch (const MkError& e) {
        if (e.kind >= 0 && e.kind < 16) ++errs[t][e.kind];
      }
    }
  };
  if (fnt > 1) {
    std::vector<std::thread> pool;
    for (int t = 0; t < fnt; ++t) pool.emplace_back(rw_worker, t);
    for (auto& th : pool) th.join();
  } else {
    rw_worker(0);
  }
  size_t total = 0;
  for (auto& s : parts) total += s.size();
  if (compress_level < 0) {
    out->blob = (uint8_t*)std::malloc(total ? total : 1);
    uint8_t* w = out->blob;
    for (auto& s : parts) {
      std::memcpy(w, s.data(), s.size());
      w += s.size();
    }
    out->blob_len = (int64_t)total;
  } else {
    // 6) BGZF-compress the rewritten record stream in parallel 0xFF00
    // chunks (the htslib/gzp multi-threaded writer analog); the caller
    // appends the blocks verbatim after its header block
    std::vector<uint8_t> flat(total);
    {
      uint8_t* w = flat.data();
      for (auto& s : parts) {
        std::memcpy(w, s.data(), s.size());
        w += s.size();
      }
    }
    size_t nchunk = (total + 0xFEFF) / 0xFF00;
    std::vector<size_t> bsizes(nchunk, 0);
    std::vector<uint8_t> cbuf(nchunk * 0x10000);
    std::atomic<size_t> cnext{0};
    std::atomic<bool> c_ok{true};
    auto c_worker = [&]() {
      for (;;) {
        size_t i = cnext.fetch_add(1);
        if (i >= nchunk) return;
        size_t lo = i * 0xFF00;
        size_t len = std::min<size_t>(0xFF00, total - lo);
        size_t bs = bgzf_compress_block(flat.data() + lo, len,
                                        cbuf.data() + i * 0x10000,
                                        compress_level);
        if (bs == 0) c_ok.store(false);
        bsizes[i] = bs;
      }
    };
    if (nt > 1 && nchunk > 1) {
      std::vector<std::thread> pool;
      for (int t = 0; t < nt; ++t) pool.emplace_back(c_worker);
      for (auto& th : pool) th.join();
    } else {
      c_worker();
    }
    if (!c_ok.load()) return 4;
    size_t ctotal = 0;
    for (size_t b : bsizes) ctotal += b;
    out->blob = (uint8_t*)std::malloc(ctotal ? ctotal : 1);
    uint8_t* w = out->blob;
    for (size_t i = 0; i < nchunk; ++i) {
      std::memcpy(w, cbuf.data() + i * 0x10000, bsizes[i]);
      w += bsizes[i];
    }
    out->blob_len = (int64_t)ctotal;
  }
  for (int t = 0; t < fnt; ++t) {
    out->n_written += wrote[t];
    for (int k = 0; k < 16; ++k) out->err_counts[k] += errs[t][k];
  }
  return 0;
}

// Python writers' block-compression hook (io/bgzf.py): one BGZF block
// from <= 0xFF00 bytes. Returns block size, 0 on failure. ctypes releases
// the GIL during the call, so pooled Python threads scale.
int64_t mk_compress_block(const uint8_t* src, int64_t n, uint8_t* dst,
                          int32_t level) {
  if (n < 0 || n > 0xFF00) return 0;
  return (int64_t)bgzf_compress_block(src, (size_t)n, dst, level);
}

void mk_free_adjust(MkAdjustOut* out) {
  std::free(out->blob);
  std::free(out->carry);
  out->blob = nullptr;
  out->carry = nullptr;
}

// ---------------------------------------------------------------------------
// Methylation entropy math (engines/entropy.py calc_me_entropy; reference
// src/entropy/methylation_entropy.rs:16-199). One window's epiallele
// strings -> mean Shannon entropy, f32 accumulation orders identical to
// the reference's scalar fold: counts add in sequence order; total and
// shannon sums visit patterns in first-hit insertion order (ties by
// sorted-pattern index). log2f matches Rust's f32::log2 (libm).
// ---------------------------------------------------------------------------
static float me_entropy_core(const std::vector<std::string>& seqs,
                             int32_t w, float constant) {
  const int32_t n_seqs = (int32_t)seqs.size();
  if (n_seqs <= 0 || w <= 0) return 0.0f;
  bool any_wild = false;
  for (const auto& s : seqs)
    if (s.find('*') != std::string::npos) {
      any_wild = true;
      break;
    }
  float shannon = 0.0f;
  if (!any_wild) {
    // no wildcards: each sequence matches exactly itself; counts keyed
    // by first occurrence
    std::vector<std::string> order;
    std::unordered_map<std::string, float> counts;
    for (const auto& s : seqs) {
      auto it = counts.find(s);
      if (it == counts.end()) {
        counts.emplace(s, 1.0f);
        order.push_back(s);
      } else {
        it->second += 1.0f;
      }
    }
    float total = 0.0f;
    for (const auto& k : order) total += counts[k];
    for (const auto& k : order) {
      float p = counts[k] / total;
      shannon += p * log2f(p);
    }
  } else {
    // per-column alphabets of observed (non-'*') characters, sorted
    // (AlphabetInfo::from_sequences)
    std::vector<std::string> cols(w);
    for (int32_t c = 0; c < w; ++c) {
      bool seen[256] = {false};
      for (const auto& s : seqs) {
        unsigned char ch = (unsigned char)s[c];
        if (ch != '*') seen[ch] = true;
      }
      for (int ch = 0; ch < 256; ++ch)
        if (seen[ch]) cols[c].push_back((char)ch);
    }
    // DP expansion of wildcard-consistent patterns (all_patterns_dp)
    std::set<std::string> uniq_set(seqs.begin(), seqs.end());
    std::vector<std::string> uniq(uniq_set.begin(), uniq_set.end());
    auto matches = [](const std::string& seq, const std::string& pat,
                      size_t n) {
      for (size_t i = 0; i < n; ++i)
        if (seq[i] != '*' && seq[i] != pat[i]) return false;
      return true;
    };
    std::set<std::string> acc;
    for (char ch : cols[0]) acc.emplace(1, ch);
    for (int32_t idx = 1; idx < w; ++idx) {
      std::set<std::string> nxt;
      for (const auto& seq : uniq) {
        for (const auto& pat : acc) {
          if (!matches(seq, pat, (size_t)idx)) continue;
          char last = seq[idx];
          if (last == '*') {
            for (char x : cols[idx]) nxt.insert(pat + x);
          } else {
            nxt.insert(pat + last);
          }
        }
      }
      acc.swap(nxt);
    }
    std::vector<std::string> patterns(acc.begin(), acc.end());
    const int np = (int)patterns.size();
    // fractional counting: each sequence splits 1.0 evenly over the
    // patterns it matches (f32 divide), added in sequence order
    std::vector<float> counts(np, 0.0f);
    std::vector<int32_t> first_seq(np, -1);
    std::vector<int> hit;
    hit.reserve(np);
    for (int32_t i = 0; i < n_seqs; ++i) {
      hit.clear();
      for (int p = 0; p < np; ++p)
        if (matches(seqs[i], patterns[p], (size_t)w)) hit.push_back(p);
      if (hit.empty()) continue;  // cannot happen: own pattern matches
      float factor = 1.0f / (float)hit.size();
      for (int p : hit) {
        counts[p] += factor;
        if (first_seq[p] < 0) first_seq[p] = i;
      }
    }
    // visit order: first matching sequence, then pattern index
    std::vector<int> order;
    order.reserve(np);
    for (int p = 0; p < np; ++p)
      if (first_seq[p] >= 0) order.push_back(p);
    std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
      return first_seq[a] < first_seq[b];
    });
    float total = 0.0f;
    for (int p : order) total += counts[p];
    for (int p : order) {
      float pp = counts[p] / total;
      shannon += pp * log2f(pp);
    }
  }
  float me = constant * (-shannon);
  if (me == 0.0f) return 0.0f;  // normalize -0.0
  return me;
}

float mk_me_entropy(const char* blob, int32_t n_seqs, int32_t w,
                    float constant) {
  std::vector<std::string> seqs;
  seqs.reserve(n_seqs > 0 ? n_seqs : 0);
  for (int32_t i = 0; i < n_seqs; ++i)
    seqs.emplace_back(blob + (size_t)i * w, (size_t)w);
  return me_entropy_core(seqs, w, constant);
}

// ---------------------------------------------------------------------------
// Entropy window-batch engine (engines/entropy.py process_batch; reference
// entropy/mod.rs:1483-1621 process_bam_fp + add_read_to_patterns). One
// handle per window batch: mk_entropy_add streams each input BAM's BGZF
// chunks through decode -> per-position threshold calls -> pattern
// assembly; mk_entropy_finish computes per-window entropies
// (methylation_entropy.rs semantics via me_entropy_core).
// ---------------------------------------------------------------------------

static const int64_t EP_CANON = INT64_MIN;      // canonical call sentinel
static const int64_t EP_FILT = INT64_MIN + 1;   // filtered call sentinel

struct EpCallerCfg {
  // lookup chain resolved host-side: explicit per-mod first, else the
  // per-base fallback (per_mod[any_mod_code] -> per_base -> default)
  double can_thr[4];
  double mod_fallback[4];
  std::vector<std::pair<Code, double>> per_mod;

  double mod_thr(Code c, int bidx) const {
    for (auto& kv : per_mod)
      if (kv.first == c) return kv.second;
    return mod_fallback[bidx];
  }
};

struct EpWindow {
  // pattern keys: (base char, genome pos), index-aligned with coverage.
  // stranded: plus=pos_positions, minus=neg_positions; combine:
  // plus=pos-side keys (sorted by pos), minus=neg keys in value-pos order
  std::vector<std::pair<char, int64_t>> plus_keys, minus_keys;
  int64_t gate_plus[2] = {-1, -1}, gate_minus[2] = {-1, -1};
  bool plus_present = false, minus_present = false;
  std::vector<std::vector<int64_t>> plus_patterns, minus_patterns;
  std::vector<int32_t> plus_cov, minus_cov;
};

struct EpBatch {
  int32_t n_windows = 0, N = 0, max_filtered = 0;
  bool combine = false;
  bool route_all = false;  // reference scan shape: every read offered to
                           // every window (entropy/mod.rs:1604 par_iter)
  EpCallerCfg cfg;
  std::vector<EpWindow> wins;
  std::vector<int32_t> route;   // window index sorted by leftmost
  std::vector<int64_t> lefts;   // sorted leftmost values
};

// scalar MultipleThresholdModCaller::call (caller.py ThresholdCaller.call):
// f64 threshold comparisons (np.float32 cmp python-float promotes)
static int64_t ep_scalar_call(
    const EpCallerCfg& cfg, int bidx,
    const std::vector<std::pair<Code, float>>& probs) {
  bool has_best = false;
  double best_p = 0.0;
  Code best_code = 0;
  for (auto& kv : probs) {
    double p = (double)kv.second;
    if (p >= cfg.mod_thr(kv.first, bidx)) {
      if (!has_best || p >= best_p) {
        has_best = true;
        best_p = p;
        best_code = kv.first;
      }
    }
  }
  float sum = 0.0f;
  for (auto& kv : probs) sum += kv.second;
  float canon = 1.0f - sum;
  bool canonical = false;
  if ((double)canon >= cfg.can_thr[bidx]) {
    if (!has_best || (double)canon >= best_p) {
      canonical = true;
      has_best = true;
    }
  }
  if (!has_best) return EP_FILT;
  if (canonical) return EP_CANON;
  return best_code;
}

static void ep_add_read(EpBatch* b, EpWindow& w, bool read_plus,
                        const std::unordered_map<int64_t, int64_t>& calls,
                        int64_t ref_start, int64_t ref_end) {
  if (ref_start < 0 || ref_end <= ref_start) return;
  const int64_t* gate;
  const std::vector<std::pair<char, int64_t>>* keys;
  if (b->combine) {
    gate = w.gate_plus;
    keys = read_plus ? &w.plus_keys : &w.minus_keys;
  } else if (read_plus) {
    if (!w.plus_present) return;
    gate = w.gate_plus;
    keys = &w.plus_keys;
  } else {
    if (!w.minus_present) return;
    gate = w.gate_minus;
    keys = &w.minus_keys;
  }
  if (gate[0] < 0) return;
  if (!(ref_start <= gate[0] && ref_end >= gate[1])) return;
  const int n = (int)keys->size();
  std::vector<int64_t> pattern(n, EP_FILT);
  int n_filt = 0;
  for (int i = 0; i < n; ++i) {
    const auto& bp = (*keys)[i];
    int64_t key = (bp.second << 2) | (int64_t)base_idx_of(bp.first);
    auto it = calls.find(key);
    if (it != calls.end()) pattern[i] = it->second;
    if (pattern[i] == EP_FILT) ++n_filt;
  }
  if (n_filt > b->max_filtered) return;
  bool to_plus = b->combine || read_plus;
  auto& cov = to_plus ? w.plus_cov : w.minus_cov;
  for (int i = 0; i < n; ++i)
    if (pattern[i] != EP_FILT) ++cov[i];
  (to_plus ? w.plus_patterns : w.minus_patterns).push_back(
      std::move(pattern));
}

void* mk_entropy_new(
    int32_t n_windows, int32_t num_positions, int32_t combine,
    int32_t max_filtered, int32_t route_all,
    const int8_t* plus_base, const int64_t* plus_pos,
    const int8_t* minus_base, const int64_t* minus_pos,
    const int32_t* plus_present, const int32_t* minus_present,
    const int64_t* gates,  // [n_windows*4] +start,+end,-start,-end (-1 absent)
    const double* can_thr4, const double* mod_fallback4,
    const int64_t* pm_codes, const double* pm_thrs, int32_t n_pm) {
  EpBatch* b = new EpBatch();
  b->n_windows = n_windows;
  b->N = num_positions;
  b->combine = combine != 0;
  b->max_filtered = max_filtered;
  b->route_all = route_all != 0;
  for (int i = 0; i < 4; ++i) {
    b->cfg.can_thr[i] = can_thr4[i];
    b->cfg.mod_fallback[i] = mod_fallback4[i];
  }
  for (int32_t i = 0; i < n_pm; ++i)
    b->cfg.per_mod.emplace_back((Code)pm_codes[i], pm_thrs[i]);
  b->wins.resize((size_t)n_windows);
  const int N = num_positions;
  std::vector<std::pair<int64_t, int32_t>> order;
  order.reserve(n_windows);
  for (int32_t wi = 0; wi < n_windows; ++wi) {
    EpWindow& w = b->wins[wi];
    w.plus_present = plus_present[wi] != 0;
    w.minus_present = minus_present[wi] != 0;
    if (w.plus_present) {
      w.plus_keys.reserve(N);
      for (int i = 0; i < N; ++i)
        w.plus_keys.emplace_back((char)plus_base[(size_t)wi * N + i],
                                 plus_pos[(size_t)wi * N + i]);
    }
    if (w.minus_present) {
      w.minus_keys.reserve(N);
      for (int i = 0; i < N; ++i)
        w.minus_keys.emplace_back((char)minus_base[(size_t)wi * N + i],
                                  minus_pos[(size_t)wi * N + i]);
    }
    w.gate_plus[0] = gates[(size_t)wi * 4 + 0];
    w.gate_plus[1] = gates[(size_t)wi * 4 + 1];
    w.gate_minus[0] = gates[(size_t)wi * 4 + 2];
    w.gate_minus[1] = gates[(size_t)wi * 4 + 3];
    if (b->combine || w.plus_present) w.plus_cov.assign(N, 0);
    if (!b->combine && w.minus_present) w.minus_cov.assign(N, 0);
    int64_t leftmost = INT64_MAX;
    if (w.gate_plus[0] >= 0) leftmost = std::min(leftmost, w.gate_plus[0]);
    if (w.gate_minus[0] >= 0) leftmost = std::min(leftmost, w.gate_minus[0]);
    order.emplace_back(leftmost, wi);
  }
  std::stable_sort(order.begin(), order.end(),
                   [](const auto& a, const auto& b2) {
                     return a.first < b2.first;
                   });
  for (auto& kv : order) {
    b->lefts.push_back(kv.first);
    b->route.push_back(kv.second);
  }
  return b;
}

int32_t mk_entropy_add(void* handle, const uint8_t* raw, int64_t raw_len,
                       const int64_t* vbeg, const int64_t* vend,
                       int32_t n_chunks, int32_t tid, int64_t lo,
                       int64_t hi, int32_t n_threads) {
  EpBatch* b = static_cast<EpBatch*>(handle);
  int nt = n_threads > 0 ? n_threads : 1;
  std::vector<std::vector<uint8_t>> datas;
  std::vector<const uint8_t*> ptrs;
  std::vector<int64_t> lens;
  inflate_voffset_chunks(raw, raw_len, vbeg, vend, n_chunks, tid, hi, nt,
                         datas, ptrs, lens);
  std::vector<uint8_t> fwd;
  std::vector<int32_t> qf, rp;
  std::vector<int32_t> refmap;
  std::unordered_map<int64_t, int64_t> calls;
  bool done = false;
  for (int32_t c = 0; c < n_chunks && !done; ++c) {
    const uint8_t* data = ptrs[c];
    int64_t len = lens[c];
    int64_t off = 0;
    while (off + 4 <= len && !done) {
      int32_t bs;
      std::memcpy(&bs, data + off, 4);
      if (bs < 32 || off + 4 + bs > len) break;
      Rec r;
      r.p = data + off + 4;
      r.len = bs;
      off += 4 + bs;
      r.parse_head();
      if (r.ref_id != tid) {
        if (r.ref_id > tid) done = true;
        continue;
      }
      if ((int64_t)r.pos >= hi) {
        done = true;
        break;
      }
      if (r.is_unmapped() || r.is_not_primary() || r.l_seq == 0) continue;
      int64_t ref_start = r.pos;
      int64_t ref_end = ref_start + r.reference_span();
      if (ref_end <= lo) continue;
      // routing: windows whose leftmost lies in [ref_start, ref_end]
      // (route_all = the reference's shape: no routing, every window)
      auto first = b->route_all
                       ? b->lefts.begin()
                       : std::lower_bound(b->lefts.begin(), b->lefts.end(),
                                          ref_start);
      auto last = b->route_all
                      ? b->lefts.end()
                      : std::upper_bound(b->lefts.begin(), b->lefts.end(),
                                         ref_end);
      if (first == last) continue;
      // decode (read_mod_calls: any failure -> skip silently)
      ModInfo info;
      try {
        AuxTags aux = scan_aux(r);
        if (aux.bad) throw MkError{E_INVALID_MM};
        const TagSlot& mm = aux.mm_up.present ? aux.mm_up : aux.mm_lo;
        if (!mm.present) throw MkError{E_MM_MISSING};
        if (mm.wrong_type || mm.z == nullptr) throw MkError{E_INVALID_MM};
        const TagSlot& ml = aux.ml_up.present ? aux.ml_up : aux.ml_lo;
        if (!ml.present) throw MkError{E_ML_MISSING};
        if (ml.wrong_type || ml.b == nullptr) throw MkError{E_INVALID_ML};
        if (aux.mn_present) {
          if (aux.mn_wrong_type) throw MkError{E_INVALID_MN};
          if (aux.mn_value != (int64_t)r.l_seq) throw MkError{E_INVALID_MN};
        } else if (r.is_not_primary()) {
          throw MkError{E_NON_PRIMARY_MN};
        }
        forward_seq(r, fwd);
        info = decode_read_mods(fwd, mm.z, ml.b, ml.b_n);
      } catch (const MkError&) {
        continue;
      } catch (...) {
        continue;
      }
      // duplex reads skipped (entropy/mod.rs:1535)
      {
        bool s0 = false, s1 = false;
        for (auto& g : info.groups)
          (g.mod_strand == 0 ? s0 : s1) = true;
        if (s0 && s1) continue;
      }
      // union of observed codes per base across the read (any row with
      // a present prob), sorted by mod-code order
      std::array<std::vector<Code>, 4> union_by_base;
      for (int strand_pass = 0; strand_pass < 2; ++strand_pass) {
        for (auto& g : info.groups) {
          if (g.mod_strand != strand_pass) continue;
          auto& u = union_by_base[base_idx_of(g.base)];
          size_t gm = g.codes.size(), gn = g.pos.size();
          for (size_t j = 0; j < gm; ++j) {
            bool present_any = false;
            for (size_t i = 0; i < gn && !present_any; ++i)
              if (g.probs[i * gm + j] >= 0.0f) present_any = true;
            if (present_any &&
                std::find(u.begin(), u.end(), g.codes[j]) == u.end())
              u.push_back(g.codes[j]);
          }
        }
      }
      for (auto& u : union_by_base)
        std::sort(u.begin(), u.end(), code_less);
      // forward query pos -> ref pos
      qf.clear();
      rp.clear();
      aligned_pairs_sorted(r, qf, rp);
      refmap.assign(r.l_seq, -1);
      for (size_t i = 0; i < qf.size(); ++i) refmap[qf[i]] = rp[i];
      // per-position thresholded calls (entropy.py _group_calls)
      calls.clear();
      for (int strand_pass = 0; strand_pass < 2; ++strand_pass) {
        for (auto& g : info.groups) {
          if (g.mod_strand != strand_pass) continue;
          int bidx = base_idx_of(g.base);
          const auto& u = union_by_base[bidx];
          size_t gm = g.codes.size(), gn = g.pos.size();
          // candidate columns: group codes then union leftovers
          std::vector<Code> cols(g.codes);
          for (Code cu : u)
            if (std::find(cols.begin(), cols.end(), cu) == cols.end())
              cols.push_back(cu);
          std::vector<float> thr(cols.size());
          for (size_t j = 0; j < cols.size(); ++j)
            thr[j] = (float)b->cfg.mod_thr(cols[j], bidx);
          // one shared call covers every inferred row of the base
          int64_t call0 = 0;
          bool have_call0 = false;
          for (size_t i = 0; i < gn; ++i) {
            int32_t qpos = g.pos[i];
            if (qpos < 0 || qpos >= (int32_t)r.l_seq) continue;
            int32_t rpos = refmap[qpos];
            if (rpos < 0) continue;
            int64_t key = ((int64_t)rpos << 2) | (int64_t)bidx;
            if (g.inferred[i]) {
              if (!have_call0) {
                std::vector<std::pair<Code, float>> probs;
                for (Code cu : u) probs.emplace_back(cu, 0.0f);
                call0 = ep_scalar_call(b->cfg, bidx, probs);
                have_call0 = true;
              }
              calls[key] = call0;
              continue;
            }
            bool all_present = true;
            for (size_t j = 0; j < gm && all_present; ++j)
              if (g.probs[i * gm + j] < 0.0f) all_present = false;
            if (!all_present) {
              // rare multi-subtag rows with absent classes: scalar path
              std::vector<std::pair<Code, float>> probs;
              for (size_t j = 0; j < gm; ++j) {
                float p = g.probs[i * gm + j];
                if (p >= 0.0f) probs.emplace_back(g.codes[j], p);
              }
              for (Code cu : u) {
                bool seen = false;
                for (auto& kv : probs)
                  if (kv.first == cu) {
                    seen = true;
                    break;
                  }
                if (!seen) probs.emplace_back(cu, 0.0f);
              }
              calls[key] = ep_scalar_call(b->cfg, bidx, probs);
              continue;
            }
            // vectorized-path semantics: f32 thresholds, later candidate
            // wins ties, canonical last
            float canon = 1.0f;
            {
              float sum = 0.0f;
              for (size_t j = 0; j < gm; ++j) sum += g.probs[i * gm + j];
              canon = 1.0f - sum;
            }
            float best = -INFINITY;
            size_t best_j = 0;
            bool any_mod = false;
            for (size_t j = 0; j < cols.size(); ++j) {
              float val = j < gm ? g.probs[i * gm + j] : 0.0f;
              bool pass = val >= thr[j];
              if (pass && val >= best) {
                best = val;
                best_j = j;
              }
              any_mod |= pass;
            }
            bool pass_can =
                canon >= (float)b->cfg.can_thr[bidx];
            if (pass_can && (!any_mod || canon >= best))
              calls[key] = EP_CANON;
            else if (any_mod)
              calls[key] = cols[best_j];
            else
              calls[key] = EP_FILT;
          }
        }
      }
      bool read_plus = !r.is_reverse();
      for (auto it = first; it != last; ++it) {
        int32_t wi = b->route[(size_t)(it - b->lefts.begin())];
        ep_add_read(b, b->wins[wi], read_plus, calls, ref_start, ref_end);
      }
    }
  }
  return 0;
}

void mk_entropy_finish(void* handle, int32_t min_coverage,
                       int32_t* plus_status, float* plus_me,
                       int32_t* plus_nreads, int32_t* minus_status,
                       float* minus_me, int32_t* minus_nreads) {
  EpBatch* b = static_cast<EpBatch*>(handle);
  const int N = b->N;
  const float constant = (float)(1.0 / (double)N);
  for (int32_t wi = 0; wi < b->n_windows; ++wi) {
    EpWindow& w = b->wins[wi];
    plus_status[wi] = minus_status[wi] = -1;
    plus_me[wi] = minus_me[wi] = 0.0f;
    plus_nreads[wi] = minus_nreads[wi] = 0;
    // mod-code vocabulary across both strands' patterns, sorted
    std::vector<Code> codes;
    for (auto* store : {&w.plus_patterns, &w.minus_patterns})
      for (auto& pat : *store)
        for (int64_t v : pat)
          if (v != EP_CANON && v != EP_FILT &&
              std::find(codes.begin(), codes.end(), (Code)v) == codes.end())
            codes.push_back((Code)v);
    std::sort(codes.begin(), codes.end(), code_less);
    auto encode = [&](const std::vector<std::vector<int64_t>>& pats,
                      const std::vector<int32_t>& cov, int32_t* status,
                      float* me, int32_t* nreads) {
      bool all_ok = true, all_zero = true;
      for (int i = 0; i < N; ++i) {
        if (cov[i] < min_coverage) all_ok = false;
        if (cov[i] != 0) all_zero = false;
      }
      if (!all_ok) {
        *status = all_zero ? 1 : 2;
        return;
      }
      std::vector<std::string> seqs;
      seqs.reserve(pats.size());
      for (auto& pat : pats) {
        std::string s(N, '0');
        for (int i = 0; i < N; ++i) {
          if (pat[i] == EP_CANON)
            s[i] = '0';
          else if (pat[i] == EP_FILT)
            s[i] = '*';
          else {
            size_t ci = std::find(codes.begin(), codes.end(),
                                  (Code)pat[i]) -
                        codes.begin();
            s[i] = (char)('1' + (int)ci);
          }
        }
        seqs.push_back(std::move(s));
      }
      *status = 0;
      *me = me_entropy_core(seqs, N, constant);
      *nreads = (int32_t)seqs.size();
    };
    if (b->combine || w.plus_present)
      encode(w.plus_patterns, w.plus_cov, &plus_status[wi], &plus_me[wi],
             &plus_nreads[wi]);
    if (!b->combine && w.minus_present)
      encode(w.minus_patterns, w.minus_cov, &minus_status[wi],
             &minus_me[wi], &minus_nreads[wi]);
  }
}

void mk_entropy_free(void* handle) {
  delete static_cast<EpBatch*>(handle);
}

// ---------------------------------------------------------------------------
// bedMethyl columnar parse (bedmethyl.py BedMethylLine.parse; reference
// src/dmr/bedmethyl.rs:25-160). Parses a fetched text blob into flat i64
// columns for the vectorized dmr single-site path:
//   [start, code, strand(0 '+',1 '-',2 '.'), n_mod, valid_cov, n_canonical]
// filtered by chrom, [qstart, qend) overlap, min coverage, and an allowed
// mod-code list (empty = all). Malformed lines are skipped, mirroring the
// Python read_lines ValueError->continue.
// ---------------------------------------------------------------------------
int32_t mk_parse_bedmethyl(
    const char* text, int64_t len, const char* chrom, int32_t chrom_len,
    int64_t qstart, int64_t qend, int64_t min_valid,
    const int64_t* allowed_codes, int32_t n_allowed,
    int64_t** out_blob, int64_t* out_n) {
  *out_blob = nullptr;
  *out_n = 0;
  std::vector<int64_t> rows;
  rows.reserve(4096);
  const char* p = text;
  const char* endp = text + len;
  auto parse_int = [](const char* s, const char* e, int64_t* v) -> bool {
    if (s >= e) return false;
    bool neg = false;
    if (*s == '-') { neg = true; ++s; }
    if (s >= e) return false;
    int64_t x = 0;
    for (; s < e; ++s) {
      if (*s < '0' || *s > '9') return false;
      x = x * 10 + (*s - '0');
    }
    *v = neg ? -x : x;
    return true;
  };
  while (p < endp) {
    const char* nl = (const char*)memchr(p, '\n', (size_t)(endp - p));
    const char* line_end = nl ? nl : endp;
    const char* line = p;
    p = nl ? nl + 1 : endp;
    // split on tabs: need fields 0..5 and 9.. (space-or-tab stats)
    const char* f[10];
    const char* fe[10];
    int nf = 0;
    const char* q = line;
    while (nf < 10 && q <= line_end) {
      const char* t =
          (const char*)memchr(q, '\t', (size_t)(line_end - q));
      f[nf] = q;
      fe[nf] = t ? t : line_end;
      ++nf;
      if (!t) break;
      q = t + 1;
    }
    if (nf < 10) continue;
    // chrom filter
    if ((int32_t)(fe[0] - f[0]) != chrom_len ||
        std::memcmp(f[0], chrom, (size_t)chrom_len) != 0)
      continue;
    int64_t start = 0, stop = 0, valid = 0;
    if (!parse_int(f[1], fe[1], &start)) continue;
    if (!parse_int(f[2], fe[2], &stop)) continue;
    if (!(start < qend && stop > qstart)) continue;
    // mod code: name column up to the first comma
    const char* ce = (const char*)memchr(f[3], ',', (size_t)(fe[3] - f[3]));
    const char* code_end = ce ? ce : fe[3];
    int64_t code;
    if (code_end - f[3] == 1) {
      code = -(int64_t)(uint8_t)f[3][0];
    } else if (!parse_int(f[3], code_end, &code)) {
      continue;
    }
    if (n_allowed > 0) {
      bool ok = false;
      for (int32_t i = 0; i < n_allowed && !ok; ++i)
        if (allowed_codes[i] == code) ok = true;
      if (!ok) continue;
    }
    if (!parse_int(f[4], fe[4], &valid)) continue;
    if (valid < min_valid) continue;
    if (fe[5] - f[5] < 1) continue;
    char sc = f[5][0];
    int64_t strand = sc == '+' ? 0 : sc == '-' ? 1 : sc == '.' ? 2 : -1;
    if (strand < 0) continue;
    // stats columns: fields 9..end re-split on space OR tab
    // (writers.rs:94-101 --mixed-delim). The scalar parser requires >= 9
    // stats tokens with integer tokens 2..8 (bedmethyl.py parse nums =
    // int(rest[2:9])); mirror it so both paths skip the same lines.
    int64_t n_mod = -1, canon = -1;
    {
      int ri = 0;
      bool bad = false;
      const char* s = f[9];
      while (s < line_end && ri < 9) {
        const char* e2 = s;
        while (e2 < line_end && *e2 != ' ' && *e2 != '\t') ++e2;
        if (e2 > s) {
          if (ri >= 2) {
            int64_t v;
            if (!parse_int(s, e2, &v)) { bad = true; break; }
            if (ri == 2) n_mod = v;
            if (ri == 3) canon = v;
          }
          ++ri;
        }
        s = e2 + 1;
      }
      if (bad || ri < 9) continue;
    }
    if (n_mod < 0 || canon < 0) continue;
    rows.push_back(start);
    rows.push_back(code);
    rows.push_back(strand);
    rows.push_back(n_mod);
    rows.push_back(valid);
    rows.push_back(canon);
  }
  int64_t n = (int64_t)(rows.size() / 6);
  if (n) {
    int64_t* blob = (int64_t*)std::malloc(rows.size() * sizeof(int64_t));
    if (blob == nullptr) return 2;
    std::memcpy(blob, rows.data(), rows.size() * sizeof(int64_t));
    *out_blob = blob;
  }
  *out_n = n;
  return 0;
}

}  // extern "C"

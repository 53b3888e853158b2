// segment_build — the native segment build of index/segment.py
// (SegmentBuilder._build_native): one text field inverted in contiguous
// doc ranges, each on a thread of its own, and the ranges merged into
// the layout one inversion of every doc gives.
//
// The analyzer below is native/fugu_native.cc's, copied unchanged
// (tests/test_torch_drift.py holds it to that file), with the tables
// native/gen_unicode_tables.py generates from the running CPython; so
// is the Builder's add_doc, the tokenizing loop that calls emit.  What
// differs from that file's Builder is what emit keeps: a term id, doc
// and position a token, appended to three flat arrays, where the
// reference grows four vectors a term.  finish lays the tokens out term
// by term with one stable counting sort, so each term's postings come
// out in doc order and each posting's positions in the order they were
// emitted, which is the reference's layout.
//
// The merge walks the ranges' sorted term lists together (byte order:
// std::string's, which for UTF-8 is code-point order, Python's); a
// term's doc frequency is the sum of its ranges', and its postings are
// laid out range after range, each doc shifted by its range's first
// doc, so they stay in doc order.  Position offsets are rebased onto
// the merged position array.
//
// Plain C interface over flat arrays, loaded with ctypes
// (fugu_tpu_torch/native.py invert_docs, merge_ranges).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <vector>

#include "unicode_tables.h"

namespace {

constexpr size_t kLongTokenByteLimit = 40;
constexpr int kPositionGap = 2;

bool is_alnum(uint32_t cp) {
  if (cp < 128) {  // ASCII fast path (str.isalnum semantics)
    return (cp >= '0' && cp <= '9') || (cp >= 'A' && cp <= 'Z') ||
           (cp >= 'a' && cp <= 'z');
  }
  int lo = 0, hi = ALNUM_RANGES_N - 1;
  while (lo <= hi) {
    int mid = (lo + hi) / 2;
    if (cp < ALNUM_RANGES[mid][0]) {
      hi = mid - 1;
    } else if (cp > ALNUM_RANGES[mid][1]) {
      lo = mid + 1;
    } else {
      return true;
    }
  }
  return false;
}

// append lowercase(cp) to out as UTF-8
void append_lower_utf8(uint32_t cp, std::string* out);

void append_utf8(uint32_t cp, std::string* out) {
  if (cp < 0x80) {
    out->push_back(static_cast<char>(cp));
  } else if (cp < 0x800) {
    out->push_back(static_cast<char>(0xC0 | (cp >> 6)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    out->push_back(static_cast<char>(0xE0 | (cp >> 12)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else {
    out->push_back(static_cast<char>(0xF0 | (cp >> 18)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  }
}

void append_lower_utf8(uint32_t cp, std::string* out) {
  if (cp < 0x80) {  // ASCII fast path
    if (cp >= 'A' && cp <= 'Z') cp += 32;
    out->push_back(static_cast<char>(cp));
    return;
  }
  // multi-char expansions first (tiny table)
  for (int i = 0; i < LOWER_MULTI_N; ++i) {
    if (LOWER_MULTI[i][0] == cp) {
      for (int j = 1; j < 4 && LOWER_MULTI[i][j]; ++j) {
        append_utf8(LOWER_MULTI[i][j], out);
      }
      return;
    }
  }
  int lo = 0, hi = LOWER_SIMPLE_N - 1;
  while (lo <= hi) {
    int mid = (lo + hi) / 2;
    if (LOWER_SIMPLE[mid][0] < cp) {
      lo = mid + 1;
    } else if (LOWER_SIMPLE[mid][0] > cp) {
      hi = mid - 1;
    } else {
      append_utf8(LOWER_SIMPLE[mid][1], out);
      return;
    }
  }
  append_utf8(cp, out);
}

// decode one UTF-8 codepoint; returns bytes consumed (>=1)
inline int decode_utf8(const uint8_t* p, const uint8_t* end, uint32_t* cp) {
  uint8_t b = p[0];
  if (b < 0x80) { *cp = b; return 1; }
  if ((b >> 5) == 0x6 && p + 1 < end) {
    *cp = ((b & 0x1F) << 6) | (p[1] & 0x3F);
    return 2;
  }
  if ((b >> 4) == 0xE && p + 2 < end) {
    *cp = ((b & 0x0F) << 12) | ((p[1] & 0x3F) << 6) | (p[2] & 0x3F);
    return 3;
  }
  if ((b >> 3) == 0x1E && p + 3 < end) {
    *cp = ((b & 0x07) << 18) | ((p[1] & 0x3F) << 12) | ((p[2] & 0x3F) << 6) |
          (p[3] & 0x3F);
    return 4;
  }
  *cp = 0xFFFD;
  return 1;
}

// the order of std::string's operator<: bytes compared unsigned, then
// the shorter first
inline bool less_bytes(const char* a, int32_t la, const char* b,
                       int32_t lb) {
  int c = std::memcmp(a, b, static_cast<size_t>(la < lb ? la : lb));
  return c < 0 || (c == 0 && la < lb);
}

inline bool same_bytes(const char* a, int32_t la, const char* b,
                       int32_t lb) {
  return la == lb && std::memcmp(a, b, static_cast<size_t>(la)) == 0;
}

// One doc range's tokens, in the order add_doc emits them: a term id,
// doc and position each.  Term ids come from an open-addressing table
// over the terms' bytes, kept in one arena in id order.
struct Builder {
  // per slot: (term id + 1) << 32 | the hash's high half; 0 when empty
  std::vector<uint64_t> slots = std::vector<uint64_t>(1 << 12);
  std::string arena;
  std::vector<int64_t> term_off = std::vector<int64_t>(1, 0);
  std::vector<int32_t> tok_term;
  std::vector<int32_t> tok_doc;
  std::vector<int32_t> tok_pos;
  std::vector<int64_t> doc_token_counts;
  int32_t next_doc = 0;

  // scratch reused across docs
  std::string token;

  int32_t n_terms() const {
    return static_cast<int32_t>(term_off.size() - 1);
  }

  static uint64_t hash(const char* p, size_t n) {
    return std::hash<std::string_view>{}(std::string_view(p, n));
  }

  void grow() {
    std::vector<uint64_t> old(slots.size() * 2);
    old.swap(slots);
    const uint64_t mask = slots.size() - 1;
    for (uint64_t s : old) {
      if (s == 0) continue;
      const int64_t id = static_cast<int64_t>(s >> 32) - 1;
      const uint64_t h = hash(arena.data() + term_off[id],
                              term_off[id + 1] - term_off[id]);
      uint64_t i = h & mask;
      while (slots[i] != 0) i = (i + 1) & mask;
      slots[i] = s;
    }
  }

  // the id of `token`, a new one for a new term
  int32_t term_id() {
    const uint64_t h = hash(token.data(), token.size());
    const uint64_t tag = h >> 32;
    const uint64_t mask = slots.size() - 1;
    for (uint64_t i = h & mask;; i = (i + 1) & mask) {
      const uint64_t s = slots[i];
      if (s == 0) {
        const int32_t id = n_terms();
        slots[i] = (static_cast<uint64_t>(id) + 1) << 32 | tag;
        arena += token;
        term_off.push_back(static_cast<int64_t>(arena.size()));
        if (2 * term_off.size() > slots.size()) grow();
        return id;
      }
      if ((s & 0xFFFFFFFFu) == tag) {
        const int64_t id = static_cast<int64_t>(s >> 32) - 1;
        const int64_t n = term_off[id + 1] - term_off[id];
        if (n == static_cast<int64_t>(token.size()) &&
            std::memcmp(arena.data() + term_off[id], token.data(), n) == 0) {
          return static_cast<int32_t>(id);
        }
      }
    }
  }

  inline void emit(int32_t doc, int32_t pos) {
    tok_term.push_back(term_id());
    tok_doc.push_back(doc);
    tok_pos.push_back(pos);
  }

  void add_doc(const char* data, int64_t len, int64_t n_values,
               const int64_t* value_offsets) {
    int32_t doc = next_doc++;
    int64_t n_tokens = 0;
    int pos_base = 0;
    for (int64_t v = 0; v < n_values; ++v) {
      const uint8_t* p =
          reinterpret_cast<const uint8_t*>(data) + value_offsets[v];
      const uint8_t* end =
          reinterpret_cast<const uint8_t*>(data) + value_offsets[v + 1];
      int pos = 0;
      int last_pos = -1;
      size_t raw_bytes = 0;
      bool in_token = false;
      while (p < end) {
        uint32_t cp;
        int n;
        if (*p < 0x80) {  // ASCII fast path (the overwhelming majority)
          cp = *p;
          n = 1;
        } else {
          n = decode_utf8(p, end, &cp);
        }
        if (is_alnum(cp)) {
          if (!in_token) {
            in_token = true;
            token.clear();
            raw_bytes = 0;
          }
          raw_bytes += n;
          append_lower_utf8(cp, &token);
        } else if (in_token) {
          in_token = false;
          if (raw_bytes < kLongTokenByteLimit) {
            emit(doc, pos_base + pos);
            ++n_tokens;
            last_pos = std::max(last_pos, pos);
          }
          ++pos;
        }
        p += n;
      }
      if (in_token) {
        if (raw_bytes < kLongTokenByteLimit) {
          emit(doc, pos_base + pos);
          ++n_tokens;
          last_pos = std::max(last_pos, pos);
        }
        ++pos;
      }
      // match the Python builder's position-gap rule: value k starts at
      // (last emitted position of value k-1) + POSITION_GAP
      if (last_pos >= 0) pos_base += last_pos + kPositionGap;
    }
    doc_token_counts.push_back(n_tokens);
  }
};

// A range's inversion: native/fugu_native.cc's finish output, flat.
struct Result {
  std::string term_blob;           // terms joined, no separators
  std::vector<int32_t> term_lens;  // byte length per term
  std::vector<int32_t> term_dfs;
  std::vector<int32_t> post_docs;
  std::vector<int32_t> post_tfs;
  std::vector<int64_t> pos_offsets;  // per posting entry, +1 leading 0
  std::vector<int32_t> pos_data;
  std::vector<int64_t> doc_token_counts;
};

// the batch loop of fugu_native.cc's fugu_builder_add_docs: each doc's
// slice of the shared offset table rebased to start at 0
void add_docs(Builder* b, const char* data, const int64_t* value_offsets,
              const int64_t* doc_value_counts, int64_t n_docs) {
  int64_t n_values = 0;
  for (int64_t d = 0; d < n_docs; ++d) n_values += doc_value_counts[d];
  // room for tokens of three bytes on average (and their separators),
  // so that the arrays rarely move; pages never written are never
  // faulted in
  const int64_t room =
      (value_offsets[n_values] - value_offsets[0]) / 4 + n_values;
  b->tok_term.reserve(room);
  b->tok_doc.reserve(room);
  b->tok_pos.reserve(room);
  b->doc_token_counts.reserve(n_docs);
  int64_t v = 0;
  std::vector<int64_t> local;
  for (int64_t d = 0; d < n_docs; ++d) {
    int64_t nv = doc_value_counts[d];
    const int64_t* offs = value_offsets + v;
    int64_t base = offs[0];
    local.resize(nv + 1);
    for (int64_t i = 0; i <= nv; ++i) local[i] = offs[i] - base;
    b->add_doc(data + base, local[nv], nv, local.data());
    v += nv;
  }
}

Result* finish(Builder* b) {
  Result* r = new Result();
  const int64_t n_terms = b->n_terms();
  const char* arena = b->arena.data();
  const int64_t* off = b->term_off.data();
  // terms in byte order: by their first 8 bytes as one big-endian key
  // (zero-padded: a term holds no 0 byte, so a prefix sorts first), ties
  // by the rest
  std::vector<std::pair<uint64_t, int32_t>> keys(n_terms);
  for (int64_t id = 0; id < n_terms; ++id) {
    uint64_t key = 0;
    const int64_t n = std::min<int64_t>(off[id + 1] - off[id], 8);
    for (int64_t i = 0; i < 8; ++i) {
      key = key << 8 | (i < n ? static_cast<uint8_t>(arena[off[id] + i]) : 0);
    }
    keys[id] = {key, static_cast<int32_t>(id)};
  }
  std::sort(keys.begin(), keys.end(), [&](const std::pair<uint64_t, int32_t>& a,
                                          const std::pair<uint64_t, int32_t>& c) {
    if (a.first != c.first) return a.first < c.first;
    return less_bytes(arena + off[a.second] + 8,
                      static_cast<int32_t>(off[a.second + 1] - off[a.second] - 8),
                      arena + off[c.second] + 8,
                      static_cast<int32_t>(off[c.second + 1] - off[c.second] - 8));
  });
  std::vector<int32_t> rank(n_terms);
  for (int64_t i = 0; i < n_terms; ++i) rank[keys[i].second] = static_cast<int32_t>(i);
  // stable counting sort of the tokens by their term's rank
  const int64_t n_tok = static_cast<int64_t>(b->tok_term.size());
  std::vector<int64_t> start(n_terms + 1, 0);
  for (int32_t t : b->tok_term) ++start[rank[t] + 1];
  for (int64_t i = 0; i < n_terms; ++i) start[i + 1] += start[i];
  std::vector<int64_t> at(start.begin(), start.end() - 1);
  std::vector<int32_t> doc(n_tok);
  r->pos_data.resize(n_tok);
  for (int64_t i = 0; i < n_tok; ++i) {
    const int64_t k = at[rank[b->tok_term[i]]]++;
    doc[k] = b->tok_doc[i];
    r->pos_data[k] = b->tok_pos[i];
  }
  std::vector<int32_t>().swap(b->tok_term);
  std::vector<int32_t>().swap(b->tok_doc);
  std::vector<int32_t>().swap(b->tok_pos);
  // a posting a run of one doc within a term
  int64_t n_post = 0;
  for (int64_t j = 0; j < n_terms; ++j) {
    for (int64_t k = start[j]; k < start[j + 1]; ++k) {
      n_post += k == start[j] || doc[k] != doc[k - 1];
    }
  }
  r->term_blob.resize(b->arena.size());
  r->term_lens.resize(n_terms);
  r->term_dfs.resize(n_terms);
  r->post_docs.resize(n_post);
  r->post_tfs.resize(n_post);
  r->pos_offsets.resize(n_post + 1);
  r->pos_offsets[0] = 0;
  int64_t blob_at = 0, p = -1;
  for (int64_t j = 0; j < n_terms; ++j) {
    const int32_t id = keys[j].second;
    const int64_t n = off[id + 1] - off[id];
    std::memcpy(&r->term_blob[blob_at], arena + off[id], n);
    blob_at += n;
    r->term_lens[j] = static_cast<int32_t>(n);
    int32_t df = 0;
    for (int64_t k = start[j]; k < start[j + 1]; ++k) {
      if (k == start[j] || doc[k] != doc[k - 1]) {
        ++p;
        r->post_docs[p] = doc[k];
        r->post_tfs[p] = 0;
        ++df;
      }
      ++r->post_tfs[p];
      r->pos_offsets[p + 1] = k + 1;
    }
    r->term_dfs[j] = df;
  }
  r->doc_token_counts.swap(b->doc_token_counts);
  return r;
}

// memcpy from vec.data() of an EMPTY vector is UB (data() may be null
// even with size 0); copy only when non-empty
template <typename T>
void copy_vec(T* dst, const std::vector<T>& src) {
  if (!src.empty()) std::memcpy(dst, src.data(), src.size() * sizeof(T));
}

}  // namespace

extern "C" {

// One doc range inverted: `data` holds its values' UTF-8 text,
// `value_offsets` (n_values + 1) delimits each value in it and
// `doc_value_counts` (n_docs) gives how many values each doc owns.
// Returns the Result; read its sizes and arrays with fugu_range_sizes
// and fugu_range_copy, then fugu_range_free it.
void* fugu_range_invert(const char* data, const int64_t* value_offsets,
                        const int64_t* doc_value_counts, int64_t n_docs) {
  Builder b;
  add_docs(&b, data, value_offsets, doc_value_counts, n_docs);
  return finish(&b);
}

// sizes[5]: terms, postings, positions, term blob bytes, docs
void fugu_range_sizes(void* h, int64_t* sizes) {
  Result* r = static_cast<Result*>(h);
  sizes[0] = static_cast<int64_t>(r->term_lens.size());
  sizes[1] = static_cast<int64_t>(r->post_docs.size());
  sizes[2] = static_cast<int64_t>(r->pos_data.size());
  sizes[3] = static_cast<int64_t>(r->term_blob.size());
  sizes[4] = static_cast<int64_t>(r->doc_token_counts.size());
}

void fugu_range_copy(void* h, char* term_blob, int32_t* term_lens,
                     int32_t* term_dfs, int32_t* post_docs, int32_t* post_tfs,
                     int64_t* pos_offsets, int32_t* pos_data,
                     int64_t* doc_token_counts) {
  Result* r = static_cast<Result*>(h);
  if (!r->term_blob.empty())
    std::memcpy(term_blob, r->term_blob.data(), r->term_blob.size());
  copy_vec(term_lens, r->term_lens);
  copy_vec(term_dfs, r->term_dfs);
  copy_vec(post_docs, r->post_docs);
  copy_vec(post_tfs, r->post_tfs);
  copy_vec(pos_offsets, r->pos_offsets);
  copy_vec(pos_data, r->pos_data);
  copy_vec(doc_token_counts, r->doc_token_counts);
}

void fugu_range_free(void* h) { delete static_cast<Result*>(h); }

// Inputs, one pointer a range for each array (n_ranges of each):
//   blobs[r]       the range's terms joined, no separators
//   term_lens[r]   int32[n_terms[r]] byte length of each term
//   dfs[r]         int32[n_terms[r]] postings of each term
//   docs[r], tfs[r]  int32[sum of dfs[r]] doc (range-relative) and tf
//   pos_offsets[r] int64[sum of dfs[r] + 1] each posting's position run
//   pos_data[r]    int32[pos_offsets[r][last]] positions
//   doc_base[r]    the range's first doc in the field's numbering
// Outputs, sized by the caller for the sum over the ranges:
//   out_blob       each merged term followed by '\n' (tokens hold no
//                  '\n': they are lowercased alphanumeric code points)
//   out_dfs, out_docs, out_tfs, out_pos_offsets (with its leading 0),
//   out_pos_data
//   out_blob_size  the bytes written to out_blob
// Returns the number of merged terms.
int64_t fugu_merge_ranges(int64_t n_ranges, const char* const* blobs,
                          const int32_t* const* term_lens,
                          const int32_t* const* dfs,
                          const int32_t* const* docs,
                          const int32_t* const* tfs,
                          const int64_t* const* pos_offsets,
                          const int32_t* const* pos_data,
                          const int64_t* n_terms, const int64_t* doc_base,
                          char* out_blob, int32_t* out_dfs,
                          int32_t* out_docs, int32_t* out_tfs,
                          int64_t* out_pos_offsets, int32_t* out_pos_data,
                          int64_t* out_blob_size) {
  const int64_t R = n_ranges;
  // per range: next term, its bytes' start, its first posting
  std::vector<int64_t> term(R), byte(R), post(R);
  int64_t n_out = 0, blob_at = 0, post_at = 0, pos_at = 0;
  out_pos_offsets[0] = 0;
  for (;;) {
    // the least head term over the ranges not yet exhausted
    int64_t least = -1;
    for (int64_t r = 0; r < R; ++r) {
      if (term[r] == n_terms[r]) continue;
      if (least < 0 ||
          less_bytes(blobs[r] + byte[r], term_lens[r][term[r]],
                     blobs[least] + byte[least],
                     term_lens[least][term[least]])) {
        least = r;
      }
    }
    if (least < 0) break;
    const char* t = blobs[least] + byte[least];
    const int32_t tl = term_lens[least][term[least]];
    std::memcpy(out_blob + blob_at, t, static_cast<size_t>(tl));
    blob_at += tl;
    out_blob[blob_at++] = '\n';
    int64_t df = 0;
    // ranges in order, so the term's docs stay in increasing order
    for (int64_t r = least; r < R; ++r) {
      if (term[r] == n_terms[r]) continue;
      const int32_t rl = term_lens[r][term[r]];
      if (!same_bytes(blobs[r] + byte[r], rl, t, tl)) continue;
      const int64_t p0 = post[r], n = dfs[r][term[r]];
      const int64_t base = doc_base[r];
      for (int64_t i = 0; i < n; ++i) {
        out_docs[post_at + i] = static_cast<int32_t>(docs[r][p0 + i] + base);
      }
      std::memcpy(out_tfs + post_at, tfs[r] + p0, n * sizeof(int32_t));
      const int64_t q0 = pos_offsets[r][p0], q1 = pos_offsets[r][p0 + n];
      std::memcpy(out_pos_data + pos_at, pos_data[r] + q0,
                  (q1 - q0) * sizeof(int32_t));
      for (int64_t i = 1; i <= n; ++i) {
        out_pos_offsets[post_at + i] = pos_at + (pos_offsets[r][p0 + i] - q0);
      }
      post_at += n;
      pos_at += q1 - q0;
      df += n;
      post[r] += n;
      byte[r] += rl;
      ++term[r];
    }
    out_dfs[n_out++] = static_cast<int32_t>(df);
  }
  *out_blob_size = blob_at;
  return n_out;
}

}  // extern "C"

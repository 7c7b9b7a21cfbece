// Host C++ for the port's irregular host work, built by g++ into a plain-C
// library (lfr_tpu_torch/ops/host_build.py) and bound with ctypes
// (lfr_tpu_torch/solver/native.py).
//
// A copy of the functions of lfr_tpu/native/lfr_native.cc that the port's
// chains call: the maximum-spanning-forest track builder and its match
// order, the stable counting argsort of the bucket packer, and the
// MatchingFile codec.  Two changes in the decoder: a pair without
// image_name1 gets an empty name, where the copied one shifted image_name2
// into its slot; and a submessage whose length runs past its parent's end
// fails the decode instead of reading past the buffer.
//
// The forest is sequential (it consumes edges in global similarity order,
// and each union depends on all prior ones), so it stays on the host
// (reference: multi-view-refinement/solve.cc:67-77,488-541).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <iterator>
#include <thread>
#include <vector>

extern "C" {

// Union-find with image-disjoint merge constraint.
//
//   order:      edge indices sorted by descending similarity
//   src/dst:    undirected match endpoints (node ids)
//   node_image: image id per node
//   parent:     out, -1 for roots (pre-initialized by caller)
void lfr_msf_union_find(
    int64_t n_edges,
    const int64_t* order,
    const int64_t* src,
    const int64_t* dst,
    int64_t n_nodes,
    const int64_t* node_image,
    int64_t* parent) {
  // Per-root sorted image-id sets; smaller always merges into larger.
  std::vector<std::vector<int64_t>> images(n_nodes);
  for (int64_t i = 0; i < n_nodes; ++i) {
    images[i].push_back(node_image[i]);
  }

  std::vector<int64_t> stack;
  auto find = [&](int64_t node) {
    int64_t root = node;
    while (parent[root] != -1) root = parent[root];
    // Iterative path compression.
    while (parent[node] != -1) {
      int64_t next = parent[node];
      parent[node] = root;
      node = next;
    }
    return root;
  };

  std::vector<int64_t> merged;
  for (int64_t e = 0; e < n_edges; ++e) {
    const int64_t idx = order[e];
    int64_t r1 = find(src[idx]);
    int64_t r2 = find(dst[idx]);
    if (r1 == r2) continue;

    auto& s1 = images[r1];
    auto& s2 = images[r2];
    // Reject merges sharing any image (one feature per image per track).
    const auto* small = &s1;
    const auto* big = &s2;
    if (small->size() > big->size()) std::swap(small, big);
    bool overlap = false;
    for (int64_t img : *small) {
      if (std::binary_search(big->begin(), big->end(), img)) {
        overlap = true;
        break;
      }
    }
    if (overlap) continue;

    // Smaller-image-set tree merges into larger.
    if (s1.size() < s2.size()) std::swap(r1, r2);
    parent[r2] = r1;
    auto& keep = images[r1];
    auto& give = images[r2];
    merged.clear();
    merged.reserve(keep.size() + give.size());
    std::merge(keep.begin(), keep.end(), give.begin(), give.end(),
               std::back_inserter(merged));
    keep.swap(merged);
    give.clear();
    give.shrink_to_fit();
  }
}

// Sort match indices by (sim desc, src desc, dst desc, idx desc) — the
// exact order np.lexsort((dst, src, sim))[::-1] produces (reversed stable
// ascending) and the order the reference's MSF consumes
// (reference: multi-view-refinement/solve.cc:488-490).  Parallel merge
// sort: chunk std::sort in threads, then pairwise merges.
void lfr_sort_matches_desc(
    int64_t n,
    const float* sim,
    const int64_t* src,
    const int64_t* dst,
    int64_t* order,
    int n_threads) {
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  auto cmp = [&](int64_t a, int64_t b) {
    if (sim[a] != sim[b]) return sim[a] > sim[b];
    if (src[a] != src[b]) return src[a] > src[b];
    if (dst[a] != dst[b]) return dst[a] > dst[b];
    return a > b;
  };
  if (n_threads < 1) n_threads = 1;
  if (n < 1 << 15 || n_threads == 1) {
    std::sort(order, order + n, cmp);
    return;
  }
  // Round chunk count down to a power of two for clean pairwise merging.
  int chunks = 1;
  while (chunks * 2 <= n_threads) chunks *= 2;
  std::vector<int64_t> bounds(chunks + 1);
  for (int c = 0; c <= chunks; ++c) bounds[c] = n * c / chunks;
  {
    std::vector<std::thread> threads;
    for (int c = 0; c < chunks; ++c) {
      threads.emplace_back([&, c] {
        std::sort(order + bounds[c], order + bounds[c + 1], cmp);
      });
    }
    for (auto& t : threads) t.join();
  }
  std::vector<int64_t> buf(n);
  int64_t* a = order;
  int64_t* b = buf.data();
  for (int step = chunks; step > 1; step /= 2) {
    std::vector<std::thread> threads;
    for (int c = 0; c < step; c += 2) {
      threads.emplace_back([&, c] {
        int64_t lo = bounds[c], mid = bounds[c + 1], hi = bounds[c + 2];
        std::merge(a + lo, a + mid, a + mid, a + hi, b + lo, cmp);
      });
    }
    for (auto& t : threads) t.join();
    for (int c = 0; c + 2 <= step; c += 2) bounds[c / 2] = bounds[c];
    bounds[step / 2] = n;
    std::swap(a, b);
  }
  if (a != order) std::copy(a, a + n, order);
}

// Stable counting argsort for small-range integer keys (component ids):
// O(n + n_vals) — replaces np.argsort(kind="stable") in the bucket packer.
void lfr_counting_argsort(
    int64_t n, const int64_t* vals, int64_t n_vals, int64_t* order) {
  std::vector<int64_t> starts(n_vals + 1, 0);
  for (int64_t i = 0; i < n; ++i) ++starts[vals[i] + 1];
  for (int64_t v = 0; v < n_vals; ++v) starts[v + 1] += starts[v];
  for (int64_t i = 0; i < n; ++i) order[starts[vals[i]]++] = i;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// MatchingFile wire-format decoder.
//
// Parses the reference-compatible protobuf artifact (types.proto schema)
// straight into flat arrays, replacing the Python decoder's per-match loop
// for large match graphs.  Two-pass API: count, then fill caller-allocated
// buffers.
// ---------------------------------------------------------------------------

namespace {

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  uint64_t varint() {
    uint64_t v = 0;
    int shift = 0;
    while (p < end) {
      uint8_t b = *p++;
      v |= static_cast<uint64_t>(b & 0x7F) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
      if (shift > 63) break;
    }
    ok = false;
    return 0;
  }

  float fixed32() {
    if (end - p < 4) { ok = false; return 0.f; }
    float f;
    std::memcpy(&f, p, 4);
    p += 4;
    return f;
  }

  void skip(uint8_t tag) {
    switch (tag & 7) {
      case 0: varint(); break;
      case 1: p += 8; break;
      case 2: { uint64_t n = varint(); p += n; break; }
      case 5: p += 4; break;
      default: ok = false;
    }
    if (p > end) ok = false;
  }
};

// Parse one Displacement submessage -> (di, dj).
inline void parse_disp(Cursor& c, const uint8_t* end, float* di, float* dj) {
  *di = 0.f; *dj = 0.f;
  while (c.p < end && c.ok) {
    uint8_t tag = *c.p++;
    if (tag == 0x0D) *di = c.fixed32();
    else if (tag == 0x15) *dj = c.fixed32();
    else c.skip(tag);
  }
}

}  // namespace

extern "C" {

// Pass 1: count pairs / matches / name bytes.  Returns 0 on success.
int lfr_matching_count(const uint8_t* buf, int64_t len,
                       int64_t* n_pairs, int64_t* n_matches, int64_t* name_bytes) {
  Cursor c{buf, buf + len};
  *n_pairs = 0; *n_matches = 0; *name_bytes = 0;
  while (c.p < c.end && c.ok) {
    uint8_t tag = *c.p++;
    if (tag != 0x0A) { c.skip(tag); continue; }
    uint64_t plen = c.varint();
    const uint8_t* pend = c.p + plen;
    if (pend > c.end) return 1;
    ++*n_pairs;
    while (c.p < pend && c.ok) {
      uint8_t t = *c.p++;
      if (t == 0x0A || t == 0x1A) {            // image_name1 / image_name2
        uint64_t n = c.varint();
        *name_bytes += n;
        c.p += n;
      } else if (t == 0x2A) {                  // matches entry
        uint64_t n = c.varint();
        c.p += n;
        ++*n_matches;
      } else {
        c.skip(t);
      }
    }
    c.p = pend;
  }
  return c.ok ? 0 : 1;
}

// Pass 2: fill flat buffers.
//   pair_match_counts[n_pairs]   matches per pair
//   facts[2*n_pairs]             fact1, fact2
//   name_offsets[2*n_pairs + 1]  running offsets into name_data
//   name_data[name_bytes]
//   matches[2*n_matches]         feature_idx1, feature_idx2
//   sims[n_matches]
//   disps[n_matches * 36]        disp1 grid (9 x di,dj) then disp2 grid
int lfr_matching_fill(const uint8_t* buf, int64_t len,
                      int64_t* pair_match_counts, float* facts,
                      int64_t* name_offsets, char* name_data,
                      uint32_t* matches, float* sims, float* disps) {
  Cursor c{buf, buf + len};
  int64_t pair_idx = 0, match_idx = 0, name_off = 0, name_idx = 0;
  name_offsets[0] = 0;
  while (c.p < c.end && c.ok) {
    uint8_t tag = *c.p++;
    if (tag != 0x0A) { c.skip(tag); continue; }
    uint64_t plen = c.varint();
    const uint8_t* pend = c.p + plen;
    int64_t pair_matches = 0;
    facts[2 * pair_idx] = 0.f;
    facts[2 * pair_idx + 1] = 0.f;
    // Each name goes to its own slot, the last occurrence winning; proto3
    // omits an empty name, so a pair may carry image_name2 alone.
    const uint8_t* name_ptr[2] = {nullptr, nullptr};
    uint64_t name_len[2] = {0, 0};
    while (c.p < pend && c.ok) {
      uint8_t t = *c.p++;
      if (t == 0x0A || t == 0x1A) {
        const int slot = t == 0x0A ? 0 : 1;
        name_len[slot] = c.varint();
        name_ptr[slot] = c.p;
        c.p += name_len[slot];
        if (c.p > pend) c.ok = false;
      } else if (t == 0x15) {
        facts[2 * pair_idx] = c.fixed32();
      } else if (t == 0x25) {
        facts[2 * pair_idx + 1] = c.fixed32();
      } else if (t == 0x2A) {                  // one Match
        uint64_t n = c.varint();
        const uint8_t* mend = c.p + n;
        if (mend > pend) { c.ok = false; break; }
        uint32_t f1 = 0, f2 = 0;
        float sim = 0.f;
        int d1 = 0, d2 = 0;
        float* base = disps + match_idx * 36;
        for (int k = 0; k < 36; ++k) base[k] = 0.f;
        while (c.p < mend && c.ok) {
          uint8_t mt = *c.p++;
          if (mt == 0x08) f1 = static_cast<uint32_t>(c.varint());
          else if (mt == 0x10) f2 = static_cast<uint32_t>(c.varint());
          else if (mt == 0x1D) sim = c.fixed32();
          else if (mt == 0x22 || mt == 0x2A) {
            uint64_t dn = c.varint();
            const uint8_t* dend = c.p + dn;
            if (dend > mend) { c.ok = false; break; }
            float di, dj;
            parse_disp(c, dend, &di, &dj);
            c.p = dend;
            if (mt == 0x22) {
              if (d1 < 9) { base[2 * d1] = di; base[2 * d1 + 1] = dj; }
              ++d1;
            } else {
              if (d2 < 9) { base[18 + 2 * d2] = di; base[18 + 2 * d2 + 1] = dj; }
              ++d2;
            }
          } else {
            c.skip(mt);
          }
        }
        c.p = mend;
        matches[2 * match_idx] = f1;
        matches[2 * match_idx + 1] = f2;
        sims[match_idx] = sim;
        ++match_idx;
        ++pair_matches;
      } else {
        c.skip(t);
      }
    }
    if (!c.ok) break;
    for (int slot = 0; slot < 2; ++slot) {
      if (name_len[slot]) std::memcpy(name_data + name_off, name_ptr[slot], name_len[slot]);
      name_off += name_len[slot];
      name_offsets[++name_idx] = name_off;
    }
    c.p = pend;
    pair_match_counts[pair_idx++] = pair_matches;
  }
  return c.ok ? 0 : 1;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// MatchingFile wire-format encoder (exact inverse of the decoder above;
// matches canonical proto3 serialization byte-for-byte, including
// default-value skipping and the always-present 9+9 displacement entries).
// ---------------------------------------------------------------------------

namespace {

inline int varint_size(uint64_t v) {
  int n = 1;
  while (v >= 0x80) { v >>= 7; ++n; }
  return n;
}

inline uint8_t* put_varint(uint8_t* p, uint64_t v) {
  while (v >= 0x80) { *p++ = static_cast<uint8_t>(v) | 0x80; v >>= 7; }
  *p++ = static_cast<uint8_t>(v);
  return p;
}

inline uint8_t* put_f32(uint8_t* p, uint8_t tag, float v) {
  if (v == 0.f) return p;
  *p++ = tag;
  std::memcpy(p, &v, 4);
  return p + 4;
}

inline int disp_size(const float* d) {  // one Displacement body
  return (d[0] != 0.f ? 5 : 0) + (d[1] != 0.f ? 5 : 0);
}

inline int match_body_size(uint32_t f1, uint32_t f2, float sim, const float* g) {
  int n = 0;
  if (f1) n += 1 + varint_size(f1);
  if (f2) n += 1 + varint_size(f2);
  if (sim != 0.f) n += 5;
  for (int k = 0; k < 18; ++k) {
    int b = disp_size(g + 2 * k);
    n += 2 + b;  // tag + 1-byte length + body
  }
  return n;
}

}  // namespace

extern "C" {

// Returns the total encoded size.  Inputs use the decoder's flat layout.
int64_t lfr_matching_encode_size(
    int64_t n_pairs, const int64_t* pair_match_counts, const float* facts,
    const int64_t* name_offsets,
    const uint32_t* matches, const float* sims, const float* disps) {
  int64_t total = 0;
  int64_t m0 = 0;
  for (int64_t p = 0; p < n_pairs; ++p) {
    int64_t body = 0;
    int64_t n1 = name_offsets[2 * p + 1] - name_offsets[2 * p];
    int64_t n2 = name_offsets[2 * p + 2] - name_offsets[2 * p + 1];
    if (n1) body += 1 + varint_size(n1) + n1;
    if (facts[2 * p] != 0.f) body += 5;
    if (n2) body += 1 + varint_size(n2) + n2;
    if (facts[2 * p + 1] != 0.f) body += 5;
    for (int64_t m = 0; m < pair_match_counts[p]; ++m) {
      int mb = match_body_size(
          matches[2 * (m0 + m)], matches[2 * (m0 + m) + 1], sims[m0 + m],
          disps + 36 * (m0 + m));
      body += 1 + varint_size(mb) + mb;
    }
    m0 += pair_match_counts[p];
    total += 1 + varint_size(body) + body;
  }
  return total;
}

int lfr_matching_encode(
    int64_t n_pairs, const int64_t* pair_match_counts, const float* facts,
    const int64_t* name_offsets, const char* name_data,
    const uint32_t* matches, const float* sims, const float* disps,
    uint8_t* out) {
  uint8_t* p = out;
  int64_t m0 = 0;
  for (int64_t pi = 0; pi < n_pairs; ++pi) {
    // Recompute the pair body size (cheap relative to writing).
    int64_t body = 0;
    int64_t n1 = name_offsets[2 * pi + 1] - name_offsets[2 * pi];
    int64_t n2 = name_offsets[2 * pi + 2] - name_offsets[2 * pi + 1];
    if (n1) body += 1 + varint_size(n1) + n1;
    if (facts[2 * pi] != 0.f) body += 5;
    if (n2) body += 1 + varint_size(n2) + n2;
    if (facts[2 * pi + 1] != 0.f) body += 5;
    for (int64_t m = 0; m < pair_match_counts[pi]; ++m) {
      int mb = match_body_size(
          matches[2 * (m0 + m)], matches[2 * (m0 + m) + 1], sims[m0 + m],
          disps + 36 * (m0 + m));
      body += 1 + varint_size(mb) + mb;
    }

    *p++ = 0x0A;
    p = put_varint(p, body);
    if (n1) {
      *p++ = 0x0A;
      p = put_varint(p, n1);
      std::memcpy(p, name_data + name_offsets[2 * pi], n1);
      p += n1;
    }
    p = put_f32(p, 0x15, facts[2 * pi]);
    if (n2) {
      *p++ = 0x1A;
      p = put_varint(p, n2);
      std::memcpy(p, name_data + name_offsets[2 * pi + 1], n2);
      p += n2;
    }
    p = put_f32(p, 0x25, facts[2 * pi + 1]);

    for (int64_t m = 0; m < pair_match_counts[pi]; ++m) {
      int64_t mi = m0 + m;
      const float* g = disps + 36 * mi;
      int mb = match_body_size(matches[2 * mi], matches[2 * mi + 1], sims[mi], g);
      *p++ = 0x2A;
      p = put_varint(p, mb);
      if (matches[2 * mi]) { *p++ = 0x08; p = put_varint(p, matches[2 * mi]); }
      if (matches[2 * mi + 1]) { *p++ = 0x10; p = put_varint(p, matches[2 * mi + 1]); }
      p = put_f32(p, 0x1D, sims[mi]);
      for (int k = 0; k < 9; ++k) {          // disp1 entries (field 4)
        const float* d = g + 2 * k;
        *p++ = 0x22;
        *p++ = static_cast<uint8_t>(disp_size(d));
        p = put_f32(p, 0x0D, d[0]);
        p = put_f32(p, 0x15, d[1]);
      }
      for (int k = 9; k < 18; ++k) {         // disp2 entries (field 5)
        const float* d = g + 2 * k;
        *p++ = 0x2A;
        *p++ = static_cast<uint8_t>(disp_size(d));
        p = put_f32(p, 0x0D, d[0]);
        p = put_f32(p, 0x15, d[1]);
      }
    }
    m0 += pair_match_counts[pi];
  }
  return 0;
}

}  // extern "C"

// gnnome_native — C++ support library for gnnome_tpu.
//
// Provides the CPU-bound preprocessing/decoding primitives that the reference
// delegates to third-party native code:
//   * exact global edit distance (replaces the edlib dependency,
//     reference graph_parser.py:110 — banded DP with Ukkonen band doubling,
//     exact for any inputs, fast for the high-identity overlaps seen in
//     assembly graphs);
//   * batch overlap-similarity computation straight from the packed read
//     store (real strand stored, reverse complements materialised on the fly
//     — node i^1 is the RC of node i, reference graph_parser.py:174-184);
//   * greedy decode walk inner loop (reference inference.py:70-157) over CSR
//     arrays.
//
// Exposed with a plain C ABI for ctypes.  Build: native/build.sh -> libgnnome.so
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline char complement(char c) {
  switch (c) {
    case 'A': return 'T';
    case 'C': return 'G';
    case 'G': return 'C';
    case 'T': return 'A';
    case 'a': return 't';
    case 'c': return 'g';
    case 'g': return 'c';
    case 't': return 'a';
    default:  return 'N';
  }
}

// Banded Levenshtein with band half-width k.  Returns the exact global edit
// distance if it is <= k, otherwise some value > k (caller must widen).
int64_t banded_levenshtein(const char* a, int64_t n, const char* b, int64_t m,
                           int64_t k) {
  if (n > m) { std::swap(a, b); std::swap(n, m); }
  if (m - n > k) return k + 1;
  const int64_t INF = k + 1;
  // dp row over diagonal window [i - k, i + k] intersect [0, m]
  std::vector<int64_t> prev(2 * k + 1, INF), cur(2 * k + 1, INF);
  // row 0: D[0][j] = j for j in [0, k]
  for (int64_t d = 0; d <= k && d + k < (int64_t)prev.size(); ++d) prev[k + d] = d;
  for (int64_t i = 1; i <= n; ++i) {
    int64_t lo = std::max<int64_t>(1, i - k);
    int64_t hi = std::min<int64_t>(m, i + k);
    std::fill(cur.begin(), cur.end(), INF);
    if (i - k <= 0) cur[k - i] = i;  // D[i][0] = i sits at offset j - i + k with j=0
    for (int64_t j = lo; j <= hi; ++j) {
      int64_t off = j - i + k;
      int64_t best = INF;
      // substitution / match from D[i-1][j-1] (same offset in prev)
      int64_t sub = prev[off] + (a[i - 1] == b[j - 1] ? 0 : 1);
      best = std::min(best, sub);
      // deletion from D[i-1][j] (offset + 1 in prev)
      if (off + 1 <= 2 * k) best = std::min(best, prev[off + 1] + 1);
      // insertion from D[i][j-1] (offset - 1 in cur)
      if (off - 1 >= 0) best = std::min(best, cur[off - 1] + 1);
      cur[off] = best;
    }
    std::swap(prev, cur);
  }
  int64_t off = m - n + k;
  return prev[off];
}

// Materialise the sequence of a node into buf.  Real (even) nodes are stored
// verbatim; virtual (odd) nodes are the reverse complement of their pair.
void node_slice(const char* blob, const int64_t* offsets, int64_t node,
                int64_t slice_start, int64_t slice_len, char* buf) {
  int64_t t = node >> 1;
  const char* base = blob + offsets[t];
  int64_t len = offsets[t + 1] - offsets[t];
  if ((node & 1) == 0) {
    std::memcpy(buf, base + slice_start, slice_len);
  } else {
    // virtual node char at position p == complement(base[len - 1 - p])
    for (int64_t p = 0; p < slice_len; ++p)
      buf[p] = complement(base[len - 1 - (slice_start + p)]);
  }
}

}  // namespace

extern "C" {

// Exact global edit distance (Ukkonen band doubling).  High-identity overlap
// pairs (the common case in assembly graphs) exit in the first narrow band;
// identical strings short-circuit entirely.  ``kcap > 0`` bounds the band:
// the result is exact when <= kcap, otherwise a band-limited LOWER-ish value
// (~kcap + 1) — callers that only need "similarity is at most 1 - kcap/L"
// (feature clamping) save the O(L * trueED) cost of diverged pairs.
static int64_t edit_distance_impl(const char* a, int64_t n, const char* b,
                                  int64_t m, int64_t kcap) {
  if (n == m && std::memcmp(a, b, n) == 0) return 0;
  int64_t k = std::max<int64_t>(std::llabs(n - m) + 8, 16);
  int64_t cap = std::max<int64_t>(std::max(n, m), 1);
  if (kcap > 0) cap = std::min(cap, std::max(k, kcap));
  while (true) {
    int64_t d = banded_levenshtein(a, n, b, m, k);
    if (d <= k || k >= cap) return d;
    k = std::min(cap, k * 4);
  }
}

int64_t gn_edit_distance(const char* a, int64_t n, const char* b, int64_t m) {
  return edit_distance_impl(a, n, b, m, 0);
}

// Batch overlap edit distances for assembly-graph edges.
//   blob/offsets: packed real-strand read store (num_reads+1 offsets)
//   src/dst:      node ids per edge (virtual = odd = RC of node-1)
//   ol:           overlap length per edge; comparison is
//                 seq(src)[-ol:] vs seq(dst)[:ol]  (reference graph_parser.py:110)
//   out:          edit distance per edge (-1 where ol <= 0)
// ``max_k_frac > 0`` caps each edge's band at max_k_frac * max(La, Lb):
// exact below the cap, band-limited (similarity clamp) above it — diverged
// pairs (random/wrong-strand overlaps) stop costing O(L * trueED).
void gn_overlap_edit_distance_batch_capped(
    const char* blob, const int64_t* offsets, const int32_t* src,
    const int32_t* dst, const int64_t* ol, int64_t n_edges,
    int32_t n_threads, double max_k_frac, int64_t* out) {
  if (n_threads < 1) n_threads = 1;
  auto worker = [&](int64_t tid) {
    std::vector<char> abuf, bbuf;
    for (int64_t e = tid; e < n_edges; e += n_threads) {
      int64_t L = ol[e];
      if (L <= 0) { out[e] = -1; continue; }
      int64_t s = src[e], d = dst[e];
      int64_t slen = offsets[(s >> 1) + 1] - offsets[s >> 1];
      int64_t dlen = offsets[(d >> 1) + 1] - offsets[d >> 1];
      // Python-slice semantics: seq[-L:] / seq[:L] clamp at the string ends
      // (reference graph_parser.py:110 relies on this when ol > read length).
      int64_t La = std::min(L, slen), Lb = std::min(L, dlen);
      int64_t kcap = max_k_frac > 0.0
          ? std::max<int64_t>(16, (int64_t)(max_k_frac * std::max(La, Lb)))
          : 0;
      abuf.resize(La); bbuf.resize(Lb);
      node_slice(blob, offsets, s, slen - La, La, abuf.data());
      node_slice(blob, offsets, d, 0, Lb, bbuf.data());
      out[e] = edit_distance_impl(abuf.data(), La, bbuf.data(), Lb, kcap);
    }
  };
  std::vector<std::thread> threads;
  for (int64_t t = 1; t < n_threads; ++t) threads.emplace_back(worker, t);
  worker(0);
  for (auto& th : threads) th.join();
}

void gn_overlap_edit_distance_batch(const char* blob, const int64_t* offsets,
                                    const int32_t* src, const int32_t* dst,
                                    const int64_t* ol, int64_t n_edges,
                                    int32_t n_threads, int64_t* out) {
  gn_overlap_edit_distance_batch_capped(blob, offsets, src, dst, ol, n_edges,
                                        n_threads, 0.0, out);
}

// Greedy walk (reference inference.py:70-111 greedy_forwards /
// :114-157 greedy_backwards_rc run on the reversed CSR).
//
//   row_ptr/col/eid:   CSR adjacency (successors) with edge ids
//   log_probs:         per-edge log sigmoid scores
//   visited:           byte mask over nodes (1 = already used); NOT mutated
//   start:             starting node
//   out_walk:          buffer of capacity max_walk
//   returns            walk length; *sum_log_prob accumulates chosen edges
//
// Marks nodes of the walk (and their RC pairs) in local_visited (caller
// allocates + zeroes, reused across calls via epoch stamping).
// early_stop_threshold: if >= 0 is log(p_threshold) and the walk stops when
// every candidate's log-prob is below it (reference inference.py:98-100);
// pass NaN (or any value with use_early_stop=0) to disable.
int64_t gn_greedy_walk(const int64_t* row_ptr, const int32_t* col,
                       const int64_t* eid, const float* log_probs,
                       const uint8_t* visited, int32_t* stamp,
                       int32_t epoch, int64_t start, int64_t max_walk,
                       int32_t use_early_stop, float log_p_threshold,
                       int32_t* out_walk, double* sum_log_prob) {
  double slp = 0.0;
  int64_t len = 0;
  int64_t current = start;
  while (len < max_walk) {
    out_walk[len++] = (int32_t)current;
    stamp[current] = epoch;
    stamp[current ^ 1] = epoch;
    int64_t lo = row_ptr[current], hi = row_ptr[current + 1];
    if (hi == lo) break;
    if (hi - lo == 1) {
      int64_t nb = col[lo];
      if (visited[nb] || stamp[nb] == epoch) break;
      slp += log_probs[eid[lo]];
      current = nb;
      continue;
    }
    // argmax over unvisited successors (ties -> first, matching torch.topk)
    float best_p = 0.f;
    int64_t best_nb = -1, best_eid = -1;
    for (int64_t k = lo; k < hi; ++k) {
      int64_t nb = col[k];
      if (visited[nb] || stamp[nb] == epoch) continue;
      float p = log_probs[eid[k]];
      if (best_nb < 0 || p > best_p) { best_p = p; best_nb = nb; best_eid = eid[k]; }
    }
    if (best_nb < 0) break;
    if (use_early_stop && best_p < log_p_threshold) break;
    slp += log_probs[best_eid];
    current = best_nb;
  }
  *sum_log_prob = slp;
  return len;
}

// Batch of candidate walks in parallel (the reference runs its 100
// candidates strictly sequentially through a 1-worker pool,
// inference.py:231-243).  Each candidate c seeds from edge
// (seed_src[c], seed_dst[c]): forward walk from dst, backward walk from
// src^1, both over the successor CSR (reference run_greedy_both_ways,
// inference.py:160-164).  Threads use private stamp arrays; the shared
// ``visited`` mask is read-only.
//
//   out_walks:  [n_cand, max_walk] buffer; walk c = fwd walk then bwd walk
//   out_lens:   [n_cand, 2] = (fwd_len, bwd_len)
//   out_slp:    [n_cand, 2] = (sum_log_prob_fwd, sum_log_prob_bwd)
void gn_greedy_walk_batch(const int64_t* row_ptr, const int32_t* col,
                          const int64_t* eid, const float* log_probs,
                          const uint8_t* visited, int64_t n_nodes,
                          const int32_t* seed_src, const int32_t* seed_dst,
                          int64_t n_cand, int64_t max_walk,
                          int32_t use_early_stop, float log_p_threshold,
                          int32_t n_threads,
                          int32_t* out_walks, int64_t* out_lens,
                          double* out_slp) {
  if (n_threads < 1) n_threads = 1;
  auto worker = [&](int64_t tid) {
    std::vector<int32_t> stamp(n_nodes, 0);
    int32_t epoch = 0;
    for (int64_t c = tid; c < n_cand; c += n_threads) {
      ++epoch;
      int64_t s = seed_src[c], d = seed_dst[c];
      stamp[s] = epoch; stamp[s ^ 1] = epoch;
      stamp[d] = epoch; stamp[d ^ 1] = epoch;
      int32_t* buf = out_walks + c * max_walk;
      double slp_f = 0.0, slp_b = 0.0;
      int64_t len_f = gn_greedy_walk(row_ptr, col, eid, log_probs, visited,
                                     stamp.data(), epoch, d, max_walk,
                                     use_early_stop, log_p_threshold,
                                     buf, &slp_f);
      int64_t len_b = gn_greedy_walk(row_ptr, col, eid, log_probs, visited,
                                     stamp.data(), epoch, s ^ 1,
                                     max_walk - len_f, use_early_stop,
                                     log_p_threshold, buf + len_f, &slp_b);
      out_lens[2 * c] = len_f;
      out_lens[2 * c + 1] = len_b;
      out_slp[2 * c] = slp_f;
      out_slp[2 * c + 1] = slp_b;
    }
  };
  std::vector<std::thread> threads;
  for (int64_t t = 1; t < n_threads; ++t) threads.emplace_back(worker, t);
  worker(0);
  for (auto& th : threads) th.join();
}

// One full decode iteration (reference inference.py:231-306 candidate loop):
// walk every candidate seed edge in parallel, splice each backward walk onto
// its forward walk, score the spliced walk's contig length (sum of clamped
// prefix lengths along the walk + the last node's read length,
// inference.py:30-37), and return the FIRST candidate achieving the maximum
// contig length (the reference keeps the first strict improvement while
// scanning candidates in seed order).
//
// Compared to calling gn_greedy_walk_batch + gn_walk_edge_ids from Python,
// this removes the [n_cand, n_nodes] walk staging buffer (400 MB per
// iteration at 1M nodes) and ~n_cand ctypes round trips per iteration —
// per-candidate walks live in thread-local scratch and only the winner is
// copied out.
//
//   prefix_len: per-edge contig contribution, pre-clamped >= 0 by the caller
//   out_walk:   capacity >= n_nodes; receives the winning spliced walk
// Returns the winner's walk length (0 when every candidate is a self-loop
// seed), or -1-c when candidate c's spliced walk contains an edge missing
// from the CSR (the Python path raises KeyError; impossible for graphs with
// the RC-twin invariant).
// ``stamp`` is a caller-persistent zero-initialised int32[n_threads*n_nodes]
// buffer and ``wbuf`` an int32[n_threads*2*n_nodes] walk scratch — allocating
// (and value-zeroing) them per call cost more than the walks themselves once
// most of the graph is visited (measured ~40% of threshold-0 decode).
// ``epoch_base`` must exceed every epoch a previous call used on this stamp
// buffer; each call consumes at most n_cand epochs (caller advances by n_cand
// and re-zeroes the stamps before int32 wraparound).
int64_t gn_decode_round(const int64_t* row_ptr, const int32_t* col,
                        const int64_t* eid, const float* log_probs,
                        const int64_t* prefix_len, const int64_t* read_len,
                        const uint8_t* visited, int64_t n_nodes,
                        const int32_t* seed_src, const int32_t* seed_dst,
                        int64_t n_cand, int32_t use_early_stop,
                        float log_p_threshold, int32_t n_threads,
                        int32_t* stamp_buf, int32_t* wbuf,
                        int32_t epoch_base,
                        int32_t* out_walk, int64_t* out_contig_len,
                        double* out_slp) {
  if (n_threads < 1) n_threads = 1;
  if ((int64_t)n_threads > n_cand) n_threads = (int32_t)std::max<int64_t>(n_cand, 1);
  struct Best {
    int64_t clen = -1, cand = -1, len = 0;
    double slp = 0.0;
    std::vector<int32_t> walk;
  };
  std::vector<Best> bests(n_threads);
  std::vector<int64_t> errs(n_cand, 0);
  auto worker = [&](int64_t tid) {
    int32_t* stamp = stamp_buf + tid * n_nodes;
    int32_t* fwd = wbuf + tid * 2 * n_nodes;
    int32_t* spliced = fwd + n_nodes;
    int32_t epoch = epoch_base;
    Best& best = bests[tid];
    for (int64_t c = tid; c < n_cand; c += n_threads) {
      int64_t s = seed_src[c], d = seed_dst[c];
      int64_t wlen = 0, clen = 0;
      double slp = 0.0;
      if (s != d) {  // self-loop seeds score 0 with an empty walk
        ++epoch;
        stamp[s] = epoch; stamp[s ^ 1] = epoch;
        stamp[d] = epoch; stamp[d ^ 1] = epoch;
        double slp_f = 0.0, slp_b = 0.0;
        int64_t len_f = gn_greedy_walk(row_ptr, col, eid, log_probs, visited,
                                       stamp, epoch, d, n_nodes,
                                       use_early_stop, log_p_threshold,
                                       fwd, &slp_f);
        int64_t len_b = gn_greedy_walk(row_ptr, col, eid, log_probs, visited,
                                       stamp, epoch, s ^ 1,
                                       n_nodes - len_f, use_early_stop,
                                       log_p_threshold, fwd + len_f,
                                       &slp_b);
        // splice: reversed-RC backward walk, then the forward walk
        for (int64_t i = 0; i < len_b; ++i)
          spliced[i] = fwd[len_f + len_b - 1 - i] ^ 1;
        std::memcpy(spliced + len_b, fwd, (size_t)len_f * sizeof(int32_t));
        wlen = len_f + len_b;
        slp = slp_f + slp_b;
        bool bad = false;
        for (int64_t i = 0; i + 1 < wlen; ++i) {
          int64_t u = spliced[i], v = spliced[i + 1], found = -1;
          for (int64_t k = row_ptr[u]; k < row_ptr[u + 1]; ++k)
            if (col[k] == v) { found = eid[k]; break; }
          if (found < 0) { errs[c] = -1 - c; bad = true; break; }
          clen += prefix_len[found];
        }
        if (bad) continue;
        if (wlen > 0) clen += read_len[spliced[wlen - 1]];
      }
      if (clen > best.clen) {  // strict >: first max wins (ascending c)
        best.clen = clen; best.cand = c; best.len = wlen; best.slp = slp;
        best.walk.assign(spliced, spliced + wlen);
      }
    }
  };
  std::vector<std::thread> threads;
  for (int64_t t = 1; t < n_threads; ++t) threads.emplace_back(worker, t);
  worker(0);
  for (auto& th : threads) th.join();
  for (int64_t c = 0; c < n_cand; ++c)
    if (errs[c] < 0) return errs[c];       // earliest candidate's error
  const Best* win = nullptr;
  for (const auto& b : bests) {
    if (b.cand < 0) continue;
    if (!win || b.clen > win->clen ||
        (b.clen == win->clen && b.cand < win->cand))
      win = &b;
  }
  if (!win) { *out_contig_len = 0; *out_slp = 0.0; return 0; }
  std::memcpy(out_walk, win->walk.data(), (size_t)win->len * sizeof(int32_t));
  *out_contig_len = win->clen;
  *out_slp = win->slp;
  return win->len;
}

// Weighted categorical seed-edge sampling over the not-yet-visited subgraph
// in ONE pass over the edge list (reference inference.py:54-67; the numpy
// path materialises the eligible-id array and several O(E) float64
// temporaries per decode iteration).  Weight of an alive edge (both endpoints
// unvisited) is max(probs[e], 1e-9); sample i selects the first edge whose
// running cumulative weight exceeds uniforms[i] * total.  Block sums
// accumulate in fixed block order, so results are deterministic for fixed
// inputs regardless of n_threads.  Returns k, or 0 when no edge is alive.
int64_t gn_sample_seed_edges(const int32_t* src, const int32_t* dst,
                             const float* probs, const uint8_t* visited,
                             int64_t n_edges, const double* uniforms,
                             int64_t k, int32_t n_threads, int64_t* out) {
  if (n_threads < 1) n_threads = 1;
  const int64_t B = 1 << 10;   // small blocks: per-sample scan <= B edges
  const int64_t n_blocks = (n_edges + B - 1) / B;
  std::vector<double> bsum(n_blocks, 0.0);
  std::vector<int64_t> blast(n_blocks, -1);    // last alive edge per block
  auto weight = [&](int64_t e) -> double {
    if (visited[src[e]] || visited[dst[e]]) return 0.0;
    double w = (double)probs[e];
    return w > 1e-9 ? w : 1e-9;
  };
  auto bworker = [&](int64_t tid) {
    for (int64_t b = tid; b < n_blocks; b += n_threads) {
      double acc = 0.0;
      int64_t last = -1;
      const int64_t hi = std::min(n_edges, (b + 1) * B);
      for (int64_t e = b * B; e < hi; ++e) {
        double w = weight(e);
        acc += w;
        if (w > 0.0) last = e;
      }
      bsum[b] = acc;
      blast[b] = last;
    }
  };
  {
    std::vector<std::thread> threads;
    for (int64_t t = 1; t < n_threads; ++t) threads.emplace_back(bworker, t);
    bworker(0);
    for (auto& th : threads) th.join();
  }
  std::vector<double> bpre(n_blocks + 1, 0.0);  // exclusive block prefix
  int64_t last_alive = -1;
  for (int64_t b = 0; b < n_blocks; ++b) {
    bpre[b + 1] = bpre[b] + bsum[b];
    if (blast[b] >= 0) last_alive = blast[b];
  }
  const double total = bpre[n_blocks];
  if (last_alive < 0 || total <= 0.0) return 0;
  for (int64_t i = 0; i < k; ++i) {
    const double target = uniforms[i] * total;
    int64_t lo = 0, hi = n_blocks;               // largest b: bpre[b] <= target
    while (lo + 1 < hi) {
      int64_t mid = (lo + hi) / 2;
      if (bpre[mid] <= target) lo = mid; else hi = mid;
    }
    double cum = bpre[lo];
    int64_t pick = -1;
    for (int64_t e = lo * B; e < n_edges; ++e) {
      double w = weight(e);
      cum += w;
      if (w > 0.0 && cum > target) { pick = e; break; }
    }
    out[i] = pick >= 0 ? pick : last_alive;      // rounding fallback
  }
  return k;
}

// Mark a decoded walk (and RC pairs) visited and absorb transitively
// jumped-over nodes: for each consecutive (u, v) of the walk, every node in
// succ(u) ∩ pred(v) and its RC pair is marked (reference inference.py:
// 316-322; the numpy path runs one intersect1d per walk edge).
//
// The intersection is O(deg_u + deg_v) via epoch stamping (neighbor lists are
// in arbitrary order, so a sorted merge is not available): succ(u) is stamped
// with a per-walk-edge epoch, then pred(v) is scanned against the stamps.
// ``stamp`` is a caller-persistent int32[n_nodes] buffer (zeroed once);
// ``epoch_base`` must exceed every previously used epoch (caller advances it
// by walk_len per call and re-zeroes on int32 wraparound).
//
// Nodes whose visited bit flips 0 -> 1 are appended to ``out_newly`` (the
// incremental seed sampler's dirty list); returns the count written.
int64_t gn_absorb_walk(const int64_t* csr_ptr, const int32_t* csr_col,
                       const int64_t* csc_ptr, const int32_t* csc_row,
                       const int32_t* walk, int64_t walk_len,
                       uint8_t* visited, int32_t* stamp, int32_t epoch_base,
                       int32_t* out_newly) {
  int64_t n_new = 0;
  auto mark = [&](int32_t node) {
    if (!visited[node]) { visited[node] = 1; out_newly[n_new++] = node; }
    const int32_t rc = node ^ 1;
    if (!visited[rc]) { visited[rc] = 1; out_newly[n_new++] = rc; }
  };
  for (int64_t i = 0; i < walk_len; ++i) mark(walk[i]);
  for (int64_t i = 0; i + 1 < walk_len; ++i) {
    const int64_t u = walk[i], v = walk[i + 1];
    const int32_t epoch = (int32_t)(epoch_base + i);
    for (int64_t a = csr_ptr[u]; a < csr_ptr[u + 1]; ++a)
      stamp[csr_col[a]] = epoch;
    for (int64_t b = csc_ptr[v]; b < csc_ptr[v + 1]; ++b) {
      const int32_t p = csc_row[b];
      if (stamp[p] == epoch) mark(p);
    }
  }
  return n_new;
}

// ---------------------------------------------------------------------------
// Incremental seed sampler: per-block alive-weight sums maintained across
// decode iterations so each sampling call is O(n_blocks + k*B) instead of
// O(E) (threshold-0 full-graph decode was sampler-bound: one O(E) pass per
// contig).  Exactness: block sums are RECOMPUTED over dirty blocks in the
// same fixed in-block order the one-shot gn_sample_seed_edges uses (dead
// edges contribute exactly 0.0), so the CDF — and every sample — is bitwise
// identical to the one-shot path.
//
// State (caller-owned numpy arrays):
//   ealive  uint8[E]    1 while both endpoints unvisited
//   weight  f64[E]      max(probs[e], 1e-9), fixed
//   bsum    f64[nb]     per-1024-block alive-weight sums (maintained by
//                       subtraction — ULP-level drift vs a fresh rescan, but
//                       every sample is still guaranteed to be an ALIVE edge
//                       and termination rides the exact integer alive count)
//   blast   i64[nb]     last alive edge id per block, -1 if none (exact)
//   alive_count i64[1]  exact number of alive edges (the termination signal)
constexpr int64_t GN_SAMPLER_B = 1 << 10;

void gn_sampler_init(const int32_t* src, const int32_t* dst,
                     const float* probs, const uint8_t* visited,
                     int64_t n_edges, int32_t n_threads,
                     uint8_t* ealive, double* weight, double* bsum,
                     int64_t* blast, int64_t* alive_count) {
  if (n_threads < 1) n_threads = 1;
  const int64_t B = GN_SAMPLER_B;
  const int64_t n_blocks = (n_edges + B - 1) / B;
  std::vector<int64_t> counts(n_threads, 0);
  auto worker = [&](int64_t tid) {
    int64_t cnt = 0;
    for (int64_t b = tid; b < n_blocks; b += n_threads) {
      double acc = 0.0;
      int64_t last = -1;
      const int64_t hi = std::min(n_edges, (b + 1) * B);
      for (int64_t e = b * B; e < hi; ++e) {
        const bool alive = !visited[src[e]] && !visited[dst[e]];
        ealive[e] = alive ? 1 : 0;
        double w = (double)probs[e];
        weight[e] = w > 1e-9 ? w : 1e-9;
        acc += alive ? weight[e] : 0.0;
        if (alive) { last = e; ++cnt; }
      }
      bsum[b] = acc;
      blast[b] = last;
    }
    counts[tid] = cnt;
  };
  std::vector<std::thread> threads;
  for (int64_t t = 1; t < n_threads; ++t) threads.emplace_back(worker, t);
  worker(0);
  for (auto& th : threads) th.join();
  int64_t total = 0;
  for (int64_t c : counts) total += c;
  *alive_count = total;
}

// Kill edges incident to newly visited nodes: O(sum deg(newly)) direct
// subtraction from the owning block's sum (a full-block rescan per dirty
// block costs ~E/2 per iteration on scattered edge orders — measured).
// blast stays exact via a bounded backward rescan when the block's last
// alive edge dies.
void gn_sampler_update(const int64_t* csr_ptr, const int32_t* csr_col,
                       const int64_t* csr_eid,
                       const int64_t* csc_ptr, const int32_t* csc_row,
                       const int64_t* csc_eid,
                       const int32_t* newly, int64_t n_newly,
                       int64_t n_edges, uint8_t* ealive, const double* weight,
                       double* bsum, int64_t* blast, int64_t* alive_count) {
  const int64_t B = GN_SAMPLER_B;
  int64_t killed = 0;
  auto kill = [&](int64_t e) {
    if (!ealive[e]) return;
    ealive[e] = 0;
    ++killed;
    const int64_t b = e / B;
    bsum[b] -= weight[e];
    if (blast[b] == e) {                  // find the new last alive edge
      int64_t last = -1;
      for (int64_t j = e - 1; j >= b * B; --j)
        if (ealive[j]) { last = j; break; }
      blast[b] = last;
      if (last < 0) bsum[b] = 0.0;        // empty block: cancel drift residue
    }
  };
  for (int64_t i = 0; i < n_newly; ++i) {
    const int64_t u = newly[i];
    for (int64_t k = csr_ptr[u]; k < csr_ptr[u + 1]; ++k) kill(csr_eid[k]);
    for (int64_t k = csc_ptr[u]; k < csc_ptr[u + 1]; ++k) kill(csc_eid[k]);
  }
  *alive_count -= killed;
}

// Sampling over the maintained state — the incremental counterpart of
// gn_sample_seed_edges.  Identical to the one-shot path right after init;
// after updates the CDF differs by ULP-level subtraction drift only, and
// every returned edge is guaranteed alive (the scan skips dead edges and the
// fallback is the exact per-block last-alive edge).
int64_t gn_sample_seed_edges_inc(const uint8_t* ealive, const double* weight,
                                 const double* bsum, const int64_t* blast,
                                 const int64_t* alive_count,
                                 int64_t n_edges, const double* uniforms,
                                 int64_t k, int64_t* out) {
  const int64_t B = GN_SAMPLER_B;
  const int64_t n_blocks = (n_edges + B - 1) / B;
  if (*alive_count <= 0) return 0;
  std::vector<double> bpre((size_t)n_blocks + 1, 0.0);
  int64_t last_alive = -1;
  for (int64_t b = 0; b < n_blocks; ++b) {
    // clamp ULP-negative drift residue out of the prefix
    bpre[b + 1] = bpre[b] + (bsum[b] > 0.0 ? bsum[b] : 0.0);
    if (blast[b] >= 0) last_alive = blast[b];
  }
  const double total = bpre[n_blocks];
  if (last_alive < 0) return 0;
  for (int64_t i = 0; i < k; ++i) {
    const double target = uniforms[i] * total;
    int64_t lo = 0, hi = n_blocks;               // largest b: bpre[b] <= target
    while (lo + 1 < hi) {
      int64_t mid = (lo + hi) / 2;
      if (bpre[mid] <= target) lo = mid; else hi = mid;
    }
    double cum = bpre[lo];
    int64_t pick = -1;
    for (int64_t e = lo * B; e < n_edges; ++e) {
      const double w = ealive[e] ? weight[e] : 0.0;
      cum += w;
      if (w > 0.0 && cum > target) { pick = e; break; }
    }
    out[i] = pick >= 0 ? pick : last_alive;      // rounding fallback
  }
  return k;
}

// Whole decode iterations natively: up to ``max_contigs`` rounds of
// sample -> walk-all-candidates -> threshold check -> absorb -> sampler
// update, with every piece of state caller-owned (so Python checkpoints
// between chunks exactly as the reference does every 10 contigs,
// inference.py:346-359).  Per-phase ctypes calls and per-iteration thread
// spawn/join dominated threshold-0 decode wall time (measured ~0.6 ms/round
// of pure overhead at 131k nodes); chunking amortises both.
//
// ``uniforms`` holds max_contigs * n_paths doubles consumed row-by-row —
// the same stream order as per-iteration rng.random(n_paths) calls, so
// chunked and per-iteration decode sample identically.
//
// Appends accepted walks into ``out_walks_flat`` (accepted walks are
// node-disjoint after absorption, so n_nodes + max_contigs bounds the total)
// with per-walk lengths/contig lengths, sets ``out_status`` (0 = chunk
// exhausted — call again; 1 = contig below len_threshold (or empty-walk
// winner) — decoding done; 2 = no alive edge remains) and returns the number
// of contigs accepted.  Returns a negative walk-validation error as
// gn_decode_round does.
int64_t gn_decode_chunk(
    const int64_t* row_ptr, const int32_t* col, const int64_t* eid,
    const int64_t* csc_ptr, const int32_t* csc_row, const int64_t* csc_eid,
    const int32_t* src, const int32_t* dst,
    const float* log_probs, const int64_t* prefix_len, const int64_t* read_len,
    int64_t n_nodes, int64_t n_edges,
    int64_t n_paths, int32_t use_early_stop, float log_p_threshold,
    int64_t len_threshold, int32_t n_threads,
    const double* uniforms, int64_t max_contigs,
    uint8_t* visited,
    uint8_t* ealive, const double* weight, double* bsum, int64_t* blast,
    int64_t* alive_count,
    int32_t* absorb_stamp, int32_t* absorb_epoch,
    int32_t* round_stamp, int32_t* round_wbuf, int32_t* round_epoch,
    int32_t* newly_buf, int64_t* seeds_buf,
    int32_t* out_walks_flat, int64_t* out_walk_lens, int64_t* out_contig_lens,
    int32_t* out_status) {
  int64_t n_done = 0;
  int64_t flat_pos = 0;
  std::vector<int32_t> seed_src((size_t)n_paths), seed_dst((size_t)n_paths);
  *out_status = 0;
  const int32_t eff_threads =
      n_threads < 1 ? 1
                    : (int32_t)std::min<int64_t>(n_threads, n_paths);
  // thread spawn/join costs ~0.2 ms/worker/round — worth paying only while
  // walks are long.  Adapt on the previous winner's length (walks shrink
  // monotonically-ish as the graph is consumed).
  int64_t prev_wlen = (int64_t)1 << 30;
  for (int64_t it = 0; it < max_contigs; ++it) {
    const int64_t got = gn_sample_seed_edges_inc(
        ealive, weight, bsum, blast, alive_count, n_edges,
        uniforms + it * n_paths, n_paths, seeds_buf);
    if (got == 0) { *out_status = 2; break; }
    for (int64_t i = 0; i < n_paths; ++i) {
      seed_src[i] = src[seeds_buf[i]];
      seed_dst[i] = dst[seeds_buf[i]];
    }
    if (*round_epoch > (int32_t)(0x7fffffff - n_paths - 16)) {
      std::memset(round_stamp, 0,
                  (size_t)eff_threads * n_nodes * sizeof(int32_t));
      *round_epoch = 0;
    }
    int64_t clen = 0;
    double slp = 0.0;
    const int32_t rt = prev_wlen >= 512 ? eff_threads : 1;
    const int64_t wlen = gn_decode_round(
        row_ptr, col, eid, log_probs, prefix_len, read_len, visited, n_nodes,
        seed_src.data(), seed_dst.data(), n_paths, use_early_stop,
        log_p_threshold, rt, round_stamp, round_wbuf, *round_epoch,
        out_walks_flat + flat_pos, &clen, &slp);
    prev_wlen = wlen;
    *round_epoch += (int32_t)n_paths;
    if (wlen < 0) return wlen;
    if (clen < len_threshold || wlen == 0) { *out_status = 1; break; }
    if (*absorb_epoch > (int32_t)(0x7fffffff - n_nodes - 16)) {
      std::memset(absorb_stamp, 0, (size_t)n_nodes * sizeof(int32_t));
      *absorb_epoch = 0;
    }
    const int64_t n_new = gn_absorb_walk(
        row_ptr, col, csc_ptr, csc_row, out_walks_flat + flat_pos, wlen,
        visited, absorb_stamp, *absorb_epoch + 1, newly_buf);
    *absorb_epoch += (int32_t)std::max<int64_t>(wlen, 1);
    if (n_new > 0)
      gn_sampler_update(row_ptr, col, eid, csc_ptr, csc_row, csc_eid,
                        newly_buf, n_new, n_edges, ealive, weight, bsum,
                        blast, alive_count);
    out_walk_lens[n_done] = wlen;
    out_contig_lens[n_done] = clen;
    flat_pos += wlen;
    ++n_done;
  }
  return n_done;
}

// Ground-truth label sweep over one strand's candidate subgraph (reference
// utils/labels.py:23-71; Python set/DFS version was the chromosome-scale
// bottleneck — O(E*C) membership rescans per accepted component).
//
// Nodes are 0..m-1 (caller relabels); ``fptr``/``fcol`` the forward CSR,
// ``rptr``/``rcol`` the reverse.  ``key_sweep`` is minimised to pick each
// round's start node (read start for the + strand, -read_end for the -
// strand) and ``key_high`` maximised for coverage extension (read end /
// -read_start).  Writes the accepted-component id per node (-1 = none);
// an edge is a true overlap iff both endpoints share a component id.
// O(V log V + E) total.  Returns the number of accepted components.
int64_t gn_gt_sweep(const int64_t* fptr, const int32_t* fcol,
                    const int64_t* rptr, const int32_t* rcol,
                    const int64_t* key_sweep, const int64_t* key_high,
                    int64_t m, int32_t* comp_id) {
  std::vector<uint8_t> remaining((size_t)m, 1);
  std::vector<uint8_t> in_full((size_t)m, 0), in_comp((size_t)m, 0);
  std::vector<int32_t> full, comp, stack, order((size_t)m);
  full.reserve((size_t)m); comp.reserve((size_t)m); stack.reserve((size_t)m);
  for (int64_t i = 0; i < m; ++i) order[i] = (int32_t)i;
  std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    return key_sweep[a] != key_sweep[b] ? key_sweep[a] < key_sweep[b]
                                        : a < b;
  });
  // first max/min in ascending id order (ties -> smallest id, matching the
  // reference's max/min over the sorted node list)
  int64_t final_node = 0, highest_reached = 0;
  for (int64_t i = 1; i < m; ++i) {
    if (key_high[i] > key_high[final_node]) final_node = i;
    if (key_high[i] < key_high[highest_reached]) highest_reached = i;
  }
  std::fill(comp_id, comp_id + m, -1);
  int32_t cid = 0;
  size_t oi = 0;
  while (true) {
    while (oi < order.size() && !remaining[order[oi]]) ++oi;
    if (oi >= order.size()) break;
    const int32_t s0 = order[oi];
    full.clear(); stack.clear();
    stack.push_back(s0); in_full[s0] = 1; full.push_back(s0);
    while (!stack.empty()) {           // forward reach within remaining
      const int32_t u = stack.back(); stack.pop_back();
      for (int64_t k = fptr[u]; k < fptr[u + 1]; ++k) {
        const int32_t v = fcol[k];
        if (remaining[v] && !in_full[v]) {
          in_full[v] = 1; full.push_back(v); stack.push_back(v);
        }
      }
    }
    int32_t hic = full[0];             // coverage-extremal node of the reach
    for (const int32_t u : full)
      if (key_high[u] > key_high[hic]
          || (key_high[u] == key_high[hic] && u < hic)) hic = u;
    comp.clear(); stack.clear();       // reverse reach within the component
    stack.push_back(hic); in_comp[hic] = 1; comp.push_back(hic);
    while (!stack.empty()) {
      const int32_t u = stack.back(); stack.pop_back();
      for (int64_t k = rptr[u]; k < rptr[u + 1]; ++k) {
        const int32_t v = rcol[k];
        if (in_full[v] && !in_comp[v]) {
          in_comp[v] = 1; comp.push_back(v); stack.push_back(v);
        }
      }
    }
    bool stop = false;
    if (comp.size() >= 2 && key_high[hic] >= key_high[highest_reached]) {
      highest_reached = hic;
      for (const int32_t u : comp) comp_id[u] = cid;
      ++cid;
      if (hic == (int32_t)final_node) stop = true;  // full coverage reached
    }
    for (const int32_t u : full) { remaining[u] = 0; in_full[u] = 0; }
    for (const int32_t u : comp) in_comp[u] = 0;
    if (stop) break;
  }
  return cid;
}

// FIFO multi-seed BFS relabelling over a (pair-level) CSR: new_of_old[i] is
// node i's BFS position, seeds taken in ascending id order (the banded node
// reordering behind halo plans and the BFS partitioner — parallel/halo.py
// band_order, graphs/partition.py _bfs_order_pairs; the pure-Python deque
// loop was minutes at chromosome scale).
void gn_bfs_order(const int64_t* ptr, const int32_t* col, int64_t m,
                  int64_t* new_of_old) {
  std::fill(new_of_old, new_of_old + m, -1);
  std::vector<int32_t> q;
  q.reserve((size_t)m);
  int64_t pos = 0;
  for (int64_t seed = 0; seed < m; ++seed) {
    if (new_of_old[seed] >= 0) continue;
    size_t head = q.size();
    q.push_back((int32_t)seed);
    new_of_old[seed] = pos++;
    while (head < q.size()) {
      const int32_t p = q[head++];
      for (int64_t k = ptr[p]; k < ptr[p + 1]; ++k) {
        const int32_t nb = col[k];
        if (new_of_old[nb] < 0) {
          new_of_old[nb] = pos++;
          q.push_back(nb);
        }
      }
    }
  }
}

// Edge ids along a walk: out_eids[i] = id of edge walk[i] -> walk[i+1]
// (first match in the CSR row).  Returns number of ids written, or the
// negated position (-1-i) of the first missing edge.
int64_t gn_walk_edge_ids(const int64_t* row_ptr, const int32_t* col,
                         const int64_t* eid, const int32_t* walk,
                         int64_t walk_len, int64_t* out_eids) {
  for (int64_t i = 0; i + 1 < walk_len; ++i) {
    int64_t u = walk[i], v = walk[i + 1];
    int64_t found = -1;
    for (int64_t k = row_ptr[u]; k < row_ptr[u + 1]; ++k) {
      if (col[k] == v) { found = eid[k]; break; }
    }
    if (found < 0) return -1 - i;
    out_eids[i] = found;
  }
  return walk_len - 1;
}

}  // extern "C"

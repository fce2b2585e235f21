// tempme_tpu_torch native host runtime.
//
// The port's copy of the JAX package's native/tempme_host.cpp (the same
// code): CSV event parsing, CSR temporal-adjacency construction, and
// exact-semantics temporal neighbor / motif-walk sampling on the host
// (bisect_left tie-exemption, uniform prefix sampling, the 3-case
// anonymous-walk analysis). The card's path samples with the CUDA kernels
// of ops/kernels/; this library is a host-side loader and an independent
// oracle for the samplers.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC -o libtempme_host.so
//        tempme_host.cpp
// Exposed via ctypes (tempme_tpu_torch/utils/native.py).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <numeric>
#include <random>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// CSV event parsing: ml_{name}.csv with header ",u,i,ts,label,idx"
// Returns number of events parsed, or -1 on error. Caller passes buffers of
// capacity `cap`; call once with cap=0 to get the required size.
// ---------------------------------------------------------------------------
int64_t th_load_csv(const char* path, int64_t cap, int32_t* src, int32_t* dst,
                    float* ts, float* label, int32_t* eidx) {
  FILE* f = fopen(path, "r");
  if (!f) return -1;
  char line[4096];
  if (!fgets(line, sizeof line, f)) { fclose(f); return -1; }  // header
  int64_t n = 0;
  while (fgets(line, sizeof line, f)) {
    if (cap > 0) {
      if (n >= cap) break;
      char* p = line;
      strtoll(p, &p, 10); p++;                    // index column
      src[n] = (int32_t)strtoll(p, &p, 10); p++;
      dst[n] = (int32_t)strtoll(p, &p, 10); p++;
      ts[n] = strtof(p, &p); p++;
      label[n] = strtof(p, &p); p++;
      eidx[n] = (int32_t)strtoll(p, &p, 10);
    }
    n++;
  }
  fclose(f);
  return n;
}

// ---------------------------------------------------------------------------
// CSR temporal adjacency (data/graph.py semantics): each event contributes a
// directed entry at both endpoints; per-node lists sorted by (ts, insertion).
// off has capacity num_nodes+1; ngh_* have capacity 2*n_events.
// ---------------------------------------------------------------------------
void th_build_csr(int64_t n_events, const int32_t* src, const int32_t* dst,
                  const int32_t* eidx, const float* ts, int64_t num_nodes,
                  int32_t* out_ngh, int32_t* out_eid, float* out_ts,
                  int64_t* out_off) {
  const int64_t t = 2 * n_events;
  std::vector<int64_t> owner(t);
  std::vector<int64_t> order(t);
  for (int64_t i = 0; i < n_events; ++i) {
    owner[i] = src[i];
    owner[n_events + i] = dst[i];
  }
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    if (owner[a] != owner[b]) return owner[a] < owner[b];
    float ta = ts[a % n_events], tb = ts[b % n_events];
    if (ta != tb) return ta < tb;
    return a < b;  // stable on insertion order
  });
  std::vector<int64_t> counts(num_nodes + 1, 0);
  for (int64_t i = 0; i < t; ++i) counts[owner[i] + 1]++;
  out_off[0] = 0;
  for (int64_t v = 0; v < num_nodes; ++v) out_off[v + 1] = out_off[v] + counts[v + 1];
  for (int64_t k = 0; k < t; ++k) {
    int64_t e = order[k];
    int64_t ev = e % n_events;
    out_ngh[k] = (e < n_events) ? dst[ev] : src[ev];
    out_eid[k] = eidx[ev];
    out_ts[k] = ts[ev];
  }
}

// bisect_left over one node's slice (the tie-exempting cut,
// utils/graph.py:511-530 / data/graph.py docstring)
static inline int64_t cut_left(const float* tsarr, int64_t lo, int64_t hi,
                               float x) {
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (tsarr[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// ---------------------------------------------------------------------------
// k=1 temporal neighbor sampling (utils/graph.py:197-231): uniform over the
// strict-history prefix, sorted ascending, zero-padded. OpenMP over queries.
// ---------------------------------------------------------------------------
void th_sample_neighbors(const int32_t* ngh, const int32_t* eid,
                         const float* tsa, const int64_t* off,
                         int64_t n_queries, const int32_t* q_node,
                         const float* q_time, int32_t n, uint64_t seed,
                         int32_t* out_node, int32_t* out_eid,
                         float* out_ts) {
#pragma omp parallel for schedule(static)
  for (int64_t q = 0; q < n_queries; ++q) {
    std::mt19937_64 rng(seed * 0x9E3779B97F4A7C15ULL + q);
    int64_t lo = off[q_node[q]], hi = off[q_node[q] + 1];
    int64_t cut = cut_left(tsa, lo, hi, q_time[q]) - lo;
    int32_t* on = out_node + q * n;
    int32_t* oe = out_eid + q * n;
    float* ot = out_ts + q * n;
    if (cut <= 0) {
      std::fill(on, on + n, 0);
      std::fill(oe, oe + n, 0);
      std::fill(ot, ot + n, 0.f);
      continue;
    }
    std::vector<int64_t> pick(n);
    for (int32_t j = 0; j < n; ++j) pick[j] = (int64_t)(rng() % (uint64_t)cut);
    std::sort(pick.begin(), pick.end());
    for (int32_t j = 0; j < n; ++j) {
      int64_t p = lo + pick[j];
      on[j] = ngh[p];
      oe[j] = eid[p];
      ot[j] = tsa[p];
    }
  }
}

// cut for the e-path: node 0 / edge 0 force empty (utils/graph.py:133)
static inline int64_t cut_by_edge(const float* tsa, const int64_t* off,
                                  const float* edge_ts, int32_t node,
                                  int32_t e) {
  if (node == 0 || e == 0) return 0;
  int64_t lo = off[node], hi = off[node + 1];
  return cut_left(tsa, lo, hi, edge_ts[e]) - lo;
}

// ---------------------------------------------------------------------------
// 3-event motif walks (utils/graph.py:265-476). Per (event-1) walk:
// step 2 uniform over the union of {src, tgt1} prefixes cut at e1;
// step 3 the 3-case candidate-restricted sampling with anonymous codes.
// Inputs: first-hop arrays [n_queries] flattened (one row per (b, n1, n2)).
// ---------------------------------------------------------------------------
void th_sample_walks(const int32_t* ngh, const int32_t* eid, const float* tsa,
                     const int64_t* off, const float* edge_ts,
                     int64_t n_walks, const int32_t* s1a, const int32_t* u1a,
                     const int32_t* e1a, uint64_t seed,
                     int32_t* out, float* out_t) {
  // out: per walk 8 int32: s2,u2,e2,s3,u3,e3,x,t ; out_t: t2,t3
#pragma omp parallel for schedule(static)
  for (int64_t w = 0; w < n_walks; ++w) {
    std::mt19937_64 rng(seed * 0xD1B54A32D192ED03ULL + w);
    int32_t s1 = s1a[w], u1 = u1a[w], e1 = e1a[w];
    int32_t* o = out + w * 8;
    float* ot = out_t + w * 2;
    std::fill(o, o + 8, 0);
    ot[0] = ot[1] = 0.f;

    // step 2: union of prefixes of s1 and u1 before e1
    int64_t ca = cut_by_edge(tsa, off, edge_ts, s1, e1);
    int64_t cb = cut_by_edge(tsa, off, edge_ts, u1, e1);
    int64_t total = ca + cb;
    int32_t s2 = 0, u2 = 0, e2 = 0;
    float t2 = 0.f;
    if (total > 0) {
      int64_t r = (int64_t)(rng() % (uint64_t)total);
      int64_t p = (r < ca) ? off[s1] + r : off[u1] + (r - ca);
      s2 = (r < ca) ? s1 : u1;
      u2 = ngh[p];
      e2 = eid[p];
      t2 = tsa[p];
    }
    o[0] = s2; o[1] = u2; o[2] = e2; ot[0] = t2;

    // step 3: case analysis (utils/graph.py:353-474)
    bool case1 = (s1 == s2) && (u1 != u2);
    bool case2 = !case1 && (u1 == s2) && (s1 != u2);
    int32_t a = case1 ? s1 : u1;
    int32_t x = case1 ? 2 : (case2 ? 3 : 1);
    int64_t cA = cut_by_edge(tsa, off, edge_ts, a, e2);
    int64_t cB = cut_by_edge(tsa, off, edge_ts, u2, e2);
    // collect candidates
    int64_t n_cand = 0;
    int32_t s3 = 0, u3 = 0, e3 = 0;
    float t3 = 0.f;
    // reservoir sampling (uniform over matches, single pass)
    auto consider = [&](int32_t srcn, int64_t p) {
      ++n_cand;
      if (rng() % (uint64_t)n_cand == 0) {
        s3 = srcn; u3 = ngh[p]; e3 = eid[p]; t3 = tsa[p];
      }
    };
    for (int64_t p = off[a]; p < off[a] + cA; ++p) {
      int32_t v = ngh[p];
      bool ok = case1 ? (v == u1 || v == u2)
                      : case2 ? (v == s1 || v == u2) : true;
      if (ok) consider(a, p);
    }
    for (int64_t p = off[u2]; p < off[u2] + cB; ++p) {
      int32_t v = ngh[p];
      bool ok = case1 ? (v == u1) : case2 ? (v == s1) : true;
      if (ok) consider(u2, p);
    }
    int32_t t = 0;
    if (n_cand > 0) {
      if (case1) {
        t = (s3 == s1 && u3 == u1) ? 1 : (s3 == s1 && u3 == u2) ? 2
            : (s3 == u1 && u3 == u2) ? 3 : 0;
      } else if (case2) {
        t = (s3 == u1 && u3 == s1) ? 1 : (s3 == u1 && u3 == u2) ? 3
            : (s3 == u2 && u3 == s1) ? 2 : 0;
      } else {
        t = (s3 == s1 && u3 != u1) ? 3 : (s3 == u1 && u3 != s1) ? 2
            : (s3 == s1 && u3 == u1) ? 1 : (s3 == u1 && u3 == s1) ? 1 : 0;
      }
    }
    o[3] = s3; o[4] = u3; o[5] = e3; o[6] = x; o[7] = t; ot[1] = t3;
  }
}

}  // extern "C"

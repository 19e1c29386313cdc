// Multilevel k-way graph partitioner (METIS-family algorithm), the
// port's copy of the reference's native/partition_ml.cpp.
//
// Heavy-edge-matching coarsening, greedy graph growing on the coarsest
// graph, and greedy boundary refinement with balance constraints at
// every uncoarsening step, sized for host planning on 100M+-edge graphs.
//
// Host code, not a kernel: pygim_tpu_torch/core/native.py compiles it
// with g++ at first use and calls partition_kway through ctypes
// (core/cluster.py).  The halo layout consumes the induced node order:
// sorting nodes by part makes each shard's contiguous row range a
// low-cut cluster, which shrinks the halo exchange.
//
// Determinism: all tie-breaks are index-ordered and the only RNG is a
// seeded mt19937 for visit orders, so results are reproducible per
// (graph, nparts, tol, seed).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <random>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Graph {
  int32_t n = 0;
  std::vector<int64_t> xadj;   // n+1
  std::vector<int32_t> adj;    // neighbor ids (symmetric, no self loops)
  std::vector<int32_t> ewgt;   // merged-edge weights
  std::vector<int32_t> vwgt;   // vertex weights (fine level: all 1)
  int64_t total_vwgt = 0;
};

// Symmetrize a CSR adjacency: undirected simple graph, self loops
// dropped, duplicate/reciprocal edges merged with accumulated weight.
Graph symmetrize(int32_t n, const int32_t* rowptr, const int32_t* colind) {
  Graph g;
  g.n = n;
  std::vector<int64_t> deg(static_cast<size_t>(n) + 1, 0);
  for (int32_t u = 0; u < n; ++u) {
    for (int32_t e = rowptr[u]; e < rowptr[u + 1]; ++e) {
      int32_t v = colind[e];
      if (v == u || v < 0 || v >= n) continue;
      deg[static_cast<size_t>(u) + 1]++;
      deg[static_cast<size_t>(v) + 1]++;
    }
  }
  std::vector<int64_t> xadj(static_cast<size_t>(n) + 1, 0);
  for (int32_t i = 0; i < n; ++i) xadj[i + 1] = xadj[i] + deg[i + 1];
  std::vector<int32_t> adj(static_cast<size_t>(xadj[n]));
  std::vector<int64_t> pos(xadj.begin(), xadj.end() - 1);
  for (int32_t u = 0; u < n; ++u) {
    for (int32_t e = rowptr[u]; e < rowptr[u + 1]; ++e) {
      int32_t v = colind[e];
      if (v == u || v < 0 || v >= n) continue;
      adj[static_cast<size_t>(pos[u]++)] = v;
      adj[static_cast<size_t>(pos[v]++)] = u;
    }
  }
  // per-row sort + dedup with weight accumulation
  g.xadj.assign(static_cast<size_t>(n) + 1, 0);
  std::vector<int32_t> cnt(static_cast<size_t>(n), 0);
#pragma omp parallel for schedule(dynamic, 4096)
  for (int32_t u = 0; u < n; ++u) {
    auto* b = adj.data() + xadj[u];
    auto* e = adj.data() + xadj[u + 1];
    std::sort(b, e);
    int32_t uniq = 0;
    for (auto* p = b; p != e;) {
      auto* q = p;
      while (q != e && *q == *p) ++q;
      uniq++;
      p = q;
    }
    cnt[u] = uniq;
  }
  for (int32_t i = 0; i < n; ++i) g.xadj[i + 1] = g.xadj[i] + cnt[i];
  g.adj.resize(static_cast<size_t>(g.xadj[n]));
  g.ewgt.resize(static_cast<size_t>(g.xadj[n]));
#pragma omp parallel for schedule(dynamic, 4096)
  for (int32_t u = 0; u < n; ++u) {
    const auto* b = adj.data() + xadj[u];
    const auto* e = adj.data() + xadj[u + 1];
    int64_t w = g.xadj[u];
    for (const auto* p = b; p != e;) {
      const auto* q = p;
      while (q != e && *q == *p) ++q;
      g.adj[static_cast<size_t>(w)] = *p;
      g.ewgt[static_cast<size_t>(w)] = static_cast<int32_t>(q - p);
      ++w;
      p = q;
    }
  }
  g.vwgt.assign(static_cast<size_t>(n), 1);
  g.total_vwgt = n;
  return g;
}

// Heavy-edge matching: returns cmap fine->coarse and the coarse count.
// Pairs whose combined weight exceeds ``max_vwgt`` are not matched, so
// no coarse vertex ever outgrows a fraction of a part (METIS's balance
// guard — without it, mega-hub chains starve the initial partition).
int32_t hem_match(const Graph& g, std::mt19937& rng, int64_t max_vwgt,
                  std::vector<int32_t>& cmap) {
  const int32_t n = g.n;
  std::vector<int32_t> order(static_cast<size_t>(n));
  std::iota(order.begin(), order.end(), 0);
  std::shuffle(order.begin(), order.end(), rng);
  std::vector<int32_t> match(static_cast<size_t>(n), -1);
  for (int32_t i = 0; i < n; ++i) {
    int32_t u = order[i];
    if (match[u] >= 0) continue;
    int32_t best = -1, bw = -1;
    for (int64_t e = g.xadj[u]; e < g.xadj[u + 1]; ++e) {
      int32_t v = g.adj[static_cast<size_t>(e)];
      if (match[v] >= 0) continue;
      if (g.vwgt[u] + g.vwgt[v] > max_vwgt) continue;
      int32_t w = g.ewgt[static_cast<size_t>(e)];
      if (w > bw || (w == bw && v < best)) {
        bw = w;
        best = v;
      }
    }
    if (best < 0) best = u;  // no unmatched neighbor: match with self
    match[u] = best;
    match[best] = u;
  }
  cmap.assign(static_cast<size_t>(n), -1);
  int32_t nc = 0;
  for (int32_t i = 0; i < n; ++i) {
    int32_t u = order[i];
    if (cmap[u] >= 0) continue;
    cmap[u] = nc;
    cmap[match[u]] = nc;  // self-match writes the same id twice
    nc++;
  }
  return nc;
}

// Contract g by cmap into a coarse graph (marker-array merge).
Graph contract(const Graph& g, const std::vector<int32_t>& cmap,
               int32_t nc) {
  Graph cg;
  cg.n = nc;
  cg.vwgt.assign(static_cast<size_t>(nc), 0);
  for (int32_t u = 0; u < g.n; ++u) cg.vwgt[cmap[u]] += g.vwgt[u];
  cg.total_vwgt = g.total_vwgt;
  // fine vertices of each coarse vertex
  std::vector<int64_t> cptr(static_cast<size_t>(nc) + 1, 0);
  for (int32_t u = 0; u < g.n; ++u) cptr[static_cast<size_t>(cmap[u]) + 1]++;
  for (int32_t c = 0; c < nc; ++c) cptr[c + 1] += cptr[c];
  std::vector<int32_t> members(static_cast<size_t>(g.n));
  {
    std::vector<int64_t> fill(cptr.begin(), cptr.end() - 1);
    for (int32_t u = 0; u < g.n; ++u)
      members[static_cast<size_t>(fill[cmap[u]]++)] = u;
  }
  cg.xadj.assign(static_cast<size_t>(nc) + 1, 0);
  std::vector<int32_t> where(static_cast<size_t>(nc), -1);
  std::vector<int32_t> nbr;
  std::vector<int32_t> nbw;
  nbr.reserve(1024);
  nbw.reserve(1024);
  // two-pass would re-walk edges; single pass with growing output
  std::vector<int32_t> out_adj;
  std::vector<int32_t> out_w;
  out_adj.reserve(g.adj.size() / 2);
  out_w.reserve(g.adj.size() / 2);
  for (int32_t c = 0; c < nc; ++c) {
    nbr.clear();
    nbw.clear();
    for (int64_t m = cptr[c]; m < cptr[c + 1]; ++m) {
      int32_t u = members[static_cast<size_t>(m)];
      for (int64_t e = g.xadj[u]; e < g.xadj[u + 1]; ++e) {
        int32_t cv = cmap[g.adj[static_cast<size_t>(e)]];
        if (cv == c) continue;  // contracted edge disappears
        int32_t slot = where[cv];
        if (slot < 0) {
          where[cv] = static_cast<int32_t>(nbr.size());
          nbr.push_back(cv);
          nbw.push_back(g.ewgt[static_cast<size_t>(e)]);
        } else {
          nbw[slot] += g.ewgt[static_cast<size_t>(e)];
        }
      }
    }
    for (size_t i = 0; i < nbr.size(); ++i) where[nbr[i]] = -1;
    out_adj.insert(out_adj.end(), nbr.begin(), nbr.end());
    out_w.insert(out_w.end(), nbw.begin(), nbw.end());
    cg.xadj[c + 1] = static_cast<int64_t>(out_adj.size());
  }
  cg.adj = std::move(out_adj);
  cg.ewgt = std::move(out_w);
  return cg;
}

// Greedy graph growing initial partition (GGGP).
void initial_partition(const Graph& g, int32_t nparts, std::mt19937& rng,
                       std::vector<int32_t>& part) {
  const int32_t n = g.n;
  part.assign(static_cast<size_t>(n), -1);
  const double target =
      static_cast<double>(g.total_vwgt) / static_cast<double>(nparts);
  std::vector<int32_t> seeds(static_cast<size_t>(n));
  std::iota(seeds.begin(), seeds.end(), 0);
  std::shuffle(seeds.begin(), seeds.end(), rng);
  size_t seed_i = 0;
  std::vector<int32_t> queue;
  for (int32_t p = 0; p + 1 < nparts; ++p) {
    double pw = 0;
    queue.clear();
    size_t head = 0;
    while (pw < target) {
      if (head == queue.size()) {
        // (re)seed from the next unassigned vertex
        while (seed_i < seeds.size() && part[seeds[seed_i]] >= 0) seed_i++;
        if (seed_i == seeds.size()) break;
        queue.push_back(seeds[seed_i]);
      }
      int32_t u = queue[head++];
      if (part[u] >= 0) continue;
      part[u] = p;
      pw += g.vwgt[u];
      for (int64_t e = g.xadj[u]; e < g.xadj[u + 1]; ++e) {
        int32_t v = g.adj[static_cast<size_t>(e)];
        if (part[v] < 0) queue.push_back(v);
      }
    }
  }
  for (int32_t u = 0; u < n; ++u)
    if (part[u] < 0) part[u] = nparts - 1;
}

// Repair starved parts: any part below ``minw`` grows one vertex at a
// time along its frontier, stealing a vertex only when the move
// STRICTLY shrinks the donor–receiver gap (so no oscillation is
// possible and the loop provably terminates).  With lumpy coarse-vertex
// weights the tolerance may remain slightly violated — finer levels
// (unit weights at the finest) re-run this and converge.
void balance_parts(const Graph& g, int32_t nparts, double tol,
                   std::vector<int32_t>& part) {
  const int32_t n = g.n;
  std::vector<int64_t> pw(static_cast<size_t>(nparts), 0);
  for (int32_t u = 0; u < n; ++u) pw[part[u]] += g.vwgt[u];
  const double target =
      static_cast<double>(g.total_vwgt) / static_cast<double>(nparts);
  const int64_t minw = static_cast<int64_t>(target * (1.0 - tol));
  std::vector<uint8_t> inf(static_cast<size_t>(n), 0);
  std::vector<int32_t> frontier;
  for (int32_t fix = 0; fix < nparts; ++fix) {
    int32_t p = 0;
    for (int32_t i = 1; i < nparts; ++i)
      if (pw[i] < pw[p]) p = i;
    if (pw[p] >= minw) break;
    // frontier = non-p vertices adjacent to p's region
    std::fill(inf.begin(), inf.end(), 0);
    frontier.clear();
    for (int32_t u = 0; u < n; ++u) {
      if (part[u] != p) continue;
      for (int64_t e = g.xadj[u]; e < g.xadj[u + 1]; ++e) {
        int32_t v = g.adj[static_cast<size_t>(e)];
        if (part[v] != p && !inf[v]) {
          inf[v] = 1;
          frontier.push_back(v);
        }
      }
    }
    size_t head = 0;
    while (pw[p] < minw) {
      int32_t u = -1;
      while (head < frontier.size()) {
        int32_t c = frontier[head++];
        const int64_t w = g.vwgt[c];
        // strict-improvement guard: donor stays above receiver
        if (part[c] != p && pw[part[c]] - w > pw[p] + w) {
          u = c;
          break;
        }
        inf[c] = 0;  // not stealable now; may re-enter later
      }
      if (u < 0) {
        // empty/exhausted frontier: teleport-seed from the heaviest part
        int32_t q = 0;
        for (int32_t i = 1; i < nparts; ++i)
          if (pw[i] > pw[q]) q = i;
        const int64_t gap = pw[q] - pw[p];
        for (int32_t c = 0; c < n && u < 0; ++c)
          if (part[c] == q && !inf[c] && 2 * g.vwgt[c] < gap) u = c;
        if (u < 0) break;  // no improving move exists anywhere
      }
      pw[part[u]] -= g.vwgt[u];
      pw[p] += g.vwgt[u];
      part[u] = p;
      for (int64_t e = g.xadj[u]; e < g.xadj[u + 1]; ++e) {
        int32_t v = g.adj[static_cast<size_t>(e)];
        if (part[v] != p && !inf[v]) {
          inf[v] = 1;
          frontier.push_back(v);
        }
      }
    }
  }
}

// Greedy boundary refinement with balance constraints.  Seeds a work
// queue with every boundary vertex; each successful move re-enqueues
// the moved vertex's neighbors — total work is O(boundary + moves·deg),
// not O(passes·E) full sweeps.  conn[] is a lazily-reset scratch.
void refine(const Graph& g, int32_t nparts, double tol,
            std::vector<int32_t>& part, int64_t max_moves) {
  const int32_t n = g.n;
  std::vector<int64_t> pw(static_cast<size_t>(nparts), 0);
  for (int32_t u = 0; u < n; ++u) pw[part[u]] += g.vwgt[u];
  const double target =
      static_cast<double>(g.total_vwgt) / static_cast<double>(nparts);
  const int64_t maxw = static_cast<int64_t>(target * (1.0 + tol)) + 1;
  const int64_t minw = static_cast<int64_t>(target * (1.0 - tol));
  std::vector<int64_t> conn(static_cast<size_t>(nparts), 0);
  std::vector<int32_t> touched;
  touched.reserve(64);
  std::vector<uint8_t> inq(static_cast<size_t>(n), 0);
  std::vector<int32_t> queue;
  queue.reserve(static_cast<size_t>(n) / 4);
  for (int32_t u = 0; u < n; ++u) {
    for (int64_t e = g.xadj[u]; e < g.xadj[u + 1]; ++e) {
      if (part[g.adj[static_cast<size_t>(e)]] != part[u]) {
        inq[u] = 1;
        queue.push_back(u);
        break;
      }
    }
  }
  size_t head = 0;
  int64_t moves = 0;
  while (head < queue.size() && moves < max_moves) {
    const int32_t u = queue[head++];
    inq[u] = 0;
    const int32_t own = part[u];
    touched.clear();
    for (int64_t e = g.xadj[u]; e < g.xadj[u + 1]; ++e) {
      int32_t p = part[g.adj[static_cast<size_t>(e)]];
      if (conn[p] == 0) touched.push_back(p);
      conn[p] += g.ewgt[static_cast<size_t>(e)];
    }
    const int64_t own_conn = conn[own];
    int32_t best = -1;
    int64_t best_gain = 0;
    const bool own_over = pw[own] > maxw;  // overweight: allow ≤0 gain
    for (int32_t p : touched) {
      if (p == own) continue;
      if (pw[p] + g.vwgt[u] > maxw) continue;
      if (pw[own] - g.vwgt[u] < minw && !own_over) continue;
      const int64_t gain = conn[p] - own_conn;
      if (gain > best_gain ||
          (own_over && best < 0 && gain >= best_gain) ||
          (gain == best_gain && best >= 0 && pw[p] < pw[best])) {
        best = p;
        best_gain = gain;
      }
    }
    for (int32_t p : touched) conn[p] = 0;
    if (best >= 0 && (best_gain > 0 || own_over)) {
      pw[own] -= g.vwgt[u];
      pw[best] += g.vwgt[u];
      part[u] = best;
      moves++;
      for (int64_t e = g.xadj[u]; e < g.xadj[u + 1]; ++e) {
        int32_t v = g.adj[static_cast<size_t>(e)];
        if (!inq[v]) {
          inq[v] = 1;
          queue.push_back(v);
        }
      }
    }
  }
}

int64_t edge_cut(const Graph& g, const std::vector<int32_t>& part) {
  int64_t cut = 0;
  for (int32_t u = 0; u < g.n; ++u)
    for (int64_t e = g.xadj[u]; e < g.xadj[u + 1]; ++e)
      if (part[g.adj[static_cast<size_t>(e)]] != part[u])
        cut += g.ewgt[static_cast<size_t>(e)];
  return cut / 2;  // each cut edge counted from both sides
}

}  // namespace

extern "C" {

// Multilevel k-way partition of the SYMMETRIZED graph of a CSR
// adjacency.  part_out[n] receives the part id per vertex.  Returns the
// achieved edge cut (undirected, merged-weight), or -1 on error.
int64_t partition_kway(int32_t n, const int32_t* rowptr,
                       const int32_t* colind, int32_t nparts, float tol,
                       int32_t seed, int32_t* part_out) {
  if (n <= 0 || nparts <= 0) return -1;
  if (nparts == 1) {
    std::memset(part_out, 0, sizeof(int32_t) * static_cast<size_t>(n));
    return 0;
  }
  std::mt19937 rng(static_cast<uint32_t>(seed));

  std::vector<Graph> levels;
  std::vector<std::vector<int32_t>> cmaps;
  levels.push_back(symmetrize(n, rowptr, colind));

  const int32_t coarse_stop =
      std::max<int32_t>(128, 24 * nparts);
  // no coarse vertex may outgrow a quarter-part: keeps GGGP feedable
  const int64_t max_vwgt =
      std::max<int64_t>(1, levels[0].total_vwgt / (4 * nparts));
  while (levels.back().n > coarse_stop) {
    std::vector<int32_t> cmap;
    int32_t nc = hem_match(levels.back(), rng, max_vwgt, cmap);
    if (nc > static_cast<int32_t>(0.97 * levels.back().n)) break;  // stall
    levels.push_back(contract(levels.back(), cmap, nc));
    cmaps.push_back(std::move(cmap));
  }

  std::vector<int32_t> part;
  initial_partition(levels.back(), nparts, rng, part);
  balance_parts(levels.back(), nparts, static_cast<double>(tol), part);
  refine(levels.back(), nparts, static_cast<double>(tol), part,
         8LL * levels.back().n);

  for (size_t li = levels.size() - 1; li > 0; --li) {
    const std::vector<int32_t>& cmap = cmaps[li - 1];
    const Graph& fine = levels[li - 1];
    std::vector<int32_t> fpart(static_cast<size_t>(fine.n));
    for (int32_t u = 0; u < fine.n; ++u) fpart[u] = part[cmap[u]];
    part = std::move(fpart);
    // finer weights are less lumpy: re-balance converges toward tol
    balance_parts(fine, nparts, static_cast<double>(tol), part);
    refine(fine, nparts, static_cast<double>(tol), part, 4LL * fine.n);
    levels.pop_back();  // free the coarse level before refining finer
  }

  int64_t cut = edge_cut(levels[0], part);
  std::memcpy(part_out, part.data(), sizeof(int32_t) * static_cast<size_t>(n));
  return cut;
}

}  // extern "C"

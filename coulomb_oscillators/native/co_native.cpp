// Native runtime components: exact kd-tree build + dual-tree traversal.
//
// Replacement for the reference's vendored native libraries
// (bb_segsort GPU segmented sort, parasort CPU sample-sort — SURVEY.md §2.6)
// and the persistent-kernel dual traversal (fmm_cart3_kdtree.cuh:416-567).
// The device compute path stays in XLA; these host routines run at
// tree-rebuild time only (amortized over tree_steps integrator steps).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libco_native.so co_native.cpp
// C ABI, loaded via ctypes (no pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Equal-count kd-tree build.
//
// pos:  [n*dim] float32 (row-major points)
// perm: [n] int32, preloaded with 0..n-1; on return, sorted slot -> original
//       particle index such that node i at level l covers slots
//       [n*i/2^l, n*(i+1)/2^l).
// Splits each node along its widest axis with std::nth_element (O(N) per
// level, no full sort — the host analogue of the reference's per-level
// bb_segsort passes, cheaper by a log factor).
// ---------------------------------------------------------------------------
void co_kdtree_build(const float* pos, int32_t* perm, int64_t n, int32_t L,
                     int32_t dim) {
  std::vector<int64_t> beg((size_t(1) << L) + 1);
  for (int32_t l = 0; l < L; ++l) {
    int64_t m = int64_t(1) << l;
    for (int64_t i = 0; i <= m; ++i) beg[i] = (n * i) / m;
    for (int64_t i = 0; i < m; ++i) {
      int64_t lo = beg[i], hi = beg[i + 1];
      if (hi - lo < 2) continue;
      // widest axis of this node's particles
      float mn[3] = {1e30f, 1e30f, 1e30f};
      float mx[3] = {-1e30f, -1e30f, -1e30f};
      for (int64_t k = lo; k < hi; ++k) {
        const float* p = pos + int64_t(perm[k]) * dim;
        for (int32_t a = 0; a < dim; ++a) {
          mn[a] = std::min(mn[a], p[a]);
          mx[a] = std::max(mx[a], p[a]);
        }
      }
      int32_t axis = 0;
      float w = mx[0] - mn[0];
      for (int32_t a = 1; a < dim; ++a)
        if (mx[a] - mn[a] > w) { w = mx[a] - mn[a]; axis = a; }
      int64_t mid = (n * (2 * i + 1)) / (2 * m);  // left child's end
      std::nth_element(perm + lo, perm + mid, perm + hi,
                       [&](int32_t a, int32_t b) {
                         return pos[int64_t(a) * dim + axis] <
                                pos[int64_t(b) * dim + axis];
                       });
    }
  }
}

// ---------------------------------------------------------------------------
// Dual-tree MAC traversal (kd_admissible semantics,
// fmm_cart3_kdtree.cuh:395-414): admissible iff
// (radius*Mf)^2 * max(diag2_a, diag2_b) < dist2,  Mf=(max(mult)/n)^(1/(3p+6)).
//
// Heap arrays over all 2^(L+1)-1 nodes.  Writes up to cap entries into
// m2l_out / p2p_out as (i, j) int32 pairs (unordered, i<=j; self pairs only
// in p2p).  Returns 0 on success; counts written via out params.  If a list
// overflows, keeps counting (so the caller can re-alloc) but stops writing.
// ---------------------------------------------------------------------------
int32_t co_traverse(const float* center, const float* lb, const float* rb,
                    const int32_t* mult, int32_t L, int64_t n, int32_t dim,
                    int32_t p, float radius, int32_t mult_floor,
                    int64_t boost_from, float sub_boost,
                    int32_t* m2l_out,
                    int64_t m2l_cap, int64_t* m2l_count, int32_t* p2p_out,
                    int64_t p2p_cap, int64_t* p2p_count) {
  const int64_t leaf0 = (int64_t(1) << L) - 1;
  const int64_t M = (int64_t(1) << (L + 1)) - 1;
  std::vector<float> sz(M);
  for (int64_t i = 0; i < M; ++i) {
    float s = 0;
    for (int32_t a = 0; a < dim; ++a) {
      float d = rb[i * dim + a] - lb[i * dim + a];
      s += d * d;
    }
    sz[i] = s;
  }
  const float expo = 1.0f / float(3 * p + 6);
  // (radius * Mf)^2 per node: Mf = (mult/n)^expo is monotone in mult, so
  // the pair value (radius*(max mult)^expo)^2 = max of the two node values.
  // Precomputing it hoists std::pow out of the traversal hot loop (the pow
  // dominated at deep refinements: millions of visited pairs).
  // mult_floor: Mf is floored at mult_floor/n so acceptance below that
  // granularity is never LOOSER than at mult_floor-sized cells.
  // boost_from/sub_boost: nodes at heap index >= boost_from (i.e. BELOW
  // the 128-lane block level) use radius*sub_boost — sub-block M2L
  // acceptances replace interactions the block-granularity MAC computed
  // EXACTLY (P2P), so they must carry negligible error; boosting the
  // acceptance radius by b cuts their per-pair error ~b^(p+1) while still
  // converting the far corners of near block pairs into M2L (measured:
  // unboosted sub-leaf MAC costs 4x force error at fixed (p, r); see
  // KdFmmEngine).
  std::vector<float> pm2(M);
  for (int64_t i = 0; i < M; ++i) {
    float m = float(std::max(mult[i], mult_floor));
    float Mf = std::pow(m / float(n), expo);
    float rad = (i >= boost_from) ? radius * sub_boost : radius;
    pm2[i] = (rad * Mf) * (rad * Mf);
  }
  int64_t nm = 0, np_ = 0;
  std::vector<std::pair<int64_t, int64_t>> stack;
  stack.reserve(4096);
  stack.emplace_back(0, 0);
  while (!stack.empty()) {
    auto [i, j] = stack.back();
    stack.pop_back();
    if (i != j) {
      float dist2 = 0;
      for (int32_t a = 0; a < dim; ++a) {
        float d = center[i * dim + a] - center[j * dim + a];
        dist2 += d * d;
      }
      if (std::max(pm2[i], pm2[j]) * std::max(sz[i], sz[j]) < dist2) {
        if (nm < m2l_cap) {
          m2l_out[2 * nm] = int32_t(i);
          m2l_out[2 * nm + 1] = int32_t(j);
        }
        ++nm;
        continue;
      }
    }
    bool leaf_i = i >= leaf0, leaf_j = j >= leaf0;
    if (leaf_i && leaf_j) {
      if (np_ < p2p_cap) {
        p2p_out[2 * np_] = int32_t(i - leaf0);
        p2p_out[2 * np_ + 1] = int32_t(j - leaf0);
      }
      ++np_;
      continue;
    }
    if (i == j) {
      int64_t l = 2 * i + 1, r = 2 * i + 2;
      stack.emplace_back(l, l);
      stack.emplace_back(l, r);
      stack.emplace_back(r, r);
    } else if (!leaf_i && (leaf_j || sz[i] >= sz[j])) {
      stack.emplace_back(2 * i + 1, j);
      stack.emplace_back(2 * i + 2, j);
    } else {
      stack.emplace_back(i, 2 * j + 1);
      stack.emplace_back(i, 2 * j + 2);
    }
  }
  *m2l_count = nm;
  *p2p_count = np_;
  return (nm <= m2l_cap && np_ <= p2p_cap) ? 0 : 1;
}

// ---------------------------------------------------------------------------
// Dual-granularity traversal + list construction, single pass.
//
// Runs the MAC dual traversal to the SUB-LEAF level L, then builds on the
// spot the two device-ready, target-sorted lists the engine consumes:
//   * near:  directed (target sub-leaf, packed source block) pairs, where
//     the packed int32 carries the source block id in its low bits and a
//     2^S-bit sub-leaf membership mask in its top bits (S = sub_depth);
//   * m2l:   directed (t <- s) heap-index pairs (both directions of every
//     admissible unordered pair).
// Counting sorts by target (O(K)); per-target block dedup + mask OR over
// small sorted runs.  Replaces the numpy post-processing that cost multiple
// seconds per rebuild on this single-core host.
// ---------------------------------------------------------------------------
int32_t co_traverse_fine(const float* center, const float* lb,
                         const float* rb, const int32_t* mult, int32_t L,
                         int32_t S, int64_t n, int32_t dim, int32_t p,
                         float radius, int32_t mult_floor, float sub_boost,
                         int32_t coll,
                         int32_t* m2l_out,
                         int64_t m2l_cap, int64_t* m2l_count,
                         int32_t* near_t_out, int32_t* near_p_out,
                         int64_t near_cap, int64_t* near_count) {
  const int64_t leaf0 = (int64_t(1) << L) - 1;
  const int64_t M = (int64_t(1) << (L + 1)) - 1;
  const int64_t Gsub = int64_t(1) << L;
  const int64_t Gblk = Gsub >> S;
  const int32_t ngroups = 1 << S;
  const int32_t shift = 32 - ngroups;
  std::vector<float> sz(M);
  for (int64_t i = 0; i < M; ++i) {
    float s = 0;
    for (int32_t a = 0; a < dim; ++a) {
      float d = rb[i * dim + a] - lb[i * dim + a];
      s += d * d;
    }
    sz[i] = s;
  }
  const float expo = 1.0f / float(3 * p + 6);
  // sub-block nodes (below the 128-lane block level) accept with a boosted
  // radius: see co_traverse on why.
  const int64_t boost_from = (int64_t(1) << (L - S + 1)) - 1;
  std::vector<float> pm2(M);
  for (int64_t i = 0; i < M; ++i) {
    float m = float(std::max(mult[i], mult_floor));
    float Mf = std::pow(m / float(n), expo);
    float rad = (i >= boost_from) ? radius * sub_boost : radius;
    pm2[i] = (rad * Mf) * (rad * Mf);
  }
  std::vector<std::pair<int32_t, int32_t>> m2l_u;  // unordered admissible
  std::vector<std::pair<int32_t, int32_t>> near_u; // unordered sub-leaf
  m2l_u.reserve(1 << 20);
  near_u.reserve(1 << 20);
  std::vector<std::pair<int64_t, int64_t>> stack;
  stack.reserve(4096);
  stack.emplace_back(0, 0);
  while (!stack.empty()) {
    auto [i, j] = stack.back();
    stack.pop_back();
    if (i != j) {
      float dist2 = 0;
      for (int32_t a = 0; a < dim; ++a) {
        float d = center[i * dim + a] - center[j * dim + a];
        dist2 += d * d;
      }
      if (std::max(pm2[i], pm2[j]) * std::max(sz[i], sz[j]) < dist2) {
        m2l_u.emplace_back(int32_t(i), int32_t(j));
        continue;
      }
    }
    bool leaf_i = i >= leaf0, leaf_j = j >= leaf0;
    if (leaf_i && leaf_j) {
      near_u.emplace_back(int32_t(i - leaf0), int32_t(j - leaf0));
      continue;
    }
    if (i == j) {
      int64_t l = 2 * i + 1, r = 2 * i + 2;
      stack.emplace_back(l, l);
      stack.emplace_back(l, r);
      stack.emplace_back(r, r);
    } else if (!leaf_i && (leaf_j || sz[i] >= sz[j])) {
      stack.emplace_back(2 * i + 1, j);
      stack.emplace_back(2 * i + 2, j);
    } else {
      stack.emplace_back(i, 2 * j + 1);
      stack.emplace_back(i, 2 * j + 2);
    }
  }

  // ---- directed M2L, counting-sorted by target ----
  const int64_t Kd = int64_t(m2l_u.size()) * 2;
  {
    std::vector<int64_t> cnt(M + 1, 0);
    for (auto& e : m2l_u) {
      ++cnt[e.first];
      ++cnt[e.second];
    }
    std::vector<int64_t> pos_(M + 1);
    int64_t run = 0;
    for (int64_t t = 0; t <= M; ++t) {
      pos_[t] = run;
      run += cnt[t];
    }
    *m2l_count = Kd;
    if (Kd <= m2l_cap) {
      for (auto& e : m2l_u) {
        int64_t k = pos_[e.first]++;
        m2l_out[2 * k] = e.first;
        m2l_out[2 * k + 1] = e.second;
        k = pos_[e.second]++;
        m2l_out[2 * k] = e.second;
        m2l_out[2 * k + 1] = e.first;
      }
    }
  }

  // ---- near: directed, grouped by (target, source block), mask-OR ----
  if (!coll) {
    *near_count = 0;
    return (Kd <= m2l_cap) ? 0 : 1;
  }
  std::vector<int64_t> cnt(Gsub + 1, 0);
  for (auto& e : near_u) {
    ++cnt[e.first];
    ++cnt[e.second];
  }
  std::vector<int64_t> start(Gsub + 1);
  int64_t run = 0;
  for (int64_t t = 0; t <= Gsub; ++t) {
    start[t] = run;
    run += cnt[t];
  }
  std::vector<int64_t> pos_(start);
  std::vector<int32_t> srcs(run);
  for (auto& e : near_u) {
    srcs[pos_[e.first]++] = e.second;
    srcs[pos_[e.second]++] = e.first;
  }
  int64_t nq = 0;
  bool ok = true;
  // per-target: sort the (few dozen) sub-leaf partners, emit one packed
  // entry per distinct block with OR'd group bits
  for (int64_t t = 0; t < Gsub; ++t) {
    int64_t lo = start[t], hi = lo + cnt[t];
    std::sort(srcs.begin() + lo, srcs.begin() + hi);
    int64_t k = lo;
    while (k < hi) {
      int32_t blk = srcs[k] >> S;
      uint32_t mask = 0;
      while (k < hi && (srcs[k] >> S) == blk) {
        mask |= uint32_t(1) << (srcs[k] & (ngroups - 1));
        ++k;
      }
      if (nq < near_cap) {
        near_t_out[nq] = int32_t(t);
        near_p_out[nq] = int32_t(uint32_t(blk) | (mask << shift));
      } else {
        ok = false;
      }
      ++nq;
    }
  }
  *near_count = nq;
  return (ok && Kd <= m2l_cap) ? 0 : 1;
}

// Node geometry from a sorted particle array (host fallback/check).
// pos_s: [n*dim] sorted; fills center/lb/rb ([M*dim]) and lam [M].
void co_node_geometry(const float* pos_s, int64_t n, int32_t L, int32_t dim,
                      float* center, float* lb, float* rb, float* lam) {
  for (int32_t l = 0; l <= L; ++l) {
    int64_t m = int64_t(1) << l;
    int64_t off = m - 1;
    for (int64_t i = 0; i < m; ++i) {
      int64_t lo = (n * i) / m, hi = (n * (i + 1)) / m;
      float mn[3] = {1e30f, 1e30f, 1e30f};
      float mx[3] = {-1e30f, -1e30f, -1e30f};
      double sum[3] = {0, 0, 0};
      for (int64_t k = lo; k < hi; ++k)
        for (int32_t a = 0; a < dim; ++a) {
          float v = pos_s[k * dim + a];
          mn[a] = std::min(mn[a], v);
          mx[a] = std::max(mx[a], v);
          sum[a] += v;
        }
      float diag2 = 0;
      for (int32_t a = 0; a < dim; ++a) {
        center[(off + i) * dim + a] = float(sum[a] / std::max<int64_t>(hi - lo, 1));
        lb[(off + i) * dim + a] = mn[a];
        rb[(off + i) * dim + a] = mx[a];
        float d = mx[a] - mn[a];
        diag2 += d * d;
      }
      lam[off + i] = std::max(0.5f * std::sqrt(diag2), 1e-30f);
    }
  }
}

}  // extern "C"

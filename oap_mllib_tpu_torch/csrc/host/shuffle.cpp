// Host-side ratings shuffle prep: block bucketing, the (block, user,
// item) order, distinct counts (the counterpart of the JAX package's
// native shuffle prep).
//
// The reference's native ALS shuffle (mllib-dal ALSShuffle.cpp) buckets
// packed Rating{i64 user, i64 item, f32 rating} records by user block
// (getPartiton, :30-35), exchanges them with oneCCL alltoall/alltoallv
// (:92-109), sorts by (user, item) (:111) and counts distinct users for
// the CSR row count (:50-60).  Records here are three parallel arrays.
//
// The permutation is the stable order by (block, user, item): the one
// numpy.lexsort((items, users, block)) gives and the JAX package's
// three-key std::stable_sort gives.  A block is a non-decreasing
// function of its user (min(user / kpb, n_blocks - 1) for users >= 0,
// or the block of explicit offsets), so that order is the stable order
// by (user, item) alone.  When (user - min, item - min) packs into 64
// bits the sort is a radix sort: one parallel stable scatter by the
// key's top 12 bits (a counting sort whose buckets are contiguous key
// ranges), then a stable LSD radix sort of each bucket's low bits,
// buckets shared among the threads.  Otherwise a comparison
// std::stable_sort gives the same permutation.
//
// Return codes: 0 ok; -1 bad arguments (keys_per_block or n_blocks below
// 1); -4 a negative user id on the uniform layout (its block is
// undefined); -3 out of memory or no thread.  No exception crosses the
// extern "C" boundary.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>
#include <numeric>
#include <thread>
#include <vector>

namespace {

// the host's cores, at most 64, and at least 65,536 records a thread
int pick_threads(int64_t n) {
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int t = hw > 0 ? hw : 1;
  if (t > 64) t = 64;
  int64_t by_size = n >> 16;
  if (by_size < 1) by_size = 1;
  if (t > by_size) t = static_cast<int>(by_size);
  return t;
}

// f(thread) on t threads, the caller's among them.
template <class F>
void parallel_for(int t, F f) {
  if (t <= 1) {
    f(0);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(static_cast<size_t>(t - 1));
  for (int i = 1; i < t; ++i) pool.emplace_back(f, i);
  f(0);
  for (auto& th : pool) th.join();
}

inline int64_t lo_of(int64_t n, int t, int i) { return n * i / t; }

inline int64_t block_of(int64_t u, int64_t kpb, int64_t nb, const int64_t* offsets) {
  if (offsets) {
    // clip(searchsorted(offsets, u, side="right") - 1, 0, nb - 1)
    int64_t b = (std::upper_bound(offsets, offsets + nb + 1, u) - offsets) - 1;
    return b < 0 ? 0 : (b > nb - 1 ? nb - 1 : b);
  }
  int64_t b = u / kpb;
  return b < nb - 1 ? b : nb - 1;
}

// Stable LSD radix sort of (k, p)[0, m) on the low `bits` bits of k.
void lsd_sort(uint64_t* k, int64_t* p, int64_t m, int bits, std::vector<uint64_t>& ks,
              std::vector<int64_t>& ps) {
  if (m <= 1 || bits <= 0) return;
  if (m <= 48) {  // insertion sort: stable, no scratch
    for (int64_t a = 1; a < m; ++a) {
      uint64_t kv = k[a];
      int64_t pv = p[a];
      int64_t b = a - 1;
      while (b >= 0 && k[b] > kv) {
        k[b + 1] = k[b];
        p[b + 1] = p[b];
        --b;
      }
      k[b + 1] = kv;
      p[b + 1] = pv;
    }
    return;
  }
  if (static_cast<int64_t>(ks.size()) < m) {
    ks.resize(static_cast<size_t>(m));
    ps.resize(static_cast<size_t>(m));
  }
  int passes = (bits + 10) / 11;
  int db = (bits + passes - 1) / passes;
  uint64_t mask = (uint64_t{1} << db) - 1;
  std::vector<int64_t> count(static_cast<size_t>(mask + 1));
  uint64_t* src_k = k;
  int64_t* src_p = p;
  uint64_t* dst_k = ks.data();
  int64_t* dst_p = ps.data();
  for (int pass = 0, shift = 0; pass < passes; ++pass, shift += db) {
    std::fill(count.begin(), count.end(), 0);
    for (int64_t a = 0; a < m; ++a) ++count[(src_k[a] >> shift) & mask];
    if (count[(src_k[0] >> shift) & mask] == m) continue;  // one digit: nothing moves
    int64_t run = 0;
    for (auto& c : count) {
      int64_t v = c;
      c = run;
      run += v;
    }
    for (int64_t a = 0; a < m; ++a) {
      int64_t at = count[(src_k[a] >> shift) & mask]++;
      dst_k[at] = src_k[a];
      dst_p[at] = src_p[a];
    }
    std::swap(src_k, dst_k);
    std::swap(src_p, dst_p);
  }
  if (src_k != k) {
    memcpy(k, src_k, static_cast<size_t>(m) * sizeof(uint64_t));
    memcpy(p, src_p, static_cast<size_t>(m) * sizeof(int64_t));
  }
}

int64_t prep(const int64_t* users, const int64_t* items, int64_t n, int64_t kpb, int64_t nb,
             const int64_t* offsets, int64_t* out_counts, int64_t* out_perm) {
  if (nb <= 0 || (!offsets && kpb <= 0) || n < 0) return -1;
  int t = pick_threads(n);
  std::vector<int64_t> hist(static_cast<size_t>(t) * nb, 0);
  std::vector<int64_t> umin(t, INT64_MAX), umax(t, INT64_MIN), imin(t, INT64_MAX),
      imax(t, INT64_MIN);
  std::atomic<bool> negative{false};
  parallel_for(t, [&](int w) {
    int64_t* h = hist.data() + static_cast<size_t>(w) * nb;
    int64_t ulo = INT64_MAX, uhi = INT64_MIN, ilo = INT64_MAX, ihi = INT64_MIN;
    for (int64_t a = lo_of(n, t, w), e = lo_of(n, t, w + 1); a < e; ++a) {
      int64_t u = users[a], it = items[a];
      if (!offsets && u < 0) {
        negative = true;
        break;
      }
      ++h[block_of(u, kpb, nb, offsets)];
      ulo = std::min(ulo, u);
      uhi = std::max(uhi, u);
      ilo = std::min(ilo, it);
      ihi = std::max(ihi, it);
    }
    umin[w] = ulo;
    umax[w] = uhi;
    imin[w] = ilo;
    imax[w] = ihi;
  });
  if (negative) return -4;
  for (int64_t b = 0; b < nb; ++b) {
    int64_t c = 0;
    for (int w = 0; w < t; ++w) c += hist[static_cast<size_t>(w) * nb + b];
    out_counts[b] = c;
  }
  if (n == 0) return 0;
  int64_t u0 = *std::min_element(umin.begin(), umin.end());
  int64_t u1 = *std::max_element(umax.begin(), umax.end());
  int64_t i0 = *std::min_element(imin.begin(), imin.end());
  int64_t i1 = *std::max_element(imax.begin(), imax.end());
  unsigned __int128 span_u = static_cast<uint64_t>(u1) - static_cast<uint64_t>(u0) + 1;
  unsigned __int128 span_i = static_cast<uint64_t>(i1) - static_cast<uint64_t>(i0) + 1;
  if (span_u * span_i - 1 > static_cast<unsigned __int128>(UINT64_MAX)) {
    // the key does not pack: a comparison sort of the same order
    std::iota(out_perm, out_perm + n, 0);
    std::stable_sort(out_perm, out_perm + n, [&](int64_t a, int64_t b) {
      if (users[a] != users[b]) return users[a] < users[b];
      return items[a] < items[b];
    });
    return 0;
  }
  const uint64_t si = static_cast<uint64_t>(span_i);
  auto key = [&](int64_t a) {
    return (static_cast<uint64_t>(users[a]) - static_cast<uint64_t>(u0)) * si +
           (static_cast<uint64_t>(items[a]) - static_cast<uint64_t>(i0));
  };
  uint64_t max_key = static_cast<uint64_t>(span_u * span_i - 1);
  int bits = max_key ? 64 - __builtin_clzll(max_key) : 0;
  if (bits == 0) {  // every record has one key
    std::iota(out_perm, out_perm + n, 0);
    return 0;
  }
  int top = bits < 12 ? bits : 12;
  int shift = bits - top;
  int64_t nbuckets = int64_t{1} << top;
  std::vector<uint64_t> keys(static_cast<size_t>(n));
  std::vector<int64_t> bh(static_cast<size_t>(t) * nbuckets, 0);
  // the counting sort by the top digit: histograms, then a stable scatter
  parallel_for(t, [&](int w) {
    int64_t* h = bh.data() + static_cast<size_t>(w) * nbuckets;
    for (int64_t a = lo_of(n, t, w), e = lo_of(n, t, w + 1); a < e; ++a) ++h[key(a) >> shift];
  });
  std::vector<int64_t> start(static_cast<size_t>(nbuckets) + 1, 0);
  int64_t run = 0;
  for (int64_t b = 0; b < nbuckets; ++b) {
    start[b] = run;
    for (int w = 0; w < t; ++w) {
      int64_t& c = bh[static_cast<size_t>(w) * nbuckets + b];
      int64_t v = c;
      c = run;
      run += v;
    }
  }
  start[nbuckets] = run;
  parallel_for(t, [&](int w) {
    int64_t* at = bh.data() + static_cast<size_t>(w) * nbuckets;
    for (int64_t a = lo_of(n, t, w), e = lo_of(n, t, w + 1); a < e; ++a) {
      uint64_t k = key(a);
      int64_t pos = at[k >> shift]++;
      keys[pos] = k;
      out_perm[pos] = a;
    }
  });
  // each bucket's low bits, buckets handed out in turn
  std::atomic<int64_t> next{0};
  parallel_for(t, [&](int) {
    std::vector<uint64_t> ks;
    std::vector<int64_t> ps;
    for (int64_t b; (b = next.fetch_add(1)) < nbuckets;) {
      int64_t lo = start[b], m = start[b + 1] - lo;
      lsd_sort(keys.data() + lo, out_perm + lo, m, shift, ks, ps);
    }
  });
  return 0;
}

template <size_t E>
void gather_fixed(const char* src, const int64_t* perm, int64_t lo, int64_t hi, char* dst) {
  for (int64_t a = lo; a < hi; ++a) memcpy(dst + a * E, src + perm[a] * E, E);
}

}  // namespace

extern "C" {

// Block counts (n_blocks) and the stable (block, user, item) permutation
// (n) of the records.  offsets: null for the uniform layout
// (keys_per_block), else the (n_blocks + 1,) monotone block boundaries.
int64_t oap_shuffle_prep(const int64_t* users, const int64_t* items, int64_t n,
                         int64_t keys_per_block, int64_t n_blocks, const int64_t* offsets,
                         int64_t* out_counts, int64_t* out_perm) {
  try {
    return prep(users, items, n, keys_per_block, n_blocks, offsets, out_counts, out_perm);
  } catch (...) {
    return -3;
  }
}

// dst[a] = src[perm[a]] for elements of elem_size bytes, on the host's
// cores: the prep order's reads are random, so one core waits on memory.
int64_t oap_gather(const void* src, int64_t elem_size, const int64_t* perm, int64_t n,
                   void* dst) {
  if (n < 0 || elem_size <= 0) return -1;
  try {
    const char* s = static_cast<const char*>(src);
    char* d = static_cast<char*>(dst);
    int t = pick_threads(n);
    parallel_for(t, [&](int w) {
      int64_t lo = lo_of(n, t, w), hi = lo_of(n, t, w + 1);
      switch (elem_size) {
        case 4: gather_fixed<4>(s, perm, lo, hi, d); break;
        case 8: gather_fixed<8>(s, perm, lo, hi, d); break;
        default:
          for (int64_t a = lo; a < hi; ++a)
            memcpy(d + a * elem_size, s + perm[a] * elem_size, static_cast<size_t>(elem_size));
      }
    });
    return 0;
  } catch (...) {
    return -3;
  }
}

// Distinct consecutive keys of a sorted array: the CSR row count.
// (~ distinct_count, ALSShuffle.cpp:50-60)
int64_t oap_distinct_count(const int64_t* sorted_keys, int64_t n) {
  if (n <= 0) return 0;
  int64_t count = 1;
  for (int64_t a = 1; a < n; ++a) count += sorted_keys[a] != sorted_keys[a - 1];
  return count;
}

}  // extern "C"

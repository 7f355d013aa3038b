// ALS grouped-edge layout prep on the host (~ the reference's host-side
// data prep in ALSDALImpl.cpp:184-230, which built per-rank CSR tables
// before handing off to the device kernels).  The numpy route
// (ops/als_ops.build_grouped_edges_np) is argsort-bound — O(nnz log nnz)
// plus several full-size temporaries; this is a stable counting sort by
// destination, O(nnz + n_dst), filling the padded (G, P) blocks in one
// pass.  Built with the host compiler at first use (ops/host_prep.py).
//
// Error contract (shared by both entry points): -1 = bad input (P<=0,
// n_dst<=0, or a destination id outside [0, n_dst)); -2 = allocation
// failure (the O(n_dst) counts buffer).  The binding raises on either.
// No exception ever crosses the extern "C" boundary.

#include <algorithm>
#include <cstdint>
#include <new>
#include <vector>

namespace {

// counts per destination; returns false on out-of-range ids
bool count_dsts(const int64_t* dst, int64_t nnz, int64_t n_dst,
                std::vector<int64_t>& counts) {
  counts.assign(static_cast<size_t>(n_dst), 0);
  for (int64_t e = 0; e < nnz; ++e) {
    int64_t d = dst[e];
    if (d < 0 || d >= n_dst) return false;
    counts[static_cast<size_t>(d)]++;
  }
  return true;
}

}  // namespace

extern "C" {

// Total padded edge count the grouped layout produces for one side:
// each destination's edge list rounds up to a multiple of P.  Also the
// input of the COO-fallback blowup guard (ops/als_ops.py
// grouped_padded_edges).
int64_t oap_als_grouped_total(const int64_t* dst, int64_t nnz, int64_t n_dst,
                              int64_t P) {
  if (P <= 0 || n_dst <= 0 || nnz < 0) return -1;
  try {
    std::vector<int64_t> counts;
    if (!count_dsts(dst, nnz, n_dst, counts)) return -1;
    int64_t total = 0;
    for (int64_t d = 0; d < n_dst; ++d)
      total += ((counts[static_cast<size_t>(d)] + P - 1) / P) * P;
    return total;
  } catch (const std::bad_alloc&) {
    return -2;
  } catch (...) {
    return -2;
  }
}

// Fill the padded grouped layout.  Outputs are caller-allocated with
// capacity `total` (= oap_als_grouped_total) for src_g/conf_g/valid_g and
// total/P for group_dst, and MUST be pre-zeroed (pad slots keep src=0,
// conf=0, valid=0).  The capacity is validated BEFORE any output write,
// so a stale/mismatched capacity returns -1 without touching the
// buffers.  Edges keep their input order within each destination
// (stable, matching the NumPy path's stable argsort).  Returns total.
int64_t oap_als_group_edges(const int64_t* dst, const int64_t* src,
                            const float* conf, int64_t nnz, int64_t n_dst,
                            int64_t P, int64_t capacity, int32_t* src_g,
                            float* conf_g, float* valid_g,
                            int32_t* group_dst) {
  if (P <= 0 || n_dst <= 0 || nnz < 0) return -1;
  try {
    std::vector<int64_t> counts;
    if (!count_dsts(dst, nnz, n_dst, counts)) return -1;
    // per-destination padded start offsets; validate capacity before
    // writing a single output element
    std::vector<int64_t> start(static_cast<size_t>(n_dst), 0);
    int64_t total = 0;
    for (int64_t d = 0; d < n_dst; ++d) {
      start[static_cast<size_t>(d)] = total;
      total += ((counts[static_cast<size_t>(d)] + P - 1) / P) * P;
    }
    if (total != capacity) return -1;
    int64_t gidx = 0;
    for (int64_t d = 0; d < n_dst; ++d) {
      int64_t padded =
          ((counts[static_cast<size_t>(d)] + P - 1) / P) * P;
      for (int64_t g = 0; g < padded / P; ++g)
        group_dst[gidx++] = static_cast<int32_t>(d);
    }
    // stable scatter: slot = start[d] + (running fill of d)
    std::vector<int64_t>& fill = counts;  // reuse as fill cursors
    std::fill(fill.begin(), fill.end(), 0);
    for (int64_t e = 0; e < nnz; ++e) {
      int64_t d = dst[e];
      int64_t slot =
          start[static_cast<size_t>(d)] + fill[static_cast<size_t>(d)]++;
      src_g[slot] = static_cast<int32_t>(src[e]);
      conf_g[slot] = conf[e];
      valid_g[slot] = 1.0f;
    }
    return total;
  } catch (const std::bad_alloc&) {
    return -2;
  } catch (...) {
    return -2;
  }
}

}  // extern "C"

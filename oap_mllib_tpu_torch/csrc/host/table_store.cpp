// Host-side table store: a handle-based registry of dense row-major
// float64 buffers (the port's copy of the JAX package's table store).
//
// The reference's native table layer (mllib-dal OneDAL.cpp) memcpy'd JVM
// double[] batches into oneDAL HomogenNumericTables (cSetDoubleBatch,
// OneDAL.cpp:50-60), appended tables into a RowMergedNumericTable
// (cAddNumericTable, :67-76) and freed native memory explicitly
// (cFreeDataMemory, :83-89).  This store owns 64-byte aligned host
// buffers that are filled batch by batch and handed on in one zero-copy
// view: native.table_view wraps the pointer in a numpy array, and
// torch.from_numpy of that view shares the memory.
//
// Handles are process-global ints; every call is thread-safe.  A bad
// handle returns -1 (nullptr from oap_table_data).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>

namespace {

struct DenseTable {
  double* data = nullptr;  // row-major, 64-byte aligned
  int64_t rows = 0;        // valid rows
  int64_t capacity = 0;    // allocated rows
  int64_t cols = 0;
};

std::mutex g_mu;
std::map<int64_t, DenseTable> g_tables;
int64_t g_next_handle = 1;

double* aligned_alloc_rows(int64_t rows, int64_t cols) {
  void* p = nullptr;
  size_t bytes = static_cast<size_t>(rows) * cols * sizeof(double);
  if (bytes == 0) bytes = 64;
  if (posix_memalign(&p, 64, bytes) != 0) return nullptr;
  return static_cast<double*>(p);
}

// Append while g_mu is held.  Returns the new row count or -1.
int64_t append_locked(DenseTable& t, const double* batch, int64_t n_rows) {
  if (n_rows < 0) return -1;
  if (t.rows + n_rows > t.capacity) {
    int64_t new_cap = t.capacity ? t.capacity : 64;
    while (new_cap < t.rows + n_rows) new_cap *= 2;
    double* nb = aligned_alloc_rows(new_cap, t.cols);
    if (!nb) return -1;
    memcpy(nb, t.data, static_cast<size_t>(t.rows) * t.cols * sizeof(double));
    free(t.data);
    t.data = nb;
    t.capacity = new_cap;
  }
  if (n_rows) {
    memcpy(t.data + t.rows * t.cols, batch,
           static_cast<size_t>(n_rows) * t.cols * sizeof(double));
  }
  t.rows += n_rows;
  return t.rows;
}

}  // namespace

extern "C" {

// An empty table of the given capacity; returns its handle or -1.
int64_t oap_table_create(int64_t capacity_rows, int64_t cols) {
  if (capacity_rows < 0 || cols <= 0) return -1;
  double* buf = aligned_alloc_rows(capacity_rows, cols);
  if (!buf) return -1;
  std::lock_guard<std::mutex> lk(g_mu);
  int64_t h = g_next_handle++;
  g_tables[h] = DenseTable{buf, 0, capacity_rows, cols};
  return h;
}

// Append a batch of rows (row-major doubles), growing past capacity.
// Returns the new row count or -1.  (~ cSetDoubleBatch)
int64_t oap_table_append(int64_t handle, const double* batch, int64_t n_rows) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_tables.find(handle);
  if (it == g_tables.end()) return -1;
  return append_locked(it->second, batch, n_rows);
}

// Append src's rows to dst and free src, atomically under the registry
// lock.  Returns dst's row count or -1.  (~ cAddNumericTable)
int64_t oap_table_merge(int64_t dst, int64_t src) {
  std::lock_guard<std::mutex> lk(g_mu);
  if (dst == src) return -1;
  auto it = g_tables.find(src);
  auto jt = g_tables.find(dst);
  if (it == g_tables.end() || jt == g_tables.end()) return -1;
  if (jt->second.cols != it->second.cols) return -1;
  int64_t r = append_locked(jt->second, it->second.data, it->second.rows);
  if (r < 0) return -1;
  free(it->second.data);
  g_tables.erase(it);
  return r;
}

int64_t oap_table_rows(int64_t handle) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_tables.find(handle);
  return it == g_tables.end() ? -1 : it->second.rows;
}

int64_t oap_table_cols(int64_t handle) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_tables.find(handle);
  return it == g_tables.end() ? -1 : it->second.cols;
}

// The data pointer for a zero-copy view (the caller keeps the table
// alive while the view lives); nullptr for a bad handle.
double* oap_table_data(int64_t handle) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_tables.find(handle);
  return it == g_tables.end() ? nullptr : it->second.data;
}

// Copy up to max_rows valid rows out; returns the rows copied or -1.
int64_t oap_table_copy_out(int64_t handle, double* out, int64_t max_rows) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_tables.find(handle);
  if (it == g_tables.end() || max_rows < 0) return -1;
  DenseTable& t = it->second;
  int64_t n = t.rows < max_rows ? t.rows : max_rows;
  if (n) memcpy(out, t.data, static_cast<size_t>(n) * t.cols * sizeof(double));
  return n;
}

// Free a table.  (~ cFreeDataMemory)
int64_t oap_table_free(int64_t handle) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_tables.find(handle);
  if (it == g_tables.end()) return -1;
  free(it->second.data);
  g_tables.erase(it);
  return 0;
}

// Live tables (leak checks).
int64_t oap_table_count() {
  std::lock_guard<std::mutex> lk(g_mu);
  return static_cast<int64_t>(g_tables.size());
}

}  // extern "C"

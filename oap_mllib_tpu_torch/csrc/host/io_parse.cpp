// File parsers of the example formats: libsvm, dense CSV and
// "user<sep>item<sep>rating" lines, in parallel over a memory map.
//
// The reference read its example data through Spark (libsvm with
// spark.read.format, CSV, MovieLens ratings parsed in
// examples/als/.../ALSExample.scala).  The contract here is the port's
// plain Python readers (data/io.py), which are the JAX package's Python
// path: each parser gives their arrays, or an error where they raise.
//
// - ratings: a line is split at the separator (str.split: literal,
//   non-overlapping, left to right) and its first three fields are
//   taken, so MovieLens's user::item::rating::timestamp lines read; ids
//   parse as Python's int() into int64 (exact above 2^53), the rating as
//   float() rounded once to float32.
// - csv: numpy.loadtxt(delimiter=d, comments="#"): a '#' ends a line's
//   data, a line empty after that is skipped, every field (stripped of
//   whitespace) must be a number, so an empty field (a trailing
//   delimiter) raises; the column count is the first row's.
// - libsvm: "label idx:val ..." with 1-based indices, whitespace split;
//   blank lines and lines starting '#' are skipped, every other token
//   must be idx:val, so an inline comment raises.  An index <= 0 lands
//   where numpy's negative indexing puts it, as the Python reader's does.
//
// Numbers: Python's float() grammar (decimal, exponent, inf, infinity,
// nan, PEP 515 underscores) for libsvm and ratings; numpy's for CSV
// (no underscores).  Hex floats and nan(...) are refused.  ASCII
// whitespace is Python's str.isspace() set; lines end at \n, \r\n or \r.
//
// A parse is two passes over chunks cut at line ends, one thread a
// chunk: the first counts each chunk's rows (and, for libsvm, checks the
// index tokens and finds the largest index), the caller allocates the
// outputs, and the second parses every chunk into its rows' place.  The
// peak is the file's pages plus the outputs.
//
// A parse is a job handle: oap_parse_open, oap_parse_status (the first
// error's message and 1-based line), oap_parse_rows / _cols, a fill,
// oap_parse_close.  No exception crosses the extern "C" boundary.

#include <algorithm>
#include <cerrno>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <map>
#include <mutex>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <utility>
#include <vector>

namespace {

enum Kind { RATINGS = 0, CSV = 1, LIBSVM = 2 };

inline bool is_ws(unsigned char c) {  // str.isspace() on ASCII
  return c == ' ' || (c >= '\t' && c <= '\r') || (c >= 0x1c && c <= 0x1f);
}
inline bool is_digit(unsigned char c) { return c >= '0' && c <= '9'; }

inline void trim(const char*& b, const char*& e) {
  while (b < e && is_ws(*b)) ++b;
  while (e > b && is_ws(e[-1])) --e;
}

std::string show(const char* b, const char* e) {
  std::string s(b, std::min<size_t>(e - b, 60));
  return "'" + s + (e - b > 60 ? "...'" : "'");
}

// PEP 515: each underscore between two digits.  The digits go to buf.
bool strip_underscores(const char* b, const char* e, std::string& buf) {
  buf.clear();
  for (const char* p = b; p < e; ++p) {
    if (*p == '_') {
      if (p == b || p + 1 >= e || !is_digit(p[-1]) || !is_digit(p[1])) return false;
      continue;
    }
    buf.push_back(*p);
  }
  return true;
}

// Python's int() of a decimal string, into int64.
bool parse_int(const char* b, const char* e, int64_t* out) {
  trim(b, e);
  std::string buf;
  if (memchr(b, '_', e - b)) {
    if (!strip_underscores(b, e, buf)) return false;
    b = buf.data();
    e = b + buf.size();
  }
  bool neg = false;
  if (b < e && (*b == '+' || *b == '-')) neg = *b++ == '-';
  if (b == e) return false;
  const uint64_t limit = neg ? uint64_t{1} << 63 : (uint64_t{1} << 63) - 1;
  uint64_t acc = 0;
  for (; b < e; ++b) {
    if (!is_digit(*b)) return false;
    uint64_t d = static_cast<uint64_t>(*b - '0');
    if (acc > (limit - d) / 10) return false;  // past int64
    acc = acc * 10 + d;
  }
  *out = neg ? static_cast<int64_t>(0 - acc) : static_cast<int64_t>(acc);
  return true;
}

bool iequal(const char* b, const char* e, const char* word) {
  size_t n = strlen(word);
  if (static_cast<size_t>(e - b) != n) return false;
  for (size_t k = 0; k < n; ++k)
    if ((b[k] | 0x20) != word[k]) return false;
  return true;
}

// The decimal digits [b, e) (grammar already checked) as the nearest double.
double to_double(const char* b, const char* e) {
#if defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L
  double v = 0.0;
  auto r = std::from_chars(b, e, v, std::chars_format::general);
  if (r.ec == std::errc() && r.ptr == e) return v;
#endif
  // out of range (inf, 0 or a subnormal) or no floating from_chars
  char small[64];
  std::string big;
  const char* s;
  if (e - b < 63) {
    memcpy(small, b, e - b);
    small[e - b] = '\0';
    s = small;
  } else {
    big.assign(b, e);
    s = big.c_str();
  }
  return strtod(s, nullptr);
}

// float() (python: underscores allowed) or numpy's loadtxt (not).
bool parse_float(const char* b, const char* e, bool python, double* out) {
  trim(b, e);
  std::string buf;
  if (memchr(b, '_', e - b)) {
    if (!python || !strip_underscores(b, e, buf)) return false;
    b = buf.data();
    e = b + buf.size();
  }
  bool neg = false;
  if (b < e && (*b == '+' || *b == '-')) neg = *b++ == '-';
  if (b == e) return false;
  double v;
  if (!is_digit(*b) && *b != '.') {
    if (iequal(b, e, "inf") || iequal(b, e, "infinity")) {
      v = INFINITY;
    } else if (iequal(b, e, "nan")) {
      v = NAN;
    } else {
      return false;
    }
  } else {
    const char* q = b;
    int digits = 0;
    while (q < e && is_digit(*q)) ++q, ++digits;
    if (q < e && *q == '.') {
      ++q;
      while (q < e && is_digit(*q)) ++q, ++digits;
    }
    if (digits == 0) return false;
    if (q < e && (*q == 'e' || *q == 'E')) {
      ++q;
      if (q < e && (*q == '+' || *q == '-')) ++q;
      int ed = 0;
      while (q < e && is_digit(*q)) ++q, ++ed;
      if (ed == 0) return false;
    }
    if (q != e) return false;
    v = to_double(b, e);
  }
  *out = neg ? -v : v;
  return true;
}

// str.split(sep)'s next cut at or after p, or e.
const char* find_sep(const char* p, const char* e, const std::string& sep) {
  const size_t n = sep.size();
  while (static_cast<size_t>(e - p) >= n) {
    const void* hit = memchr(p, sep[0], (e - p) - n + 1);
    if (!hit) return e;
    const char* h = static_cast<const char*>(hit);
    if (memcmp(h, sep.data(), n) == 0) return h;
    p = h + 1;
  }
  return e;
}

struct Chunk {
  const char* lo = nullptr;
  const char* hi = nullptr;
  int64_t rows = 0, lines = 0, row0 = 0, line0 = 0;
  int64_t max_idx = 0;  // libsvm
  int64_t cols = -1;    // csv: the first row's fields
  int64_t err_line = -1;
  std::string err;
  bool fail(int64_t line, std::string what) {
    err_line = line;
    err = std::move(what);
    return false;
  }
};

struct Job {
  int kind = RATINGS;
  int fd = -1;
  void* map = nullptr;
  size_t size = 0;
  std::string sep;
  int64_t n_features = -1;
  std::vector<Chunk> chunks;
  int64_t rows = 0, cols = 0;
  int64_t err_line = -1;  // 1-based; 0 when the error has no line
  std::string err;
  bool failed = false;
  bool filled = false;

  ~Job() {
    if (map) munmap(map, size);
    if (fd >= 0) close(fd);
  }
  void fail(int64_t line, std::string what) {
    if (!failed) {
      failed = true;
      err_line = line;
      err = std::move(what);
    }
  }
  // the earliest chunk's error, as a 1-based line of the file
  void take_chunk_errors() {
    for (const Chunk& c : chunks) {
      if (c.err_line >= 0) {
        fail(c.line0 + c.err_line + 1, c.err);
        return;
      }
    }
  }
};

std::mutex g_mu;
std::map<int64_t, Job*> g_jobs;
int64_t g_next = 1;

Job* find_job(int64_t h) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_jobs.find(h);
  return it == g_jobs.end() ? nullptr : it->second;
}

// f(line begin, line end, line index in the chunk) -> keep going
template <class F>
void for_lines(const char* lo, const char* hi, F f) {
  int64_t line = 0;
  for (const char* p = lo; p < hi; ++line) {
    const char* e = p;
    while (e < hi && *e != '\n' && *e != '\r') ++e;
    if (!f(p, e, line)) return;
    if (e < hi) e += (*e == '\r' && e + 1 < hi && e[1] == '\n') ? 2 : 1;
    p = e;
  }
}

int64_t count_lines(const char* lo, const char* hi) {
  int64_t n = 0;
  for_lines(lo, hi, [&](const char*, const char*, int64_t) { return ++n, true; });
  return n;
}

template <class F>
void run_chunks(Job& job, F f) {
  size_t t = job.chunks.size();
  if (t <= 1) {
    if (t) f(job.chunks[0]);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(t - 1);
  for (size_t k = 1; k < t; ++k) pool.emplace_back([&, k] { f(job.chunks[k]); });
  f(job.chunks[0]);
  for (auto& th : pool) th.join();
}

// chunks of about equal bytes, each cut just after a line end
void cut_chunks(Job& job, const char* base) {
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int t = hw > 0 ? hw : 1;
  t = std::min<int64_t>(std::min(t, 64), std::max<int64_t>(1, job.size >> 20));
  const char* end = base + job.size;
  const char* lo = base;
  for (int k = 0; k < t && lo < end; ++k) {
    const char* hi = k == t - 1 ? end : std::max(lo, base + job.size * (k + 1) / t);
    while (hi < end && *hi != '\n' && *hi != '\r') ++hi;
    if (hi < end) hi += (*hi == '\r' && hi + 1 < end && hi[1] == '\n') ? 2 : 1;
    Chunk c;
    c.lo = lo;
    c.hi = hi;
    job.chunks.push_back(std::move(c));
    lo = hi;
  }
}

// -- the first pass: rows (and libsvm's index tokens) --------------------------

void count_ratings(Chunk& c) {
  for_lines(c.lo, c.hi, [&](const char* b, const char* e, int64_t) {
    trim(b, e);
    c.rows += b < e;
    return true;
  });
}

inline const char* csv_data_end(const char* b, const char* e) {
  const void* hash = memchr(b, '#', e - b);
  return hash ? static_cast<const char*>(hash) : e;
}

void count_csv(Chunk& c, char delim) {
  for_lines(c.lo, c.hi, [&](const char* b, const char* e, int64_t) {
    e = csv_data_end(b, e);
    if (b == e) return true;
    if (c.cols < 0) c.cols = 1 + std::count(b, e, delim);
    ++c.rows;
    return true;
  });
}

inline bool libsvm_data(const char*& b, const char*& e) {
  trim(b, e);
  return b < e && *b != '#';
}

// the next whitespace-separated token of [p, e): [tb, te)
inline bool next_token(const char*& p, const char* e, const char*& tb, const char*& te) {
  while (p < e && is_ws(*p)) ++p;
  if (p == e) return false;
  tb = p;
  while (p < e && !is_ws(*p)) ++p;
  te = p;
  return true;
}

// idx of an idx:val token, the colon at *colon
bool libsvm_entry(const char* tb, const char* te, int64_t* idx, const char** colon,
                  Chunk& c, int64_t line) {
  const char* k = static_cast<const char*>(memchr(tb, ':', te - tb));
  if (!k || memchr(k + 1, ':', te - k - 1))
    return c.fail(line, "expected idx:val, got " + show(tb, te));
  if (!parse_int(tb, k, idx)) return c.fail(line, "invalid index " + show(tb, k));
  *colon = k;
  return true;
}

void count_libsvm(Chunk& c) {
  for_lines(c.lo, c.hi, [&](const char* b, const char* e, int64_t line) {
    if (!libsvm_data(b, e)) return true;
    ++c.rows;
    const char *tb, *te, *p = b;
    next_token(p, e, tb, te);  // the label, read in the second pass
    while (next_token(p, e, tb, te)) {
      int64_t idx;
      const char* colon;
      if (!libsvm_entry(tb, te, &idx, &colon, c, line)) return false;
      c.max_idx = std::max(c.max_idx, idx);
    }
    return true;
  });
}

// -- the second pass: values into place ---------------------------------------

void fill_ratings(Chunk& c, const std::string& sep, int64_t* users, int64_t* items,
                  float* ratings) {
  int64_t row = c.row0;
  for_lines(c.lo, c.hi, [&](const char* b, const char* e, int64_t line) {
    trim(b, e);
    if (b == e) return true;
    const char* s1 = find_sep(b, e, sep);
    const char* s2 = s1 == e ? e : find_sep(s1 + sep.size(), e, sep);
    if (s2 == e) return c.fail(line, "expected 3 fields split by '" + sep + "', got " + show(b, e));
    const char* f2 = s2 + sep.size();
    const char* s3 = find_sep(f2, e, sep);
    double r;
    if (!parse_int(b, s1, &users[row])) return c.fail(line, "invalid user id " + show(b, s1));
    if (!parse_int(s1 + sep.size(), s2, &items[row]))
      return c.fail(line, "invalid item id " + show(s1 + sep.size(), s2));
    if (!parse_float(f2, s3, true, &r)) return c.fail(line, "invalid rating " + show(f2, s3));
    ratings[row++] = static_cast<float>(r);
    return true;
  });
}

void fill_csv(Chunk& c, char delim, int64_t cols, double* x) {
  double* out = x + c.row0 * cols;
  for_lines(c.lo, c.hi, [&](const char* b, const char* e, int64_t line) {
    e = csv_data_end(b, e);
    if (b == e) return true;
    int64_t got = 1 + std::count(b, e, delim);
    if (got != cols)
      return c.fail(line, "the number of columns changed from " + std::to_string(cols) +
                              " to " + std::to_string(got));
    for (const char* f = b;; ++f) {
      const char* fe = static_cast<const char*>(memchr(f, delim, e - f));
      if (!fe) fe = e;
      if (!parse_float(f, fe, false, out++)) return c.fail(line, "invalid number " + show(f, fe));
      if (fe == e) break;
      f = fe;
    }
    return true;
  });
}

void fill_libsvm(Chunk& c, int64_t d, double* labels, double* x) {
  int64_t row = c.row0;
  std::vector<std::pair<int64_t, double>> entries;
  for_lines(c.lo, c.hi, [&](const char* b, const char* e, int64_t line) {
    if (!libsvm_data(b, e)) return true;
    const char *tb = b, *te = b, *p = b;
    next_token(p, e, tb, te);
    if (!parse_float(tb, te, true, &labels[row])) return c.fail(line, "invalid label " + show(tb, te));
    double* xr = x + row * d;
    entries.clear();
    bool wraps = false;
    while (next_token(p, e, tb, te)) {
      int64_t idx;
      const char* colon;
      double v;
      if (!libsvm_entry(tb, te, &idx, &colon, c, line)) return false;
      if (!parse_float(colon + 1, te, true, &v)) return c.fail(line, "invalid value " + show(tb, te));
      if (idx > d) return c.fail(line, "index " + std::to_string(idx) + " out of range");
      wraps |= idx <= 0;
      if (!wraps) xr[idx - 1] = v;  // distinct indices >= 1: distinct columns
      entries.emplace_back(idx, v);
    }
    if (wraps) {
      // an index <= 0 counts from the row's end and may share a column
      // with another: replay a dict's order (first appearance, last value)
      std::fill(xr, xr + d, 0.0);
      for (size_t k = 0; k < entries.size(); ++k) {
        int64_t idx = entries[k].first;
        bool seen = false;
        for (size_t j = 0; j < k && !seen; ++j) seen = entries[j].first == idx;
        if (seen) continue;
        double v = entries[k].second;
        for (size_t j = k + 1; j < entries.size(); ++j)
          if (entries[j].first == idx) v = entries[j].second;
        int64_t col = idx - 1;
        if (col < 0) col += d;
        if (col < 0) return c.fail(line, "index " + std::to_string(idx) + " out of range");
        xr[col] = v;
      }
    }
    ++row;
    return true;
  });
}

int64_t open_job(const char* path, int kind, const char* sep, int64_t n_features) {
  Job* job = new Job;
  job->kind = kind;
  job->sep = sep ? sep : "";
  job->n_features = n_features;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    int64_t h = g_next++;
    g_jobs[h] = job;
    job->rows = -h;  // the handle until the count below
  }
  int64_t handle = -job->rows;
  job->rows = 0;
  if (kind < RATINGS || kind > LIBSVM) {
    job->fail(0, "unknown format");
    return handle;
  }
  if (kind == RATINGS && job->sep.empty()) {
    job->fail(0, "empty separator");
    return handle;
  }
  if (kind == CSV && job->sep.size() != 1) {
    job->fail(0, "the delimiter must be one character");
    return handle;
  }
  job->fd = open(path, O_RDONLY | O_CLOEXEC);
  struct stat st;
  if (job->fd < 0 || fstat(job->fd, &st) != 0) {
    job->fail(0, std::string("cannot open: ") + strerror(errno));
    return handle;
  }
  if (S_ISDIR(st.st_mode)) {
    job->fail(0, "is a directory");
    return handle;
  }
  job->size = static_cast<size_t>(st.st_size);
  const char* base = nullptr;
  if (job->size) {
    job->map = mmap(nullptr, job->size, PROT_READ, MAP_PRIVATE, job->fd, 0);
    if (job->map == MAP_FAILED) {
      job->map = nullptr;
      job->fail(0, std::string("cannot map: ") + strerror(errno));
      return handle;
    }
    madvise(job->map, job->size, MADV_WILLNEED);
    base = static_cast<const char*>(job->map);
    cut_chunks(*job, base);
  }
  const char delim = job->sep.empty() ? ',' : job->sep[0];
  run_chunks(*job, [&](Chunk& c) {
    c.lines = count_lines(c.lo, c.hi);
    if (kind == RATINGS) count_ratings(c);
    else if (kind == CSV) count_csv(c, delim);
    else count_libsvm(c);
  });
  int64_t row = 0, line = 0, max_idx = 0;
  job->cols = kind == RATINGS ? 3 : -1;
  for (Chunk& c : job->chunks) {
    c.row0 = row;
    c.line0 = line;
    row += c.rows;
    line += c.lines;
    max_idx = std::max(max_idx, c.max_idx);
    if (kind == CSV && job->cols < 0 && c.rows) job->cols = c.cols;
  }
  job->rows = row;
  job->take_chunk_errors();
  if (kind == CSV && job->cols < 0) job->cols = 1;  // loadtxt's (0, 1) of no data
  if (kind == LIBSVM) {
    job->cols = n_features >= 0 ? n_features : max_idx;
    if (n_features >= 0 && max_idx > n_features)
      job->fail(0, "libsvm feature index " + std::to_string(max_idx) +
                       " exceeds n_features=" + std::to_string(n_features));
  }
  return handle;
}

}  // namespace

extern "C" {

// Open a parse job: the file mapped and the first pass run.  Returns its
// handle (>= 1), or -3 out of memory.  kind 0 ratings (sep), 1 csv
// (sep[0] the delimiter), 2 libsvm (n_features, -1 from the data).
int64_t oap_parse_open(const char* path, int kind, const char* sep, int64_t n_features) {
  try {
    return open_job(path, kind, sep, n_features);
  } catch (...) {
    return -3;
  }
}

// 0 ok; -1 failed (the message into msg, its 1-based line, or 0, into
// *line); -2 a bad handle.
int64_t oap_parse_status(int64_t h, char* msg, int64_t len, int64_t* line) {
  Job* job = find_job(h);
  if (!job) return -2;
  if (!job->failed) return 0;
  if (msg && len > 0) {
    size_t n = std::min<size_t>(job->err.size(), static_cast<size_t>(len - 1));
    memcpy(msg, job->err.data(), n);
    msg[n] = '\0';
  }
  if (line) *line = job->err_line;
  return -1;
}

int64_t oap_parse_rows(int64_t h) {
  Job* job = find_job(h);
  return job ? job->rows : -2;
}

int64_t oap_parse_cols(int64_t h) {
  Job* job = find_job(h);
  return job ? job->cols : -2;
}

// The second pass of a ratings job into (rows,) int64, int64, float32.
// Returns the status (0 ok, -1 failed).
int64_t oap_parse_fill_ratings(int64_t h, int64_t* users, int64_t* items, float* ratings) {
  Job* job = find_job(h);
  if (!job || job->kind != RATINGS) return -2;
  if (job->failed || job->filled) return -1;
  try {
    run_chunks(*job, [&](Chunk& c) { fill_ratings(c, job->sep, users, items, ratings); });
  } catch (...) {
    job->fail(0, "out of memory");
  }
  job->filled = true;
  job->take_chunk_errors();
  return job->failed ? -1 : 0;
}

// The second pass of a csv or libsvm job into x ((rows, cols) float64;
// zeros for libsvm) and, for libsvm, labels ((rows,) float64).
int64_t oap_parse_fill_dense(int64_t h, double* labels, double* x) {
  Job* job = find_job(h);
  if (!job || job->kind == RATINGS || (job->kind == LIBSVM && !labels)) return -2;
  if (job->failed || job->filled) return -1;
  const char delim = job->sep.empty() ? ',' : job->sep[0];
  try {
    run_chunks(*job, [&](Chunk& c) {
      if (job->kind == CSV) fill_csv(c, delim, job->cols, x);
      else fill_libsvm(c, job->cols, labels, x);
    });
  } catch (...) {
    job->fail(0, "out of memory");
  }
  job->filled = true;
  job->take_chunk_errors();
  return job->failed ? -1 : 0;
}

// Unmap and forget a job; -2 for a bad handle.
int64_t oap_parse_close(int64_t h) {
  Job* job;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_jobs.find(h);
    if (it == g_jobs.end()) return -2;
    job = it->second;
    g_jobs.erase(it);
  }
  delete job;
  return 0;
}

// Open jobs (leak checks).
int64_t oap_parse_live() {
  std::lock_guard<std::mutex> lk(g_mu);
  return static_cast<int64_t>(g_jobs.size());
}

}  // extern "C"

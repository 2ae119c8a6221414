// Native I/O tier: fast whitespace-separated numeric tokenizer and BAL
// writer for the BAL / Bundler text formats (pysfm_tpu_torch/io/bal.py).
//
// Parsing a Venice-scale BAL file (~100 MB of ASCII doubles) through
// Python's str.split() costs seconds and a 3x memory blow-up; this
// single-pass strtod loop runs at memory bandwidth.  Host code, no device
// kernel: the port's own copy of pysfm_tpu/io/_native/fast_parse.cpp.
//
// Exposed via ctypes (pysfm_tpu_torch/io/native.py), which builds it at
// first use into build/ at the root of the checkout:
//   g++ -O3 -shared -fPIC fast_parse.cpp -o build/libpysfm_io_<hash>.so

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// Parse up to max_out whitespace-separated doubles from buf[0..len).
// Returns the number parsed. Stops early at max_out or on a token that is
// not a number (returns count so far; caller validates the expected count).
int64_t pysfm_parse_doubles(const char* buf, int64_t len, double* out,
                            int64_t max_out) {
  const char* p = buf;
  const char* end = buf + len;
  int64_t n = 0;
  while (p < end && n < max_out) {
    // Skip whitespace.
    while (p < end && (*p == ' ' || *p == '\n' || *p == '\r' || *p == '\t'))
      ++p;
    if (p >= end) break;
    char* next = nullptr;
    // strtod needs NUL-terminated input in the worst case; the caller
    // guarantees a NUL (or whitespace) terminator at buf[len].
    double v = strtod(p, &next);
    if (next == p) break;  // non-numeric token
    out[n++] = v;
    p = next;
  }
  return n;
}

// Format a BAL problem body (everything after the header line): n_obs
// observation lines "cam pt u v\n" followed by n_vals values one per line
// at %.17g (round-trip precision).  Returns bytes written, or -1 if cap is
// too small.  The write-side counterpart of pysfm_parse_doubles: a per-line
// Python f-string loop is orders of magnitude slower.
int64_t pysfm_format_bal(const int32_t* obs_cam, const int32_t* obs_pt,
                         const double* uv, int64_t n_obs,
                         const double* vals, int64_t n_vals,
                         char* out, int64_t cap) {
  char* p = out;
  char* end = out + cap;
  for (int64_t i = 0; i < n_obs; ++i) {
    if (end - p < 80) return -1;  // worst-case line: 2 ints + 2 %.17g
    int w = snprintf(p, end - p, "%d %d %.17g %.17g\n", obs_cam[i],
                     obs_pt[i], uv[2 * i], uv[2 * i + 1]);
    if (w < 0 || w >= end - p) return -1;
    p += w;
  }
  for (int64_t i = 0; i < n_vals; ++i) {
    if (end - p < 32) return -1;
    int w = snprintf(p, end - p, "%.17g\n", vals[i]);
    if (w < 0 || w >= end - p) return -1;
    p += w;
  }
  return p - out;
}

// Count whitespace-separated tokens (for pre-sizing the output array).
int64_t pysfm_count_tokens(const char* buf, int64_t len) {
  int64_t n = 0;
  bool in_tok = false;
  for (int64_t i = 0; i < len; ++i) {
    char c = buf[i];
    bool ws = (c == ' ' || c == '\n' || c == '\r' || c == '\t');
    if (!ws && !in_tok) ++n;
    in_tok = !ws;
  }
  return n;
}

}  // extern "C"

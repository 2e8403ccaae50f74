// fastcsv — native CSV runtime for nbody_tpu.
//
// The reference's body I/O tier is C inside every binary: a line-count pass
// plus an fscanf("%lf, %lf, ...") parse loop (serial/exhaustive.c:79-146)
// and an fprintf("%lu,%lf,%lf,%lf,%lf\n") trajectory writer
// (serial/exhaustive.c:208-216, cuda/barnes-hut.cu:785-803).  This file is
// the TPU framework's native equivalent: a single shared library, loaded via
// ctypes, that parses the 7-column body format and streams trajectory frames
// to disk an order of magnitude faster than the NumPy fallback at 1M bodies.
//
// Semantics matched to the reference:
//  * input rows are exactly 7 comma-separated floats; whitespace around
//    values is tolerated (fscanf " %lf," behaviour);
//  * a structurally malformed file is an error (reference aborts with
//    "file is not well formed", serial/exhaustive.c:136-142);
//  * output rows are "id,x,y,z,mass" with %lf (fixed 6-decimal) formatting,
//    mass repeated on every row.

#include <cctype>
#include <cerrno>
#include <charconv>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// Count data rows (lines containing at least one non-space character).
// Returns -1 if the file cannot be opened.
long fastcsv_count_rows(const char *path) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return -1;
  std::vector<char> buf(1 << 20);
  long rows = 0;
  bool line_has_data = false;
  size_t got;
  while ((got = std::fread(buf.data(), 1, buf.size(), f)) > 0) {
    for (size_t i = 0; i < got; i++) {
      char c = buf[i];
      if (c == '\n') {
        if (line_has_data) rows++;
        line_has_data = false;
      } else if (!std::isspace(static_cast<unsigned char>(c))) {
        line_has_data = true;
      }
    }
  }
  if (line_has_data) rows++;  // no trailing newline (serial/exhaustive.c:98-100)
  std::fclose(f);
  return rows;
}

// Parse up to `cap` rows of 7 comma-separated doubles into `out` (row-major
// cap x 7).  Returns the number of rows parsed, or:
//   -1  file cannot be opened
//   -2  file is not well formed (wrong column count / trailing junk)
long fastcsv_read7(const char *path, double *out, long cap) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (sz < 0) { std::fclose(f); return -1; }
  std::vector<char> data(static_cast<size_t>(sz) + 1);
  size_t got = std::fread(data.data(), 1, static_cast<size_t>(sz), f);
  std::fclose(f);
  data[got] = '\0';

  const char *p = data.data();
  const char *end = data.data() + got;
  long row = 0;
  while (p < end) {
    // Skip blank space between rows.
    while (p < end && std::isspace(static_cast<unsigned char>(*p))) p++;
    if (p >= end) break;
    if (row >= cap) return -2;
    for (int col = 0; col < 7; col++) {
      char *next = nullptr;
      errno = 0;
      double v = std::strtod(p, &next);
      if (next == p) return -2;  // not a number where one was required
      out[row * 7 + col] = v;
      p = next;
      while (p < end && (*p == ' ' || *p == '\t')) p++;
      if (col < 6) {
        if (p >= end || *p != ',') return -2;
        p++;  // consume comma
      }
    }
    // After the 7th value: only spaces until newline/EOF are legal.
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) p++;
    if (p < end && *p != '\n') return -2;
    row++;
  }
  return row;
}

// Append `t` frames of `n` bodies to `path` as "id,x,y,z,mass" rows with
// %lf formatting (reference writer layout, serial/exhaustive.c:211-215).
// pos is (t, n, 3) row-major; mass is (n,).  Returns 0 on success.
int fastcsv_write_frames(const char *path, const double *pos,
                         const double *mass, long t, long n) {
  FILE *f = std::fopen(path, "ab");
  if (!f) return -1;
  std::vector<char> iobuf(4 << 20);
  std::setvbuf(f, iobuf.data(), _IOFBF, iobuf.size());
  char line[256];
  for (long k = 0; k < t; k++) {
    const double *frame = pos + k * n * 3;
    for (long i = 0; i < n; i++) {
      int len = std::snprintf(line, sizeof(line), "%ld,%lf,%lf,%lf,%lf\n", i,
                              frame[i * 3 + 0], frame[i * 3 + 1],
                              frame[i * 3 + 2], mass[i]);
      if (len <= 0 || std::fwrite(line, 1, static_cast<size_t>(len), f) !=
                          static_cast<size_t>(len)) {
        std::fclose(f);
        return -1;
      }
    }
  }
  std::fclose(f);
  return 0;
}

// Write `n` rows of 7 comma-separated doubles (the runnable-input
// checkpoint format: x, y, z, vx, vy, vz, mass) to `path`, truncating.
// std::to_chars emits the SHORTEST representation that round-trips the
// double exactly (strtod reads it back bit-for-bit) — and its Ryu-style
// conversion is ~10x faster than snprintf's %.17g exact-decimal path,
// which matters on the single host core behind a 10M-body run.
// Returns 0 on success.
int fastcsv_write7(const char *path, const double *data, long n) {
  FILE *f = std::fopen(path, "wb");
  if (!f) return -1;
  std::vector<char> iobuf(4 << 20);
  std::setvbuf(f, iobuf.data(), _IOFBF, iobuf.size());
  char line[512];
  for (long i = 0; i < n; i++) {
    const double *r = data + i * 7;
    char *p = line;
    for (int col = 0; col < 7; col++) {
      auto res = std::to_chars(p, line + sizeof(line) - 2, r[col]);
      if (res.ec != std::errc()) { std::fclose(f); return -1; }
      p = res.ptr;
      *p++ = (col < 6) ? ',' : '\n';
    }
    size_t len = static_cast<size_t>(p - line);
    if (std::fwrite(line, 1, len, f) != len) {
      std::fclose(f);
      return -1;
    }
  }
  if (std::fclose(f) != 0) return -1;
  return 0;
}

}  // extern "C"

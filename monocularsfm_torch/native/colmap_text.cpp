// The long lines of a COLMAP text model, written in C++ because a model of
// a few hundred views holds millions of keypoints and a hundred thousand
// points: the POINTS2D line of images.txt (`X Y POINT3D_ID` for every
// keypoint, joined by single spaces, -1 for none) and the lines of
// points3D.txt.  Every float is written in std::to_chars' shortest form,
// which float() reads back to the same double, and every integer in
// decimal; numbers are read back as float() reads them.  io/colmap.py
// binds it with ctypes.

#include <charconv>
#include <cstdint>
#include <cstring>

namespace {

char* put_double(char* p, double x) { return std::to_chars(p, p + 24, x).ptr; }

}  // namespace

// Writes the line of `n` keypoints (uv: n x 2 doubles, row-major; ids: n)
// into `out` and returns its length, with no terminator.  A keypoint takes
// 72 bytes at most: two coordinates of at most 24 characters (sign, 17
// digits, point, e-308), an id of at most 20 and three spaces.
extern "C" int64_t colmap_points2d_line(const double* uv, const int64_t* ids,
                                        int64_t n, char* out) {
  char* p = out;
  for (int64_t k = 0; k < n; ++k) {
    if (k) *p++ = ' ';
    p = put_double(p, uv[2 * k]);
    *p++ = ' ';
    p = put_double(p, uv[2 * k + 1]);
    *p++ = ' ';
    const int64_t id = ids[k] >= 0 ? ids[k] : -1;
    p = std::to_chars(p, p + 24, id).ptr;
  }
  return p - out;
}

// Writes one line `POINT3D_ID X Y Z R G B ERROR TRACK[]` per point, each
// ended by a newline, into `out` and returns their length: ids (n), xyz
// (n x 3), rgb (n x 3), errors (n), and the tracks as (image id, keypoint)
// pairs, point p's from pair offsets[p] to offsets[p + 1].  A point takes
// 192 bytes at most and a pair of its track 42.
extern "C" int64_t colmap_points3d_lines(const int64_t* ids, const double* xyz,
                                         const int64_t* rgb, const double* err,
                                         const int64_t* offsets,
                                         const int64_t* track, int64_t n,
                                         char* out) {
  char* p = out;
  for (int64_t k = 0; k < n; ++k) {
    p = std::to_chars(p, p + 24, ids[k]).ptr;
    for (int c = 0; c < 3; ++c) {
      *p++ = ' ';
      p = put_double(p, xyz[3 * k + c]);
    }
    for (int c = 0; c < 3; ++c) {
      *p++ = ' ';
      p = std::to_chars(p, p + 24, rgb[3 * k + c]).ptr;
    }
    *p++ = ' ';
    p = put_double(p, err[k]);
    for (int64_t o = 2 * offsets[k]; o < 2 * offsets[k + 1]; ++o) {
      *p++ = ' ';
      p = std::to_chars(p, p + 24, track[o]).ptr;
    }
    *p++ = '\n';
  }
  return p - out;
}

// Reads the whitespace-separated numbers of text[0, len) line by line into
// `out` (at most `cap`), as float() reads them, correctly rounded, and each
// line's count into `counts` (at most `cap_lines`), skipping blank lines
// and those whose first character that is not a space is '#'.  Sets *lines
// to the number of lines read and returns the number of numbers; returns
// -1 - the offset of the first token that is not a number, or -1 - len
// where a bound would be passed.
extern "C" int64_t colmap_parse_numbers(const char* text, int64_t len,
                                        double* out, int64_t cap,
                                        int64_t* counts, int64_t cap_lines,
                                        int64_t* lines) {
  const char* p = text;
  const char* end = text + len;
  int64_t n = 0, nl = 0;
  auto space = [](char c) {
    return c == ' ' || c == '\t' || c == '\r' || c == '\v' || c == '\f';
  };
  while (p < end) {
    const char* eol = static_cast<const char*>(std::memchr(p, '\n', end - p));
    if (!eol) eol = end;
    const char* q = p;
    while (q < eol && space(*q)) ++q;
    p = eol + (eol < end);
    if (q == eol || *q == '#') continue;
    const int64_t first = n;
    while (q < eol) {
      if (n == cap) return -1 - len;
      auto r = std::from_chars(q, eol, out[n]);
      if (r.ec != std::errc() || (r.ptr < eol && !space(*r.ptr))) {
        return -1 - (q - text);
      }
      ++n;
      q = r.ptr;
      while (q < eol && space(*q)) ++q;
    }
    if (nl == cap_lines) return -1 - len;
    counts[nl++] = n - first;
  }
  *lines = nl;
  return n;
}

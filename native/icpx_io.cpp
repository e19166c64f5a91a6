// icpx native IO kernels — the C++ data-loader tier.
//
// The reference delegates cloud parsing to PCL's C++ readers
// (`pcl::PCDReader::read`, `myicp.cpp:22-26`); this framework keeps the same split: Python orchestrates headers/dispatch, this
// library does the hot byte-level work (whitespace-separated float
// tables for ASCII PCD/PLY/xyz, float formatting for writers). Exposed
// through ctypes (no pybind11 dependency in the image).
//
// Build: make -C native   (or icpx.io.native builds it on first use)

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <cmath>

extern "C" {

// Line-aware table parsing shared core: each non-blank, non-'#' line
// must contain exactly `row_cols` whitespace-separated float tokens
// ("nan"/"inf" ok via strtof). Stores columns [col0, col0+n_take) of each
// row. Returns rows parsed, or -(line_index+1) on a malformed line so
// Python can fall back to numpy with a real error instead of silently
// mis-aligned data (a skipped token would shift every later coordinate).
static int64_t parse_lines(
    const char* text,
    int64_t length,
    int64_t n_rows,
    int64_t row_cols,
    int64_t col0,
    int64_t n_take,
    float* out) {
  const char* p = text;
  const char* end = text + length;
  int64_t row = 0;
  while (row < n_rows && p < end) {
    // bounds of this line
    const char* eol = p;
    while (eol < end && *eol != '\n') ++eol;
    // skip blank / comment lines
    const char* q = p;
    while (q < eol && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
    if (q == eol || *q == '#') {
      p = eol + 1;
      continue;
    }
    int64_t c = 0;
    while (q < eol) {
      while (q < eol && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
      if (q >= eol) break;
      char* next = nullptr;
      float v = strtof(q, &next);
      if (next == q || next > eol) return -(row + 1);  // bad token
      if (c >= row_cols) return -(row + 1);  // too many columns
      if (c >= col0 && c < col0 + n_take) {
        out[row * n_take + (c - col0)] = v;
      }
      ++c;
      q = next;
    }
    if (c != row_cols) return -(row + 1);  // too few columns
    ++row;
    p = eol + 1;
  }
  return row;
}

// Parse n_values = n_rows*n_cols floats (all columns kept). n_cols is
// inferred by the caller; rows are validated line-by-line.
int64_t icpx_parse_float_table(
    const char* text,
    int64_t length,
    int64_t n_values,
    float* out,
    int64_t n_cols) {
  if (n_cols <= 0) return -1;
  int64_t n_rows = n_values / n_cols;
  int64_t got = parse_lines(text, length, n_rows, n_cols, 0, n_cols, out);
  return got < 0 ? got : got * n_cols;
}

// Column-subset variant (e.g. xyz out of multi-field rows).
int64_t icpx_parse_float_columns(
    const char* text,
    int64_t length,
    int64_t n_rows,
    int64_t row_cols,
    int64_t col0,
    int64_t n_take,
    float* out) {
  return parse_lines(text, length, n_rows, row_cols, col0, n_take, out);
}

// Format an (n_rows, n_cols) float table as ASCII rows into out_buf
// ("%.9g" per value, space separated, '\n' rows). Returns bytes written,
// or -1 if out_cap would overflow.
int64_t icpx_format_float_table(
    const float* values,
    int64_t n_rows,
    int64_t n_cols,
    char* out_buf,
    int64_t out_cap) {
  char* w = out_buf;
  char* wend = out_buf + out_cap;
  for (int64_t r = 0; r < n_rows; ++r) {
    for (int64_t c = 0; c < n_cols; ++c) {
      if (wend - w < 32) return -1;
      if (c) *w++ = ' ';
      int n = snprintf(w, (size_t)(wend - w), "%.9g",
                       (double)values[r * n_cols + c]);
      if (n < 0) return -1;
      w += n;
    }
    if (w >= wend) return -1;
    *w++ = '\n';
  }
  return (int64_t)(w - out_buf);
}

// KITTI velodyne: raw float32 x,y,z,reflectance records -> xyz only.
// (A memcpy-with-stride; here so the loader path is fully native.)
int64_t icpx_kitti_xyz(
    const char* raw,
    int64_t n_bytes,
    float* out_xyz) {
  int64_t n = n_bytes / 16;
  const float* f = (const float*)raw;
  for (int64_t i = 0; i < n; ++i) {
    out_xyz[i * 3 + 0] = f[i * 4 + 0];
    out_xyz[i * 3 + 1] = f[i * 4 + 1];
    out_xyz[i * 3 + 2] = f[i * 4 + 2];
  }
  return n;
}

// LZF compression (liblzf-compatible format, used by PCL's
// binary_compressed PCD payloads). Simple 8k-entry hash chain.
int64_t icpx_lzf_compress(
    const char* in,
    int64_t in_len,
    char* out,
    int64_t out_cap) {
  if (in_len <= 0) return 0;
  const unsigned char* ip = (const unsigned char*)in;
  const unsigned char* in_end = ip + in_len;
  unsigned char* op = (unsigned char*)out;
  unsigned char* out_end = op + out_cap;

  const int HLOG = 13;
  static thread_local const unsigned char* htab[1 << 13];
  for (int i = 0; i < (1 << HLOG); ++i) htab[i] = ip;

  int lit = 0;
  unsigned char* lit_hdr = op++;  // reserve literal-run header
  if (op >= out_end) return -1;

  while (ip < in_end) {
    if (ip + 4 < in_end) {
      uint32_t h = (uint32_t)(ip[0] << 16 | ip[1] << 8 | ip[2]);
      uint32_t slot = ((h >> (24 - HLOG)) ^ h) & ((1 << HLOG) - 1);
      const unsigned char* ref = htab[slot];
      htab[slot] = ip;
      int64_t off = ip - ref - 1;
      if (ref < ip && off < (1 << 13) && ref[0] == ip[0] &&
          ref[1] == ip[1] && ref[2] == ip[2]) {
        // found a match of at least 3
        int64_t maxlen = in_end - ip;
        if (maxlen > 264) maxlen = 264;
        int64_t len = 3;
        while (len < maxlen && ref[len] == ip[len]) ++len;
        // close current literal run
        if (lit) {
          *lit_hdr = (unsigned char)(lit - 1);
          lit = 0;
        } else {
          --op;  // unused header byte
        }
        int64_t l = len - 2;
        if (op + 4 > out_end) return -1;
        if (l < 7) {
          *op++ = (unsigned char)((off >> 8) + (l << 5));
        } else {
          *op++ = (unsigned char)((off >> 8) + (7 << 5));
          *op++ = (unsigned char)(l - 7);
        }
        *op++ = (unsigned char)(off & 0xFF);
        ip += len;
        lit_hdr = op++;  // reserve next literal header
        if (op > out_end) return -1;
        continue;
      }
    }
    // literal byte
    if (op >= out_end) return -1;
    *op++ = *ip++;
    ++lit;
    if (lit == 32) {
      *lit_hdr = 31;
      lit = 0;
      lit_hdr = op++;
      if (op > out_end) return -1;
    }
  }
  if (lit) {
    *lit_hdr = (unsigned char)(lit - 1);
  } else {
    --op;
  }
  return (int64_t)(op - (unsigned char*)out);
}

// LZF decompression (mirrors the Python fallback in icpx/io/pcd.py).
int64_t icpx_lzf_decompress(
    const char* in,
    int64_t in_len,
    char* out,
    int64_t out_cap) {
  const unsigned char* ip = (const unsigned char*)in;
  const unsigned char* in_end = ip + in_len;
  unsigned char* op = (unsigned char*)out;
  unsigned char* out_end = op + out_cap;
  while (ip < in_end) {
    unsigned int ctrl = *ip++;
    if (ctrl < 32) {
      int64_t run = ctrl + 1;
      if (op + run > out_end || ip + run > in_end) return -1;
      memcpy(op, ip, run);
      op += run;
      ip += run;
    } else {
      int64_t len = ctrl >> 5;
      if (len == 7) {
        if (ip >= in_end) return -1;
        len += *ip++;
      }
      if (ip >= in_end) return -1;
      const unsigned char* ref = op - ((ctrl & 0x1F) << 8) - *ip++ - 1;
      if (ref < (unsigned char*)out) return -1;
      len += 2;
      if (op + len > out_end) return -1;
      for (int64_t i = 0; i < len; ++i) op[i] = ref[i];
      op += len;
    }
  }
  return (int64_t)(op - (unsigned char*)out);
}

int icpx_io_abi_version(void) { return 3; }

}  // extern "C"

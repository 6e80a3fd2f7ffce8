// Native trajectory CSV writer.
//
// The reference dumps trajectories with Python's csv module
// (the reference's output_generator.py:32-51); at this framework's scale a
// recorded rollout is (steps x capacity) arrays that can reach gigabytes of
// CSV, so the serialization hot path is C++: shortest-round-trip float
// formatting via std::to_chars into a large buffered stream.  Loaded through
// ctypes with a pure-Python fallback (utils/csvout.py).  Floats are written
// as Python's csv module writes them (str of a numpy float32 or a Python
// float: the shortest round-trip digits, positional with a trailing ".0"
// when integral, scientific below 1e-4 and from 1e16 on), so both writers
// produce the same bytes.
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Buffer {
  explicit Buffer(FILE* f) : file(f) { data.reserve(kCap + 128); }
  ~Buffer() { flush(); }
  void flush() {
    if (!data.empty()) {
      fwrite(data.data(), 1, data.size(), file);
      data.clear();
    }
  }
  void put(const char* s, size_t n) {
    data.insert(data.end(), s, s + n);
    if (data.size() >= kCap) flush();
  }
  void put_char(char c) { data.push_back(c); }
  template <typename T>
  void put_num(T v) {
    char tmp[32];
    auto res = std::to_chars(tmp, tmp + sizeof(tmp), v);
    put(tmp, static_cast<size_t>(res.ptr - tmp));
  }
  // A float or double as Python's str() writes it (see the header): the
  // shortest round-trip digits of the scientific form, laid out positionally
  // for 1e-4 <= |v| < 1e16 (zeros padded, ".0" when integral).
  template <typename T>
  void put_float(T v) {
    if (std::isnan(v)) return put("nan", 3);
    if (std::isinf(v)) return v < 0 ? put("-inf", 4) : put("inf", 3);
    char sci[48];
    const auto res = std::to_chars(sci, sci + sizeof(sci) - 1, v,
                                   std::chars_format::scientific);
    *res.ptr = '\0';  // for atoi below
    const double a = std::fabs(static_cast<double>(v));
    if (a != 0.0 && (a < 1e-4 || a >= 1e16)) {
      return put(sci, static_cast<size_t>(res.ptr - sci));
    }
    // sci = [-]d[.ddd]e(+|-)XX: split sign, digits and exponent
    const char* p = sci;
    char out[64];
    char* o = out;
    if (*p == '-') *o++ = *p++;
    char digits[32];
    int nd = 0;
    for (; *p != 'e'; ++p) {
      if (*p != '.') digits[nd++] = *p;
    }
    const int exp10 = std::atoi(p + 1);
    if (exp10 < 0) {
      *o++ = '0';
      *o++ = '.';
      for (int k = 0; k < -exp10 - 1; ++k) *o++ = '0';
      for (int k = 0; k < nd; ++k) *o++ = digits[k];
    } else {
      for (int k = 0; k <= exp10; ++k) *o++ = k < nd ? digits[k] : '0';
      *o++ = '.';
      if (nd > exp10 + 1) {
        for (int k = exp10 + 1; k < nd; ++k) *o++ = digits[k];
      } else {
        *o++ = '0';
      }
    }
    put(out, static_cast<size_t>(o - out));
  }
  static constexpr size_t kCap = 1 << 20;
  FILE* file;
  std::vector<char> data;
};

}  // namespace

extern "C" {

// Appends a chunk of the reference-schema pedestrian.csv. Returns rows
// written, -1 on I/O error.  pos/vel: (T, N, 2) float32; mode: (T, N)
// int32; alive: (T, N) uint8.  frame_offset shifts the frame/time columns
// (streamed multi-chunk rollouts); append != 0 opens in append mode and
// skips the header.
int64_t write_pedestrian_csv_chunk(const char* path, int64_t t_steps,
                                   int64_t n, const float* pos,
                                   const float* vel, const int32_t* mode,
                                   const uint8_t* alive, double dt,
                                   int64_t frame_offset, int32_t append) {
  FILE* f = fopen(path, append ? "ab" : "wb");
  if (!f) return -1;
  int64_t rows = 0;
  {
    Buffer buf(f);
    if (!append) {
      const char header[] = "ped_id,frame,time,x,y,v_x,v_y,mode\r\n";
      buf.put(header, sizeof(header) - 1);
    }
    for (int64_t t = 0; t < t_steps; ++t) {
      const int64_t frame = frame_offset + t;
      const double time = static_cast<double>(frame) * dt;
      for (int64_t i = 0; i < n; ++i) {
        if (!alive[t * n + i]) continue;
        const int64_t base = (t * n + i) * 2;
        buf.put_num(i);
        buf.put_char(',');
        buf.put_num(frame);
        buf.put_char(',');
        buf.put_float(time);
        buf.put_char(',');
        buf.put_float(pos[base]);
        buf.put_char(',');
        buf.put_float(pos[base + 1]);
        buf.put_char(',');
        buf.put_float(vel[base]);
        buf.put_char(',');
        buf.put_float(vel[base + 1]);
        buf.put_char(',');
        buf.put_num(mode[t * n + i]);
        buf.put_char('\r');  // python csv module line terminator is \r\n
        buf.put_char('\n');
        ++rows;
      }
    }
  }
  fclose(f);
  return rows;
}

}  // extern "C"

// Reverses the five PNG row filters (PNG spec, section 9) in place of the
// sequential inner loop that Average and Paeth need; the port's PNG decoder
// (ubpl_torch/data/native_io.py) does the rest of the decode in Python.
//
// Build: c++ -O3 -shared -fPIC -o libubpl_png.so png_unfilter.cc
// (native_io.py compiles it at first use into .kernel_build/).
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// src: h rows of (1 + stride) bytes (filter type byte, then the filtered
// row); dst: h rows of stride bytes.  bpp: bytes per pixel (>= 1).
// Returns 0, or 1 + the index of the first row with an unknown filter type.
int ubpl_png_unfilter(const uint8_t* src, uint8_t* dst, int h, int stride,
                      int bpp) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* in = src + static_cast<size_t>(y) * (stride + 1);
    const int type = in[0];
    ++in;
    uint8_t* out = dst + static_cast<size_t>(y) * stride;
    const uint8_t* up = y > 0 ? out - stride : nullptr;
    switch (type) {
      case 0:
        std::memcpy(out, in, stride);
        break;
      case 1:
        for (int x = 0; x < stride; ++x)
          out[x] = static_cast<uint8_t>(in[x] + (x >= bpp ? out[x - bpp] : 0));
        break;
      case 2:
        for (int x = 0; x < stride; ++x)
          out[x] = static_cast<uint8_t>(in[x] + (up ? up[x] : 0));
        break;
      case 3:
        for (int x = 0; x < stride; ++x) {
          const int a = x >= bpp ? out[x - bpp] : 0;
          const int b = up ? up[x] : 0;
          out[x] = static_cast<uint8_t>(in[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int x = 0; x < stride; ++x) {
          const int a = x >= bpp ? out[x - bpp] : 0;
          const int b = up ? up[x] : 0;
          const int c = (up && x >= bpp) ? up[x - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          out[x] = static_cast<uint8_t>(in[x] + pred);
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

}  // extern "C"

// Frame upload fill: uint8 images written into a batch of padded slots.
//
// The port's multi-sequence step uploads its images as one (N, pad_h, pad_w)
// uint8 batch through a pinned host slot (frontend/fused.py::fill_padded).
// Each of a pool of host threads fills a share of whole images with one
// call, outside Python's interpreter lock. Only the pads are zeroed: the
// slot may hold an earlier batch. Where the slots are 16-byte aligned the
// stores stream past the caches: the slot is next read by the card's copy
// engine, not by this host. Built and loaded by native.py (fill_library).

#include <cstdint>
#include <cstring>
#if defined(__SSE2__)
#include <emmintrin.h>
#endif

namespace {

void fill_plain(uint8_t* slot, const uint8_t* src, int64_t rows, int64_t cols, int64_t stride,
                int64_t pad_h, int64_t pad_w) {
  for (int64_t r = 0; r < rows; ++r) {
    uint8_t* row = slot + r * pad_w;
    std::memcpy(row, src + r * stride, static_cast<size_t>(cols));
    std::memset(row + cols, 0, static_cast<size_t>(pad_w - cols));
  }
  std::memset(slot + rows * pad_w, 0, static_cast<size_t>((pad_h - rows) * pad_w));
}

#if defined(__SSE2__)
// pad_w a multiple of 16 and slot 16-byte aligned.
void fill_streaming(uint8_t* slot, const uint8_t* src, int64_t rows, int64_t cols, int64_t stride,
                    int64_t pad_h, int64_t pad_w) {
  const __m128i zero = _mm_setzero_si128();
  for (int64_t r = 0; r < pad_h; ++r) {
    uint8_t* row = slot + r * pad_w;
    int64_t c = 0;
    if (r < rows) {
      const uint8_t* in = src + r * stride;
      for (; c + 16 <= cols; c += 16)
        _mm_stream_si128(reinterpret_cast<__m128i*>(row + c),
                         _mm_loadu_si128(reinterpret_cast<const __m128i*>(in + c)));
      if (c < cols) {  // the row's last bytes and the first of its pad
        alignas(16) uint8_t tail[16] = {0};
        std::memcpy(tail, in + c, static_cast<size_t>(cols - c));
        _mm_stream_si128(reinterpret_cast<__m128i*>(row + c),
                         _mm_load_si128(reinterpret_cast<const __m128i*>(tail)));
        c += 16;
      }
    }
    for (; c < pad_w; c += 16) _mm_stream_si128(reinterpret_cast<__m128i*>(row + c), zero);
  }
}
#endif

}  // namespace

extern "C" {

// Image k is row k of `images` (n x 4): its address, height, width and row
// stride in bytes (columns contiguous). Its rows, cropped to the pad, are
// written at the top left of out's k-th pad_h x pad_w slot; the rest of that
// slot is zeroed.
void ssl_fill_padded(uint8_t* out, int64_t n, int64_t pad_h, int64_t pad_w,
                     const int64_t* images) {
#if defined(__SSE2__)
  const bool streaming = pad_w % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
#endif
  for (int64_t k = 0; k < n; ++k) {
    const int64_t* im = images + 4 * k;
    const uint8_t* src = reinterpret_cast<const uint8_t*>(im[0]);
    uint8_t* slot = out + k * pad_h * pad_w;
    const int64_t rows = im[1] < pad_h ? im[1] : pad_h;
    const int64_t cols = im[2] < pad_w ? im[2] : pad_w;
#if defined(__SSE2__)
    if (streaming) {
      fill_streaming(slot, src, rows, cols, im[3], pad_h, pad_w);
      continue;
    }
#endif
    fill_plain(slot, src, rows, cols, im[3], pad_h, pad_w);
  }
#if defined(__SSE2__)
  _mm_sfence();  // the streamed stores visible before the caller hands the slot on
#endif
}

}  // extern "C"

// The native VTK XML binary encoder of io/vtk.py (a copy of the JAX
// package's native/src/vtkenc.cpp, its C ABI unchanged): VTK XML
// "binary" format is base64(uint32 length header + raw little-endian
// payload), and for the large fields of a write the Python base64 path
// is the output's bottleneck; this is a single-pass encoder.
//
// Built by the host compiler at first use (io/vtk.py), no nvcc; exposed
// as a plain C ABI for ctypes.

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr char kB64[] =
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";

// Encode `n` bytes from `src` into base64 at `dst`; returns bytes written.
size_t b64_encode(const uint8_t* src, size_t n, char* dst) {
  size_t o = 0;
  size_t i = 0;
  for (; i + 3 <= n; i += 3) {
    const uint32_t v = (uint32_t(src[i]) << 16) | (uint32_t(src[i + 1]) << 8) |
                       uint32_t(src[i + 2]);
    dst[o++] = kB64[(v >> 18) & 63];
    dst[o++] = kB64[(v >> 12) & 63];
    dst[o++] = kB64[(v >> 6) & 63];
    dst[o++] = kB64[v & 63];
  }
  const size_t rem = n - i;
  if (rem == 1) {
    const uint32_t v = uint32_t(src[i]) << 16;
    dst[o++] = kB64[(v >> 18) & 63];
    dst[o++] = kB64[(v >> 12) & 63];
    dst[o++] = '=';
    dst[o++] = '=';
  } else if (rem == 2) {
    const uint32_t v = (uint32_t(src[i]) << 16) | (uint32_t(src[i + 1]) << 8);
    dst[o++] = kB64[(v >> 18) & 63];
    dst[o++] = kB64[(v >> 12) & 63];
    dst[o++] = kB64[(v >> 6) & 63];
    dst[o++] = '=';
  }
  return o;
}

}  // namespace

extern "C" {

// Required output capacity for vtk_encode_block with n payload bytes.
size_t vtk_b64_bound(size_t n_payload) {
  const size_t total = n_payload + 4;  // uint32 header
  return ((total + 2) / 3) * 4;
}

// VTK XML inline-binary block: base64(uint32le(n) + payload).
// dst must have vtk_b64_bound(n) bytes. Returns bytes written.
size_t vtk_encode_block(const uint8_t* payload, size_t n, char* dst) {
  // Header and payload must be encoded as one contiguous stream; to
  // stay single-pass without a bounce buffer, encode the first bytes
  // (header + up to 2 payload bytes) separately so the remainder is
  // 3-aligned.
  uint8_t head[6];
  head[0] = uint8_t(n & 0xff);
  head[1] = uint8_t((n >> 8) & 0xff);
  head[2] = uint8_t((n >> 16) & 0xff);
  head[3] = uint8_t((n >> 24) & 0xff);
  const size_t take = n < 2 ? n : 2;  // make 4+take divisible by 3
  std::memcpy(head + 4, payload, take);
  size_t o = 0;
  if (take == 2) {
    o += b64_encode(head, 6, dst);  // 6 % 3 == 0: no padding emitted
    o += b64_encode(payload + 2, n - 2, dst + o);
  } else {
    // tiny payloads: just bounce through a stack buffer
    o += b64_encode(head, 4 + take, dst);
  }
  return o;
}

}  // extern "C"

// Dependency-free PNG (RGB8) encoder.
//
// The reference presents frames through GLFW/OpenGL (main.cpp:301-335);
// the headless renderer writes PNGs instead. This encoder produces a
// valid zlib stream using fixed-Huffman deflate with a per-row Paeth
// filter — small output, no external libraries, fast enough to keep up
// with interactive rendering.
#include "common.h"

#include <cstring>
#include <vector>

namespace {

// ---- CRC32 (PNG chunk checksum) ----
uint32_t crc_table[256];
bool crc_ready = false;

void crc_init() {
  for (uint32_t n = 0; n < 256; ++n) {
    uint32_t c = n;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xedb88320u ^ (c >> 1) : c >> 1;
    crc_table[n] = c;
  }
  crc_ready = true;
}

uint32_t crc32_update(uint32_t crc, const uint8_t* buf, size_t len) {
  if (!crc_ready) crc_init();
  crc ^= 0xffffffffu;
  for (size_t i = 0; i < len; ++i) {
    crc = crc_table[(crc ^ buf[i]) & 0xff] ^ (crc >> 8);
  }
  return crc ^ 0xffffffffu;
}

// ---- Adler32 (zlib checksum) ----
uint32_t adler32(const uint8_t* buf, size_t len) {
  uint32_t a = 1, b = 0;
  for (size_t i = 0; i < len; ++i) {
    a = (a + buf[i]) % 65521u;
    b = (b + a) % 65521u;
  }
  return (b << 16) | a;
}

// ---- bit writer for deflate ----
struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t bits = 0;
  int nbits = 0;

  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}

  void put(uint32_t value, int n) {  // LSB-first
    bits |= value << nbits;
    nbits += n;
    while (nbits >= 8) {
      out.push_back(bits & 0xff);
      bits >>= 8;
      nbits -= 8;
    }
  }

  void flush() {
    if (nbits) out.push_back(bits & 0xff);
    bits = 0;
    nbits = 0;
  }
};

// Fixed-Huffman literal/length code (RFC 1951 §3.2.6).
void put_literal(BitWriter& bw, int lit) {
  auto rev = [](uint32_t v, int n) {
    uint32_t r = 0;
    for (int i = 0; i < n; ++i) r = (r << 1) | ((v >> i) & 1);
    return r;
  };
  if (lit < 144) {
    bw.put(rev(0x30 + lit, 8), 8);
  } else {
    bw.put(rev(0x190 + lit - 144, 9), 9);
  }
}

}  // namespace

extern "C" {

int64_t sf_png_encode_rgb8(uint8_t* out, int64_t out_cap, const uint8_t* rgb,
                           int width, int height) {
  const int64_t stride = static_cast<int64_t>(width) * 3;
  const int64_t raw_len = (stride + 1) * height;

  // Filtered scanlines: Paeth (filter 4) predicts well on smooth renders.
  std::vector<uint8_t> raw(raw_len);
  for (int y = 0; y < height; ++y) {
    uint8_t* dst = raw.data() + y * (stride + 1);
    const uint8_t* row = rgb + y * stride;
    const uint8_t* prev = y ? rgb + (y - 1) * stride : nullptr;
    dst[0] = 4;  // Paeth
    for (int64_t x = 0; x < stride; ++x) {
      int a = x >= 3 ? row[x - 3] : 0;
      int b = prev ? prev[x] : 0;
      int c = (prev && x >= 3) ? prev[x - 3] : 0;
      int p = a + b - c;
      int pa = p > a ? p - a : a - p;
      int pb = p > b ? p - b : b - p;
      int pc = p > c ? p - c : c - p;
      int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
      dst[1 + x] = static_cast<uint8_t>(row[x] - pred);
    }
  }

  // zlib stream: header + one fixed-Huffman block of literals + adler.
  std::vector<uint8_t> z;
  z.reserve(raw_len + raw_len / 8 + 64);
  z.push_back(0x78);
  z.push_back(0x01);
  {
    BitWriter bw(z);
    bw.put(1, 1);  // final block
    bw.put(1, 2);  // fixed Huffman
    for (int64_t i = 0; i < raw_len; ++i) put_literal(bw, raw[i]);
    // end-of-block symbol 256: fixed code 0000000
    bw.put(0, 7);
    bw.flush();
  }
  uint32_t ad = adler32(raw.data(), raw.size());
  for (int i = 3; i >= 0; --i) z.push_back((ad >> (8 * i)) & 0xff);

  // PNG container.
  auto be32 = [](std::vector<uint8_t>& v, uint32_t x) {
    for (int i = 3; i >= 0; --i) v.push_back((x >> (8 * i)) & 0xff);
  };
  std::vector<uint8_t> png;
  png.reserve(z.size() + 128);
  const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  png.insert(png.end(), sig, sig + 8);

  auto chunk = [&](const char* tag, const uint8_t* data, size_t len) {
    be32(png, static_cast<uint32_t>(len));
    size_t start = png.size();
    png.insert(png.end(), tag, tag + 4);
    png.insert(png.end(), data, data + len);
    uint32_t crc = crc32_update(0, png.data() + start, len + 4);
    be32(png, crc);
  };

  uint8_t ihdr[13];
  ihdr[0] = (width >> 24) & 0xff;
  ihdr[1] = (width >> 16) & 0xff;
  ihdr[2] = (width >> 8) & 0xff;
  ihdr[3] = width & 0xff;
  ihdr[4] = (height >> 24) & 0xff;
  ihdr[5] = (height >> 16) & 0xff;
  ihdr[6] = (height >> 8) & 0xff;
  ihdr[7] = height & 0xff;
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 2;   // color type RGB
  ihdr[10] = 0;  // compression
  ihdr[11] = 0;  // filter
  ihdr[12] = 0;  // interlace
  chunk("IHDR", ihdr, 13);
  chunk("IDAT", z.data(), z.size());
  chunk("IEND", nullptr, 0);

  int64_t total = static_cast<int64_t>(png.size());
  if (!out) return total;
  if (out_cap < total) return -1;
  std::memcpy(out, png.data(), total);
  return total;
}

}  // extern "C"

// Native data-loader core of the port: parallel PNG/JPEG decode into one
// uint8 NHWC batch (the port's own copy of the JAX package's native loader,
// with the same C entry points and semantics).
//
// A persistent pthread pool decodes a whole batch of image files straight
// into one contiguous (n, h, w, 3) uint8 buffer, outside the Python GIL;
// Python binds through ctypes (ddl_tpu_torch/native/__init__.py), which
// builds this file with g++ at first use.
//
// API (C linkage):
//   ddl_pool_init(n_threads)            -> 0 on success
//   ddl_load_batch(paths, n, h, w, out) -> number of images decoded OK;
//        each failed slot is zero-filled.
//   ddl_image_size(path, &h, &w)        -> probe a PNG's dimensions
//   ddl_pool_shutdown()
//
// PNG is decoded here on top of zlib (inflate and CRC-32): the chunks with
// their CRC checks, the five filters, Adam7, every bit depth and colour
// type, promoted to 8-bit RGB as libpng's transforms promote them (the JAX
// package decodes through libpng, which hosts may lack).
//
// Compile-time switch (set by the binding from a link probe):
//   DDL_LIBJPEG  decode .jpg/.jpeg with libjpeg; without it such a file
//                fails to decode (its slot is zero-filled and counted as
//                failed).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <condition_variable>
#include <functional>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

#ifndef DDL_LIBJPEG
#define DDL_LIBJPEG 0
#endif

#if DDL_LIBJPEG
extern "C" {
#include <jpeglib.h>
}
#endif

namespace {

// ---------------------------------------------------------------- thread pool
class Pool {
 public:
  explicit Pool(int n) : stop_(false) {
    for (int i = 0; i < n; ++i) {
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> job;
          {
            std::unique_lock<std::mutex> lk(mu_);
            cv_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
            if (stop_ && jobs_.empty()) return;
            job = std::move(jobs_.front());
            jobs_.pop();
          }
          job();
        }
      });
    }
  }
  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }
  void submit(std::function<void()> f) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      jobs_.push(std::move(f));
    }
    cv_.notify_one();
  }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> jobs_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_;
};

Pool* g_pool = nullptr;

// ------------------------------------------------------------------ PNG decode

const uint8_t kSignature[8] = {137, 80, 78, 71, 13, 10, 26, 10};

uint32_t be32(const uint8_t* p) {
  return (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 | p[3];
}

// zlib stream -> exactly `want` bytes (the PNG's filtered scanlines); zlib
// checks the stream's header and its Adler-32.
bool zlib_inflate(const uint8_t* src, size_t n, size_t want, std::vector<uint8_t>& out) {
  out.resize(want);
  uLongf got = want;
  return uncompress(out.data(), &got, src, n) == Z_OK && got == want;
}

int paeth(int a, int b, int c) {
  int p = a + b - c, pa = p > a ? p - a : a - p, pb = p > b ? p - b : b - p,
      pc = p > c ? p - c : c - p;
  return pa <= pb && pa <= pc ? a : pb <= pc ? b : c;
}

// Undo the five filters of `rows` scanlines of `rowbytes` each (every row
// led by its filter byte), in place; `bpp` is the byte distance to the
// previous pixel (at least 1).
bool unfilter(uint8_t* data, int rows, size_t rowbytes, int bpp) {
  const uint8_t* prev = nullptr;
  for (int y = 0; y < rows; ++y) {
    uint8_t* row = data + y * (rowbytes + 1);
    int f = row[0];
    uint8_t* x = row + 1;
    for (size_t i = 0; i < rowbytes; ++i) {
      int a = i >= (size_t)bpp ? x[i - bpp] : 0;
      int b = prev ? prev[i] : 0;
      int c = prev && i >= (size_t)bpp ? prev[i - bpp] : 0;
      switch (f) {
        case 0: break;
        case 1: x[i] = (uint8_t)(x[i] + a); break;
        case 2: x[i] = (uint8_t)(x[i] + b); break;
        case 3: x[i] = (uint8_t)(x[i] + ((a + b) >> 1)); break;
        case 4: x[i] = (uint8_t)(x[i] + paeth(a, b, c)); break;
        default: return false;
      }
    }
    prev = x;
  }
  return true;
}

struct PngImage {
  int w = 0, h = 0, depth = 0, color = 0, interlace = 0;
  uint8_t palette[256][3] = {};  // unset entries stay black, as in libpng
  int npal = 0;
  std::vector<uint8_t> idat;
};

int channels_of(int color) {
  switch (color) {
    case 0: return 1;
    case 2: return 3;
    case 3: return 1;
    case 4: return 2;
    case 6: return 4;
  }
  return 0;
}

bool depth_ok(int color, int depth) {
  switch (color) {
    case 0: return depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16;
    case 3: return depth == 1 || depth == 2 || depth == 4 || depth == 8;
    case 2: case 4: case 6: return depth == 8 || depth == 16;
  }
  return false;
}

int read_file(const char* path, std::vector<uint8_t>& data) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return -1;
  uint8_t buf[65536];
  size_t got;
  while ((got = fread(buf, 1, sizeof buf, fp)) > 0) data.insert(data.end(), buf, buf + got);
  fclose(fp);
  return 0;
}

// Chunks -> header, palette and the concatenated IDAT stream.  With
// `header_only` it stops after IHDR.  Critical chunks' CRCs are checked
// (libpng refuses a file whose IHDR, PLTE or IDAT CRC is wrong).
int parse_png(const char* path, PngImage& img, bool header_only) {
  std::vector<uint8_t> data;
  if (read_file(path, data)) return -1;
  if (data.size() < 8 || memcmp(data.data(), kSignature, 8)) return -2;
  size_t pos = 8;
  bool have_header = false;
  while (pos + 12 <= data.size()) {
    uint32_t len = be32(&data[pos]);
    const uint8_t* type = &data[pos + 4];
    if (len > data.size() - pos - 12) return -3;
    const uint8_t* body = type + 4;
    bool critical = !(type[0] & 32);
    if (critical && crc32(0, type, len + 4) != be32(body + len)) return -3;
    pos += 12 + (size_t)len;
    if (!memcmp(type, "IHDR", 4)) {
      if (have_header || len != 13) return -3;
      img.w = (int)be32(body);
      img.h = (int)be32(body + 4);
      img.depth = body[8];
      img.color = body[9];
      img.interlace = body[12];
      if (img.w <= 0 || img.h <= 0 || !depth_ok(img.color, img.depth) || body[10] || body[11] ||
          img.interlace > 1)
        return -3;
      have_header = true;
      if (header_only) return 0;
    } else if (!have_header) {
      return -3;  // IHDR must come first
    } else if (!memcmp(type, "PLTE", 4)) {
      if (len % 3 || len / 3 > 256) return -3;
      img.npal = (int)(len / 3);
      memcpy(img.palette, body, len);
    } else if (!memcmp(type, "IDAT", 4)) {
      img.idat.insert(img.idat.end(), body, body + len);
    } else if (!memcmp(type, "IEND", 4)) {
      return img.color == 3 && img.npal == 0 ? -3 : 0;
    } else if (critical) {
      return -3;  // an unknown critical chunk
    }
  }
  return -3;  // no IEND
}

// One sample of a scanline: depths below 8 pack MSB first; 16-bit keeps
// its high byte (libpng's png_set_strip_16).
inline int sample(const uint8_t* row, size_t i, int depth) {
  if (depth == 8) return row[i];
  if (depth == 16) return row[2 * i];
  size_t bit = i * depth;
  return row[bit >> 3] >> (8 - depth - (bit & 7)) & ((1 << depth) - 1);
}

// A scanline of `n` pixels -> RGB8 at `out`, `stride` bytes apart
// (libpng's transforms: palette -> RGB, gray 1/2/4 -> 8 by bit
// replication, 16 -> 8, gray -> RGB, alpha and tRNS dropped).
void to_rgb(const PngImage& img, const uint8_t* row, int n, uint8_t* out, size_t stride) {
  int ch = channels_of(img.color), d = img.depth;
  for (int x = 0; x < n; ++x, out += stride) {
    size_t s = (size_t)x * ch;
    if (img.color == 3) {
      int idx = sample(row, s, d);
      memcpy(out, img.palette[idx], 3);
    } else if (img.color == 0 || img.color == 4) {
      int v = sample(row, s, d);
      if (d < 8) v = v * 255 / ((1 << d) - 1);
      out[0] = out[1] = out[2] = (uint8_t)v;
    } else {
      for (int c = 0; c < 3; ++c) out[c] = (uint8_t)sample(row, s + c, d);
    }
  }
}

int decode_png(const char* path, int h, int w, uint8_t* out) {
  PngImage img;
  int rc = parse_png(path, img, false);
  if (rc) return rc;
  if (img.w != w || img.h != h) return -4;
  int bits = channels_of(img.color) * img.depth;
  int bpp = bits >= 8 ? bits / 8 : 1;
  // the passes: the whole image, or Adam7's seven sub-images
  static const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                                   {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
  static const int kWhole[1][4] = {{0, 0, 1, 1}};
  const int(*passes)[4] = img.interlace ? kAdam7 : kWhole;
  int npass = img.interlace ? 7 : 1;
  size_t want = 0;
  for (int p = 0; p < npass; ++p) {
    size_t pw = (size_t)(w - passes[p][0] + passes[p][2] - 1) / passes[p][2];
    size_t ph = (size_t)(h - passes[p][1] + passes[p][3] - 1) / passes[p][3];
    if (w > passes[p][0] && h > passes[p][1]) want += ph * (1 + (pw * bits + 7) / 8);
  }
  std::vector<uint8_t> raw;
  if (!zlib_inflate(img.idat.data(), img.idat.size(), want, raw)) return -3;
  uint8_t* at = raw.data();
  for (int p = 0; p < npass; ++p) {
    int x0 = passes[p][0], y0 = passes[p][1], dx = passes[p][2], dy = passes[p][3];
    if (w <= x0 || h <= y0) continue;
    int pw = (w - x0 + dx - 1) / dx, ph = (h - y0 + dy - 1) / dy;
    size_t rowbytes = ((size_t)pw * bits + 7) / 8;
    if (!unfilter(at, ph, rowbytes, bpp)) return -3;
    for (int y = 0; y < ph; ++y)
      to_rgb(img, at + y * (rowbytes + 1) + 1, pw,
             out + ((size_t)(y0 + y * dy) * w + x0) * 3, (size_t)dx * 3);
    at += (size_t)ph * (rowbytes + 1);
  }
  return 0;
}

int png_size(const char* path, int* h, int* w) {
  PngImage img;
  int rc = parse_png(path, img, true);
  if (rc) return rc;
  *h = img.h;
  *w = img.w;
  return 0;
}

// --------------------------------------------------------------- JPEG decode
#if DDL_LIBJPEG
int decode_jpeg(const char* path, int h, int w, uint8_t* out) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return -1;
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    fclose(fp);
    return -2;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if ((int)cinfo.output_width != w || (int)cinfo.output_height != h) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    fclose(fp);
    return -4;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + (size_t)cinfo.output_scanline * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(fp);
  return 0;
}
#else
int decode_jpeg(const char*, int, int, uint8_t*) { return -5; }  // built without libjpeg
#endif

int decode_any(const char* path, int h, int w, uint8_t* out) {
  size_t n = strlen(path);
  if (n > 4 && (strcmp(path + n - 4, ".jpg") == 0 || strcmp(path + n - 5, ".jpeg") == 0))
    return decode_jpeg(path, h, w, out);
  return decode_png(path, h, w, out);
}

}  // namespace

extern "C" {

int ddl_pool_init(int n_threads) {
  if (g_pool) return 0;
  if (n_threads < 1) n_threads = 1;
  g_pool = new Pool(n_threads);
  return 0;
}

void ddl_pool_shutdown() {
  delete g_pool;
  g_pool = nullptr;
}

int ddl_image_size(const char* path, int* h, int* w) { return png_size(path, h, w); }

// Decode `n` images (newline-joined `paths`) into `out` (n*h*w*3 uint8,
// NHWC).  Failed slots are zero-filled; their count is the return deficit.
int ddl_load_batch(const char* paths, int n, int h, int w, uint8_t* out) {
  if (!g_pool) ddl_pool_init((int)std::thread::hardware_concurrency());
  std::vector<std::string> files;
  files.reserve(n);
  const char* p = paths;
  for (int i = 0; i < n; ++i) {
    const char* q = strchr(p, '\n');
    files.emplace_back(p, q ? (size_t)(q - p) : strlen(p));
    p = q ? q + 1 : p + files.back().size();
  }
  std::mutex mu;
  std::condition_variable cv;
  int done = 0, ok = 0;
  for (int i = 0; i < n; ++i) {
    g_pool->submit([&, i] {
      uint8_t* slot = out + (size_t)i * h * w * 3;
      int rc = decode_any(files[i].c_str(), h, w, slot);
      if (rc != 0) memset(slot, 0, (size_t)h * w * 3);
      std::lock_guard<std::mutex> lk(mu);
      ++done;
      if (rc == 0) ++ok;
      cv.notify_one();
    });
  }
  std::unique_lock<std::mutex> lk(mu);
  cv.wait(lk, [&] { return done == n; });
  return ok;
}

}  // extern "C"

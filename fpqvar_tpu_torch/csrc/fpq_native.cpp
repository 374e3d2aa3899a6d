// fpq_native — host-side native routines of fpqvar_tpu_torch.
//
// The port's copy of the JAX package's host library; the kernels that run
// on the card live in csrc/*.cu.  This library covers the host-side hot
// paths, the role the quant_cuda extension (the reference's
// quant/quant_kernel.cu) plays for the reference's CPU/GPU tools:
//
//   * fpq_snap          — nearest-grid snap over a flat f32 array
//                         (binary search over grid midpoints; ties snap to
//                         the larger value, matching quant_kernel.cu:31's
//                         `<=` scan semantics)
//   * fpq_encode        — nearest-grid code indices (for packing)
//   * fpq_pack_rows     — row-split nibble packing (two 4-bit codes/byte,
//                         layout documented in fpqvar_tpu_torch/ops/packing.py)
//   * fpq_images_to_u8  — NCHW float[0,1] -> NHWC uint8 image conversion
//                         (the 50k-image eval writer's inner loop)
//   * fpq_write_png / fpq_write_png_batch
//                       — RGB8 PNG encoder (zlib IDAT at level 1, per-row
//                         None/Sub filter choice) with one thread per image;
//                         the reference saves its 50k eval images one by one
//                         through torchvision/PIL
//                         (evaluate_fp_quant_transform_rotate.py:203-207)
//   * fpq_zlib_version  — the version of the libz this library runs on
//
// Multithreaded with std::thread; zlib is the only external dependency.
// Built at first use with `g++ -O3 -fPIC -shared ... -lpthread -lz` by
// fpqvar_tpu_torch/ops/_build.py (build_host) into its build directory and
// loaded through ctypes by fpqvar_tpu_torch/utils/native.py, which has a
// numpy fallback for every entry point.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

int hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n ? static_cast<int>(n) : 4;
}

template <typename F>
void parallel_for(int64_t n, F fn) {
  int nt = std::min<int64_t>(hw_threads(), std::max<int64_t>(1, n / 65536));
  if (nt <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back([=] { fn(lo, hi); });
  }
  for (auto& t : ts) t.join();
}

// index of nearest grid value; midpoint ties -> larger value.
// == searchsorted(mids, v, side="right"): the count of midpoints <= v.
inline int nearest_idx(float v, const float* mids, int n_mids) {
  return static_cast<int>(std::upper_bound(mids, mids + n_mids, v) - mids);
}

}  // namespace

extern "C" {

// x[n] -> out[n] snapped to the gn sorted grid values.
void fpq_snap(const float* x, int64_t n, const float* grid, int gn,
              float* out) {
  std::vector<float> mids(gn > 1 ? gn - 1 : 1);
  for (int i = 0; i + 1 < gn; ++i) mids[i] = 0.5f * (grid[i] + grid[i + 1]);
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i)
      out[i] = grid[nearest_idx(x[i], mids.data(), gn - 1)];
  });
}

// x[n] -> codes[n] (int32 indices into the sorted grid).
void fpq_encode(const float* x, int64_t n, const float* grid, int gn,
                int32_t* codes) {
  std::vector<float> mids(gn > 1 ? gn - 1 : 1);
  for (int i = 0; i + 1 < gn; ++i) mids[i] = 0.5f * (grid[i] + grid[i + 1]);
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i)
      codes[i] = nearest_idx(x[i], mids.data(), gn - 1);
  });
}

// codes [rows, cols] int32 (rows % 128 == 0) -> bytes [rows/2, cols]:
// within each 128-row tile, byte row r = code[r] | code[r+64] << 4.
void fpq_pack_rows(const int32_t* codes, int64_t rows, int64_t cols,
                   int8_t* out) {
  int64_t tiles = rows / 128;
  parallel_for(tiles * 64 * cols, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int64_t c = i % cols;
      int64_t rr = i / cols;         // 0 .. tiles*64
      int64_t tile = rr / 64, r = rr % 64;
      const int32_t* base = codes + (tile * 128) * cols;
      int v = (base[r * cols + c] & 0xF) |
              ((base[(r + 64) * cols + c] & 0xF) << 4);
      out[(tile * 64 + r) * cols + c] = static_cast<int8_t>(v);
    }
  });
}

// imgs [B, 3, H, W] float in [0,1] -> out [B, H, W, 3] uint8
void fpq_images_to_u8(const float* imgs, int64_t b, int64_t h, int64_t w,
                      uint8_t* out) {
  int64_t hw = h * w;
  parallel_for(b * hw, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int64_t bi = i / hw, px = i % hw;
      const float* src = imgs + bi * 3 * hw + px;
      uint8_t* dst = out + (bi * hw + px) * 3;
      for (int c = 0; c < 3; ++c) {
        float v = src[c * hw] * 255.0f;
        v = std::max(0.0f, std::min(255.0f, v));
        dst[c] = static_cast<uint8_t>(v);
      }
    }
  });
}

namespace {

void put_be32(uint8_t* p, uint32_t v) {
  p[0] = v >> 24; p[1] = v >> 16; p[2] = v >> 8; p[3] = v;
}

// append one PNG chunk (length, 4-char type, data, CRC over type+data)
void put_chunk(std::vector<uint8_t>& out, const char* type,
               const uint8_t* data, size_t n) {
  uint8_t hdr[8];
  put_be32(hdr, static_cast<uint32_t>(n));
  std::memcpy(hdr + 4, type, 4);
  out.insert(out.end(), hdr, hdr + 8);
  if (n) out.insert(out.end(), data, data + n);
  uLong crc = crc32(0L, reinterpret_cast<const Bytef*>(type), 4);
  if (n) crc = crc32(crc, data, static_cast<uInt>(n));
  uint8_t c[4];
  put_be32(c, static_cast<uint32_t>(crc));
  out.insert(out.end(), c, c + 4);
}

// encode one [h, w, 3] uint8 image into a PNG byte stream.
// Per row, pick None or Sub filtering by absolute-residual heuristic —
// Sub helps smooth natural images considerably at deflate level 1.
bool encode_png(const uint8_t* img, int64_t h, int64_t w,
                std::vector<uint8_t>& png) {
  const int64_t stride = w * 3;
  std::vector<uint8_t> raw(static_cast<size_t>(h) * (stride + 1));
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* row = img + y * stride;
    uint8_t* dst = raw.data() + y * (stride + 1);
    int64_t none_cost = 0, sub_cost = 0;
    for (int64_t i = 0; i < stride; ++i) {
      uint8_t left = i >= 3 ? row[i - 3] : 0;
      int8_t d = static_cast<int8_t>(row[i] - left);
      none_cost += row[i] < 128 ? row[i] : 256 - row[i];
      sub_cost += d >= 0 ? d : -d;
    }
    if (sub_cost < none_cost) {
      dst[0] = 1;  // Sub
      for (int64_t i = 0; i < stride; ++i)
        dst[1 + i] = static_cast<uint8_t>(row[i] - (i >= 3 ? row[i - 3] : 0));
    } else {
      dst[0] = 0;  // None
      std::memcpy(dst + 1, row, stride);
    }
  }
  uLongf bound = compressBound(static_cast<uLong>(raw.size()));
  std::vector<uint8_t> idat(bound);
  if (compress2(idat.data(), &bound, raw.data(),
                static_cast<uLong>(raw.size()), 1) != Z_OK)
    return false;
  idat.resize(bound);

  png.clear();
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  png.insert(png.end(), sig, sig + 8);
  uint8_t ihdr[13];
  put_be32(ihdr, static_cast<uint32_t>(w));
  put_be32(ihdr + 4, static_cast<uint32_t>(h));
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 2;   // truecolor RGB
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  put_chunk(png, "IHDR", ihdr, 13);
  put_chunk(png, "IDAT", idat.data(), idat.size());
  put_chunk(png, "IEND", nullptr, 0);
  return true;
}

bool write_file(const char* path, const std::vector<uint8_t>& bytes) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return false;
  size_t n = std::fwrite(bytes.data(), 1, bytes.size(), f);
  return std::fclose(f) == 0 && n == bytes.size();
}

}  // namespace

// img [h, w, 3] uint8 -> PNG file at path.  Returns 0 on success.
int fpq_write_png(const uint8_t* img, int64_t h, int64_t w,
                  const char* path) {
  std::vector<uint8_t> png;
  if (!encode_png(img, h, w, png) || !write_file(path, png)) return 1;
  return 0;
}

// imgs [b, h, w, 3] uint8 -> one PNG per path; images encoded and written
// in parallel.  Returns the number of failures (0 = all written).
int fpq_write_png_batch(const uint8_t* imgs, int64_t b, int64_t h,
                        int64_t w, const char* const* paths) {
  std::vector<int> fails(static_cast<size_t>(b), 0);
  int nt = std::min<int64_t>(hw_threads(), b);
  std::vector<std::thread> ts;
  for (int t = 0; t < nt; ++t) {
    ts.emplace_back([&, t] {
      for (int64_t i = t; i < b; i += nt)
        fails[i] = fpq_write_png(imgs + i * h * w * 3, h, w, paths[i]);
    });
  }
  for (auto& th : ts) th.join();
  int total = 0;
  for (int f : fails) total += f;
  return total;
}

const char* fpq_zlib_version() { return zlibVersion(); }

int fpq_abi_version() { return 2; }

}  // extern "C"

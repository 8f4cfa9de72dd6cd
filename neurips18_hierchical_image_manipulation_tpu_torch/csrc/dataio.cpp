// Host data-IO loops of the data pipeline (C ABI, loaded with ctypes by
// data/native.py, which builds this file with g++ at first use).
//
// The numpy forms of these loops (data/hostops.py) are the host's share of
// the streaming loader's time, so they are implemented natively:
//
//   himan_extract_bboxes     per-instance-id bounding boxes of an instance
//                            map (id = class*1000+k), one O(H*W) pass
//                            instead of numpy's unique() + nonzero() per id
//   himan_u8_to_pm1          uint8 -> float32 in [-1, 1] (Normalize(0.5, 0.5))
//   himan_nearest_resize_i32 nearest resize of an int32 id map at pixel
//                            centres, index floor((i + 0.5) * in / out)
//   himan_box_mask_f32       binary box-interior mask
//
// Every entry returns what its numpy form returns, bit for bit.

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// Scans an int32 instance map and writes up to max_records records of
// (inst_id, cls, y0, x0, h, w) into out (int32, row-major 6 cols), in no
// particular order. Only ids >= min_id (1000: Cityscapes things). Returns
// the number of records written; max_records means there may be more.
int32_t himan_extract_bboxes(const int32_t* inst, int32_t h, int32_t w,
                             int32_t min_id, int32_t* out,
                             int32_t max_records) {
  struct Box {
    int32_t y0, x0, y1, x1;
  };
  std::unordered_map<int32_t, Box> boxes;
  boxes.reserve(64);
  for (int32_t y = 0; y < h; ++y) {
    const int32_t* row = inst + (int64_t)y * w;
    for (int32_t x = 0; x < w; ++x) {
      int32_t id = row[x];
      if (id < min_id) continue;
      auto it = boxes.find(id);
      if (it == boxes.end()) {
        boxes.emplace(id, Box{y, x, y, x});
      } else {
        Box& b = it->second;
        if (y < b.y0) b.y0 = y;
        if (y > b.y1) b.y1 = y;
        if (x < b.x0) b.x0 = x;
        if (x > b.x1) b.x1 = x;
      }
    }
  }
  int32_t n = 0;
  for (const auto& kv : boxes) {
    if (n >= max_records) break;
    const Box& b = kv.second;
    int32_t* rec = out + (int64_t)n * 6;
    rec[0] = kv.first;
    rec[1] = kv.first / 1000;
    rec[2] = b.y0;
    rec[3] = b.x0;
    rec[4] = b.y1 - b.y0 + 1;
    rec[5] = b.x1 - b.x0 + 1;
    ++n;
  }
  return n;
}

// uint8 -> float32 in [-1, 1]: dst = src / 127.5 - 1, from a table built
// once (a function-local static: its initialization is thread-safe, and the
// loader's worker threads call this concurrently).
struct Pm1Table {
  float v[256];
  Pm1Table() {
    for (int i = 0; i < 256; ++i) v[i] = (float)i / 127.5f - 1.0f;
  }
};

void himan_u8_to_pm1(const uint8_t* src, float* dst, int64_t n) {
  static const Pm1Table lut;
  for (int64_t i = 0; i < n; ++i) dst[i] = lut.v[src[i]];
}

// Nearest resize of an int32 (H,W) map to (oh, ow): src index =
// floor((i + 0.5) * in / out), the product rounded before the division as
// numpy rounds it (a precomputed in / out scale would round once more and
// move an index that lands on an integer).
void himan_nearest_resize_i32(const int32_t* src, int32_t h, int32_t w,
                              int32_t* dst, int32_t oh, int32_t ow) {
  std::vector<int32_t> xi(ow);
  for (int32_t x = 0; x < ow; ++x) {
    int32_t v = (int32_t)(((x + 0.5) * w) / ow);
    xi[x] = v < w ? v : w - 1;
  }
  for (int32_t y = 0; y < oh; ++y) {
    int32_t yi = (int32_t)(((y + 0.5) * h) / oh);
    if (yi >= h) yi = h - 1;
    const int32_t* srow = src + (int64_t)yi * w;
    int32_t* drow = dst + (int64_t)y * ow;
    for (int32_t x = 0; x < ow; ++x) drow[x] = srow[xi[x]];
  }
}

// Binary box mask (float32 HxW): 1 inside [y0,y0+bh) x [x0,x0+bw), 0
// elsewhere.
void himan_box_mask_f32(float* dst, int32_t h, int32_t w, int32_t y0,
                        int32_t x0, int32_t bh, int32_t bw) {
  std::memset(dst, 0, sizeof(float) * (int64_t)h * w);
  int32_t y1 = y0 + bh < h ? y0 + bh : h;
  int32_t x1 = x0 + bw < w ? x0 + bw : w;
  if (y0 < 0) y0 = 0;
  if (x0 < 0) x0 = 0;
  for (int32_t y = y0; y < y1; ++y) {
    float* row = dst + (int64_t)y * w;
    for (int32_t x = x0; x < x1; ++x) row[x] = 1.0f;
  }
}

}  // extern "C"

// Feature loader of the PyTorch port: threaded host-side batch assembly
// (the port's own copy of native/feature_loader.cpp, built by
// hriemo_torch/native.py into hriemo_torch/_build/).
//
// The reference's host data path is Python DataLoader workers deserialising
// torch .pt files per utterance (reference: scripts/fusion/
// train_mosei_fusion_seq_level_decoder.py:534-541). Here the hot host loop
// (read feature file -> NaN-clean -> center-crop -> pad into the bucket
// tensor -> build the True=PAD mask) is C++ with a std::thread pool, called
// from Python via ctypes (the GIL is released for the whole call), so batch
// assembly overlaps with device compute and with itself across items.
//
// Supports the .npy and .npz feature artifacts directly:
//   * .npy  — v1/v2 headers, '<f4'/'<f8' payloads, [L,d] or [d];
//   * .npz  — numpy's zipfile output; members are STORED (method 0), so the
//     local file headers are walked without any zip library. Members used:
//     "hidden.npy" (+ optional "attention_mask.npy", '<i8'/'<i4'/'|b1').
//
// Semantics match hriemo_torch.data (tests drive both paths):
//   * NaN/Inf -> 0 (feature_store._clean);
//   * max_len > 0 -> center crop AND mask reset to all-valid for the kept
//     rows (the reference's crop quirk, train_mosei_...py:278-283);
//   * output pad mask: 1 = PAD.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread feature_loader.cpp -o libhriemo_torch_loader.so

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Array {
  std::vector<float> data;  // row-major
  int64_t rows = 0;         // L (1 for [d] vectors)
  int64_t cols = 0;         // d
};

struct Mask {
  std::vector<uint8_t> valid;  // 1 = valid
  bool present = false;
};

bool read_file(const std::string& path, std::vector<uint8_t>& out) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out.resize(static_cast<size_t>(n));
  size_t got = std::fread(out.data(), 1, out.size(), f);
  std::fclose(f);
  return got == out.size();
}

uint16_t rd16(const uint8_t* p) { uint16_t v; std::memcpy(&v, p, 2); return v; }
uint32_t rd32(const uint8_t* p) { uint32_t v; std::memcpy(&v, p, 4); return v; }

// Parse an .npy blob. Returns dtype code: 0 unknown, 4 f32, 8 f64, 14 i4,
// 18 i8, 1 b1/u1. Shape parsed from the header dict.
int parse_npy(const uint8_t* buf, size_t len, const uint8_t** data_out,
              int64_t* rows, int64_t* cols) {
  if (len < 10 || std::memcmp(buf, "\x93NUMPY", 6) != 0) return 0;
  int major = buf[6];
  size_t hlen, hoff;
  if (major == 1) { hlen = rd16(buf + 8); hoff = 10; }
  else { hlen = rd32(buf + 8); hoff = 12; }
  if (hoff + hlen > len) return 0;
  std::string header(reinterpret_cast<const char*>(buf + hoff), hlen);

  int code = 0;
  if (header.find("<f4") != std::string::npos) code = 4;
  else if (header.find("<f8") != std::string::npos) code = 8;
  else if (header.find("<i8") != std::string::npos) code = 18;
  else if (header.find("<i4") != std::string::npos) code = 14;
  else if (header.find("|b1") != std::string::npos ||
           header.find("|u1") != std::string::npos) code = 1;
  if (code == 0) return 0;
  if (header.find("'fortran_order': True") != std::string::npos) return 0;

  size_t sp = header.find("'shape':");
  if (sp == std::string::npos) return 0;
  size_t lp = header.find('(', sp), rp = header.find(')', sp);
  if (lp == std::string::npos || rp == std::string::npos) return 0;
  std::string shape = header.substr(lp + 1, rp - lp - 1);
  long long r = 0, c = 0;
  int n = std::sscanf(shape.c_str(), "%lld , %lld", &r, &c);
  if (n <= 0) { r = 1; c = 1; }          // scalar — unsupported shape, treat [1,1]
  else if (n == 1 || c == 0) { c = r; r = 1; }  // [d] vector
  *rows = r; *cols = c;
  *data_out = buf + hoff + hlen;
  size_t need = static_cast<size_t>(r) * c *
                (code == 4 ? 4 : code == 8 ? 8 : code == 18 ? 8 : code == 14 ? 4 : 1);
  if (hoff + hlen + need > len) return 0;
  return code;
}

void decode_floats(const uint8_t* src, int code, int64_t count, float* dst) {
  if (code == 4) {
    std::memcpy(dst, src, count * 4);
  } else if (code == 8) {
    const double* d = reinterpret_cast<const double*>(src);
    for (int64_t i = 0; i < count; ++i) dst[i] = static_cast<float>(d[i]);
  }
  for (int64_t i = 0; i < count; ++i) {
    if (!std::isfinite(dst[i])) dst[i] = 0.0f;  // NaN/Inf -> 0
  }
}

void decode_mask(const uint8_t* src, int code, int64_t count, uint8_t* dst) {
  if (code == 18) {
    const int64_t* v = reinterpret_cast<const int64_t*>(src);
    for (int64_t i = 0; i < count; ++i) dst[i] = v[i] != 0;
  } else if (code == 14) {
    const int32_t* v = reinterpret_cast<const int32_t*>(src);
    for (int64_t i = 0; i < count; ++i) dst[i] = v[i] != 0;
  } else if (code == 1) {
    for (int64_t i = 0; i < count; ++i) dst[i] = src[i] != 0;
  }
}

// Walk stored-only zip local headers; find "hidden.npy" / "attention_mask.npy".
bool load_npz(const std::vector<uint8_t>& blob, Array* arr, Mask* mask) {
  size_t off = 0;
  bool found_hidden = false;
  while (off + 30 <= blob.size()) {
    if (rd32(blob.data() + off) != 0x04034b50u) break;
    uint16_t method = rd16(blob.data() + off + 8);
    uint64_t csize = rd32(blob.data() + off + 18);
    uint64_t usize = rd32(blob.data() + off + 22);
    uint16_t nlen = rd16(blob.data() + off + 26);
    uint16_t elen = rd16(blob.data() + off + 28);
    std::string name(reinterpret_cast<const char*>(blob.data() + off + 30), nlen);
    // zip64: 32-bit sizes are 0xFFFFFFFF, real sizes in extra field 0x0001
    // (uncompressed first, then compressed — only fields that overflowed).
    if (csize == 0xFFFFFFFFu || usize == 0xFFFFFFFFu) {
      size_t ep = off + 30 + nlen, eend = ep + elen;
      while (ep + 4 <= eend) {
        uint16_t tag = rd16(blob.data() + ep);
        uint16_t tsz = rd16(blob.data() + ep + 2);
        if (tag == 0x0001 && ep + 4 + tsz <= eend) {
          size_t fp = ep + 4;
          if (usize == 0xFFFFFFFFu && fp + 8 <= eend) {
            std::memcpy(&usize, blob.data() + fp, 8); fp += 8;
          }
          if (csize == 0xFFFFFFFFu && fp + 8 <= eend) {
            std::memcpy(&csize, blob.data() + fp, 8);
          }
          break;
        }
        ep += 4 + tsz;
      }
      if (csize == 0xFFFFFFFFu) csize = usize;  // stored: equal sizes
    }
    size_t data_off = off + 30 + nlen + elen;
    if (method == 0 && data_off + csize <= blob.size()) {
      const uint8_t* payload;
      int64_t r, c;
      if (name == "hidden.npy") {
        int code = parse_npy(blob.data() + data_off, csize, &payload, &r, &c);
        if (code != 4 && code != 8) return false;
        arr->rows = r; arr->cols = c;
        arr->data.resize(static_cast<size_t>(r) * c);
        decode_floats(payload, code, r * c, arr->data.data());
        found_hidden = true;
      } else if (name == "attention_mask.npy") {
        int code = parse_npy(blob.data() + data_off, csize, &payload, &r, &c);
        if (code == 18 || code == 14 || code == 1) {
          int64_t count = r * c;
          mask->valid.resize(static_cast<size_t>(count));
          decode_mask(payload, code, count, mask->valid.data());
          mask->present = true;
        }
      }
    }
    off = data_off + csize;
  }
  return found_hidden;
}

bool load_feature(const std::string& path, Array* arr, Mask* mask) {
  std::vector<uint8_t> blob;
  if (!read_file(path, blob)) return false;
  if (blob.size() >= 4 && rd32(blob.data()) == 0x04034b50u)
    return load_npz(blob, arr, mask);
  const uint8_t* payload;
  int64_t r, c;
  int code = parse_npy(blob.data(), blob.size(), &payload, &r, &c);
  if (code != 4 && code != 8) return false;
  arr->rows = r; arr->cols = c;
  arr->data.resize(static_cast<size_t>(r) * c);
  decode_floats(payload, code, r * c, arr->data.data());
  return true;
}

// Fill one bucket slot: crop/pad + mask (1 = PAD in the output).
bool fill_slot(const std::string& path, float* hidden_out, uint8_t* pad_out,
               int64_t bucket_len, int64_t dim, int64_t max_len) {
  Array arr;
  Mask mask;
  if (!load_feature(path, &arr, &mask)) return false;
  if (arr.cols != dim) return false;

  int64_t start = 0, rows = arr.rows;
  bool mask_reset = false;
  if (max_len > 0 && rows > max_len) {        // center crop (reference quirk:
    start = (rows - max_len) / 2;             //  crop resets mask to all-valid)
    rows = max_len;
    mask_reset = true;
  } else if (max_len > 0) {
    mask_reset = true;
  }
  int64_t copy = rows < bucket_len ? rows : bucket_len;

  std::memcpy(hidden_out, arr.data.data() + start * dim,
              static_cast<size_t>(copy) * dim * sizeof(float));
  if (copy < bucket_len)
    std::memset(hidden_out + copy * dim, 0,
                static_cast<size_t>(bucket_len - copy) * dim * sizeof(float));

  for (int64_t t = 0; t < bucket_len; ++t) {
    bool valid = t < copy;
    if (valid && !mask_reset && mask.present &&
        static_cast<size_t>(start + t) < mask.valid.size())
      valid = mask.valid[start + t] != 0;
    pad_out[t] = valid ? 0 : 1;  // 1 = PAD
  }
  return true;
}

}  // namespace

extern "C" {

// Assemble one modality of a batch. paths: n C strings. hidden_out:
// [n, bucket_len, dim] f32. pad_out: [n, bucket_len] u8 (1 = PAD).
// status_out: per-item 0 = ok, 1 = failure. Returns number of failures.
int hriemo_assemble(const char** paths, int n,
                    float* hidden_out, uint8_t* pad_out,
                    long long bucket_len, long long dim, long long max_len,
                    int n_threads) {
  std::atomic<int> next(0), failures(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      bool ok = fill_slot(paths[i],
                          hidden_out + static_cast<int64_t>(i) * bucket_len * dim,
                          pad_out + static_cast<int64_t>(i) * bucket_len,
                          bucket_len, dim, max_len);
      if (!ok) failures.fetch_add(1);
    }
  };
  int nt = n_threads > 0 ? n_threads : 1;
  if (nt > n) nt = n;
  std::vector<std::thread> pool;
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failures.load();
}

}  // extern "C"

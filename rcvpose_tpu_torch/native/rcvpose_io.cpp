// rcvpose_io: native host-side IO for the data pipeline (the port's own
// copy of rcvpose_tpu/native/rcvpose_io.cpp, unchanged below this header).
//
// Zero-copy .dpt depth decoding and a threaded batch file reader that
// overlaps disk IO with device compute (the loader's producer thread calls
// batch_read_dpt once per batch). Host IO only: no device code.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in the image).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// Decode one .dpt buffer: [uint32 h][uint32 w][uint16 payload h*w].
// Returns 0 on success, negative error code otherwise.
// out must hold max_h * max_w uint16; *out_h/*out_w receive dimensions.
int decode_dpt(const uint8_t* buf, int64_t len, uint16_t* out,
               int64_t max_elems, uint32_t* out_h, uint32_t* out_w) {
  if (len < 8) return -1;
  uint32_t h, w;
  std::memcpy(&h, buf, 4);
  std::memcpy(&w, buf + 4, 4);
  const int64_t elems = static_cast<int64_t>(h) * w;
  if (elems <= 0 || elems > max_elems) return -2;
  if (len < 8 + elems * 2) return -3;
  std::memcpy(out, buf + 8, elems * 2);
  *out_h = h;
  *out_w = w;
  return 0;
}

static int read_one_dpt(const char* path, uint16_t* out, int64_t max_elems,
                        uint32_t* out_h, uint32_t* out_w) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -10;
  std::fseek(f, 0, SEEK_END);
  const long len = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(static_cast<size_t>(len));
  const size_t got = std::fread(buf.data(), 1, buf.size(), f);
  std::fclose(f);
  if (got != buf.size()) return -11;
  return decode_dpt(buf.data(), static_cast<int64_t>(got), out, max_elems,
                    out_h, out_w);
}

int read_dpt(const char* path, uint16_t* out, int64_t max_elems,
             uint32_t* out_h, uint32_t* out_w) {
  return read_one_dpt(path, out, max_elems, out_h, out_w);
}

// Read n .dpt files concurrently into out[n * max_elems]. paths is a
// '\n'-separated list. dims receives n (h, w) pairs. status receives a
// per-file return code. n_threads <= 0 selects the hardware concurrency.
void batch_read_dpt(const char* paths, int64_t n, uint16_t* out,
                    int64_t max_elems, uint32_t* dims, int* status,
                    int n_threads) {
  std::vector<std::string> files;
  files.reserve(static_cast<size_t>(n));
  const char* p = paths;
  for (int64_t i = 0; i < n; ++i) {
    const char* nl = std::strchr(p, '\n');
    const size_t span = nl ? static_cast<size_t>(nl - p) : std::strlen(p);
    files.emplace_back(p, span);
    p += span + (nl ? 1 : 0);
  }
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 2;
  }
  std::vector<std::thread> pool;
  std::vector<int64_t> next(1, 0);
  std::mutex* mu = new std::mutex();
  auto worker = [&]() {
    for (;;) {
      int64_t i;
      {
        std::lock_guard<std::mutex> lock(*mu);
        if (next[0] >= n) return;
        i = next[0]++;
      }
      status[i] = read_one_dpt(files[static_cast<size_t>(i)].c_str(),
                               out + i * max_elems, max_elems,
                               dims + i * 2, dims + i * 2 + 1);
    }
  };
  const int k = static_cast<int>(std::min<int64_t>(n_threads, n));
  for (int t = 0; t < k; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  delete mu;
}

}  // extern "C"

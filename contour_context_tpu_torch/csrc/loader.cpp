// Native data plane of the torch port: KITTI/MulRan .bin reader + threaded
// prefetcher. The port's own copy of csrc/loader.cpp, built by
// contour_context_tpu_torch/utils/native_loader.py.
//
// The reference's C++ loader (pointcloud_util.h:11-50 readKITTIPointCloudBin)
// plus a multi-threaded prefetch ring and a block reader that fill the host
// side of the device upload without GIL-bound Python file IO on the critical
// path (pipeline.py stages blocks and chains through c2_read_block).
//
// Layout contract (utils/io.py pad_points): each scan is written into a
// (max_points, 4) float32 row-major buffer: columns x, y, z, valid; rows past
// the true point count carry x=1e6, valid=0 so they also fail the BEV bounds
// check. Points are read with stride 4 (x, y, z, reflectance -> dropped).
//
// C ABI only (consumed via ctypes; pybind11 is not available in this image).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr float kPadX = 1e6f;

// Fill `out` (max_points x 4 f32) from a raw float32x4 .bin file.
// Returns the number of valid points, or -1 on IO error.
int read_bin_padded_impl(const char* path, float* out, int max_points) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return -1;
  }
  const size_t n_floats = static_cast<size_t>(st.st_size) / sizeof(float);
  const int n_pts_file = static_cast<int>(n_floats / 4);
  const int n = n_pts_file < max_points ? n_pts_file : max_points;

  const float* src = nullptr;
  void* mapped = nullptr;
  if (st.st_size > 0) {
    mapped = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (mapped == MAP_FAILED) {
      close(fd);
      return -1;
    }
    src = static_cast<const float*>(mapped);
  }

  for (int i = 0; i < n; ++i) {
    out[4 * i + 0] = src[4 * i + 0];
    out[4 * i + 1] = src[4 * i + 1];
    out[4 * i + 2] = src[4 * i + 2];
    out[4 * i + 3] = 1.0f;
  }
  for (int i = n; i < max_points; ++i) {
    out[4 * i + 0] = kPadX;
    out[4 * i + 1] = 0.0f;
    out[4 * i + 2] = 0.0f;
    out[4 * i + 3] = 0.0f;
  }
  if (mapped != nullptr) munmap(mapped, st.st_size);
  close(fd);
  return n;
}

struct Slot {
  std::vector<float> buf;
  int n_points = 0;
  int index = -1;           // global scan index held by this slot
  bool ready = false;
};

// Bounded in-order prefetcher: worker threads claim scan indices, read into
// slots of a ring of size `depth`; the consumer pops strictly in order.
struct Prefetcher {
  std::vector<std::string> paths;
  int max_points;
  int depth;
  std::vector<Slot> slots;

  std::mutex mu;
  std::condition_variable cv_ready;   // consumer waits for slots[head].ready
  std::condition_variable cv_free;    // workers wait for a free slot
  int next_claim = 0;                 // next scan index to be claimed
  int head = 0;                       // next scan index the consumer will pop
  std::atomic<bool> stop{false};
  std::vector<std::thread> workers;

  Prefetcher(std::vector<std::string> p, int mp, int d, int n_threads)
      : paths(std::move(p)), max_points(mp), depth(d), slots(d) {
    for (auto& s : slots) s.buf.resize(static_cast<size_t>(mp) * 4);
    for (int t = 0; t < n_threads; ++t)
      workers.emplace_back([this] { work(); });
  }

  ~Prefetcher() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_free.notify_all();
    cv_ready.notify_all();
    for (auto& w : workers) w.join();
  }

  void work() {
    while (true) {
      int idx;
      Slot* slot;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] {
          return stop || (next_claim < static_cast<int>(paths.size()) &&
                          next_claim < head + depth &&
                          !slots[next_claim % depth].ready &&
                          slots[next_claim % depth].index < next_claim);
        });
        if (stop) return;
        idx = next_claim++;
        slot = &slots[idx % depth];
        slot->index = idx;  // claimed (ready stays false while reading)
      }
      int n = read_bin_padded_impl(paths[idx].c_str(), slot->buf.data(),
                                   max_points);
      {
        std::lock_guard<std::mutex> lk(mu);
        slot->n_points = n;
        slot->ready = true;
      }
      cv_ready.notify_all();
    }
  }

  // Blocks until scan `head` is ready; copies it into out; advances.
  // Returns point count, -2 when the sequence is exhausted, -1 on IO error.
  int next(float* out) {
    std::unique_lock<std::mutex> lk(mu);
    if (head >= static_cast<int>(paths.size())) return -2;
    Slot& slot = slots[head % depth];
    cv_ready.wait(lk, [&] { return stop || (slot.ready && slot.index == head); });
    if (stop) return -2;
    std::memcpy(out, slot.buf.data(),
                static_cast<size_t>(max_points) * 4 * sizeof(float));
    int n = slot.n_points;
    slot.ready = false;
    ++head;
    lk.unlock();
    cv_free.notify_all();
    return n;
  }
};

}  // namespace

extern "C" {

int c2_read_bin_padded(const char* path, float* out, int max_points) {
  return read_bin_padded_impl(path, out, max_points);
}

// Fill a (n_paths, max_points, 4) f32 block buffer with a thread pool, one
// scan per row (the host side of the batched block replay). Returns 0 on
// success, -1 if any read failed; per-scan point counts land in n_out.
int c2_read_block(const char** paths, int n_paths, float* out, int max_points,
                  int n_threads, int* n_out) {
  if (n_paths <= 0) return 0;
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next{0};
  std::atomic<int> failed{0};
  const size_t row = static_cast<size_t>(max_points) * 4;
  auto work = [&] {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n_paths) return;
      int n = read_bin_padded_impl(paths[i], out + row * i, max_points);
      if (n_out != nullptr) n_out[i] = n;
      if (n < 0) failed.store(1);
    }
  };
  std::vector<std::thread> threads;
  int nt = n_threads < n_paths ? n_threads : n_paths;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(work);
  for (auto& th : threads) th.join();
  return failed.load() ? -1 : 0;
}

void* c2_prefetcher_create(const char** paths, int n_paths, int max_points,
                           int depth, int n_threads) {
  if (n_paths < 0 || max_points <= 0 || depth <= 0 || n_threads <= 0)
    return nullptr;
  std::vector<std::string> p(paths, paths + n_paths);
  return new Prefetcher(std::move(p), max_points, depth, n_threads);
}

// Copies the next scan (in strict submission order) into out.
int c2_prefetcher_next(void* h, float* out) {
  return static_cast<Prefetcher*>(h)->next(out);
}

void c2_prefetcher_destroy(void* h) { delete static_cast<Prefetcher*>(h); }

}  // extern "C"

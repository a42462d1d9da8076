// Native frame-streaming runtime: ring buffer + writer thread (the port's
// own copy of bevy_gpu_fluid_tpu/native/framesink.cpp, same C ABI and
// behaviour; the port builds and loads nothing of the JAX package).
//
// The simulation and raster loop stays on the card; the host hands
// finished RGB frames to this sink, which copies them into a ring and
// returns at once.  A dedicated writer thread persists them as binary PPM
// off the frame loop's critical path.  A push into a full ring drops the
// frame and counts it: the frame loop never blocks.
//
// C ABI (ctypes-friendly):
//   fs_create(out_dir, w, h, slots) -> handle
//   fs_push(handle, rgb8_ptr, frame_index) -> 0 ok / -1 ring full (dropped)
//   fs_pending(handle) -> frames queued
//   fs_dropped(handle) -> frames dropped because the ring was full
//   fs_written(handle) -> frames written to disk
//   fs_flush(handle)   -> block until queue drains
//   fs_destroy(handle)
//
// Build: g++ -O3 -shared -fPIC -pthread -std=c++17 (native/__init__.py).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Slot {
  std::vector<uint8_t> data;
  long frame_index = -1;
};

struct FrameSink {
  std::string out_dir;
  int width = 0, height = 0;
  int nslots = 0;
  std::vector<Slot> ring;
  // ring cursors: head = next slot to write into, tail = next to drain
  int head = 0, tail = 0, filled = 0;
  std::mutex mu;
  std::condition_variable cv_push, cv_drain;
  std::atomic<long> dropped{0}, written{0};
  std::atomic<bool> stop{false};
  std::thread writer;

  void run() {
    for (;;) {
      Slot* slot = nullptr;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_push.wait(lk, [&] { return filled > 0 || stop.load(); });
        if (filled == 0 && stop.load()) return;
        slot = &ring[tail];
      }
      write_ppm(*slot);
      written.fetch_add(1);  // before filled-- so flush() sees final counts
      {
        std::unique_lock<std::mutex> lk(mu);
        tail = (tail + 1) % nslots;
        filled--;
        cv_drain.notify_all();
      }
    }
  }

  void write_ppm(const Slot& slot) {
    char path[4096];
    std::snprintf(path, sizeof(path), "%s/frame_%06ld.ppm", out_dir.c_str(),
                  slot.frame_index);
    FILE* f = std::fopen(path, "wb");
    if (!f) return;
    std::fprintf(f, "P6\n%d %d\n255\n", width, height);
    std::fwrite(slot.data.data(), 1, slot.data.size(), f);
    std::fclose(f);
  }
};

}  // namespace

extern "C" {

void* fs_create(const char* out_dir, int width, int height, int slots) {
  auto* fs = new FrameSink();
  fs->out_dir = out_dir;
  fs->width = width;
  fs->height = height;
  fs->nslots = slots > 1 ? slots : 2;
  fs->ring.resize(fs->nslots);
  for (auto& s : fs->ring) s.data.resize((size_t)width * height * 3);
  fs->writer = std::thread([fs] { fs->run(); });
  return fs;
}

int fs_push(void* h, const uint8_t* rgb, long frame_index) {
  auto* fs = static_cast<FrameSink*>(h);
  std::unique_lock<std::mutex> lk(fs->mu);
  if (fs->filled == fs->nslots) {
    fs->dropped.fetch_add(1);
    return -1;  // never block the sim loop
  }
  Slot& slot = fs->ring[fs->head];
  std::memcpy(slot.data.data(), rgb, slot.data.size());
  slot.frame_index = frame_index;
  fs->head = (fs->head + 1) % fs->nslots;
  fs->filled++;
  fs->cv_push.notify_one();
  return 0;
}

long fs_pending(void* h) {
  auto* fs = static_cast<FrameSink*>(h);
  std::unique_lock<std::mutex> lk(fs->mu);
  return fs->filled;
}

long fs_dropped(void* h) {
  return static_cast<FrameSink*>(h)->dropped.load();
}

long fs_written(void* h) {
  return static_cast<FrameSink*>(h)->written.load();
}

void fs_flush(void* h) {
  auto* fs = static_cast<FrameSink*>(h);
  std::unique_lock<std::mutex> lk(fs->mu);
  fs->cv_drain.wait(lk, [&] { return fs->filled == 0; });
}

void fs_destroy(void* h) {
  auto* fs = static_cast<FrameSink*>(h);
  {
    std::unique_lock<std::mutex> lk(fs->mu);
    fs->stop.store(true);
    fs->cv_push.notify_all();
  }
  fs->writer.join();
  delete fs;
}

}  // extern "C"

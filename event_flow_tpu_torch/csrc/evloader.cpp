// Native event-stream loader: mmap'd event packs, multi-slot window
// assembly, and background double-buffered batch prefetch.
//
// The PyTorch port's copy of native/evloader.cpp. It replaces the
// reference's single-threaded, GIL-bound Python dataloader hot path
// (reference: dataloader/h5.py __getitem__, single process with
// num_workers=0, configs/parser.py:86). The device consumes fixed-shape
// [B, N, 4] float32 windows; this loader assembles the next batch on a
// producer thread while the card computes, so host input time hides
// behind device step time.
//
// One change from the original: each assembled Batch carries the
// sequence counter as it stood when that batch was done, and evl_next
// reports that snapshot. The original reports the live counter, which
// the producer has already advanced by the rollovers of the one or two
// batches it assembled ahead, so its seq_num can run ahead of the batch
// just returned.
//
// Pack format (.evpack v2, written by
// event_flow_tpu_torch/data/native_loader.py, byte-identical to the JAX
// package's packs):
//   magic "EVPK2\0\0\0" (8 bytes)
//   uint64 n_events
//   float64 t0            (file attr; event ts are shifted by this)
//   float64 last_ts_rel   (ts[n-1] - t0)
//   uint64 n_maps         (gt flow-map count; 0 when absent)
//   float64 map_ts[n_maps] (absolute timestamps of the gt maps)
//   float64 ts[n]   (seconds, absolute)
//   uint16  ys[n]
//   uint16  xs[n]
//   uint8   ps[n]   (0/1)
//
// Window modes (mirroring event_flow_tpu/data/h5.py::EventStream, itself a
// rebuild of reference dataloader/h5.py:136-270):
//   0 events: fixed event-count windows; rollover when a full window no
//     longer fits (h5.py:227-232)
//   1 time: fixed-seconds windows via binary search on ts; restart when
//     row + window >= last_ts_rel
//   2 gtflow: cursor over gt flow-map timestamps, fractional windows via
//     index interpolation (h5.py:208-223); also usable for `frames` mode
//     windowing if map_ts carries the image timestamps
// Variable-count modes pad to n_max with valid=0 and (y, x) = -1 (the
// Python stream's feasibility-mask convention); windows with <= 10 events
// are zeroed (h5.py:235-239).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -o libevloader.so evloader.cpp
//   -lpthread (data/native_loader.py::build_library does it at first use)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
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

enum Mode { MODE_EVENTS = 0, MODE_TIME = 1, MODE_GTFLOW = 2 };

struct Pack {
  int fd = -1;
  size_t bytes = 0;
  const uint8_t* base = nullptr;
  uint64_t n = 0;
  double t0 = 0.0;
  double last_ts_rel = 0.0;
  uint64_t n_maps = 0;
  const double* map_ts = nullptr;
  const double* ts = nullptr;
  const uint16_t* ys = nullptr;
  const uint16_t* xs = nullptr;
  const uint8_t* ps = nullptr;

  bool open(const char* path) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0) return false;
    bytes = static_cast<size_t>(st.st_size);
    base = static_cast<const uint8_t*>(
        mmap(nullptr, bytes, PROT_READ, MAP_PRIVATE, fd, 0));
    if (base == MAP_FAILED) return false;
    if (bytes < 40 || memcmp(base, "EVPK2\0\0\0", 8) != 0) return false;
    const uint8_t* p = base + 8;
    memcpy(&n, p, 8); p += 8;
    memcpy(&t0, p, 8); p += 8;
    memcpy(&last_ts_rel, p, 8); p += 8;
    memcpy(&n_maps, p, 8); p += 8;
    map_ts = reinterpret_cast<const double*>(p);
    p += n_maps * sizeof(double);
    ts = reinterpret_cast<const double*>(p);
    p += n * sizeof(double);
    ys = reinterpret_cast<const uint16_t*>(p);
    p += n * sizeof(uint16_t);
    xs = reinterpret_cast<const uint16_t*>(p);
    p += n * sizeof(uint16_t);
    ps = p;
    return p + n <= base + bytes;
  }

  // np.searchsorted(ts, t, side="left")
  uint64_t find_ts_index(double t) const {
    return static_cast<uint64_t>(
        std::lower_bound(ts, ts + n, t) - ts);
  }

  void close() {
    if (base && base != MAP_FAILED) munmap(const_cast<uint8_t*>(base), bytes);
    if (fd >= 0) ::close(fd);
  }
};

struct Batch {
  std::vector<float> events;    // [B, n_max, 4] (ts, y, x, p)
  std::vector<float> valid;     // [B, n_max]
  std::vector<float> dt_input;  // [B]
  std::vector<int32_t> gt_idx;  // [B] gt-map index (-1 if none)
  std::vector<int32_t> file_of_slot;  // file index per slot (attribution)
  uint64_t rolled_mask = 0;     // bit per slot: sequence rolled this batch
  int32_t overflow = 0;         // a window exceeded n_max (caller raises)
  int64_t seq_num = 0;          // the sequence counter after this batch
};

struct Loader {
  std::vector<Pack> packs;
  int batch = 0;
  int mode = MODE_EVENTS;
  double window = 0.0;  // events: count; time: seconds; gtflow: map frac
  int n_max = 0;
  // per-slot stream state (reference: h5.py:51-54)
  std::vector<int64_t> batch_idx;
  std::vector<double> row;  // event cursor / seconds / map cursor
  int64_t seq_num = 0;

  // double buffer: producer fills alternating slots, consumer drains in
  // the same order; `filled` flags are the handshake
  Batch buf[2];
  bool filled[2] = {false, false};
  int cons_slot = 0;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::thread producer;
  std::atomic<bool> stop{false};

  void rollover(int s, Batch& b) {
    int64_t mx = batch_idx[0];
    for (int j = 1; j < batch; ++j) mx = std::max(mx, batch_idx[j]);
    batch_idx[s] = mx + 1;
    row[s] = 0.0;
    seq_num += 1;
    b.rolled_mask |= (1ull << s);
  }

  // window's [i0, i1) event range + gt map index; false => roll sequence
  bool window_range(const Pack& pk, double r, uint64_t* i0, uint64_t* i1,
                    int32_t* gt) {
    *gt = -1;
    switch (mode) {
      case MODE_EVENTS: {
        const uint64_t c = static_cast<uint64_t>(r);
        const uint64_t w = static_cast<uint64_t>(window);
        if (c + w > pk.n) return false;  // (h5.py:227-232)
        *i0 = c;
        *i1 = c + w;
        return true;
      }
      case MODE_TIME: {
        if (r + window >= pk.last_ts_rel) return false;
        *i0 = pk.find_ts_index(r + pk.t0);
        *i1 = pk.find_ts_index(r + pk.t0 + window);
        return true;
      }
      default: {  // MODE_GTFLOW (h5.py:187-198, :208-223)
        if (static_cast<int64_t>(std::ceil(r + window)) >=
            static_cast<int64_t>(pk.n_maps))
          return false;
        int64_t idx0 = static_cast<int64_t>(std::floor(r));
        int64_t idx1 = static_cast<int64_t>(std::ceil(r + window));
        if (window < 1.0 && idx1 - idx0 > 1) idx0 += idx1 - idx0 - 1;
        uint64_t a = pk.find_ts_index(pk.map_ts[idx0]);
        uint64_t bb = pk.find_ts_index(pk.map_ts[idx1]);
        if (window < 1.0) {
          int64_t floor_row = static_cast<int64_t>(std::floor(r));
          int64_t ceil_row = static_cast<int64_t>(std::ceil(r + window));
          if (ceil_row - floor_row > 1) floor_row += ceil_row - floor_row - 1;
          const double d0 = r - static_cast<double>(floor_row);
          const double d1 = r + window - static_cast<double>(floor_row);
          const double delta = static_cast<double>(bb - a);
          bb = a + static_cast<uint64_t>(d1 * delta);
          a = a + static_cast<uint64_t>(d0 * delta);
        }
        *i0 = a;
        *i1 = bb;
        *gt = static_cast<int32_t>(std::ceil(r + window));
        return true;
      }
    }
  }

  void assemble(Batch& b) {
    const int N = n_max;
    b.events.assign(static_cast<size_t>(batch) * N * 4, 0.0f);
    b.valid.assign(static_cast<size_t>(batch) * N, 0.0f);
    b.dt_input.assign(batch, 0.0f);
    b.gt_idx.assign(batch, -1);
    b.file_of_slot.assign(batch, 0);
    b.rolled_mask = 0;
    b.overflow = 0;
    for (int s = 0; s < batch; ++s) {
      uint64_t i0 = 0, i1 = 0;
      int32_t gt = -1;
      // rollover until the slot has a valid window (h5.py:242-270)
      for (;;) {
        const Pack& pk = packs[batch_idx[s] % packs.size()];
        if (window_range(pk, row[s], &i0, &i1, &gt)) break;
        rollover(s, b);
      }
      const Pack& pk = packs[batch_idx[s] % packs.size()];
      b.file_of_slot[s] = static_cast<int32_t>(batch_idx[s] % packs.size());
      b.gt_idx[s] = gt;
      uint64_t n = i1 > i0 ? i1 - i0 : 0;
      if (n <= 10) n = 0;  // <10 events => zero window (h5.py:235-239)
      if (n > static_cast<uint64_t>(N)) {
        b.overflow = static_cast<int32_t>(n);
        n = static_cast<uint64_t>(N);
      }
      float* out = b.events.data() + static_cast<size_t>(s) * N * 4;
      float* va = b.valid.data() + static_cast<size_t>(s) * N;
      // padded events sit at (y, x) = (-1, -1) so the on-device
      // feasibility mask drops them (matches data/h5.py:336-338)
      for (int i = static_cast<int>(n); i < N; ++i) {
        out[i * 4 + 1] = -1.0f;
        out[i * 4 + 2] = -1.0f;
      }
      for (uint64_t i = 0; i < n; ++i) {
        const uint64_t e = i0 + i;
        out[i * 4 + 0] = static_cast<float>(pk.ts[e] - pk.t0);
        out[i * 4 + 1] = static_cast<float>(pk.ys[e]);
        out[i * 4 + 2] = static_cast<float>(pk.xs[e]);
        out[i * 4 + 3] = pk.ps[e] ? 1.0f : -1.0f;
        va[i] = 1.0f;
      }
      if (n > 0)
        b.dt_input[s] = static_cast<float>(pk.ts[i0 + n - 1] - pk.ts[i0]);
      row[s] += window;
    }
    b.seq_num = seq_num;
  }

  void produce_loop() {
    int slot = 0;
    while (!stop.load()) {
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] { return !filled[slot] || stop.load(); });
      }
      if (stop.load()) break;
      assemble(buf[slot]);
      {
        std::lock_guard<std::mutex> lk(mu);
        filled[slot] = true;
      }
      cv_ready.notify_one();
      slot ^= 1;
    }
  }
};

}  // namespace

extern "C" {

void* evl_open(const char** paths, int n_files, int batch, int mode,
               double window, int n_max) {
  auto* L = new Loader();
  L->batch = batch;
  L->mode = mode;
  L->window = window;
  L->n_max = n_max;
  L->packs.resize(n_files);
  for (int i = 0; i < n_files; ++i) {
    if (!L->packs[i].open(paths[i])) {
      for (int j = 0; j <= i; ++j) L->packs[j].close();
      delete L;
      return nullptr;
    }
  }
  L->batch_idx.resize(batch);
  L->row.assign(batch, 0.0);
  for (int s = 0; s < batch; ++s) L->batch_idx[s] = s;
  L->producer = std::thread([L] { L->produce_loop(); });
  return L;
}

// Blocks until the prefetched batch is ready, copies it out, and wakes the
// producer to assemble the next one. Returns the rolled-slot bitmask.
uint64_t evl_next(void* h, float* out_events, float* out_valid,
                  float* out_dt, int32_t* out_gt_idx,
                  int32_t* out_file_of_slot, int64_t* out_seq_num,
                  int32_t* out_overflow) {
  auto* L = static_cast<Loader*>(h);
  const int slot = L->cons_slot;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_ready.wait(lk, [&] { return L->filled[slot]; });
  }
  Batch& b = L->buf[slot];
  memcpy(out_events, b.events.data(), b.events.size() * sizeof(float));
  memcpy(out_valid, b.valid.data(), b.valid.size() * sizeof(float));
  memcpy(out_dt, b.dt_input.data(), b.dt_input.size() * sizeof(float));
  memcpy(out_gt_idx, b.gt_idx.data(), b.gt_idx.size() * sizeof(int32_t));
  memcpy(out_file_of_slot, b.file_of_slot.data(),
         b.file_of_slot.size() * sizeof(int32_t));
  uint64_t rolled = b.rolled_mask;
  *out_seq_num = b.seq_num;
  *out_overflow = b.overflow;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->filled[slot] = false;
  }
  L->cons_slot = slot ^ 1;
  L->cv_free.notify_one();
  return rolled;
}

void evl_close(void* h) {
  auto* L = static_cast<Loader*>(h);
  L->stop.store(true);
  L->cv_free.notify_all();
  L->cv_ready.notify_all();
  if (L->producer.joinable()) L->producer.join();
  for (auto& p : L->packs) p.close();
  delete L;
}

}  // extern "C"

// Native host-side batch assembler for the Ev2Hands-S event table.
//
// The port's own copy of the JAX package's csrc/ev2hands_loader.cpp, with
// the same code, so both give the same batches bit for bit. It holds the
// decoded int64 [N, 6] event table (x, y, t, p, annotation_index,
// event_label) in memory once, borrowed from the caller, and assembles
// fixed-shape training batches (float32 windows, int32 labels, annotation
// ids) with a pool of threads: one pass per window, no Python in the loop.
//
// Plain C interface for ctypes. ev2hands_tpu_torch/ops/_build.py compiles
// it with g++ on first use (events/native_loader.py loads it).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <functional>
#include <random>
#include <thread>
#include <vector>

namespace {

struct Loader {
  const int64_t* rows;  // [n_rows, 6], borrowed (numpy owns it)
  int64_t n_rows;
  int n_threads;
  uint64_t seed;
  std::atomic<uint64_t> epoch{0};
};

inline void fill_window(const Loader& L, int64_t start, int64_t n_events,
                        float* ev_out,       // [n_events, 4]
                        int32_t* label_out,  // [n_events]
                        int64_t* anno_out) { // [1]
  if (start > L.n_rows - n_events) start = L.n_rows - n_events;
  if (start < 0) start = 0;
  // Tables shorter than one window wrap around instead of reading past the
  // borrowed numpy buffer; the common (n_rows >= n_events) path stays a
  // single contiguous branch-free copy.
  int64_t last = start;
  const int64_t* r = L.rows + start * 6;
  for (int64_t i = 0; i < n_events; ++i, r += 6) {
    int64_t idx = start + i;
    if (idx >= L.n_rows) {
      idx %= L.n_rows;
      r = L.rows + idx * 6;
      start = idx - i;  // keep start + i == idx for subsequent iterations
    }
    ev_out[i * 4 + 0] = static_cast<float>(r[0]);
    ev_out[i * 4 + 1] = static_cast<float>(r[1]);
    ev_out[i * 4 + 2] = static_cast<float>(r[2]);
    ev_out[i * 4 + 3] = static_cast<float>(r[3]);
    label_out[i] = static_cast<int32_t>(r[5]);
    last = idx;
  }
  anno_out[0] = L.rows[last * 6 + 4];  // annotation index of the last event
}

void parallel_for(int n_threads, int64_t count,
                  const std::function<void(int64_t)>& fn) {
  if (n_threads <= 1 || count <= 1) {
    for (int64_t i = 0; i < count; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next{0};
  std::vector<std::thread> pool;
  int workers = std::min<int64_t>(n_threads, count);
  pool.reserve(workers);
  for (int w = 0; w < workers; ++w) {
    pool.emplace_back([&] {
      for (int64_t i = next.fetch_add(1); i < count; i = next.fetch_add(1)) {
        fn(i);
      }
    });
  }
  for (auto& t : pool) t.join();
}

}  // namespace

extern "C" {

void* ev2hands_loader_create(const int64_t* rows, int64_t n_rows,
                             int n_threads, uint64_t seed) {
  auto* L = new Loader();
  L->rows = rows;
  L->n_rows = n_rows;
  L->n_threads = n_threads > 0 ? n_threads
                               : static_cast<int>(std::thread::hardware_concurrency());
  L->seed = seed;
  return L;
}

void ev2hands_loader_destroy(void* handle) {
  delete static_cast<Loader*>(handle);
}

int64_t ev2hands_loader_len(void* handle) {
  return static_cast<Loader*>(handle)->n_rows;
}

// Assemble a batch from explicit window starts.
void ev2hands_loader_fill(void* handle, const int64_t* starts, int64_t batch,
                          int64_t n_events, float* events_out,
                          int32_t* labels_out, int64_t* anno_out) {
  auto& L = *static_cast<Loader*>(handle);
  parallel_for(L.n_threads, batch, [&](int64_t b) {
    fill_window(L, starts[b], n_events, events_out + b * n_events * 4,
                labels_out + b * n_events, anno_out + b);
  });
}

// Assemble a batch from uniformly random window starts (deterministic in
// (seed, step)); writes the chosen starts back for reproducibility.
void ev2hands_loader_fill_random(void* handle, uint64_t step, int64_t batch,
                                 int64_t n_events, int64_t* starts_out,
                                 float* events_out, int32_t* labels_out,
                                 int64_t* anno_out) {
  auto& L = *static_cast<Loader*>(handle);
  const int64_t limit = L.n_rows > n_events ? L.n_rows - n_events : 1;
  std::mt19937_64 rng(L.seed ^ (step * 0x9E3779B97F4A7C15ULL));
  std::uniform_int_distribution<int64_t> dist(0, limit - 1);
  for (int64_t b = 0; b < batch; ++b) starts_out[b] = dist(rng);
  ev2hands_loader_fill(handle, starts_out, batch, n_events, events_out,
                       labels_out, anno_out);
}

}  // extern "C"

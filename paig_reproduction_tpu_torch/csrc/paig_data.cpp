// paig_data: native host-side training-data service.
//
// The port's copy of native/paig_data.cpp (the same source, so the same
// batches at the same seed). A background thread gathers the next shuffled
// batch into a double-buffered staging area and converts it from uint8 to
// float32/255 while the card runs the current step.
//
// Used by paig_reproduction_tpu_torch/data/native.py (ctypes). The port's
// main input path keeps the whole split on the card (train/trainer.py,
// train_chunk); this loader serves the host path (--native_loader).
//
// Epoch semantics mirror DataIterator: a full shuffle per epoch, batches
// always full, the epoch counter increments when the NEXT batch would run
// past the end.
//
// C ABI only (ctypes-friendly). Built with g++ at first use by
// paig_reproduction_tpu_torch/ops/cuda/build.py (load_host).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <numeric>
#include <thread>
#include <vector>

namespace {

// splitmix64: tiny, seedable, good-enough shuffle RNG.
struct SplitMix64 {
  uint64_t state;
  explicit SplitMix64(uint64_t seed) : state(seed) {}
  uint64_t next() {
    uint64_t z = (state += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  // Unbiased bounded draw (Lemire).
  uint64_t bounded(uint64_t n) {
    __uint128_t m = (__uint128_t)next() * n;
    return (uint64_t)(m >> 64);
  }
};

struct Loader {
  const uint8_t* data;          // [n, example_bytes] row-major, borrowed
  int64_t n;
  int64_t example_bytes;        // bytes per example (= floats per example)
  int64_t batch;
  bool normalize;               // write float32/255 instead of raw uint8

  std::vector<int64_t> perm;
  int64_t cursor = 0;
  int64_t epochs = 0;
  SplitMix64 rng;

  // Double buffer: worker fills `filling` while consumer reads `ready`.
  std::vector<float> buf[2];
  int64_t buf_epoch[2] = {0, 0};
  int ready_slot = -1;          // slot with a prepared batch, -1 if none
  bool stop = false;

  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;

  Loader(const uint8_t* d, int64_t n_, int64_t eb, int64_t b, uint64_t seed,
         bool norm)
      : data(d), n(n_), example_bytes(eb), batch(b), normalize(norm),
        perm(n_), rng(seed) {
    std::iota(perm.begin(), perm.end(), 0);
    shuffle();
    buf[0].resize(batch * example_bytes);
    buf[1].resize(batch * example_bytes);
    worker = std::thread([this] { run(); });
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_free.notify_all();
    cv_ready.notify_all();
    worker.join();
  }

  void shuffle() {
    for (int64_t i = n - 1; i > 0; --i) {
      int64_t j = (int64_t)rng.bounded((uint64_t)(i + 1));
      std::swap(perm[i], perm[j]);
    }
    cursor = 0;
  }

  // Assemble the next batch into slot s (worker thread only).
  void fill(int s) {
    float* out = buf[s].data();
    for (int64_t b = 0; b < batch; ++b) {
      int64_t row = perm[(cursor + b) % n];
      const uint8_t* src = data + row * example_bytes;
      float* dst = out + b * example_bytes;
      if (normalize) {
        // True division (not reciprocal-multiply): bit-exact with
        // numpy's float32 `x / 255.0`, so the native and Python input
        // paths produce identical tensors.
        for (int64_t k = 0; k < example_bytes; ++k)
          dst[k] = (float)src[k] / 255.0f;
      } else {
        for (int64_t k = 0; k < example_bytes; ++k) dst[k] = (float)src[k];
      }
    }
    cursor += batch;
    if (cursor + batch > n) {
      ++epochs;
      shuffle();
    }
    // Post-increment value: what DataIterator.epochs_completed reports
    // after consuming this batch. Recorded per-batch because the
    // prefetcher runs one batch ahead of the consumer.
    buf_epoch[s] = epochs;
  }

  void run() {
    int next_slot = 0;
    while (true) {
      std::unique_lock<std::mutex> lk(mu);
      cv_free.wait(lk, [&] { return stop || ready_slot == -1; });
      if (stop) return;
      lk.unlock();

      fill(next_slot);

      lk.lock();
      ready_slot = next_slot;
      next_slot ^= 1;
      lk.unlock();
      cv_ready.notify_one();
    }
  }

  // Consumer: copy a prepared batch out; returns the epoch count AFTER
  // this batch (DataIterator.epochs_completed semantics).
  int64_t next(float* dst) {
    int slot;
    int64_t ep;
    {
      std::unique_lock<std::mutex> lk(mu);
      cv_ready.wait(lk, [&] { return stop || ready_slot != -1; });
      if (stop) return -1;
      slot = ready_slot;
      ep = buf_epoch[slot];
    }
    std::memcpy(dst, buf[slot].data(),
                sizeof(float) * batch * example_bytes);
    {
      std::lock_guard<std::mutex> lk(mu);
      ready_slot = -1;
    }
    cv_free.notify_one();
    return ep;
  }
};

}  // namespace

extern "C" {

void* pd_create(const uint8_t* data, int64_t n, int64_t example_bytes,
                int64_t batch, uint64_t seed, int normalize) {
  if (!data || n <= 0 || batch <= 0 || batch > n) return nullptr;
  return new Loader(data, n, example_bytes, batch, seed, normalize != 0);
}

// Blocks until a prefetched batch is ready, copies it into dst
// [batch * example_bytes] floats. Returns the epoch counter after the
// batch (DataIterator.epochs_completed semantics), or -1 on shutdown.
int64_t pd_next(void* handle, float* dst) {
  return static_cast<Loader*>(handle)->next(dst);
}

int64_t pd_epochs(void* handle) {
  return static_cast<Loader*>(handle)->epochs;
}

void pd_destroy(void* handle) { delete static_cast<Loader*>(handle); }

}  // extern "C"

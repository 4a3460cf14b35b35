// Native corpus loader: parallel .mm2 reading + feature post-processing.
//
// The port's copy of speechrecognition_tpu/native/corpus_loader.cpp, which
// implements the reference's corpus load path (src/sietill/Corpus.cpp:89-111
// + SignalAnalysis.cpp:379-399): reads each segment's raw 12-dim float32
// cepstra, appends Δ / ΔΔ-energy features, applies corpus mean/σ
// normalization (with the reference's two-step float32 rounding) and
// per-utterance energy-max normalization, writing into one flat
// preallocated [total_frames, n_total] float32 buffer.
//
// The reference loads ~26k files sequentially; this loader fans the file
// set across a thread pool and is exposed to Python via ctypes (no
// pybind11 dependency).
//
// Built by native/loader.py at first use:
//   g++ -O2 -shared -fPIC -std=c++17 -pthread corpus_loader.cpp -o build/native/libcorpus_loader_<hash>.so

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Config {
  int n_in;         // features per frame in file (12)
  int n_first;      // first-derivative features (12)
  int n_second;     // second-derivative features (1)
  int n_total;      // total (25)
  int deriv_step;   // Δ step (3)
  int apply_norm;   // mean/σ normalization enabled
  int energy_max_norm;
  const double* mean;    // [n_total]
  const double* stddev;  // [n_total]
};

// Returns number of frames written, or -1 on error.
long process_file(const char* path, const Config& cfg, float* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long bytes = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  long n_floats = bytes / (long)sizeof(float);
  long frames = n_floats / cfg.n_in;
  std::vector<float> raw((size_t)n_floats);
  if (frames > 0 &&
      std::fread(raw.data(), sizeof(float), (size_t)n_floats, f) != (size_t)n_floats) {
    std::fclose(f);
    return -1;
  }
  std::fclose(f);

  const int NT = cfg.n_total, NI = cfg.n_in, NF = cfg.n_first, k = cfg.deriv_step;
  // copy base features
  for (long t = 0; t < frames; t++) {
    std::memcpy(out + t * NT, raw.data() + t * NI, NI * sizeof(float));
    std::memset(out + t * NT + NI, 0, (NT - NI) * sizeof(float));
  }
  // Δ: out[t, NI+i] = out[max(t,k), i] - out[max(t,k)-k, i]   (float32 math,
  // SignalAnalysis.cpp:320-328)
  for (long t = 0; t < frames; t++) {
    long hi = std::max(t, (long)k);
    for (int i = 0; i < NF; i++) {
      out[t * NT + NI + i] = out[hi * NT + i] - out[(hi - k) * NT + i];
    }
  }
  // ΔΔ energy: out[t, NI+NF] = Δc0[min(t, T-1-k)+k] - Δc0[t]
  // (SignalAnalysis.cpp:329-335)
  for (long t = 0; t < frames; t++) {
    long u = std::min(t, frames - 1 - (long)k) + k;
    for (int i = 0; i < cfg.n_second; i++) {
      out[t * NT + NI + NF + i] = out[u * NT + NI + i] - out[t * NT + NI + i];
    }
  }
  // mean/σ normalization with two float32 roundings (SignalAnalysis.cpp:390-392)
  if (cfg.apply_norm) {
    for (long t = 0; t < frames; t++) {
      for (int i = 0; i < NT; i++) {
        float centered = (float)((double)out[t * NT + i] - cfg.mean[i]);
        out[t * NT + i] = (float)((double)centered / cfg.stddev[i]);
      }
    }
  }
  // energy-max normalization on column 0 (SignalAnalysis.cpp:340-349)
  if (cfg.energy_max_norm && frames > 0) {
    float mx = -INFINITY;
    for (long t = 0; t < frames; t++) mx = std::max(mx, out[t * NT]);
    for (long t = 0; t < frames; t++) out[t * NT] -= mx;
  }
  return frames;
}

}  // namespace

extern "C" {

// offsets: int64 [num_files + 1] frame offsets (precomputed from file sizes).
// out: float32 [offsets[num_files], n_total].
// Returns 0 on success, index+1 of the first failing file otherwise.
int load_corpus(const char** paths, long num_files, const int64_t* offsets,
                const double* mean, const double* stddev, int apply_norm,
                int energy_max_norm, int n_in, int n_first, int n_second,
                int deriv_step, float* out, int num_threads) {
  Config cfg;
  cfg.n_in = n_in;
  cfg.n_first = n_first;
  cfg.n_second = n_second;
  cfg.n_total = n_in + n_first + n_second;
  cfg.deriv_step = deriv_step;
  cfg.apply_norm = apply_norm;
  cfg.energy_max_norm = energy_max_norm;
  cfg.mean = mean;
  cfg.stddev = stddev;

  std::atomic<long> next(0);
  std::atomic<long> failed(0);
  int nthreads = num_threads > 0
                     ? num_threads
                     : (int)std::max(1u, std::thread::hardware_concurrency());
  auto worker = [&]() {
    for (;;) {
      long i = next.fetch_add(1);
      if (i >= num_files || failed.load() != 0) return;
      long expect = offsets[i + 1] - offsets[i];
      long got = process_file(paths[i], cfg, out + offsets[i] * cfg.n_total);
      if (got != expect) {
        long expected_fail = 0;
        failed.compare_exchange_strong(expected_fail, i + 1);
        return;
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; t++) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return (int)failed.load();
}

}  // extern "C"

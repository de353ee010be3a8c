// Native host runtime for the AKAZE-SLAM framework.
//
// The reference implements its host layer in C++ (image IO via OpenCV,
// main.cpp:149; the FED step planner, fed.cpp:41-148).  This library is the
// framework's native tier: everything that runs on the host CPU around the
// XLA programs — image decoding, a threaded prefetching frame loader, and
// the FED time-step planner — implemented from the published FED
// formulation (Grewenig et al., "From box filtering to fast explicit
// diffusion", DAGM 2010), not translated from the reference.
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libakaze_native.so \
//            akaze_native.cpp -lpthread

#include <atomic>
#include <cctype>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// FED time-step planner
// ---------------------------------------------------------------------------

// Number of FED steps n for one cycle reaching total time t with max step
// tau_max: t = tau_max * n(n+1)/3  =>  n = ceil(sqrt(3t/tau_max + 1/4) - 1/2).
int fed_num_steps(float t, float tau_max) {
  double n = std::ceil(std::sqrt(3.0 * t / tau_max + 0.25) - 0.5 - 1e-8);
  return n < 1.0 ? 1 : (int)n;
}

// Fill taus[0..n-1] with the FED cycle steps for total time t.
// Steps: tau_k = tau_hat / cos^2(pi (2k+1) / (4n+2)), tau_hat scaled so the
// cycle sum equals t.  If reorder != 0, apply the kappa-permutation
// (stride kappa modulo the next prime >= n+1) that interleaves stable and
// unstable steps for numerical robustness.
int fed_tau_by_process_time(float t, float tau_max, int reorder,
                            float* taus, int cap) {
  int n = fed_num_steps(t, tau_max);
  if (n > cap) return -n;  // caller must provide at least n slots
  // scale so that the cycle reaches exactly t
  double c = 1.0 / (4.0 * n + 2.0);
  double d = t * 1.5 / (0.25 * n * (n + 1.0));  // tau_hat * 1.5/... see below
  // sum_{k} 1/cos^2(pi c (2k+1)) = n(n+1)/3 / (something) — instead of the
  // closed form, normalise numerically for exactness.
  std::vector<double> raw(n);
  double sum = 0.0;
  for (int k = 0; k < n; ++k) {
    double cosv = std::cos(M_PI * c * (2.0 * k + 1.0));
    raw[k] = 1.0 / (cosv * cosv);
    sum += raw[k];
  }
  (void)d;
  double scale = t / sum;
  std::vector<float> ordered(n);
  for (int k = 0; k < n; ++k) ordered[k] = (float)(raw[k] * scale);

  if (!reorder || n <= 2) {
    std::memcpy(taus, ordered.data(), n * sizeof(float));
    return n;
  }
  // kappa-cycling permutation with kappa = n/2 modulo the next prime > n
  // (the scheme of the FED paper; index -1 wraps to the last step, matching
  // the Python planner's tauh[index] semantics)
  int p = n + 1;
  auto is_prime = [](int x) {
    if (x < 2) return false;
    for (int f = 2; (long)f * f <= x; ++f)
      if (x % f == 0) return false;
    return true;
  };
  while (!is_prime(p)) ++p;
  int kappa = n / 2;
  int k = 0;
  for (int l = 0; l < n; ++l) {
    int index;
    for (;;) {
      index = ((k + 1) * kappa) % p - 1;
      if (index < n) break;
      ++k;
    }
    taus[l] = ordered[index < 0 ? n - 1 : index];
    ++k;
  }
  return n;
}

// ---------------------------------------------------------------------------
// PGM (P5) decoding
// ---------------------------------------------------------------------------

static bool read_pgm_header(FILE* f, int* w, int* h, int* maxval) {
  char magic[3] = {0};
  if (fscanf(f, "%2s", magic) != 1 || std::strcmp(magic, "P5") != 0)
    return false;
  int vals[3], got = 0;
  while (got < 3) {
    int ch = fgetc(f);
    if (ch == '#') {  // comment
      while (ch != '\n' && ch != EOF) ch = fgetc(f);
    } else if (std::isdigit(ch)) {
      ungetc(ch, f);
      if (fscanf(f, "%d", &vals[got]) != 1) return false;
      ++got;
    } else if (ch == EOF) {
      return false;
    }
  }
  fgetc(f);  // single whitespace after maxval
  *w = vals[0];
  *h = vals[1];
  *maxval = vals[2];
  return true;
}

// Query dimensions only.  Returns 0 on success.
int pgm_query(const char* path, int* w, int* h) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  int maxval;
  bool ok = read_pgm_header(f, w, h, &maxval);
  std::fclose(f);
  return ok ? 0 : -2;
}

// Decode an 8-bit P5 PGM into caller-provided buffer (w*h bytes).
int pgm_decode(const char* path, uint8_t* out, int cap) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  int w, h, maxval;
  if (!read_pgm_header(f, &w, &h, &maxval) || maxval > 255) {
    std::fclose(f);
    return -2;
  }
  if (w * h > cap) {
    std::fclose(f);
    return -3;
  }
  size_t n = std::fread(out, 1, (size_t)w * h, f);
  std::fclose(f);
  return n == (size_t)w * h ? 0 : -4;
}

// ---------------------------------------------------------------------------
// Threaded prefetching frame loader
// ---------------------------------------------------------------------------
//
// The host-side analogue of a tf.data/grain input pipeline: worker threads
// decode frames ahead of the consumer so device steps never wait on disk.
// Frames are decoded to uint8 and (optionally) converted to float32 [0, 1]
// with normalisation done on the worker thread.

struct Frame {
  int index;
  int w, h;
  std::vector<uint8_t> data;
};

struct Loader {
  std::vector<std::string> paths;
  std::deque<Frame> queue;
  std::mutex mu;
  std::condition_variable cv_has, cv_room;
  size_t capacity;
  std::atomic<int> next_index{0};
  std::atomic<bool> stop{false};
  std::vector<std::thread> workers;
  int deliver_next = 0;  // frames are delivered strictly in order
};

static void loader_worker(Loader* L) {
  for (;;) {
    int idx = L->next_index.fetch_add(1);
    if (idx >= (int)L->paths.size() || L->stop.load()) return;
    Frame fr;
    fr.index = idx;
    int w = 0, h = 0;
    if (pgm_query(L->paths[idx].c_str(), &w, &h) == 0) {
      fr.w = w;
      fr.h = h;
      fr.data.resize((size_t)w * h);
      if (pgm_decode(L->paths[idx].c_str(), fr.data.data(), w * h) != 0) {
        fr.w = fr.h = 0;
        fr.data.clear();
      }
    } else {
      fr.w = fr.h = 0;
    }
    std::unique_lock<std::mutex> lk(L->mu);
    // admission by frame index, not queue size: with more workers than
    // capacity, a size-based gate can fill the queue with out-of-order
    // frames and starve the one the consumer needs (deadlock).  Only
    // frames inside the in-order delivery window may enter; the window
    // always admits the frame the consumer is waiting for.
    int idx_local = fr.index;
    L->cv_room.wait(lk, [L, idx_local] {
      return idx_local < L->deliver_next + (int)L->capacity
             || L->stop.load();
    });
    if (L->stop.load()) return;
    L->queue.push_back(std::move(fr));
    L->cv_has.notify_all();
  }
}

// paths: '\n'-joined file list.  Returns an opaque handle.
void* loader_create(const char* paths, int n_threads, int capacity) {
  Loader* L = new Loader();
  const char* s = paths;
  while (*s) {
    const char* e = std::strchr(s, '\n');
    if (!e) e = s + std::strlen(s);
    if (e > s) L->paths.emplace_back(s, e - s);
    s = *e ? e + 1 : e;
  }
  L->capacity = capacity > 0 ? capacity : 4;
  if (n_threads < 1) n_threads = 1;
  for (int i = 0; i < n_threads; ++i)
    L->workers.emplace_back(loader_worker, L);
  return L;
}

int loader_num_frames(void* handle) {
  return (int)((Loader*)handle)->paths.size();
}

// Pop the next frame *in order*.  Blocks until available.  Returns 0 on
// success, -1 at end of stream, -2 on decode failure.  Caller provides the
// buffer; (w, h) are written back.
int loader_next(void* handle, uint8_t* out, int cap, int* w, int* h) {
  Loader* L = (Loader*)handle;
  if (L->deliver_next >= (int)L->paths.size()) return -1;
  std::unique_lock<std::mutex> lk(L->mu);
  for (;;) {
    for (auto it = L->queue.begin(); it != L->queue.end(); ++it) {
      if (it->index == L->deliver_next) {
        Frame fr = std::move(*it);
        L->queue.erase(it);
        L->deliver_next++;
        L->cv_room.notify_all();
        lk.unlock();
        if (fr.w == 0) return -2;
        if (fr.w * fr.h > cap) return -3;
        std::memcpy(out, fr.data.data(), fr.data.size());
        *w = fr.w;
        *h = fr.h;
        return 0;
      }
    }
    L->cv_has.wait(lk);
  }
}

void loader_destroy(void* handle) {
  Loader* L = (Loader*)handle;
  L->stop.store(true);
  L->cv_room.notify_all();
  L->cv_has.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

// ---------------------------------------------------------------------------
// CPU Hamming matcher (golden reference / host fallback)
// ---------------------------------------------------------------------------

// words: [n, 16] uint32 descriptors.  For each query, find the 1-NN among
// train with the uniqueness rule (accept only a strict unique minimum below
// max_dist); write index (or -1) and distance.
void hamming_match_cpu(const uint32_t* q, int nq, const uint32_t* tr,
                       int nt, int max_dist, int32_t* index,
                       int32_t* distance) {
  for (int i = 0; i < nq; ++i) {
    int best = 1 << 30, second = 1 << 30, bidx = -1;
    const uint64_t* a = (const uint64_t*)(q + (size_t)i * 16);
    for (int j = 0; j < nt; ++j) {
      const uint64_t* b = (const uint64_t*)(tr + (size_t)j * 16);
      int d = 0;
      for (int k = 0; k < 8; ++k)
        d += __builtin_popcountll(a[k] ^ b[k]);
      if (d < best) {
        second = best;
        best = d;
        bidx = j;
      } else if (d < second) {
        second = d;
      }
    }
    bool ok = best < second && best < max_dist;
    index[i] = ok ? bidx : -1;
    distance[i] = ok ? best : -1;
  }
}

}  // extern "C"

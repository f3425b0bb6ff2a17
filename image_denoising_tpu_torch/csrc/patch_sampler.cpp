// Native threaded patch sampler for the port's finetune data path (the port's own
// copy of the sampler in the repository's `native` directory, built by
// ops/_build.py::build_host).
//
// Replaces the reference's torch DataLoader worker processes
// (finetune.py:233-240: 4 workers decoding + random-cropping per item) with a
// single-process threaded sampler over resident uint8 frames:
//   * images are registered once (decoded host-side by PIL),
//   * each batch is sampled with a counter-based SplitMix64/PCG stream keyed
//     on (seed, batch_index, item) — fully deterministic and order-independent,
//   * crops are copied and /255-normalized to float32 NHWC in parallel worker
//     threads (no GIL, no pickling, no per-item process hops).
//
// C ABI (ctypes-friendly); see image_denoising_tpu_torch/data/native_sampler.py.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Image {
  std::vector<uint8_t> clean;
  std::vector<uint8_t> noise;
  int h = 0, w = 0, c = 0;
};

struct Sampler {
  std::vector<Image> images;
};

// SplitMix64: tiny, high-quality counter-based PRNG — each (seed, ctr) pair
// yields an independent draw, so samples are reproducible regardless of
// thread scheduling.
inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97f4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

inline uint64_t draw(uint64_t seed, uint64_t batch_index, uint64_t item,
                     uint64_t salt) {
  return splitmix64(seed ^ splitmix64(batch_index * 0x9E3779B97f4A7C15ULL +
                                      item * 0xD1B54A32D192ED03ULL + salt));
}

}  // namespace

extern "C" {

void* ps_create(int n_images) {
  auto* s = new Sampler();
  s->images.resize(static_cast<size_t>(n_images));
  return s;
}

void ps_destroy(void* handle) { delete static_cast<Sampler*>(handle); }

// Register an image pair (data copied; caller may free).
int ps_add_image(void* handle, int idx, const uint8_t* clean,
                 const uint8_t* noise, int h, int w, int c) {
  auto* s = static_cast<Sampler*>(handle);
  if (idx < 0 || static_cast<size_t>(idx) >= s->images.size()) return -1;
  Image& im = s->images[static_cast<size_t>(idx)];
  const size_t n = static_cast<size_t>(h) * w * c;
  im.clean.assign(clean, clean + n);
  im.noise.assign(noise, noise + n);
  im.h = h;
  im.w = w;
  im.c = c;
  return 0;
}

// Sample `batch` patch pairs of size patch x patch into float32 NHWC buffers
// (values in [0,1]). img_of_item maps each batch item to an image index
// (callers implement the reference's index//patches_per_image layout or a
// shuffled epoch order). Deterministic in (seed, batch_index).
int ps_sample_batch(void* handle, uint64_t seed, uint64_t batch_index,
                    int batch, int patch, const int32_t* img_of_item,
                    float* out_clean, float* out_noise, int n_threads) {
  auto* s = static_cast<Sampler*>(handle);
  if (batch <= 0 || patch <= 0) return -1;
  for (int b = 0; b < batch; ++b) {
    const int32_t gi = img_of_item[b];
    if (gi < 0 || static_cast<size_t>(gi) >= s->images.size()) return -2;
    const Image& im = s->images[static_cast<size_t>(gi)];
    if (im.h < patch || im.w < patch) return -3;
  }

  const int c = s->images[static_cast<size_t>(img_of_item[0])].c;
  const size_t item_elems = static_cast<size_t>(patch) * patch * c;

  auto work = [&](int begin, int end) {
    for (int b = begin; b < end; ++b) {
      const Image& im = s->images[static_cast<size_t>(img_of_item[b])];
      const uint64_t r_top = draw(seed, batch_index, b, 0x11);
      const uint64_t r_left = draw(seed, batch_index, b, 0x22);
      const int top = static_cast<int>(r_top % (im.h - patch + 1));
      const int left = static_cast<int>(r_left % (im.w - patch + 1));
      float* oc = out_clean + static_cast<size_t>(b) * item_elems;
      float* on = out_noise + static_cast<size_t>(b) * item_elems;
      constexpr float kInv255 = 1.0f / 255.0f;
      for (int y = 0; y < patch; ++y) {
        const uint8_t* rc =
            im.clean.data() +
            (static_cast<size_t>(top + y) * im.w + left) * im.c;
        const uint8_t* rn =
            im.noise.data() +
            (static_cast<size_t>(top + y) * im.w + left) * im.c;
        const size_t row = static_cast<size_t>(y) * patch * im.c;
        for (int i = 0; i < patch * im.c; ++i) {
          oc[row + i] = rc[i] * kInv255;
          on[row + i] = rn[i] * kInv255;
        }
      }
    }
  };

  if (n_threads <= 1 || batch == 1) {
    work(0, batch);
  } else {
    const int nt = n_threads < batch ? n_threads : batch;
    std::vector<std::thread> threads;
    const int per = (batch + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
      const int begin = t * per;
      const int end = begin + per < batch ? begin + per : batch;
      if (begin >= end) break;
      threads.emplace_back(work, begin, end);
    }
    for (auto& th : threads) th.join();
  }
  return 0;
}

}  // extern "C"

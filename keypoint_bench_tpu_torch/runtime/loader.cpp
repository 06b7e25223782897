// Native data-loading runtime of the PyTorch port: the port's own copy of
// keypoint_bench_tpu/runtime/loader.cpp. Decodes P5/P6 PGM/PPM (the
// HPatches format) and resizes bilinearly to [0,1] float RGB off the Python
// thread, one image at a time or through a threaded, ordered ring-buffer
// prefetcher. The arithmetic of the decode and the resize is the original's,
// so the frames are bit-equal to the JAX package's. Left out: the
// space-to-depth output layout (a TPU layout). Added: a decode failure in the
// prefetcher is reported with the frame instead of leaving it zero, and the
// PNG row unfilter that datasets/imageio.py decodes PNGs with.
//
// Build (runtime/loader.py does it at first use, into
// keypoint_bench_tpu_torch/_build/):
//   g++ -O3 -shared -fPIC -std=c++17 -o libkbt_loader.so loader.cpp -lpthread

#include <atomic>
#include <cctype>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <utility>
#include <vector>

namespace {

struct Image {
  int w = 0, h = 0, c = 0;
  std::vector<uint8_t> data;  // interleaved
};

// ---- PPM/PGM (P5/P6 binary) decoding ---------------------------------------

bool read_token(FILE* f, char* tok, size_t cap) {
  int ch;
  // skip whitespace and comments
  while ((ch = fgetc(f)) != EOF) {
    if (ch == '#') {
      while ((ch = fgetc(f)) != EOF && ch != '\n') {
      }
    } else if (!isspace(ch)) {
      break;
    }
  }
  if (ch == EOF) return false;
  size_t n = 0;
  tok[n++] = static_cast<char>(ch);
  while ((ch = fgetc(f)) != EOF && !isspace(ch) && n + 1 < cap) {
    tok[n++] = static_cast<char>(ch);
  }
  tok[n] = 0;
  return true;
}

bool load_pnm(const char* path, Image* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  char tok[64];
  if (!read_token(f, tok, sizeof tok)) {
    fclose(f);
    return false;
  }
  int channels;
  if (strcmp(tok, "P6") == 0) {
    channels = 3;
  } else if (strcmp(tok, "P5") == 0) {
    channels = 1;
  } else {
    fclose(f);
    return false;
  }
  int w, h, maxv;
  if (!read_token(f, tok, sizeof tok)) goto fail;
  w = atoi(tok);
  if (!read_token(f, tok, sizeof tok)) goto fail;
  h = atoi(tok);
  if (!read_token(f, tok, sizeof tok)) goto fail;
  maxv = atoi(tok);
  if (w <= 0 || h <= 0 || maxv != 255) goto fail;
  out->w = w;
  out->h = h;
  out->c = channels;
  out->data.resize(static_cast<size_t>(w) * h * channels);
  if (fread(out->data.data(), 1, out->data.size(), f) != out->data.size())
    goto fail;
  fclose(f);
  return true;
fail:
  fclose(f);
  return false;
}

// ---- bilinear resize to float RGB [0,1] ------------------------------------
// cv2.resize-compatible half-pixel mapping: src = (dst + 0.5) * scale - 0.5,
// clamped at the edges; a gray image is replicated to three channels.

void resize_to_float(const Image& img, int out_w, int out_h, float* dst) {
  const float sx = static_cast<float>(img.w) / out_w;
  const float sy = static_cast<float>(img.h) / out_h;
  for (int y = 0; y < out_h; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    if (fy > img.h - 1) fy = static_cast<float>(img.h - 1);
    int y0 = static_cast<int>(fy);
    int y1 = y0 + 1 < img.h ? y0 + 1 : img.h - 1;
    float wy = fy - y0;
    for (int x = 0; x < out_w; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      if (fx > img.w - 1) fx = static_cast<float>(img.w - 1);
      int x0 = static_cast<int>(fx);
      int x1 = x0 + 1 < img.w ? x0 + 1 : img.w - 1;
      float wx = fx - x0;
      for (int ch = 0; ch < 3; ++ch) {
        int c = img.c == 1 ? 0 : ch;
        float v00 = img.data[(static_cast<size_t>(y0) * img.w + x0) * img.c + c];
        float v01 = img.data[(static_cast<size_t>(y0) * img.w + x1) * img.c + c];
        float v10 = img.data[(static_cast<size_t>(y1) * img.w + x0) * img.c + c];
        float v11 = img.data[(static_cast<size_t>(y1) * img.w + x1) * img.c + c];
        float v = (1 - wy) * ((1 - wx) * v00 + wx * v01) +
                  wy * ((1 - wx) * v10 + wx * v11);
        dst[(static_cast<size_t>(y) * out_w + x) * 3 + ch] = v / 255.0f;
      }
    }
  }
}

// ---- threaded prefetcher ---------------------------------------------------

struct Frame {
  int64_t idx;
  bool ok;
  std::vector<float> data;
};

struct Prefetcher {
  std::vector<std::string> paths;
  int out_w = 0, out_h = 0;
  size_t frame_elems = 0;

  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  // decoded results, delivered strictly in order
  std::queue<Frame> ready;
  size_t capacity = 4;
  std::atomic<int64_t> next_to_fetch{0};
  int64_t next_to_emit = 0;
  std::atomic<bool> stop{false};
  // out-of-order staging
  std::vector<Frame> staged;

  void worker() {
    for (;;) {
      int64_t idx = next_to_fetch.fetch_add(1);
      if (stop.load() || idx >= static_cast<int64_t>(paths.size())) return;
      Frame frame{idx, false, std::vector<float>(frame_elems, 0.0f)};
      Image img;
      if (load_pnm(paths[idx].c_str(), &img)) {
        resize_to_float(img, out_w, out_h, frame.data.data());
        frame.ok = true;
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] {
        return stop.load() || staged.size() + ready.size() < capacity ||
               idx == next_to_emit;
      });
      if (stop.load()) return;
      staged.push_back(std::move(frame));
      // drain the in-order prefix into the ready queue
      bool moved = true;
      while (moved) {
        moved = false;
        for (size_t i = 0; i < staged.size(); ++i) {
          if (staged[i].idx == next_to_emit) {
            ready.push(std::move(staged[i]));
            staged.erase(staged.begin() + i);
            ++next_to_emit;
            moved = true;
            break;
          }
        }
      }
      cv_ready.notify_all();
    }
  }
};

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

extern "C" {

void* kbt_prefetcher_create(const char** paths, int64_t n, int out_w,
                            int out_h, int n_threads, int capacity) {
  if (out_w <= 0 || out_h <= 0) return nullptr;
  auto* p = new Prefetcher();
  p->paths.reserve(n);
  for (int64_t i = 0; i < n; ++i) p->paths.emplace_back(paths[i]);
  p->out_w = out_w;
  p->out_h = out_h;
  p->frame_elems = static_cast<size_t>(out_w) * out_h * 3;
  p->capacity = capacity > 0 ? capacity : 4;
  int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; ++i)
    p->workers.emplace_back(&Prefetcher::worker, p);
  return p;
}

// Blocks until the next in-order frame is decoded; copies it into dst
// (out_h * out_w * 3 floats) and sets *ok to 1, or to 0 where the file did
// not decode. Returns the frame index, or -1 at the end.
int64_t kbt_prefetcher_next(void* handle, float* dst, int* ok) {
  auto* p = static_cast<Prefetcher*>(handle);
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_ready.wait(lk, [&] {
    return !p->ready.empty() ||
           p->next_to_emit >= static_cast<int64_t>(p->paths.size());
  });
  if (p->ready.empty()) return -1;
  Frame item = std::move(p->ready.front());
  p->ready.pop();
  p->cv_space.notify_all();
  lk.unlock();
  memcpy(dst, item.data.data(), item.data.size() * sizeof(float));
  *ok = item.ok ? 1 : 0;
  return item.idx;
}

void kbt_prefetcher_destroy(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  p->stop.store(true);
  p->cv_space.notify_all();
  p->cv_ready.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

// one-shot synchronous decode
int kbt_load_pnm_resized(const char* path, int out_w, int out_h, float* dst) {
  Image img;
  if (out_w <= 0 || out_h <= 0 || !load_pnm(path, &img)) return -1;
  resize_to_float(img, out_w, out_h, dst);
  return 0;
}

// Undo the PNG row filters (None, Sub, Up, Average, Paeth; PNG spec 9.2):
// `data` holds h scanlines of 1 + stride bytes, the filter type first;
// `out` receives the h * stride reconstructed bytes. bpp is the bytes per
// complete pixel. Returns 0, or -1 on an unknown filter type.
int kbt_png_unfilter(const uint8_t* data, int64_t h, int64_t stride, int bpp,
                     uint8_t* out) {
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* in = data + y * (stride + 1);
    const int filter = in[0];
    ++in;
    uint8_t* row = out + y * stride;
    const uint8_t* up = y > 0 ? out + (y - 1) * stride : nullptr;
    for (int64_t x = 0; x < stride; ++x) {
      const int a = x >= bpp ? row[x - bpp] : 0;
      const int b = up ? up[x] : 0;
      const int c = (up && x >= bpp) ? up[x - bpp] : 0;
      int pred;
      switch (filter) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: pred = paeth(a, b, c); break;
        default: return -1;
      }
      row[x] = static_cast<uint8_t>(in[x] + pred);
    }
  }
  return 0;
}

}  // extern "C"

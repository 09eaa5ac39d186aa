// fdn_serve: standalone native serving CLI — JPEG in, JSON boxes out,
// zero Python / zero ML framework in the process. The end-to-end analogue
// of the reference's lite-interpreter deployment
// (demo_scripts/convert_checkpoint_to_scripted_model.py) and
// its onnxruntime webcam demo (demo_model_onnx.py): decode (libjpeg) ->
// resize -> normalize -> conv stack -> sigmoid -> grid decode -> NMS, all
// in-repo native code (fast_loader.cpp + infer_engine.cpp).
//
// Usage:
//   fdn_serve MODEL.fdn IMG.jpg [IMG2.jpg ...] [--bench N] [--threads T]
//
// Prints one JSON line per image: {"file": ..., "boxes": [[score,x,y,w,h],
// ...]} with pixel coords at the model's input resolution. --bench N
// re-runs the forward+NMS N times on the first image and reports img/s.

#include <sys/stat.h>

#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {
int fdtpu_decode_resize(const unsigned char* data, long size, int out_h,
                        int out_w, unsigned char* out, int* src_w,
                        int* src_h);
void* fdn_load(const char* path);
void fdn_free(void* h);
int fdn_info(void* h, int* in_h, int* in_w, int* capacity);
int fdn_predict(void* h, const float* imgs, int batch, float* boxes,
                unsigned char* mask, int num_threads);
}

// JSON string escaping for the file field: quotes, backslashes, control
// chars — paths are user input and the JPEG-in/JSON-out contract promises
// parseable lines.
static void print_json_escaped(const char* s) {
  for (; *s; ++s) {
    unsigned char ch = (unsigned char)*s;
    if (ch == '"' || ch == '\\')
      printf("\\%c", ch);
    else if (ch < 0x20)
      printf("\\u%04x", ch);
    else
      putchar(ch);
  }
}

static std::vector<unsigned char> read_file(const char* path) {
  // fopen("rb") accepts directories on Linux and ftell then returns junk
  // (huge positive values -> vector(n) throws and kills the CLI): require a
  // regular file and a sane ftell, reporting a per-image error otherwise.
  struct stat st;
  if (stat(path, &st) != 0 || !S_ISREG(st.st_mode)) return {};
  FILE* f = fopen(path, "rb");
  if (!f) return {};
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  if (n < 0 || n != (long)st.st_size) {
    fclose(f);
    return {};
  }
  fseek(f, 0, SEEK_SET);
  std::vector<unsigned char> buf(n);
  if (n > 0 && fread(buf.data(), 1, n, f) != (size_t)n) buf.clear();
  fclose(f);
  return buf;
}

int main(int argc, char** argv) {
  if (argc < 3) {
    fprintf(stderr,
            "usage: %s MODEL.fdn IMG.jpg [IMG...] [--bench N] [--threads T]\n",
            argv[0]);
    return 2;
  }
  int bench = 0, threads = 1;
  std::vector<const char*> images;
  for (int i = 2; i < argc; ++i) {
    if (!strcmp(argv[i], "--bench") && i + 1 < argc)
      bench = atoi(argv[++i]);
    else if (!strcmp(argv[i], "--threads") && i + 1 < argc)
      threads = atoi(argv[++i]);
    else
      images.push_back(argv[i]);
  }

  void* model = fdn_load(argv[1]);
  if (!model) {
    fprintf(stderr, "error: cannot load model %s\n", argv[1]);
    return 1;
  }
  int H, W, cap;
  fdn_info(model, &H, &W, &cap);

  std::vector<float> img((size_t)H * W * 3);
  std::vector<unsigned char> rgb((size_t)H * W * 3);
  std::vector<float> boxes((size_t)cap * 5);
  std::vector<unsigned char> mask(cap);

  for (const char* path : images) {
    auto jpeg = read_file(path);
    int sw = 0, sh = 0;
    if (jpeg.empty() ||
        fdtpu_decode_resize(jpeg.data(), (long)jpeg.size(), H, W, rgb.data(),
                            &sw, &sh) != 0) {
      fprintf(stderr, "error: cannot decode %s\n", path);
      continue;
    }
    for (size_t i = 0; i < img.size(); ++i) img[i] = (float)rgb[i];
    if (fdn_predict(model, img.data(), 1, boxes.data(), mask.data(),
                    threads) != 0) {
      fprintf(stderr, "error: predict failed on %s\n", path);
      continue;
    }
    printf("{\"file\": \"");
    print_json_escaped(path);
    printf("\", \"boxes\": [");
    bool first = true;
    for (int k = 0; k < cap; ++k) {
      if (!mask[k]) continue;
      const float* r = &boxes[(size_t)k * 5];
      printf("%s[%.4f, %.1f, %.1f, %.1f, %.1f]", first ? "" : ", ", r[0],
             r[1], r[2], r[3], r[4]);
      first = false;
    }
    printf("]}\n");

    if (bench > 0) {
      // warm (first call above); time forward+NMS only, like the
      // reference's __main__ FPS harnesses (PoolResnet.py:120-127)
      auto t0 = std::chrono::steady_clock::now();
      for (int i = 0; i < bench; ++i)
        fdn_predict(model, img.data(), 1, boxes.data(), mask.data(),
                    threads);
      auto t1 = std::chrono::steady_clock::now();
      double s = std::chrono::duration<double>(t1 - t0).count();
      fprintf(stderr, "bench: %d runs, %.1f ms/img, %.2f img/s\n", bench,
              1e3 * s / bench, bench / s);
      bench = 0;  // only on the first image
    }
  }
  fdn_free(model);
  return 0;
}

// Native MOTChallenge sequence loader: CSV -> padded SoA device buffers (the
// port's copy of the JAX package's `native/motloader.cpp`, code line for
// line).
//
// The reference kit parses MOT det/gt CSV in Python row by row
// (python/motchallenge/trackers.py, pandas-side grouping);
// the device pipeline here wants the whole sequence as padded
// struct-of-arrays tensors (frames x dpad), so the loader does the parse,
// frame grouping, LTWH->vec5 conversion and power-of-two padding in one
// C++ pass over the file bytes — the host-side prep cost of a sequence run
// drops to a single memcpy-speed sweep.
//
// Row format (MOT det/gt): frame,id,left,top,width,height,conf[,x,y,z]
// Missing conf parses as 1.0.  Rows are grouped by frame; frames are
// reported in ascending order (they need not be contiguous).
//
// C ABI (two-call pattern: load/introspect/fill/free):
//   void* mot_load(const char* path)                      -> handle or NULL
//   void  mot_dims(handle, int64 out[3])  // {n_frames, dpad, n_rows}
//   void  mot_frames(handle, int32* frames)               // [n_frames]
//   void  mot_fill(handle, float* box5, float* conf, uint8* valid)
//         // box5[F*dpad*5] vec5 = (xc, yc, 0, w/h, h); conf raw; valid 0/1
//   void  mot_free(handle)

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <vector>

namespace {

struct Row {
  int frame;
  float l, t, w, h, conf;
};

struct MotFile {
  std::vector<int> frames;              // ascending unique frame ids
  std::vector<std::vector<Row>> rows;   // per frame, file order
  int64_t dpad = 8;
  int64_t n_rows = 0;
};

// Parse a float field and advance past the next comma (or line end).
// Bounded to [p, end): strtof skips leading whitespace INCLUDING newlines,
// so a parse that lands past `end` (the line boundary) is rejected — an
// optional trailing field must not swallow the next line's first column.
inline float field_f(const char*& p, const char* end, bool* ok) {
  if (p >= end) {
    *ok = false;
    return 0.0f;
  }
  char* q = nullptr;
  float v = std::strtof(p, &q);
  if (q == p || q > end) {
    *ok = false;
    return 0.0f;
  }
  p = q;
  while (p < end && *p != ',' && *p != '\n' && *p != '\r') ++p;
  if (p < end && *p == ',') ++p;
  return v;
}

}  // namespace

extern "C" {

void* mot_load(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(size) + 1);
  size_t got = std::fread(buf.data(), 1, static_cast<size_t>(size), f);
  std::fclose(f);
  buf[got] = '\0';

  std::map<int, std::vector<Row>> by_frame;
  const char* p = buf.data();
  const char* end = buf.data() + got;
  int64_t n_rows = 0;
  while (p < end) {
    while (p < end && (*p == '\n' || *p == '\r')) ++p;
    if (p >= end) break;
    const char* line_end = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(end - p)));
    if (!line_end) line_end = end;
    bool ok = true;
    Row r;
    r.frame = static_cast<int>(field_f(p, line_end, &ok));
    (void)field_f(p, line_end, &ok);  // object id (unused for detections)
    r.l = field_f(p, line_end, &ok);
    r.t = field_f(p, line_end, &ok);
    r.w = field_f(p, line_end, &ok);
    r.h = field_f(p, line_end, &ok);
    if (ok) {
      bool cok = true;
      const char* save = p;
      float c = field_f(p, line_end, &cok);
      if (!cok) {
        c = 1.0f;
        p = save;
      }
      r.conf = c;
      by_frame[r.frame].push_back(r);
      ++n_rows;
    }
    p = line_end;
  }

  auto* mf = new MotFile();
  mf->n_rows = n_rows;
  size_t dmax = 1;
  for (auto& kv : by_frame) {
    mf->frames.push_back(kv.first);
    dmax = std::max(dmax, kv.second.size());
    mf->rows.push_back(std::move(kv.second));
  }
  int64_t dpad = 8;
  while (dpad < static_cast<int64_t>(dmax)) dpad *= 2;
  mf->dpad = dpad;
  return mf;
}

void mot_dims(void* handle, int64_t out[3]) {
  auto* mf = static_cast<MotFile*>(handle);
  out[0] = static_cast<int64_t>(mf->frames.size());
  out[1] = mf->dpad;
  out[2] = mf->n_rows;
}

void mot_frames(void* handle, int32_t* frames) {
  auto* mf = static_cast<MotFile*>(handle);
  for (size_t i = 0; i < mf->frames.size(); ++i)
    frames[i] = static_cast<int32_t>(mf->frames[i]);
}

void mot_fill(void* handle, float* box5, float* conf, uint8_t* valid) {
  auto* mf = static_cast<MotFile*>(handle);
  const int64_t dpad = mf->dpad;
  const int64_t nf = static_cast<int64_t>(mf->frames.size());
  std::memset(box5, 0, sizeof(float) * static_cast<size_t>(nf * dpad * 5));
  std::memset(conf, 0, sizeof(float) * static_cast<size_t>(nf * dpad));
  std::memset(valid, 0, static_cast<size_t>(nf * dpad));
  for (int64_t s = 0; s < nf; ++s) {
    const auto& rows = mf->rows[static_cast<size_t>(s)];
    for (size_t i = 0; i < rows.size(); ++i) {
      const Row& r = rows[i];
      float* b = box5 + (s * dpad + static_cast<int64_t>(i)) * 5;
      b[0] = r.l + r.w * 0.5f;
      b[1] = r.t + r.h * 0.5f;
      b[2] = 0.0f;
      b[3] = r.w / std::max(r.h, 1e-6f);
      b[4] = r.h;
      conf[s * dpad + static_cast<int64_t>(i)] = r.conf;
      valid[s * dpad + static_cast<int64_t>(i)] = 1;
    }
  }
}

void mot_free(void* handle) { delete static_cast<MotFile*>(handle); }

}  // extern "C"

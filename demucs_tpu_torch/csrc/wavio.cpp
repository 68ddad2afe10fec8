// WAV window reader and example prefetcher of the port's training loader
// (the window and prefetch parts of the JAX package's wavio.cpp), bound
// with ctypes by demucs_tpu_torch/native.py and built there with g++.
//
// - wavio_info / wavio_read: RIFF/WAVE parsing (PCM 16/24/32, IEEE float32,
//   WAVE_FORMAT_EXTENSIBLE by its SubFormat code) and the decode of a
//   [frame_offset, frame_offset + num_frames) window, channel-converted
//   (demucs/audio.py:143-166) and zero-padded past the end of the file,
//   without the Python interpreter's lock.
// - prefetch_*: a thread pool walks a list of jobs (one file per stem, an
//   offset), decodes each example (S, C, frames), normalizes it by the
//   track's mean and std, and parks it until prefetch_get copies it out.
//
// Decoding follows the port's Python reader (demucs_tpu_torch/audio.py)
// operation for operation, so the two give the same bits.

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <string>
#include <thread>
#include <vector>

namespace {

struct WavInfo {
  uint16_t format = 0;       // 1 = PCM, 3 = IEEE float
  uint16_t channels = 0;
  uint32_t samplerate = 0;
  uint16_t bits = 0;
  uint16_t block_align = 0;
  uint64_t data_offset = 0;  // byte offset of the data payload
  uint64_t data_size = 0;    // bytes
};

bool parse_header(FILE* f, WavInfo* info) {
  char id[4];
  uint32_t size;
  if (fread(id, 1, 4, f) != 4 || memcmp(id, "RIFF", 4) != 0) return false;
  if (fread(&size, 4, 1, f) != 1) return false;
  if (fread(id, 1, 4, f) != 4 || memcmp(id, "WAVE", 4) != 0) return false;
  bool have_fmt = false, have_data = false;
  while (fread(id, 1, 4, f) == 4 && fread(&size, 4, 1, f) == 1) {
    const long padded = (long)size + (long)(size & 1);
    if (memcmp(id, "fmt ", 4) == 0) {
      struct __attribute__((packed)) {
        uint16_t format, channels;
        uint32_t samplerate, byte_rate;
        uint16_t block_align, bits;
      } fmt;
      if (size < sizeof(fmt) || fread(&fmt, sizeof(fmt), 1, f) != 1) return false;
      info->format = fmt.format;
      info->channels = fmt.channels;
      info->samplerate = fmt.samplerate;
      info->bits = fmt.bits;
      info->block_align = fmt.block_align;
      long rest = padded - (long)sizeof(fmt);
      if (fmt.format == 0xFFFE && rest >= 24) {
        // WAVE_FORMAT_EXTENSIBLE: cbSize, validBits, channelMask, then the
        // SubFormat GUID, whose first two bytes are the format code
        uint8_t ext[10];
        if (fread(ext, 1, sizeof(ext), f) != sizeof(ext)) return false;
        memcpy(&info->format, ext + 8, 2);
        rest -= (long)sizeof(ext);
      }
      if (rest) fseek(f, rest, SEEK_CUR);
      have_fmt = true;
    } else if (memcmp(id, "data", 4) == 0) {
      info->data_offset = (uint64_t)ftell(f);
      info->data_size = size;
      fseek(f, padded, SEEK_CUR);
      have_data = true;
    } else {
      fseek(f, padded, SEEK_CUR);
    }
  }
  return have_fmt && have_data;
}

// Channel conversion (audio.py::convert_audio_channels) of `avail` frames of
// C interleaved samples, each decoded by dec(i), straight into out,
// channels-major (out[c * num_frames + t]); zero from avail to num_frames.
template <typename Decode>
void convert(Decode dec, int C, int64_t avail, int out_channels, int64_t num_frames,
             float* out) {
  for (int64_t t = 0; t < avail; ++t) {
    const size_t i = (size_t)t * C;
    if (out_channels == 1) {
      float acc = 0.f;
      for (int c = 0; c < C; ++c) acc += dec(i + c);
      out[t] = acc / (float)C;
    } else if (C == 1) {
      const float v = dec(i);
      for (int c = 0; c < out_channels; ++c) out[(size_t)c * num_frames + t] = v;
    } else {  // as many channels, or the first out_channels
      for (int c = 0; c < out_channels; ++c) out[(size_t)c * num_frames + t] = dec(i + c);
    }
  }
  for (int c = 0; c < out_channels; ++c)
    memset(out + (size_t)c * num_frames + avail, 0, sizeof(float) * (size_t)(num_frames - avail));
}

// Decode [frame_offset, frame_offset + num_frames) into out, channels-major
// (out[c * num_frames + t]), zero past the end of the file. Returns the
// frames read, or a negative code: -1 open, -2 header, -3 short read,
// -4 unsupported format, -5 channel layout.
int64_t read_window(const char* path, int64_t frame_offset, int64_t num_frames,
                    int out_channels, float* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  if (!parse_header(f, &info) || info.block_align == 0 || info.channels == 0) {
    fclose(f);
    return -2;
  }
  const int C = info.channels;
  if (out_channels != C && out_channels != 1 && C != 1 && out_channels > C) {
    fclose(f);
    return -5;  // fewer channels than asked and not mono (audio.py's ValueError)
  }
  const bool f32 = info.format == 3 && info.bits == 32;
  const bool pcm = info.format == 1 && (info.bits == 16 || info.bits == 24 || info.bits == 32);
  if (!f32 && !pcm) {
    fclose(f);
    return -4;
  }
  const int64_t total = (int64_t)(info.data_size / info.block_align);
  int64_t avail = total - frame_offset;
  if (avail < 0) avail = 0;
  if (avail > num_frames) avail = num_frames;

  const size_t nbytes = (size_t)avail * info.block_align;
  std::unique_ptr<uint8_t[]> raw(new uint8_t[nbytes > 0 ? nbytes : 1]);  // not zeroed
  if (avail > 0) {
    fseek(f, (long)(info.data_offset + (uint64_t)frame_offset * info.block_align), SEEK_SET);
    if (fread(raw.get(), 1, nbytes, f) != nbytes) {
      fclose(f);
      return -3;
    }
  }
  fclose(f);

  // each sample decoded as audio.py::read_wav does
  const uint8_t* p = raw.get();
  if (f32) {
    convert([p](size_t i) { float v; memcpy(&v, p + 4 * i, 4); return v; },
            C, avail, out_channels, num_frames, out);
  } else if (info.bits == 16) {
    convert([p](size_t i) {
              int16_t v;
              memcpy(&v, p + 2 * i, 2);
              return (float)v / 32768.f;
            }, C, avail, out_channels, num_frames, out);
  } else if (info.bits == 24) {
    convert([p](size_t i) {
              const uint8_t* b = p + 3 * i;
              const int32_t v = (int32_t)((uint32_t)b[0] << 8 | (uint32_t)b[1] << 16 |
                                          (uint32_t)b[2] << 24) >> 8;  // sign extend
              return (float)v / 8388608.f;
            }, C, avail, out_channels, num_frames, out);
  } else {
    convert([p](size_t i) {
              int32_t v;
              memcpy(&v, p + 4 * i, 4);
              return (float)v / 2147483648.f;
            }, C, avail, out_channels, num_frames, out);
  }
  return avail;
}

struct Job {
  std::vector<std::string> files;  // one per source
  int64_t offset = 0;
  double mean = 0.0, std = 1.0;    // the track's normalization (wav.py:178-179)
};

enum State : int { kPending = 0, kDone = 2, kFailed = 3 };

struct Prefetcher {
  std::vector<Job> jobs;
  int channels = 2;
  int64_t frames = 0;  // every example's window length
  size_t sources = 0;
  std::vector<std::vector<float>> results;  // per job: S * C * frames
  std::vector<int64_t> errors;              // per job: the first read's error code
  std::vector<std::atomic<int>>* state = nullptr;
  std::atomic<size_t> next{0};
  std::vector<std::thread> threads;
  std::atomic<bool> stop{false};

  ~Prefetcher() {
    stop = true;
    for (auto& t : threads) t.join();
    delete state;
  }

  void worker() {
    while (!stop) {
      const size_t i = next.fetch_add(1);
      if (i >= jobs.size()) return;
      const Job& j = jobs[i];
      auto& dst = results[i];
      dst.assign(sources * (size_t)channels * frames, 0.f);
      int64_t err = 0;
      for (size_t s = 0; s < j.files.size() && s < sources && err == 0; ++s) {
        const int64_t got = read_window(j.files[s].c_str(), j.offset, frames, channels,
                                        dst.data() + s * (size_t)channels * frames);
        if (got < 0) err = got;
      }
      if (err == 0 && (j.std != 1.0 || j.mean != 0.0)) {
        const float inv = (float)(1.0 / j.std);
        const float mu = (float)j.mean;
        for (auto& v : dst) v = (v - mu) * inv;
      }
      errors[i] = err;
      (*state)[i].store(err == 0 ? kDone : kFailed);
    }
  }
};

}  // namespace

extern "C" {

// out5 = samplerate, channels, frames, bits, format code. Returns 0 or a
// negative code.
int64_t wavio_info(const char* path, int64_t* out5) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  const bool ok = parse_header(f, &info);
  fclose(f);
  if (!ok || info.block_align == 0) return -2;
  out5[0] = info.samplerate;
  out5[1] = info.channels;
  out5[2] = (int64_t)(info.data_size / info.block_align);
  out5[3] = info.bits;
  out5[4] = info.format;
  return 0;
}

int64_t wavio_read(const char* path, int64_t frame_offset, int64_t num_frames,
                   int out_channels, float* out) {
  return read_window(path, frame_offset, num_frames, out_channels, out);
}

void* prefetch_create(int channels, int64_t frames, int64_t sources) {
  auto* p = new Prefetcher();
  p->channels = channels;
  p->frames = frames;
  p->sources = (size_t)sources;
  return p;
}

void prefetch_add_job(void* handle, const char** files, int64_t n_files, int64_t offset,
                      double mean, double stddev) {
  auto* p = (Prefetcher*)handle;
  Job j;
  for (int64_t i = 0; i < n_files; ++i) j.files.emplace_back(files[i]);
  j.offset = offset;
  j.mean = mean;
  j.std = stddev;
  p->jobs.push_back(std::move(j));
}

void prefetch_start(void* handle, int num_threads) {
  auto* p = (Prefetcher*)handle;
  p->results.resize(p->jobs.size());
  p->errors.assign(p->jobs.size(), 0);
  p->state = new std::vector<std::atomic<int>>(p->jobs.size());
  for (auto& s : *p->state) s.store(kPending);
  for (int i = 0; i < num_threads; ++i) p->threads.emplace_back([p] { p->worker(); });
}

// Waits until job i is decoded and copies it out. Returns 0, 1 for an index
// out of range or a prefetcher not started, or the job's read error
// (negative, see read_window).
int64_t prefetch_get(void* handle, int64_t i, float* out) {
  auto* p = (Prefetcher*)handle;
  if (p->state == nullptr || i < 0 || (size_t)i >= p->jobs.size()) return 1;
  int s;
  while ((s = (*p->state)[i].load()) == kPending)
    std::this_thread::sleep_for(std::chrono::microseconds(200));
  if (s == kFailed) return p->errors[i] < 0 ? p->errors[i] : -2;
  auto& src = p->results[i];
  memcpy(out, src.data(), src.size() * sizeof(float));
  std::vector<float>().swap(src);
  return 0;
}

void prefetch_destroy(void* handle) { delete (Prefetcher*)handle; }

}  // extern "C"

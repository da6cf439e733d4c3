// Native WAV codec + block reader for the zaftpu streaming IO path.
//
// The reference does whole-file reads through scipy.io.wavfile
// (/root/reference/zaf.py:1187-1219). For hour-scale recordings feeding the
// frame-block sharded pipelines, the framework instead streams fixed-size
// sample blocks straight into pinned float32 buffers: this file implements
// the RIFF/WAVE parser, PCM16/24/32 + float32/64 decode with the reference's
// normalization contract (divide by 2^(bits-1); floats pass through), seek by
// sample index, and int16/float32 encode. Exposed through a plain C ABI and
// loaded from Python with ctypes (zaftpu.io.native).
//
// Build: g++ -O3 -shared -fPIC -o _wavio.so wavio.cpp

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

namespace {

struct WavInfo {
  uint32_t sample_rate = 0;
  uint16_t channels = 0;
  uint16_t bits_per_sample = 0;
  uint16_t format = 0;  // 1 = PCM, 3 = IEEE float
  uint64_t data_offset = 0;
  uint64_t data_bytes = 0;
};

bool parse_header(FILE* f, WavInfo* info) {
  char tag[4];
  uint32_t riff_size = 0;
  if (fread(tag, 1, 4, f) != 4 || memcmp(tag, "RIFF", 4) != 0) return false;
  if (fread(&riff_size, 4, 1, f) != 1) return false;
  if (fread(tag, 1, 4, f) != 4 || memcmp(tag, "WAVE", 4) != 0) return false;

  bool have_fmt = false;
  while (fread(tag, 1, 4, f) == 4) {
    uint32_t chunk_size = 0;
    if (fread(&chunk_size, 4, 1, f) != 1) return false;
    if (memcmp(tag, "fmt ", 4) == 0) {
      uint8_t buf[40];
      uint32_t take = chunk_size < sizeof(buf) ? chunk_size : sizeof(buf);
      if (fread(buf, 1, take, f) != take) return false;
      if (chunk_size > take && fseek(f, chunk_size - take, SEEK_CUR) != 0)
        return false;
      memcpy(&info->format, buf + 0, 2);
      memcpy(&info->channels, buf + 2, 2);
      memcpy(&info->sample_rate, buf + 4, 4);
      memcpy(&info->bits_per_sample, buf + 14, 2);
      if (info->format == 0xFFFE && chunk_size >= 40) {
        // WAVE_FORMAT_EXTENSIBLE: true format lives in the GUID's first two
        // bytes at offset 24.
        memcpy(&info->format, buf + 24, 2);
      }
      have_fmt = true;
    } else if (memcmp(tag, "data", 4) == 0) {
      info->data_offset = static_cast<uint64_t>(ftell(f));
      info->data_bytes = chunk_size;
      return have_fmt;
    } else {
      // Chunks are word-aligned.
      long skip = chunk_size + (chunk_size & 1);
      if (fseek(f, skip, SEEK_CUR) != 0) return false;
    }
  }
  return false;
}

inline int32_t decode24(const uint8_t* p) {
  int32_t v = (p[0]) | (p[1] << 8) | (p[2] << 16);
  if (v & 0x800000) v |= ~0xFFFFFF;  // sign-extend
  return v;
}

}  // namespace

extern "C" {

// Returns 0 on success. Outputs: sample_rate, channels, bits, format
// (1 PCM / 3 float), total frames (samples per channel).
int zaftpu_wav_info(const char* path, int32_t* sample_rate, int32_t* channels,
                    int32_t* bits, int32_t* format, int64_t* frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  bool ok = parse_header(f, &info);
  fclose(f);
  if (!ok || info.channels == 0 || info.bits_per_sample == 0) return -2;
  *sample_rate = static_cast<int32_t>(info.sample_rate);
  *channels = info.channels;
  *bits = info.bits_per_sample;
  *format = info.format;
  *frames = static_cast<int64_t>(
      info.data_bytes / (info.channels * info.bits_per_sample / 8));
  return 0;
}

// Decode `count` frames starting at frame `start` into `out`
// (count * channels float32, interleaved), normalized per the reference
// contract (zaf.py:1202): ints scaled by 2^(bits-1), floats pass through.
// Returns number of frames actually read, or negative on error.
int64_t zaftpu_wav_read_block(const char* path, int64_t start, int64_t count,
                              float* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  if (!parse_header(f, &info)) {
    fclose(f);
    return -2;
  }
  // Mirror zaftpu_wav_info's validation: a malformed fmt chunk with zero
  // channels/bits would otherwise make frame_bytes 0 and SIGFPE on the
  // division below.
  if (info.channels == 0 || info.bits_per_sample == 0 ||
      info.bits_per_sample % 8 != 0) {
    fclose(f);
    return -2;
  }
  const uint32_t bytes_per_sample = info.bits_per_sample / 8;
  const uint32_t frame_bytes = bytes_per_sample * info.channels;
  const int64_t total = info.data_bytes / frame_bytes;
  if (start < 0 || start > total) {
    fclose(f);
    return -3;
  }
  if (start + count > total) count = total - start;
  if (fseek(f, static_cast<long>(info.data_offset + start * frame_bytes),
            SEEK_SET) != 0) {
    fclose(f);
    return -4;
  }

  const int64_t n_values = count * info.channels;
  std::string raw(static_cast<size_t>(n_values) * bytes_per_sample, '\0');
  size_t got = fread(raw.data(), 1, raw.size(), f);
  fclose(f);
  const int64_t got_values = static_cast<int64_t>(got / bytes_per_sample);
  const uint8_t* p = reinterpret_cast<const uint8_t*>(raw.data());

  if (info.format == 3 && info.bits_per_sample == 32) {
    memcpy(out, p, got_values * 4);
  } else if (info.format == 3 && info.bits_per_sample == 64) {
    const double* d = reinterpret_cast<const double*>(p);
    for (int64_t i = 0; i < got_values; ++i) out[i] = static_cast<float>(d[i]);
  } else if (info.bits_per_sample == 16) {
    const int16_t* s = reinterpret_cast<const int16_t*>(p);
    const float scale = 1.0f / 32768.0f;
    for (int64_t i = 0; i < got_values; ++i) out[i] = s[i] * scale;
  } else if (info.bits_per_sample == 32) {
    const int32_t* s = reinterpret_cast<const int32_t*>(p);
    const float scale = 1.0f / 2147483648.0f;
    for (int64_t i = 0; i < got_values; ++i) out[i] = s[i] * scale;
  } else if (info.bits_per_sample == 24) {
    const float scale = 1.0f / 8388608.0f;
    for (int64_t i = 0; i < got_values; ++i)
      out[i] = decode24(p + i * 3) * scale;
  } else if (info.bits_per_sample == 8) {
    // 8-bit WAV is unsigned, midpoint 128 (scipy convention: no recentering
    // on read — the reference normalizes by 2^7 after scipy returns uint8;
    // match that exactly: value / 128).
    const float scale = 1.0f / 128.0f;
    for (int64_t i = 0; i < got_values; ++i) out[i] = p[i] * scale;
  } else {
    return -5;
  }
  return got_values / info.channels;
}

static int write_header(FILE* f, int32_t sample_rate, int32_t channels,
                        int32_t bits, int32_t format, int64_t frames) {
  const uint32_t frame_bytes = channels * bits / 8;
  const uint32_t data_bytes = static_cast<uint32_t>(frames * frame_bytes);
  const uint32_t fmt_size = 16;
  const uint32_t riff_size = 4 + (8 + fmt_size) + (8 + data_bytes);
  uint16_t fmt16 = static_cast<uint16_t>(format);
  uint16_t ch16 = static_cast<uint16_t>(channels);
  uint16_t bits16 = static_cast<uint16_t>(bits);
  uint32_t byte_rate = sample_rate * frame_bytes;
  uint16_t block_align = static_cast<uint16_t>(frame_bytes);
  fwrite("RIFF", 1, 4, f);
  fwrite(&riff_size, 4, 1, f);
  fwrite("WAVE", 1, 4, f);
  fwrite("fmt ", 1, 4, f);
  fwrite(&fmt_size, 4, 1, f);
  fwrite(&fmt16, 2, 1, f);
  fwrite(&ch16, 2, 1, f);
  fwrite(&sample_rate, 4, 1, f);
  fwrite(&byte_rate, 4, 1, f);
  fwrite(&block_align, 2, 1, f);
  fwrite(&bits16, 2, 1, f);
  fwrite("data", 1, 4, f);
  fwrite(&data_bytes, 4, 1, f);
  return 0;
}

// Write interleaved float32 data as IEEE-float WAV (format 3) — matches the
// reference's pass-through write contract (zaf.py:1219).
int zaftpu_wav_write_f32(const char* path, int32_t sample_rate,
                         int32_t channels, int64_t frames, const float* data) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  write_header(f, sample_rate, channels, 32, 3, frames);
  size_t n = static_cast<size_t>(frames) * channels;
  size_t wrote = fwrite(data, 4, n, f);
  fclose(f);
  return wrote == n ? 0 : -2;
}

// Write interleaved int16 PCM.
int zaftpu_wav_write_i16(const char* path, int32_t sample_rate,
                         int32_t channels, int64_t frames,
                         const int16_t* data) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  write_header(f, sample_rate, channels, 16, 1, frames);
  size_t n = static_cast<size_t>(frames) * channels;
  size_t wrote = fwrite(data, 2, n, f);
  fclose(f);
  return wrote == n ? 0 : -2;
}

}  // extern "C"

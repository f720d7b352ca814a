// Native host-side audio ingest for the PyTorch port: WAV parsing, PCM
// conversion, mixdown, linear resampling and a 16-bit WAV writer
// (counterpart of sonido_sonar_tpu/io/native/wavio.cpp, the same
// arithmetic).
//
// The reference decodes through an FFmpeg subprocess
// (transcode/decoder.go:640-870: decode -> bytesToFloat64); this code
// owns the host-side byte churn of the ffmpeg-less WAV path, which would
// otherwise hold back the input pipeline in Python.
//
// Exposed through a C ABI for ctypes (io/native/__init__.py builds it
// with g++ at first use).

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <vector>

extern "C" {

// Parse a RIFF/WAVE byte buffer. Returns 0 on success.
// On success fills *out_samples (malloc'd float32 mono PCM, caller frees
// via wavio_free), *out_len, *out_rate, *out_channels (source channels).
int wavio_decode(
    const uint8_t* data, int64_t size,
    float** out_samples, int64_t* out_len,
    int32_t* out_rate, int32_t* out_channels)
{
    if (size < 44 || memcmp(data, "RIFF", 4) != 0 || memcmp(data + 8, "WAVE", 4) != 0)
        return -1;

    int64_t pos = 12;
    int32_t rate = 0;
    int16_t channels = 0, bits = 0, format = 0;
    const uint8_t* pcm = nullptr;
    int64_t pcm_bytes = 0;

    while (pos + 8 <= size) {
        const uint8_t* hdr = data + pos;
        uint32_t chunk_size;
        memcpy(&chunk_size, hdr + 4, 4);
        const uint8_t* body = hdr + 8;
        if (memcmp(hdr, "fmt ", 4) == 0 && chunk_size >= 16 &&
            pos + 8 + 16 <= size) {
            memcpy(&format, body + 0, 2);
            memcpy(&channels, body + 2, 2);
            memcpy(&rate, body + 4, 4);
            memcpy(&bits, body + 14, 2);
        } else if (memcmp(hdr, "data", 4) == 0) {
            pcm = body;
            pcm_bytes = chunk_size;
            if (pos + 8 + pcm_bytes > size) pcm_bytes = size - pos - 8;
        }
        pos += 8 + chunk_size + (chunk_size & 1);
        if (pcm && rate) break;
    }
    if (!pcm || !rate || channels <= 0) return -2;
    // format 1 = PCM int, 3 = IEEE float
    if (format != 1 && format != 3) return -3;

    const int bytes_per = bits / 8;
    if (bytes_per < 1 || bytes_per > 4) return -4;
    const int64_t frames = pcm_bytes / (bytes_per * channels);
    float* out = (float*)malloc(sizeof(float) * frames);
    if (!out) return -5;

    const float inv_ch = 1.0f / channels;
    for (int64_t i = 0; i < frames; i++) {
        float acc = 0.0f;
        for (int c = 0; c < channels; c++) {
            const uint8_t* p = pcm + (i * channels + c) * bytes_per;
            float v = 0.0f;
            if (format == 3 && bits == 32) {
                float f; memcpy(&f, p, 4); v = f;
            } else if (bits == 16) {
                int16_t s; memcpy(&s, p, 2); v = s / 32768.0f;
            } else if (bits == 32) {
                int32_t s; memcpy(&s, p, 4); v = s / 2147483648.0f;
            } else if (bits == 24) {
                int32_t s = (int32_t)(p[0] | (p[1] << 8) | (p[2] << 16));
                if (s & 0x800000) s -= 0x1000000;
                v = s / 8388608.0f;
            } else if (bits == 8) {
                v = ((int)p[0] - 128) / 128.0f;
            }
            acc += v;
        }
        out[i] = acc * inv_ch;
    }

    *out_samples = out;
    *out_len = frames;
    *out_rate = rate;
    *out_channels = channels;
    return 0;
}

// Convert raw little-endian bytes to float32 (the bytesToFloat64
// equivalent, decoder.go:850-870). fmt: 0 = f32le, 1 = f64le, 2 = s16le.
int wavio_bytes_to_f32(
    const uint8_t* data, int64_t size, int32_t fmt,
    float** out_samples, int64_t* out_len)
{
    int64_t n;
    float* out;
    switch (fmt) {
    case 0:
        n = size / 4;
        out = (float*)malloc(sizeof(float) * n);
        if (!out) return -5;
        memcpy(out, data, n * 4);
        break;
    case 1: {
        n = size / 8;
        out = (float*)malloc(sizeof(float) * n);
        if (!out) return -5;
        for (int64_t i = 0; i < n; i++) {
            double d; memcpy(&d, data + i * 8, 8);
            out[i] = (float)d;
        }
        break;
    }
    case 2: {
        n = size / 2;
        out = (float*)malloc(sizeof(float) * n);
        if (!out) return -5;
        for (int64_t i = 0; i < n; i++) {
            int16_t s; memcpy(&s, data + i * 2, 2);
            out[i] = s / 32768.0f;
        }
        break;
    }
    default:
        return -1;
    }
    *out_samples = out;
    *out_len = n;
    return 0;
}

// Linear resampler (the WAV fallback path's resampler; the ffmpeg path
// keeps soxr upstream).
int wavio_resample_linear(
    const float* in, int64_t n_in, int32_t rate_in, int32_t rate_out,
    float** out_samples, int64_t* out_len)
{
    if (n_in <= 1 || rate_in <= 0 || rate_out <= 0) return -1;
    const int64_t n_out = (int64_t)((double)n_in * rate_out / rate_in + 0.5);
    float* out = (float*)malloc(sizeof(float) * n_out);
    if (!out) return -5;
    const double step = (double)rate_in / rate_out;
    for (int64_t i = 0; i < n_out; i++) {
        double t = i * step;
        int64_t i0 = (int64_t)t;
        if (i0 >= n_in - 1) { out[i] = in[n_in - 1]; continue; }
        double frac = t - i0;
        out[i] = (float)(in[i0] * (1.0 - frac) + in[i0 + 1] * frac);
    }
    *out_samples = out;
    *out_len = n_out;
    return 0;
}

// 16-bit WAV writer (for fixtures/benchmarks). Returns bytes written or <0.
int64_t wavio_encode16(
    const float* samples, int64_t n, int32_t rate,
    uint8_t** out_bytes)
{
    const int64_t data_bytes = n * 2;
    const int64_t total = 44 + data_bytes;
    uint8_t* buf = (uint8_t*)malloc(total);
    if (!buf) return -5;
    uint32_t u32; uint16_t u16;
    memcpy(buf, "RIFF", 4);
    u32 = (uint32_t)(total - 8); memcpy(buf + 4, &u32, 4);
    memcpy(buf + 8, "WAVEfmt ", 8);
    u32 = 16; memcpy(buf + 16, &u32, 4);
    u16 = 1; memcpy(buf + 20, &u16, 2);          // PCM
    u16 = 1; memcpy(buf + 22, &u16, 2);          // mono
    u32 = (uint32_t)rate; memcpy(buf + 24, &u32, 4);
    u32 = (uint32_t)(rate * 2); memcpy(buf + 28, &u32, 4);
    u16 = 2; memcpy(buf + 32, &u16, 2);
    u16 = 16; memcpy(buf + 34, &u16, 2);
    memcpy(buf + 36, "data", 4);
    u32 = (uint32_t)data_bytes; memcpy(buf + 40, &u32, 4);
    int16_t* pcm = (int16_t*)(buf + 44);
    for (int64_t i = 0; i < n; i++) {
        float v = samples[i];
        if (v > 1.0f) v = 1.0f;
        if (v < -1.0f) v = -1.0f;
        pcm[i] = (int16_t)(v * 32767.0f);
    }
    *out_bytes = buf;
    return total;
}

void wavio_free(void* p) { free(p); }

}  // extern "C"

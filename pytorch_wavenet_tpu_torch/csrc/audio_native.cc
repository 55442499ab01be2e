// Native audio featurization: a copy of the JAX package's
// native/audio_native.cc, host code (not a device kernel).
//
// The reference runs these hot loops in numpy/librosa (mu-law quantization
// at reference audio_data.py:133-137, per-item window assembly in 8
// DataLoader worker processes at wavenet_training.py:55-59). Here they are
// vectorizable C++: mu-law encode/quantize, expansion, PCM16 decode, and the
// batched window gather over the flat concatenated class stream. Bound with
// ctypes by pytorch_wavenet_tpu_torch/data/native.py, which builds this file
// with g++ at first use; every entry point there has a numpy fallback.

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Waveform in [-1,1] -> mu-law space [-1,1]: sign(x)*log1p(mu|x|)/log1p(mu)
// (reference: audio_data.py:151-153)
void mu_law_encode(const float* x, float* out, int64_t n, int32_t mu) {
    const float denom = 1.0f / std::log1p((float)mu);
    for (int64_t i = 0; i < n; ++i) {
        const float v = x[i];
        const float a = std::fabs(v);
        const float m = std::log1p(mu * a) * denom;
        out[i] = v < 0 ? -m : m;
    }
}

// Inverse companding (reference: audio_data.py:156-158)
void mu_law_expand(const float* x, float* out, int64_t n, int32_t mu) {
    const float lg = std::log1p((float)mu);
    const float inv_mu = 1.0f / (float)mu;
    for (int64_t i = 0; i < n; ++i) {
        const float v = x[i];
        const float a = std::fabs(v);
        const float m = (std::expm1(a * lg)) * inv_mu;
        out[i] = v < 0 ? -m : m;
    }
}

// Full quantizer: encode then digitize against `classes` edges
// linspace(-1,1,classes), minus 1 (reference: audio_data.py:133-137).
// np.digitize(v, bins)-1 == (# edges <= v) - 1; with uniform edges step
// 2/(classes-1) this is floor((v+1)/step)+1 except exact-edge handling, so
// compute the bucket arithmetically and clamp.
void mu_law_quantize(const float* x, uint8_t* out, int64_t n, int32_t classes) {
    const float denom = 1.0f / std::log1p((float)classes);
    const float step = 2.0f / (float)(classes - 1);
    const float inv_step = 1.0f / step;
    for (int64_t i = 0; i < n; ++i) {
        const float v = x[i];
        const float a = std::fabs(v);
        float m = std::log1p(classes * a) * denom;
        if (v < 0) m = -m;
        // number of edges (-1 + j*step, j=0..classes-1) that are <= m
        int32_t idx = (int32_t)std::floor((m + 1.0f) * inv_step) + 1;
        // exact-edge correction for float rounding near bucket boundaries
        float edge = -1.0f + (float)idx * step;
        while (idx < classes && edge <= m) { ++idx; edge += step; }
        while (idx > 0 && edge - step > m) { --idx; edge -= step; }
        idx -= 1;  // the reference's -1
        if (idx < 0) idx = 0;
        if (idx > classes - 1) idx = classes - 1;
        out[i] = (uint8_t)idx;
    }
}

// Dequantize classes -> waveform via the reference's edge-based decode
// ((q/classes)*2-1 then expansion; reference: wavenet_model.py:296)
void mu_law_dequantize(const uint8_t* q, float* out, int64_t n, int32_t classes) {
    const float lg = std::log1p((float)classes);
    const float inv_mu = 1.0f / (float)classes;
    const float scale = 2.0f / (float)classes;
    for (int64_t i = 0; i < n; ++i) {
        const float v = (float)q[i] * scale - 1.0f;
        const float a = std::fabs(v);
        const float m = std::expm1(a * lg) * inv_mu;
        out[i] = v < 0 ? -m : m;
    }
}

// Interleaved PCM16 -> float32 mono mixdown in [-1,1)
void pcm16_to_float_mono(const int16_t* pcm, float* out, int64_t frames,
                         int32_t channels) {
    const float s = 1.0f / 32768.0f;
    if (channels == 1) {
        for (int64_t i = 0; i < frames; ++i) out[i] = pcm[i] * s;
        return;
    }
    const float cs = s / (float)channels;
    for (int64_t i = 0; i < frames; ++i) {
        int32_t acc = 0;
        for (int32_t c = 0; c < channels; ++c) acc += pcm[i * channels + c];
        out[i] = acc * cs;
    }
}

// Batched training-window gather: for each batch row b, copy
// stream[starts[b] : starts[b]+item_len] into x[b] (int32) and
// stream[starts[b]+item_len+1-target_len : starts[b]+item_len+1] into y[b].
// This is the hot loop the reference runs per item in its DataLoader
// workers (reference: audio_data.py:91-123), batched and scatter-free (the
// one-hot embedding happens on device).
void gather_windows(const uint8_t* stream, int64_t stream_len,
                    const int64_t* starts, int32_t batch,
                    int32_t item_len, int32_t target_len,
                    int32_t* x, int32_t* y) {
    for (int32_t b = 0; b < batch; ++b) {
        const int64_t s = starts[b];
        const uint8_t* src = stream + s;
        int32_t* xb = x + (int64_t)b * item_len;
        for (int32_t i = 0; i < item_len; ++i) xb[i] = src[i];
        const uint8_t* ty = stream + s + item_len + 1 - target_len;
        int32_t* yb = y + (int64_t)b * target_len;
        for (int32_t i = 0; i < target_len; ++i) yb[i] = ty[i];
    }
}

int32_t native_abi_version() { return 1; }

}  // extern "C"

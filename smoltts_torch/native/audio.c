/* Native audio host kernels: float->PCM16 and sample-rate conversion.
 * The port's copy of smoltts_tpu/native/audio.c, built by
 * smoltts_torch/native/__init__.py into build/smoltts_torch/.
 *
 * The reference's server transcode path leans on scipy (FFT resample) and
 * soundfile/pydub for PCM conversion (reference: mlx .../server/tts_core.py:
 * 49-84); these are the framework's own native equivalents for the serving
 * hot path (every streamed chunk crosses them).
 */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>

#ifndef M_PI
#define M_PI 3.14159265358979323846
#endif

/* float32 [-1,1] -> int16, matching numpy's clip + truncating cast. */
void audio_f32_to_i16(const float *in, int16_t *out, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        float x = in[i];
        if (x > 1.0f) x = 1.0f;
        if (x < -1.0f) x = -1.0f;
        out[i] = (int16_t)(x * 32767.0f);
    }
}

/* int16 -> float32 in [-1, 1). */
void audio_i16_to_f32(const int16_t *in, float *out, int64_t n) {
    const float inv = 1.0f / 32768.0f;
    for (int64_t i = 0; i < n; i++) out[i] = (float)in[i] * inv;
}

static double hann(double u, double half_width) {
    double c = cos(M_PI * u / (2.0 * half_width));
    return c * c;
}

/* Windowed-sinc arbitrary-ratio resampler.
 *
 * For each output sample n at input-time t = n * in_rate / out_rate, sums
 * input taps within +-half_width input samples weighted by a Hann-windowed
 * sinc low-passed at fc = min(1, out_rate/in_rate). `zeros` controls
 * quality (number of sinc zero-crossings per side at the cutoff; 16 is
 * transparent for speech). Returns the number of samples written (n_out).
 */
int64_t audio_resample(const float *in, int64_t n_in, int32_t in_rate,
                       int32_t out_rate, float *out, int64_t n_out,
                       int32_t zeros) {
    if (n_in <= 0 || n_out <= 0) return 0;
    if (in_rate == out_rate) {
        for (int64_t i = 0; i < n_out; i++) out[i] = i < n_in ? in[i] : 0.0f;
        return n_out;
    }
    const double ratio = (double)in_rate / (double)out_rate;
    const double fc = ratio > 1.0 ? 1.0 / ratio : 1.0; /* anti-alias cutoff */
    const double half_width = (double)zeros / fc;

    for (int64_t n = 0; n < n_out; n++) {
        const double t = (double)n * ratio;
        int64_t k0 = (int64_t)ceil(t - half_width);
        int64_t k1 = (int64_t)floor(t + half_width);
        if (k0 < 0) k0 = 0;
        if (k1 >= n_in) k1 = n_in - 1;
        double acc = 0.0, wsum = 0.0;
        for (int64_t k = k0; k <= k1; k++) {
            double u = t - (double)k;
            double su = fc * u;
            double s = (su == 0.0) ? 1.0 : sin(M_PI * su) / (M_PI * su);
            double w = fc * s * hann(u, half_width);
            acc += w * (double)in[k];
            wsum += w;
        }
        /* normalize by the window sum so truncated edges don't droop */
        out[n] = (float)(acc / (wsum != 0.0 ? wsum : 1.0));
    }
    return n_out;
}

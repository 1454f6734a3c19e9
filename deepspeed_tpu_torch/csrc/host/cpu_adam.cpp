// Host-side SIMD optimizers of ZeRO-Offload: Adam / AdamW and Adagrad over
// flat fp32 spans (AVX2 + FMA where the host has them, OpenMP across blocks
// of 16384 elements), with the compute-dtype copy of the updated master
// written as bf16 bits in the same pass (the reference's fp16 copy-back).
//
// Compiled with the host compiler at first use by
// deepspeed_tpu_torch/ops/_build.py (load_host) and called through ctypes by
// deepspeed_tpu_torch/ops/adam/cpu_adam.py. The arithmetic is the JAX
// package's csrc/cpu_adam.cpp, statement for statement, so the two builds
// step bitwise alike under the same flags.

#include <cmath>
#include <cstdint>
#include <cstring>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

extern "C" {

// bf16 = upper half of fp32 with round-to-nearest-even.
static inline uint16_t fp32_to_bf16(float f) {
  uint32_t x;
  memcpy(&x, &f, 4);
  uint32_t lsb = (x >> 16) & 1u;
  x += 0x7fffu + lsb;
  return (uint16_t)(x >> 16);
}

// Fused Adam/AdamW step over a contiguous fp32 span.
//   p, m, v: fp32 master param / first / second moment (updated in place)
//   g:       fp32 gradient
//   bc1/bc2: bias-correction denominators (1 - beta^t), precomputed by caller
//   adamw:   1 = decoupled weight decay, 0 = L2 into the gradient
//   bf16_out: optional bf16 copy-back buffer (may be null)
void ds_adam_step(float* p, float* m, float* v, const float* g, int64_t n,
                  float lr, float beta1, float beta2, float eps, float wd,
                  float bc1, float bc2, int adamw, uint16_t* bf16_out) {
  const float om1 = 1.0f - beta1, om2 = 1.0f - beta2;
  const float inv_bc1 = 1.0f / bc1;
  const float inv_sqrt_bc2 = 1.0f / sqrtf(bc2);

#pragma omp parallel for schedule(static)
  for (int64_t blk = 0; blk < (n + 16383) / 16384; ++blk) {
    int64_t i = blk * 16384;
    int64_t i1 = i + 16384 < n ? i + 16384 : n;

#if defined(__AVX2__) && defined(__FMA__)
    const __m256 vb1 = _mm256_set1_ps(beta1);
    const __m256 vb2 = _mm256_set1_ps(beta2);
    const __m256 vom1 = _mm256_set1_ps(om1);
    const __m256 vom2 = _mm256_set1_ps(om2);
    const __m256 veps = _mm256_set1_ps(eps);
    const __m256 vlr = _mm256_set1_ps(lr);
    const __m256 vwd = _mm256_set1_ps(wd);
    const __m256 vibc1 = _mm256_set1_ps(inv_bc1);
    const __m256 visb2 = _mm256_set1_ps(inv_sqrt_bc2);
    for (; i + 8 <= i1; i += 8) {
      __m256 gi = _mm256_loadu_ps(g + i);
      __m256 pi = _mm256_loadu_ps(p + i);
      if (wd != 0.0f && !adamw) gi = _mm256_fmadd_ps(vwd, pi, gi);
      __m256 mi = _mm256_fmadd_ps(vom1, gi, _mm256_mul_ps(vb1, _mm256_loadu_ps(m + i)));
      __m256 vi = _mm256_fmadd_ps(vom2, _mm256_mul_ps(gi, gi),
                                  _mm256_mul_ps(vb2, _mm256_loadu_ps(v + i)));
      __m256 denom = _mm256_add_ps(
          _mm256_mul_ps(_mm256_sqrt_ps(vi), visb2), veps);
      __m256 upd = _mm256_div_ps(_mm256_mul_ps(mi, vibc1), denom);
      if (wd != 0.0f && adamw) upd = _mm256_fmadd_ps(vwd, pi, upd);
      pi = _mm256_fnmadd_ps(vlr, upd, pi);
      _mm256_storeu_ps(p + i, pi);
      _mm256_storeu_ps(m + i, mi);
      _mm256_storeu_ps(v + i, vi);
    }
#endif
    for (; i < i1; ++i) {
      float gi = g[i];
      float pi = p[i];
      if (wd != 0.0f && !adamw) gi += wd * pi;
      float mi = beta1 * m[i] + om1 * gi;
      float vi = beta2 * v[i] + om2 * gi * gi;
      float upd = (mi * inv_bc1) / (sqrtf(vi) * inv_sqrt_bc2 + eps);
      if (wd != 0.0f && adamw) upd += wd * pi;
      pi -= lr * upd;
      p[i] = pi;
      m[i] = mi;
      v[i] = vi;
    }
    if (bf16_out) {
      for (int64_t j = blk * 16384; j < i1; ++j) bf16_out[j] = fp32_to_bf16(p[j]);
    }
  }
}

// Adagrad step (parity: csrc/adagrad/cpu_adagrad.cpp).
void ds_adagrad_step(float* p, float* a, const float* g, int64_t n, float lr,
                     float eps, float wd, uint16_t* bf16_out) {
#pragma omp parallel for schedule(static)
  for (int64_t blk = 0; blk < (n + 16383) / 16384; ++blk) {
    int64_t i = blk * 16384;
    int64_t i1 = i + 16384 < n ? i + 16384 : n;
    for (; i < i1; ++i) {
      float gi = g[i] + wd * p[i];
      float ai = a[i] + gi * gi;
      float pi = p[i] - lr * gi / (sqrtf(ai) + eps);
      p[i] = pi;
      a[i] = ai;
      if (bf16_out) bf16_out[i] = fp32_to_bf16(pi);
    }
  }
}

// Probe symbol so the builder can verify the load.
int ds_cpu_ops_version() { return 1; }

// Reports whether this build actually used the AVX2+FMA path.
int ds_cpu_ops_simd() {
#if defined(__AVX2__) && defined(__FMA__)
  return 2;
#else
  return 0;
#endif
}
}

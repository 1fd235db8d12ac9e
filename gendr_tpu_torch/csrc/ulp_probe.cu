// ULP probe kernels for Hopper (sm_90a), hand-written CUDA C++.
//
// Replace the three TPU probe kernels of the JAX package:
// tools/ulp_check.py:_pallas_elementwise and
// tools/ulp_bisect.py:_pallas_elementwise (ulp_elementwise below) and
// tools/ulp_smem.py:pallas_smem (ulp_param_vector below).  Those ran a
// function elementwise through Mosaic to hold it, bit by bit, against the
// same function under XLA.  Here the question is how nvcc's build of the
// very device functions the render kernels call (pairmath.cuh, included
// below and compiled with the same flags, no multiply-add contraction)
// rounds against PyTorch's ops, which the kernels' plain versions are
// made of: the render gates rest on that difference staying small.
//
// One op table serves both kernels: an integer op id selects a __device__
// expression of up to two inputs and up to NQ parameters.  Each op is
// written once here and once in torch (gendr_tpu_torch/tools/_ulp.py, the
// plain version; a test holds the two tables' ids together).
// ulp_elementwise takes the parameters by value, as kernel arguments;
// ulp_param_vector reads them from a device vector inside the kernel, the
// way the render kernels read `par`.
//
// What bounds them on the card: bytes, nominally (two inputs read, one
// output written, a few dozen operations per element), but at the probes'
// 16384 elements a launch moves 196 KB and costs its launch latency.  The
// design does nothing about it: a probe is run once per op.

#include "pairmath.cuh"

namespace {

using namespace gendr;

constexpr int NQ = 5;  // parameters of an op (tools/_ulp.py NQ)
constexpr int PROBE_THREADS = 256;

// op ids (tools/_ulp.py OPS)
enum {
  // the device functions of pairmath.cuh: q = dist id, scale, shape, shift,
  // 1/Gamma(shape+1) (cdf) or 1/Gamma(shape) (pdf); x = sign, y = distance
  OP_CDF = 0,
  OP_PDF = 1,
  // q = t-conorm id, p; x = a, y = b
  OP_FOLD_STEP = 2,
  OP_AGGREGATE_BACKWARD = 3,
  // frank's fold decomposed, q = p (tools/ulp_smem.py:180-191)
  OP_FRANK_EA = 4,
  OP_FRANK_T = 5,
  OP_FRANK_C = 6,
  // primitive chains, parameters as constants or as the second input
  // (tools/ulp_bisect.py:75-164)
  OP_DIV_CONST = 7,
  OP_DIV_TRACED = 8,
  OP_RECIP = 9,
  OP_EXP = 10,
  OP_TANH = 11,
  OP_SQRT = 12,
  OP_RSQRT = 13,
  OP_LOG = 14,
  OP_POW_1_5 = 15,
  OP_POW_2 = 16,
  OP_POW_TRACED = 17,
  OP_MUL_ADD = 18,
  OP_THREE_MUL = 19,
  OP_DIV_CHAIN_CONST = 20,
  OP_DIV_CHAIN_TRACED = 21,
  OP_DIV_FOLDED_CONST = 22,
  OP_EU_PLUS_INV = 23,
  OP_GUD_PDF_FULL = 24,
  OP_GUD_PDF_REFACTOR = 25,
  OP_WIG_SQ = 26,
  OP_WIG_MID = 27,
  OP_WIG_MID_TRACED = 28,
  OP_ASIN_CLIP_DIV = 29,
  OP_ATAN = 30,
  OP_WIG_FULL = 31,
  OP_KUMMER_DIV = 32,
  OP_KUMMER_RECIP = 33,
  OP_POW_EXP = 34,
  OP_POW_TRACED_EXP = 35,
  OP_GAMMA_FULL_DIV = 36,
  OP_GAMMA_FULL_RECIP = 37,
  OP_EXPM1_LN2 = 38,
  OP_LOG1P = 39,
  OP_FRANK_C_CONST = 40,
  // chains on a scale parameter q = scale, shape; x = sign, y = distance
  // (tools/ulp_smem.py:93-132)
  OP_U = 41,
  OP_X_OVER_SCALE = 42,
  OP_LOGISTIC = 43,
  OP_CUBIC_Y = 44,
  OP_CUBIC_FULL = 45,
  OP_RECIP_FULL = 46,
  OP_RECIP_SINGLE_DIV = 47,
  OP_WIGNER_FULL = 48,
  OP_WIGNER_SQ = 49,
  OP_WIGNER_MID = 50,
  OP_ASIN_CLIP_U = 51,
  OP_ATAN_U = 52,
  // arcsine decomposed (tools/ulp_smem.py:143-158)
  OP_ONE_MINUS_XX = 53,
  OP_ASIN_DEN = 54,
  OP_ASIN_RATIO = 55,
  OP_ASIN_ATAN = 56,
  OP_ASIN = 57,
  OP_ASIN_ALT = 58,
  NUM_OPS = 59
};

// the constants of the primitive chains, folded in double and rounded
// once, as Python folds them before the framework sees them
constexpr float K_SCALE = (float)0.05;
constexpr float K_PI = (float)3.14159265358979323846;
constexpr float K_PI_SCALE = (float)(3.14159265358979323846 * 0.05);
constexpr float K_PI_SCALE2 = (float)(3.14159265358979323846 * 0.05 * 0.05);
constexpr float K_SCALE2 = (float)(0.05 * 0.05);
constexpr float K_LN2 = (float)0.69314718055994530942;

__device__ __forceinline__ float wig_sq(float x) {
  return sqrtf(fmaxf(K_SCALE2 - x * x, 0.0f));
}

// the 32-term Kummer series at shape 2, 1/Gamma(3) = 0.5, dividing by
// (shape + i) or multiplying by its reciprocal rounded beforehand
__device__ __forceinline__ float kummer(float z, bool recip) {
  float kum = 0.5f, fac = 0.5f;
#pragma unroll
  for (int i = 1; i < 32; ++i) {
    fac = recip ? fac * z * (float)(1.0 / (2.0 + (double)i))
                : fac * z / (float)(2.0 + (double)i);
    kum = kum + fac;
  }
  return kum;
}

__device__ __forceinline__ float asin_den(float x) {
  return sqrtf(fmaxf(1.0f - x * x, 1e-12f));
}

// op's expression on inputs x, y with parameters q(0) .. q(NQ - 1)
template <class Q>
__device__ __forceinline__ float probe_op(int op, float x, float y,
                                          const Q& q) {
  switch (op) {
    case OP_CDF:
      return cdf((int)q(0), x, y, q(1), q(2), q(3), q(4));
    case OP_PDF:
      return pdf((int)q(0), x, y, q(1), q(2), q(3), q(4));
    case OP_FOLD_STEP:
      return fold_step((int)q(0), x, y, q(1));
    case OP_AGGREGATE_BACKWARD:
      return aggregate_backward((int)q(0), x, y, q(1));
    case OP_FRANK_EA:
      return expm1f((1.0f - x) * logf(q(0)));
    case OP_FRANK_T:
      return expm1f((1.0f - x) * logf(q(0))) *
             expm1f((1.0f - y) * logf(q(0))) / (q(0) - 1.0f);
    case OP_FRANK_C:
      return log1pf(expm1f((1.0f - x) * logf(q(0))) *
                    expm1f((1.0f - y) * logf(q(0))) / (q(0) - 1.0f)) /
             logf(q(0));

    case OP_DIV_CONST: return x / K_SCALE;
    case OP_DIV_TRACED: return x / y;
    case OP_RECIP: return 1.0f / x;
    case OP_EXP: return expf(x);
    case OP_TANH: return tanhf(x);
    case OP_SQRT: return sqrtf(x);
    case OP_RSQRT: return rsqrtf(x);
    case OP_LOG: return logf(x);
    case OP_POW_1_5: return powf(x, 1.5f);
    case OP_POW_2: return powf(x, 2.0f);
    case OP_POW_TRACED: return powf(x, y * 40.0f);
    case OP_MUL_ADD: return x * y + 0.5f;
    case OP_THREE_MUL: return x * y * x;
    case OP_DIV_CHAIN_CONST: return 2.0f / x / K_PI / K_SCALE;
    case OP_DIV_CHAIN_TRACED: return 2.0f / x / K_PI / y;
    case OP_DIV_FOLDED_CONST: return x / K_PI_SCALE2;
    case OP_EU_PLUS_INV: return expf(x) + 1.0f / expf(x);
    case OP_GUD_PDF_FULL:
      return 2.0f / (expf(x) + 1.0f / expf(x)) / K_PI / K_SCALE;
    case OP_GUD_PDF_REFACTOR:
      return 2.0f / ((expf(x) + 1.0f / expf(x)) * K_PI_SCALE);
    case OP_WIG_SQ: return wig_sq(x);
    case OP_WIG_MID: return (x * wig_sq(x)) / K_PI_SCALE2;
    case OP_WIG_MID_TRACED: return (x * wig_sq(x)) / (K_PI * y * y);
    case OP_ASIN_CLIP_DIV: return asinf(clampf(x / K_SCALE, -1.0f, 1.0f));
    case OP_ATAN: return atanf(x);
    case OP_WIG_FULL:
      return 0.5f + (x * wig_sq(x)) / K_PI_SCALE2 +
             asinf(clampf(x / K_SCALE, -1.0f, 1.0f)) / K_PI;
    case OP_KUMMER_DIV: return kummer(x, false);
    case OP_KUMMER_RECIP: return kummer(x, true);
    case OP_POW_EXP: return powf(x, 2.0f) * expf(-x);
    case OP_POW_TRACED_EXP: return powf(x, y * 40.0f) * expf(-x);
    case OP_GAMMA_FULL_DIV:
      return powf(x, 2.0f) * expf(-x) * kummer(x, false);
    case OP_GAMMA_FULL_RECIP:
      return powf(x, 2.0f) * expf(-x) * kummer(x, true);
    case OP_EXPM1_LN2: return expm1f((1.0f - x) * K_LN2);
    case OP_LOG1P: return log1pf(x);
    case OP_FRANK_C_CONST:
      // p = 2: the division by p - 1 = 1 is the identity
      return log1pf(expm1f((1.0f - x) * K_LN2) * expm1f((1.0f - y) * K_LN2)) /
             K_LN2;

    case OP_U: return x * y / q(0);
    case OP_X_OVER_SCALE: return y / q(0);
    case OP_LOGISTIC: return 1.0f / (1.0f + expf(-(x * y / q(0))));
    case OP_CUBIC_Y: return clampf(0.5f * (x * y / q(0)) + 0.5f, 0.0f, 1.0f);
    case OP_CUBIC_FULL: {
      const float c = clampf(0.5f * (x * y / q(0)) + 0.5f, 0.0f, 1.0f);
      return 3.0f * c * c - 2.0f * c * c * c;
    }
    case OP_RECIP_FULL:
      return (x * y / q(0)) / (1.0f + y / q(0)) / 2.0f + 0.5f;
    case OP_RECIP_SINGLE_DIV: return 0.5f * x * y / (q(0) + y) + 0.5f;
    case OP_WIGNER_FULL: {
      const float s = q(0), u = x * y / s;
      const float sq = sqrtf(fmaxf(s * s - y * y, 0.0f));
      const float mid = 0.5f + (x * y * sq) / (K_PI * s * s) +
                        asinf(clampf(u, -1.0f, 1.0f)) / K_PI;
      return u < -1.0f ? 0.0f : (u < 1.0f ? mid : 1.0f);
    }
    case OP_WIGNER_SQ: return sqrtf(fmaxf(q(0) * q(0) - y * y, 0.0f));
    case OP_WIGNER_MID:
      return (x * y * sqrtf(fmaxf(q(0) * q(0) - y * y, 0.0f))) /
             (K_PI * q(0) * q(0));
    case OP_ASIN_CLIP_U: return asinf(clampf(x * y / q(0), -1.0f, 1.0f));
    case OP_ATAN_U: return atanf(x * y / q(0));

    case OP_ONE_MINUS_XX: return 1.0f - x * x;
    case OP_ASIN_DEN: return asin_den(x);
    case OP_ASIN_RATIO: return x / asin_den(x);
    case OP_ASIN_ATAN: return atanf(x / asin_den(x));
    case OP_ASIN: return asinf(x);
    case OP_ASIN_ALT:
      return atanf(x / sqrtf(fmaxf((1.0f - x) * (1.0f + x), 1e-12f)));
  }
  return 0.0f;
}

struct Params {
  float v[NQ];
};

// out[i] = op(x[i], y[i]); the op's parameters arrive by value
__global__ void __launch_bounds__(PROBE_THREADS) ulp_elementwise_kernel(
    int op, const float* __restrict__ x, const float* __restrict__ y,
    float* __restrict__ out, int n, Params q) {
  const int i = blockIdx.x * PROBE_THREADS + threadIdx.x;
  if (i >= n) return;
  out[i] = probe_op(op, x[i], y[i], [&](int k) { return q.v[k]; });
}

// out[i] = op(x[i], y[i]); the op's parameters are read from the device
// vector q [NQ] inside the kernel, as the render kernels read par
__global__ void __launch_bounds__(PROBE_THREADS) ulp_param_vector_kernel(
    int op, const float* __restrict__ x, const float* __restrict__ y,
    float* __restrict__ out, int n, const float* __restrict__ q) {
  const int i = blockIdx.x * PROBE_THREADS + threadIdx.x;
  if (i >= n) return;
  out[i] = probe_op(op, x[i], y[i], [&](int k) { return q[k]; });
}

}  // namespace

// C interface, loaded with ctypes (gendr_tpu_torch/_build.py).  Each
// launches on `stream` and returns the launch's error (0 on success);
// neither synchronizes nor allocates.  x, y and out hold n floats.
extern "C" int gendr_ulp_elementwise(int op, const float* x, const float* y,
                                     float* out, int n, float q0, float q1,
                                     float q2, float q3, float q4, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (op < 0 || op >= NUM_OPS || n < 1) return (int)cudaErrorInvalidValue;
  const Params q{{q0, q1, q2, q3, q4}};
  ulp_elementwise_kernel<<<(n + PROBE_THREADS - 1) / PROBE_THREADS,
                           PROBE_THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(op, x, y, out,
                                                                n, q);
  return (int)cudaGetLastError();
}

extern "C" int gendr_ulp_param_vector(int op, const float* x, const float* y,
                                      float* out, int n, const float* q,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (op < 0 || op >= NUM_OPS || n < 1) return (int)cudaErrorInvalidValue;
  ulp_param_vector_kernel<<<(n + PROBE_THREADS - 1) / PROBE_THREADS,
                            PROBE_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(op, x, y, out,
                                                                 n, q);
  return (int)cudaGetLastError();
}

extern "C" const char* gendr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Per-(pixel, face) pair math shared by the forward and backward kernels.
//
// Device counterpart of raster/pairmath.py and ops/distributions.py: the
// packed-row layout, the parameter-vector slots, the 18 CDFs and their
// PDFs, the nine t-conorms' fold and aggregate-inverse gradient
// (ops/tconorms.py), and the barycentric / distance algebra.  Both kernels compile this
// one copy with the same flags (gendr_tpu_torch/_build.py, no multiply-add
// contraction), so the coverage the backward recomputes equals the
// forward's bitwise: the max t-conorm's gradient finds its winner by exact
// float equality with the forward's alpha (cu:574-575).
//
// A face's packed rows are read through an accessor row(i) (shared memory
// in the forward, registers in the backward); every index is a
// compile-time constant once inlined.  Its texture values come through a
// second accessor tex(i), i counted from R_TEX, whose index is the sampled
// texel's and so known only at run time.

#pragma once

#include <cuda_runtime.h>

namespace gendr {

constexpr int TILE = 16;
constexpr int THREADS = TILE * TILE;

// parameter-vector slots (raster/pairmath.py)
constexpr int P_SCALE = 0, P_SHAPE = 1, P_SHIFT = 2, P_THR = 3, P_TCP = 4,
              P_GAMMA = 6, P_NEAR = 7, P_FAR = 8, P_GINV1 = 9, P_GINV = 10,
              P_MARGIN = 15;
// packed rows (raster/pack.py)
constexpr int R_BBOX = 0, R_INV = 4, R_TV = 13, R_E = 22, R_E2 = 28,
              R_M = 31, R_MM = 37, R_FRONT = 40, R_IZ = 41, R_FVALID = 44,
              R_DZ = 45, R_TEX = 48, NI_BASE = 48;
// what a launch aggregates beside alpha (raster/cuda_backend.py MODE_*)
enum { MODE_ALPHA = 0, MODE_HARD = 1, MODE_SOFTMAX = 2 };
// texture types (config.py)
enum { TEXTURE_SURFACE = 0, TEXTURE_VERTEX = 1 };
// distribution ids (config.py)
enum {
  HEAVISIDE = 0, UNIFORM, CUBIC_HERMITE, WIGNER_SEMICIRCLE, GAUSSIAN, LAPLACE,
  LOGISTIC, GUDERMANNIAN, CAUCHY, RECIPROCAL, GUMBEL_MAX, GUMBEL_MIN,
  EXPONENTIAL, EXPONENTIAL_REV, GAMMA, GAMMA_REV, LEVY, LEVY_REV
};
// alpha aggregation ids (config.py)
enum {
  ALPHA_HARD = 0, MAX_TCN = 1, PROBABILISTIC_TCN = 2, EINSTEIN_TCN = 3,
  HAMACHER_TCN = 4, FRANK_TCN = 5, YAGER_TCN = 6, ACZEL_ALSINA_TCN = 7,
  DOMBI_TCN = 8, SCHWEIZER_SKLAR_TCN = 9
};
// the render kernels' template value for the six parametric families
// (hamacher .. schweizer_sklar), which they tell apart at run time; not an
// id of config.py
constexpr int ALPHA_PARAMETRIC = 10;

constexpr float NEG_INF = -1e30f;
constexpr float BIG_DEPTH = 10000000.0f;
constexpr int NUM_STEPS_GAMMA = 32;
constexpr float GAMMA_THRESHOLD = 15.0f;
constexpr float PI_F = 3.14159265358979323846f;
constexpr float SQRT2_F = 1.41421356237309504880f;

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// exp with clipped input, as ops/distributions.py:_safe_exp
__device__ __forceinline__ float safe_exp(float x) {
  return expf(clampf(x, -87.0f, 87.0f));
}

// NDC centre of pixel (prow, pcol); the y axis is flipped (cu:712-719)
__device__ __forceinline__ float pixel_x(int pcol, int is) {
  const float fis = (float)is;
  return (2.0f * (float)pcol + 1.0f - fis) / fis;
}
__device__ __forceinline__ float pixel_y(int prow, int is) {
  const float fis = (float)is;
  return (2.0f * (float)(is - 1 - prow) + 1.0f - fis) / fis;
}

// ops/distributions.py:cdf, branch by branch (reference cu:242-363)
__device__ inline float cdf(int dist, float sign, float x, float scale,
                            float shape, float shift, float ginv1) {
  const float u = sign * x / scale;
  switch (dist) {
    case HEAVISIDE:
      return sign > 0.0f ? 1.0f : 0.0f;
    case LOGISTIC:
      return 1.0f / (1.0f + safe_exp(-u));
    case CAUCHY:
      return atanf(u) / PI_F + 0.5f;
    case RECIPROCAL:
      return 0.5f * sign * x / (scale + x) + 0.5f;
    case LAPLACE: {
      const float e = 0.5f * safe_exp(-x / scale);
      return sign < 0.0f ? e : 1.0f - e;
    }
    case UNIFORM:
      return clampf(0.5f * u + 0.5f, 0.0f, 1.0f);
    case GUDERMANNIAN:
      return atanf(tanhf(u / 2.0f)) * 2.0f / PI_F + 0.5f;
    case CUBIC_HERMITE: {
      const float y = clampf(0.5f * u + 0.5f, 0.0f, 1.0f);
      return 3.0f * y * y - 2.0f * y * y * y;
    }
    case GAUSSIAN:
      return 0.5f * erfcf(-u / SQRT2_F);
    case WIGNER_SEMICIRCLE: {
      if (u < -1.0f) return 0.0f;
      if (!(u < 1.0f)) return 1.0f;
      const float sq = sqrtf(fmaxf(scale * scale - x * x, 0.0f));
      return 0.5f + (sign * x * sq) / (PI_F * scale * scale) +
             asinf(clampf(u, -1.0f, 1.0f)) / PI_F;
    }
    case GUMBEL_MAX:
      return safe_exp(-safe_exp(-u));
    case GUMBEL_MIN:
      return 1.0f - safe_exp(-safe_exp(u));
    case LEVY:
    case LEVY_REV: {
      const float xs = dist == LEVY ? sign * x + shift * scale
                                    : -(sign * x - shift * scale);
      if (xs <= 1e-6f) return dist == LEVY ? 0.0f : 1.0f;
      const float y = erfcf(sqrtf(scale / 2.0f / xs));
      return dist == LEVY ? y : 1.0f - y;
    }
    case EXPONENTIAL:
    case EXPONENTIAL_REV: {
      const float xs = dist == EXPONENTIAL ? sign * x + shift * scale
                                           : -(sign * x - shift * scale);
      if (xs < 0.0f) return dist == EXPONENTIAL ? 0.0f : 1.0f;
      const float y = 1.0f - safe_exp(-xs / scale);
      return dist == EXPONENTIAL ? y : 1.0f - y;
    }
    case GAMMA:
    case GAMMA_REV: {
      // regularized lower incomplete gamma, 32-term Kummer series
      // (reference cu:295-318); ginv1 = 1/Gamma(shape+1) from the wrapper
      const float xs = dist == GAMMA ? sign * x + shift * scale
                                     : -(sign * x - shift * scale);
      float y;
      if (xs <= 0.0f) {
        y = 0.0f;
      } else {
        const float z = fmaxf(xs, 1e-30f) / scale;
        if (z > GAMMA_THRESHOLD) {
          y = 1.0f;
        } else {
          float kummers = ginv1, factor = ginv1;
          for (int i = 1; i < NUM_STEPS_GAMMA; ++i) {
            factor = factor * z / (shape + (float)i);
            kummers = kummers + factor;
          }
          y = powf(z, shape) * safe_exp(-z) * kummers;
        }
      }
      return dist == GAMMA ? y : 1.0f - y;
    }
  }
  return 0.0f;
}

// ops/distributions.py:pdf, the derivative of cdf w.r.t. sign*x, branch by
// branch with the reference's asymmetries (cu:366-459); ginv = 1/Gamma(shape)
__device__ inline float pdf(int dist, float sign, float x, float scale,
                            float shape, float shift, float ginv) {
  const float u = sign * x / scale;
  switch (dist) {
    case HEAVISIDE:
      return 0.0f;
    case LOGISTIC: {
      const float y = 1.0f / (1.0f + safe_exp(-u));
      return y * (1.0f - y) / scale;
    }
    case CAUCHY:
      return 1.0f / (PI_F * scale + PI_F / scale * x * x);
    case RECIPROCAL:
      return scale / (2.0f * (scale + x) * (scale + x));
    case LAPLACE:
      return 0.5f / scale * safe_exp(-x / scale);
    case UNIFORM:
      return (u > -1.0f && u < 1.0f) ? 0.5f / scale : 0.0f;
    case GUDERMANNIAN: {
      const float eu = safe_exp(u);
      return 2.0f / (eu + 1.0f / eu) / PI_F / scale;
    }
    case CUBIC_HERMITE:
      return (u >= -1.0f && u <= 1.0f)
                 ? 0.75f / scale - 0.75f * x * x / (scale * scale * scale)
                 : 0.0f;
    case GAUSSIAN:
      return 1.0f / scale / sqrtf(2.0f * PI_F) * safe_exp(-0.5f * u * u);
    case WIGNER_SEMICIRCLE: {
      // zero only for x/scale > 1 (cu:425-427: no sign)
      const float sq = sqrtf(fmaxf(scale * scale - x * x, 0.0f));
      return x / scale > 1.0f ? 0.0f : 2.0f / PI_F / (scale * scale) * sq;
    }
    case GUMBEL_MAX:
      return safe_exp(-(u + safe_exp(-u))) / scale;
    case GUMBEL_MIN:
      return safe_exp(-(-u + safe_exp(u))) / scale;
    case GAMMA:
    case GAMMA_REV: {
      // log space in float32 (the reference's double branch, cu:412-423)
      const float xs = dist == GAMMA ? sign * x + shift * scale
                                     : -(sign * x - shift * scale);
      if (xs <= 0.0f) return 0.0f;
      const float xss = fmaxf(xs, 1e-30f);
      const float log_pdf = logf(fmaxf(ginv, 1e-30f)) - shape * logf(scale) +
                            (shape - 1.0f) * logf(xss) - xss / scale;
      return safe_exp(log_pdf);
    }
    case LEVY:
    case LEVY_REV: {
      const float xs = dist == LEVY ? sign * x + shift * scale
                                    : -(sign * x - shift * scale);
      if (xs <= 1e-6f) return 0.0f;
      const float xss = fmaxf(xs, 1e-6f);
      return sqrtf(scale / 2.0f / PI_F) * safe_exp(-scale / 2.0f / xss) /
             powf(xss, 1.5f);
    }
    case EXPONENTIAL:
    case EXPONENTIAL_REV: {
      const float xs = dist == EXPONENTIAL ? sign * x + shift * scale
                                           : -(sign * x - shift * scale);
      if (xs < 0.0f) return 0.0f;
      return 1.0f / scale * safe_exp(-fmaxf(xs, 0.0f) / scale);
    }
  }
  return 0.0f;
}

// A t-conorm's parameter p with what depends on p alone, computed once per
// thread outside the pair loop: log p (frank), 1 / p, p - 1, 1 - p and
// (1 - p) / p, each rounded as ops/tconorms.py rounds it
struct TcnParam {
  float p, lnp, inv_p, pm1, omp, omp_over_p;
};
__device__ __forceinline__ TcnParam tcn_param(float p) {
  TcnParam t;
  t.p = p;
  t.lnp = logf(p);
  t.inv_p = 1.0f / p;
  t.pm1 = p - 1.0f;
  t.omp = 1.0f - p;
  t.omp_over_p = t.omp / p;
  return t;
}

// ops/tconorms.py:fold_step for the six parametric families, guard by
// guard (reference cu:491-563).  a _|_ 0 = a and 0 _|_ b = b exactly
// (_zero_identity): the arithmetic below reproduces the neutral element
// only up to rounding, and a pixel's first admitted pair folds into
// acc == 0.  The early returns also keep powf(0, p) and logf(0) of that
// first pair out of the result.  frank's p^(1-a) - 1 is expm1f((1-a) log p),
// never powf(p, 1-a) - 1, which cancels at the a -> 1 saturation edge.
__device__ inline float parametric_fold(int tid, float a, float b,
                                        const TcnParam& t) {
  if (b == 0.0f) return a;
  if (a == 0.0f) return b;
  const float p = t.p;
  switch (tid) {
    case HAMACHER_TCN: {  // p >= 0
      const float an = 1.0f - a, bn = 1.0f - b;
      const float c =
          (an * bn) / fmaxf(p + t.omp * (an + bn - an * bn), 1e-6f);
      return 1.0f - c;
    }
    case FRANK_TCN: {  // p > 0, p != 1
      const float ea = expm1f((1.0f - a) * t.lnp);
      const float eb = expm1f((1.0f - b) * t.lnp);
      const float c = log1pf(ea * eb / t.pm1) / t.lnp;
      return 1.0f - c;
    }
    case YAGER_TCN: {  // p > 0
      const float c =
          fmaxf(1.0f - powf(powf(a, p) + powf(b, p), t.inv_p), 0.0f);
      return 1.0f - c;
    }
    case ACZEL_ALSINA_TCN: {  // p > 0
      const float an = 1.0f - a, bn = 1.0f - b;
      // 1 - a < 1e-8 (or 1 - b): the result saturates to 1 (cu:528-529)
      if (an < 1e-8f || bn < 1e-8f) return 1.0f;
      const float la = -logf(fmaxf(an, 1e-30f));
      const float lb = -logf(fmaxf(bn, 1e-30f));
      const float c = expf(-powf(powf(la, p) + powf(lb, p), t.inv_p));
      return 1.0f - c;
    }
    case DOMBI_TCN: {  // p > 0
      const float an = 1.0f - a, bn = 1.0f - b;
      if (an < 1e-8f || bn < 1e-8f) return 1.0f;
      const float an_s = fmaxf(an, 1e-30f), bn_s = fmaxf(bn, 1e-30f);
      const float c =
          1.0f / (1.0f + powf(powf((1.0f - an_s) / an_s, p) +
                                  powf((1.0f - bn_s) / bn_s, p),
                              t.inv_p));
      return 1.0f - c;
    }
    case SCHWEIZER_SKLAR_TCN: {  // p < 0
      const float an = fmaxf(1.0f - a, 1e-30f);
      const float bn = fmaxf(1.0f - b, 1e-30f);
      const float c = powf(powf(an, p) + powf(bn, p) - 1.0f, t.inv_p);
      return 1.0f - c;
    }
  }
  return 0.0f;
}

// ops/tconorms.py:fold_step, a _|_ b for any of the nine t-conorms
__device__ inline float fold_step(int tid, float a, float b, float p) {
  switch (tid) {
    case MAX_TCN: return fmaxf(a, b);
    case PROBABILISTIC_TCN: return a + b - a * b;
    case EINSTEIN_TCN: return (a + b) / (1.0f + a * b);
  }
  return parametric_fold(tid, a, b, tcn_param(p));
}

// ops/tconorms.py:aggregate_backward for the six parametric families:
// dA/db rebuilt from the total aggregate a_all and b alone, with every
// guard of the reference (cu:577-614)
__device__ inline float parametric_aggregate_backward(int tid, float a_all,
                                                      float b,
                                                      const TcnParam& t) {
  const float p = t.p;
  switch (tid) {
    case HAMACHER_TCN: {
      const float num =
          (1.0f - a_all) * (-a_all - p * (1.0f - a_all) + p + 1.0f);
      const float den = (1.0f - b) * (-b - p * (1.0f - b) + p + 1.0f);
      return num / fmaxf(den, 1e-6f);
    }
    case FRANK_TCN: {
      const float d = expm1f((1.0f - b) * t.lnp);
      const float d_guard = d + (d >= 0.0f ? 1e-6f : -1e-6f);  // copysign
      return expf((a_all - b) * t.lnp) * expm1f((1.0f - a_all) * t.lnp) /
             d_guard;
    }
    case YAGER_TCN: {
      if (a_all == 1.0f) return 0.0f;
      return powf(fmaxf(b, 1e-30f), t.pm1) * powf(fmaxf(a_all, 1e-30f), t.omp);
    }
    case ACZEL_ALSINA_TCN: {
      const float lo = (float)(-1.0 + 1e-6);
      const float log_b = -log1pf(fmaxf(-b, lo));
      const float log_a = -log1pf(fmaxf(-a_all, lo));
      return (1.0f - a_all) * powf(fmaxf(log_b, 1e-30f), t.pm1) *
             powf(fmaxf(log_a, 1e-30f), t.omp) / fmaxf(1.0f - b, 1e-6f);
    }
    case DOMBI_TCN: {
      const float bn = fmaxf(1.0f - b, 1e-6f);
      const float an = fmaxf(1.0f - a_all, 1e-6f);
      return (1.0f - a_all) * (1.0f - a_all) *
             powf(fmaxf(b, 1e-30f) / bn, t.pm1) *
             powf(fmaxf(a_all, 1e-30f) / an, t.omp) / bn / bn;
    }
    case SCHWEIZER_SKLAR_TCN: {
      const float an = fmaxf(1.0f - a_all, 1e-6f);
      const float bn = fmaxf(1.0f - b, 1e-6f);
      const float bp = powf(bn, p), ap = powf(an, p);
      const float inner = powf(powf(-bp + ap + 1.0f, t.inv_p), p);
      return powf(bn, t.pm1) * powf(bp + inner - 1.0f, t.omp_over_p);
    }
  }
  return 0.0f;
}

// ops/tconorms.py:aggregate_backward for any of the nine t-conorms
__device__ inline float aggregate_backward(int tid, float a_all, float b,
                                           float p) {
  switch (tid) {
    case MAX_TCN: return a_all == b ? 1.0f : 0.0f;
    case PROBABILISTIC_TCN: return (1.0f - a_all) / fmaxf(1.0f - b, 1e-6f);
    case EINSTEIN_TCN:
      return (1.0f - a_all * a_all) / fmaxf(1.0f - b * b, 1e-6f);
  }
  return parametric_aggregate_backward(tid, a_all, b, tcn_param(p));
}

// bbox gate (pairmath.py P_MARGIN): outside it a pair's true coverage is
// below the probability cull, and a sliver face's fp32 barycentrics are
// not evaluated at all.  It is a rectangle: a test on x and one on y
template <class Row>
__device__ __forceinline__ bool gate_x(const Row& row, float xp,
                                       float margin) {
  return xp >= row(R_BBOX + 0) - margin && xp <= row(R_BBOX + 1) + margin;
}

template <class Row>
__device__ __forceinline__ bool gate_y(const Row& row, float yp,
                                       float margin) {
  return yp >= row(R_BBOX + 2) - margin && yp <= row(R_BBOX + 3) + margin;
}

template <class Row>
__device__ __forceinline__ bool in_gate(const Row& row, float xp, float yp,
                                        float margin) {
  return gate_x(row, xp, margin) && gate_y(row, yp, margin);
}

// an affine per-face value a*x + b*y + c (pack.py)
template <class Row>
__device__ __forceinline__ float affine(const Row& row, int r, float xp,
                                        float yp) {
  return row(r) * xp + row(r + 1) * yp + row(r + 2);
}

// edge k's parameter tv, its clamp offset dd, and the unclamped (u2) and
// clamped (c2) squared distances to it (pack.py identities); wj is the
// barycentric of the vertex opposite edge k
struct Edge {
  float tv, dd, u2, c2;
};
template <class Row>
__device__ __forceinline__ Edge edge_terms(const Row& row, int k, float wj,
                                           float xp, float yp) {
  Edge e;
  e.tv = affine(row, R_TV + 3 * k, xp, yp);
  e.dd = clampf(e.tv, 0.0f, 1.0f) - e.tv;
  e.u2 = wj * wj * row(R_MM + k);
  e.c2 = e.u2 + e.dd * e.dd * row(R_E2 + k);
  return e;
}

// the forward's squared distance: the min over the three edges of the
// unclamped (inside) or clamped (outside) distance
template <class Row>
__device__ __forceinline__ float dis2_min(const Row& row, const float w[3],
                                          bool inside, float xp, float yp) {
  float d2u_min = 0.0f, d2c_min = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const Edge e = edge_terms(row, k, w[(k + 2) % 3], xp, yp);
    d2u_min = k == 0 ? e.u2 : fminf(d2u_min, e.u2);
    d2c_min = k == 0 ? e.c2 : fminf(d2c_min, e.c2);
  }
  return inside ? d2u_min : d2c_min;
}

// the backward's closest feature (pairmath.py, fwd_only=False): the first
// edge of least distance, its (inside-folded) parameter, the distance
// vector to it, and dis2, the same min as dis2_min
struct Closest {
  int ksel;
  float tv, dis_x, dis_y, dis2;
};
template <class Row>
__device__ __forceinline__ Closest closest_feature(const Row& row,
                                                   const float w[3],
                                                   bool inside, float xp,
                                                   float yp) {
  float tvs[3], dds[3], d2[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const Edge e = edge_terms(row, k, w[(k + 2) % 3], xp, yp);
    tvs[k] = inside ? e.tv : clampf(e.tv, 0.0f, 1.0f);
    dds[k] = e.dd;
    d2[k] = inside ? e.u2 : e.c2;
  }
  Closest c;
  const bool sel0 = d2[0] <= d2[1] && d2[0] <= d2[2];
  const bool sel1 = !sel0 && d2[1] <= d2[2];
  c.ksel = sel0 ? 0 : (sel1 ? 1 : 2);
  // the vertex opposite edge k is (k + 2) % 3
  float wj, mx, my, ex, ey, dd;
  if (c.ksel == 0) {
    wj = w[2]; mx = row(R_M + 0); my = row(R_M + 1);
    ex = row(R_E + 0); ey = row(R_E + 1); dd = dds[0]; c.tv = tvs[0];
  } else if (c.ksel == 1) {
    wj = w[0]; mx = row(R_M + 2); my = row(R_M + 3);
    ex = row(R_E + 2); ey = row(R_E + 3); dd = dds[1]; c.tv = tvs[1];
  } else {
    wj = w[1]; mx = row(R_M + 4); my = row(R_M + 5);
    ex = row(R_E + 4); ey = row(R_E + 5); dd = dds[2]; c.tv = tvs[2];
  }
  const float out_dd = inside ? 0.0f : dd;
  c.dis_x = wj * mx + out_dd * ex;
  c.dis_y = wj * my + out_dd * ey;
  c.dis2 = fminf(fminf(d2[0], d2[1]), d2[2]);
  return c;
}

// the softmax colour path's depth (pairmath.py need_depth, cu:807-810): the
// clipped barycentrics, their sum s, zp = s / (wc . iz) on [near, far], and
// the normalised barycentrics wcn that blend and index the texture
struct SoftDepth {
  float zp;
  bool zvalid;
  float wcn[3];
};
template <class Row>
__device__ __forceinline__ SoftDepth softmax_depth(const Row& row,
                                                   const float w[3],
                                                   float znear, float zfar) {
  const float wc0 = clampf(w[0], 0.0f, 1.0f);
  const float wc1 = clampf(w[1], 0.0f, 1.0f);
  const float wc2 = clampf(w[2], 0.0f, 1.0f);
  const float s = fmaxf(wc0 + wc1 + wc2, 1e-5f);
  const float denom =
      wc0 * row(R_IZ + 0) + wc1 * row(R_IZ + 1) + wc2 * row(R_IZ + 2);
  SoftDepth d;
  d.zp = s / denom;
  d.zvalid = d.zp >= znear && d.zp <= zfar;
  d.wcn[0] = wc0 / s;
  d.wcn[1] = wc1 / s;
  d.wcn[2] = wc2 / s;
  return d;
}

// the texel of an R x R folded-triangle grid a pair samples
// (raster/geometry.py:surface_texel_index, cu:178-185), clamped to the grid;
// beyond the edge opposite vertex 2 (w2 clipped to 0) the fold's test reads
// exactly 1: the lower triangle
__device__ __forceinline__ int surface_texel_index(float w0, float w1,
                                                   float w2, int R) {
  const float fr = (float)R;
  const int wx = (int)floorf(w0 * fr);
  const int wy = (int)floorf(w1 * fr);
  const bool lower =
      w2 == 0.0f || (w0 + w1) * fr - (float)wx - (float)wy <= 1.0f;
  const int idx = lower ? wy * R + wx : (R - 1 - wy) * R + (R - 1 - wx);
  return min(max(idx, 0), R * R - 1);
}

// a pair's colour (forward_sample_texture, cu:175-191) from its face's
// texture values tex(i), i the texture row past R_TEX: the vertex blend of
// the three vertex colours by wcn, or the RGB of the surface texel wcn
// selects (R = 1: the one texel).  On the TPU this was a one-hot sum over
// every texel row (Mosaic has no per-lane gather); here it is a gather.
template <class Tex>
__device__ __forceinline__ void sample_color(const Tex& tex, int texture_type,
                                             int R, const float wcn[3],
                                             float col[3]) {
  if (texture_type == TEXTURE_VERTEX) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      col[c] = wcn[0] * tex(c) + wcn[1] * tex(3 + c) + wcn[2] * tex(6 + c);
  } else {
    const int t = R == 1 ? 0 : surface_texel_index(wcn[0], wcn[1], wcn[2], R);
#pragma unroll
    for (int c = 0; c < 3; ++c) col[c] = tex(3 * t + c);
  }
}

}  // namespace gendr

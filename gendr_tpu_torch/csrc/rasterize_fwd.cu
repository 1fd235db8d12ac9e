// Forward rasterization kernel for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel gendr_tpu/raster/pallas_backend.py:_fwd_kernel
// (the sub-kernel ROADMAP.md calls K1a): channels 'alpha' and 'rgba' with
// hard RGB over one-texel surface textures, the alpha families hard, max,
// probabilistic and einstein, and any of the 18 CDFs as a runtime id.
//
// What bounds it on the card: per-pair ALU work.  At the flagship size
// (256x256 pixels, 1280 faces, 56 packed rows) it reads about 0.3 MB of
// packed face rows and writes about 1.5 MB (6 channels x 65536 pixels x
// 4 B); between the two, every (pixel, face) pair it visits costs some 60
// flops of barycentric, distance and CDF arithmetic.
//
// What the design does about it: the hit-list cull.  The prepass sorts the
// faces along a Morton curve (so a chunk of FC faces is spatially tight)
// and lists, for each 16x16 pixel tile, the chunks whose bbox + cull margin
// overlaps it.  One block owns one tile (one thread per pixel) and walks
// only that list; a thread then skips each pair outside the face's bbox +
// probability margin before any distance algebra.  Everything a pixel
// aggregates stays in its thread's registers; each chunk's rows are staged
// once in shared memory and read by all 256 threads as broadcasts.
//
// Semantics follow raster/pairmath.py (forward branch) and
// raster/torch_backend.py; raster/cuda_backend.py:rasterize_fwd_plain is
// the same function in plain PyTorch.  Hard-RGB ties on the depth key go to
// the smaller INPUT face id (the perm row), so winners match the plain
// streaming backend, which walks faces in input order.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int THREADS = TILE * TILE;

// parameter-vector slots (raster/pairmath.py)
constexpr int P_SCALE = 0, P_SHAPE = 1, P_SHIFT = 2, P_THR = 3, P_NEAR = 7,
              P_FAR = 8, P_GINV1 = 9, P_MARGIN = 15;
// packed rows (raster/pack.py)
constexpr int R_BBOX = 0, R_INV = 4, R_TV = 13, R_E2 = 28, R_MM = 37,
              R_FRONT = 40, R_FVALID = 44, R_DZ = 45, R_TEX = 48;
// distribution ids (config.py)
enum {
  HEAVISIDE = 0, UNIFORM, CUBIC_HERMITE, WIGNER_SEMICIRCLE, GAUSSIAN, LAPLACE,
  LOGISTIC, GUDERMANNIAN, CAUCHY, RECIPROCAL, GUMBEL_MAX, GUMBEL_MIN,
  EXPONENTIAL, EXPONENTIAL_REV, GAMMA, GAMMA_REV, LEVY, LEVY_REV
};
// alpha aggregation ids (config.py)
enum { ALPHA_HARD = 0, MAX_TCN = 1, PROBABILISTIC_TCN = 2, EINSTEIN_TCN = 3 };

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

// ops/distributions.py:cdf, branch by branch (reference cu:242-363)
__device__ float cdf(int dist, float sign, float x, float scale, float shape,
                     float shift, float ginv1) {
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

// One block per 16x16 pixel tile of batch element blockIdx.y; one thread
// per pixel.  ALPHA: the alpha family; HARD_RGB: also run the z-argmax and
// carry the winner's colour (channels 'rgba'), else alpha only.
template <int ALPHA, bool HARD_RGB>
__global__ void __launch_bounds__(THREADS) rasterize_fwd_kernel(
    const int* __restrict__ tile_counts,  // [B, T]
    const int* __restrict__ tile_ids,     // [B, T, kcap]
    int kcap,
    const float* __restrict__ par,        // [16]
    const float* __restrict__ packed,     // [B, NI, Fp]
    const int* __restrict__ perm,         // [B, Fp] input id per sorted slot
    float* __restrict__ out,              // [B, NO, P], NO = 6 or 1
    int NI, int Fp, int FC, int image_size, int tiles_x, int dist_func,
    int dist_squared, int double_side) {
  extern __shared__ float smem[];
  float* rows = smem;                                  // [NI, FC]
  int* ids = reinterpret_cast<int*>(smem + NI * FC);   // [FC]

  const int T = gridDim.x;
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x;
  const int is = image_size;
  const int prow = (t / tiles_x) * TILE + lane / TILE;
  const int pcol = (t % tiles_x) * TILE + lane % TILE;
  const bool in_image = prow < is && pcol < is;
  // NDC pixel centres; the y axis is flipped (reference cu:712-719)
  const float fis = (float)is;
  const float xp = (2.0f * (float)pcol + 1.0f - fis) / fis;
  const float yp = (2.0f * (float)(is - 1 - prow) + 1.0f - fis) / fis;

  const float scale = par[P_SCALE], shape = par[P_SHAPE];
  const float shift = par[P_SHIFT], thr = par[P_THR];
  const float ginv1 = par[P_GINV1], margin = par[P_MARGIN];
  const float inv_far = 1.0f / par[P_FAR], inv_near = 1.0f / par[P_NEAR];

  const int n = tile_counts[b * T + t];
  const int* my_ids = tile_ids + ((size_t)b * T + t) * kcap;
  const float* pk = packed + (size_t)b * NI * Fp;
  const int* pm = perm + (size_t)b * Fp;

  // per-pixel carry: the alpha statistic (product of (1 - frag) for
  // probabilistic, the running fold otherwise) and the hard-RGB winner
  float acc = ALPHA == PROBABILISTIC_TCN ? 1.0f : 0.0f;
  float best = NEG_INF;
  int best_id = -1;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;

  for (int j = 0; j < n; ++j) {
    const int cid = my_ids[j];
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = lane; i < NI * FC; i += THREADS) {
      const int r = i / FC;
      rows[i] = pk[(size_t)r * Fp + (size_t)cid * FC + (i - r * FC)];
    }
    if (HARD_RGB) {
      for (int f = lane; f < FC; f += THREADS) ids[f] = pm[cid * FC + f];
    }
    __syncthreads();
    if (!in_image) continue;

    for (int f = 0; f < FC; ++f) {
#define ROW(i) rows[(i) * FC + f]
      // bbox gate (pairmath.py P_MARGIN): a culled pair contributes the
      // identity to every fold, so skipping it is exact
      if (!(xp >= ROW(R_BBOX + 0) - margin && xp <= ROW(R_BBOX + 1) + margin &&
            yp >= ROW(R_BBOX + 2) - margin && yp <= ROW(R_BBOX + 3) + margin))
        continue;
      if (!(ROW(R_FVALID) > 0.0f)) continue;
      const float w0 = ROW(R_INV + 0) * xp + ROW(R_INV + 1) * yp + ROW(R_INV + 2);
      const float w1 = ROW(R_INV + 3) * xp + ROW(R_INV + 4) * yp + ROW(R_INV + 5);
      const float w2 = ROW(R_INV + 6) * xp + ROW(R_INV + 7) * yp + ROW(R_INV + 8);
      const float wmin = fminf(fminf(w0, w1), w2);
      const bool inside = wmin > 0.0f;
      const bool in_loose = wmin >= 0.0f;

      float frag;
      if (dist_func == HEAVISIDE) {
        frag = in_loose ? 1.0f : 0.0f;
      } else {
        // min over the three clamped edge distances (pairmath.py)
        const float ws[3] = {w0, w1, w2};
        float d2u_min = 0.0f, d2c_min = 0.0f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float tv = ROW(R_TV + 3 * k) * xp + ROW(R_TV + 3 * k + 1) * yp +
                           ROW(R_TV + 3 * k + 2);
          const float wj = ws[(k + 2) % 3];
          const float d2u = wj * wj * ROW(R_MM + k);
          const float dd = clampf(tv, 0.0f, 1.0f) - tv;
          const float d2c = d2u + dd * dd * ROW(R_E2 + k);
          d2u_min = k == 0 ? d2u : fminf(d2u_min, d2u);
          d2c_min = k == 0 ? d2c : fminf(d2c_min, d2c);
        }
        const float dis2 = inside ? d2u_min : d2c_min;
        if (!inside && dis2 >= thr) continue;  // distance cull (cu:769)
        const float dis =
            dist_squared ? dis2 : dis2 * rsqrtf(fmaxf(dis2, 1e-30f));
        frag = cdf(dist_func, inside ? 1.0f : -1.0f, dis, scale, shape, shift,
                   ginv1);
      }
      if (!(frag > 1e-6f)) continue;  // probability cull (cu:784)

      // alpha fold (cu:791-801)
      if (ALPHA == ALPHA_HARD) {
        if (frag > 0.5f) acc = 1.0f;
      } else if (ALPHA == MAX_TCN) {
        acc = fmaxf(acc, frag);
      } else if (ALPHA == PROBABILISTIC_TCN) {
        acc = acc * (1.0f - frag);
      } else {
        acc = (acc + frag) / (1.0f + acc * frag);
      }

      if (HARD_RGB) {
        // z-argmin as an argmax of the affine denom = 1/zp (cu:815-822)
        const float denom =
            ROW(R_DZ + 0) * xp + ROW(R_DZ + 1) * yp + ROW(R_DZ + 2);
        const bool zvalid = denom >= inv_far && denom <= inv_near;
        const bool front_ok = double_side || ROW(R_FRONT) > 0.0f;
        if (in_loose && zvalid && front_ok) {
          const int oid = ids[f];
          if (denom > best || (denom == best && oid < best_id)) {
            best = denom;
            best_id = oid;
            cr = ROW(R_TEX + 0);
            cg = ROW(R_TEX + 1);
            cb = ROW(R_TEX + 2);
          }
        }
      }
#undef ROW
    }
  }

  if (!in_image) return;
  const size_t P = (size_t)is * is;
  const size_t NO = HARD_RGB ? 6 : 1;
  float* o = out + (size_t)b * NO * P + (size_t)prow * is + pcol;
  o[0] = ALPHA == PROBABILISTIC_TCN ? 1.0f - acc : acc;
  if (HARD_RGB) {
    const bool any = best > NEG_INF;
    o[P] = any ? 1.0f / best : BIG_DEPTH;
    o[2 * P] = any ? (float)best_id : -1.0f;
    o[3 * P] = cr;
    o[4 * P] = cg;
    o[5 * P] = cb;
  }
}

template <int ALPHA, bool HARD_RGB>
void launch(dim3 grid, size_t smem, cudaStream_t stream,
            const int* tile_counts, const int* tile_ids, int kcap,
            const float* par, const float* packed, const int* perm,
            float* out, int NI, int Fp, int FC, int image_size, int tiles_x,
            int dist_func, int dist_squared, int double_side) {
  rasterize_fwd_kernel<ALPHA, HARD_RGB><<<grid, THREADS, smem, stream>>>(
      tile_counts, tile_ids, kcap, par, packed, perm, out, NI, Fp, FC,
      image_size, tiles_x, dist_func, dist_squared, double_side);
}

template <bool HARD_RGB>
bool launch_family(int alpha_func, dim3 grid, size_t smem,
                   cudaStream_t stream, const int* tile_counts,
                   const int* tile_ids, int kcap, const float* par,
                   const float* packed, const int* perm, float* out, int NI,
                   int Fp, int FC, int image_size, int tiles_x, int dist_func,
                   int dist_squared, int double_side) {
#define GENDR_LAUNCH(A)                                                      \
  launch<A, HARD_RGB>(grid, smem, stream, tile_counts, tile_ids, kcap, par, \
                      packed, perm, out, NI, Fp, FC, image_size, tiles_x,   \
                      dist_func, dist_squared, double_side)
  switch (alpha_func) {
    case ALPHA_HARD: GENDR_LAUNCH(ALPHA_HARD); return true;
    case MAX_TCN: GENDR_LAUNCH(MAX_TCN); return true;
    case PROBABILISTIC_TCN: GENDR_LAUNCH(PROBABILISTIC_TCN); return true;
    case EINSTEIN_TCN: GENDR_LAUNCH(EINSTEIN_TCN); return true;
  }
#undef GENDR_LAUNCH
  return false;
}

}  // namespace

// C interface, loaded with ctypes (gendr_tpu_torch/_build.py).  Launches on
// `stream` and returns cudaGetLastError() (0 on success); never
// synchronizes and allocates nothing.
extern "C" int gendr_rasterize_fwd(
    const int* tile_counts, const int* tile_ids, int kcap, const float* par,
    const float* packed, const int* perm, float* out, int B, int NI, int Fp,
    int FC, int image_size, int dist_func, int dist_squared, int alpha_func,
    int hard_rgb, int double_side, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (image_size + TILE - 1) / TILE;
  const dim3 grid(tiles_x * tiles_x, B);
  const size_t smem = (size_t)NI * FC * sizeof(float) + FC * sizeof(int);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok =
      hard_rgb
          ? launch_family<true>(alpha_func, grid, smem, s, tile_counts,
                                tile_ids, kcap, par, packed, perm, out, NI,
                                Fp, FC, image_size, tiles_x, dist_func,
                                dist_squared, double_side)
          : launch_family<false>(alpha_func, grid, smem, s, tile_counts,
                                 tile_ids, kcap, par, packed, perm, out, NI,
                                 Fp, FC, image_size, tiles_x, dist_func,
                                 dist_squared, double_side);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* gendr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

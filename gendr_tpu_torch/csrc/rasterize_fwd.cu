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
// the same function in plain PyTorch.  The pair math is csrc/pairmath.cuh,
// shared with the backward kernel.  Hard-RGB ties on the depth key go to
// the smaller INPUT face id (the perm row), so winners match the plain
// streaming backend, which walks faces in input order.

#include <cuda_runtime.h>

#include "pairmath.cuh"

namespace {

using namespace gendr;

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
  const float xp = pixel_x(pcol, is);
  const float yp = pixel_y(prow, is);

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
      const auto row = [&](int i) { return rows[i * FC + f]; };
      // a pair outside the gate contributes the identity to every fold, so
      // skipping it is exact
      if (!in_gate(row, xp, yp, margin)) continue;
      if (!(row(R_FVALID) > 0.0f)) continue;
      const float w[3] = {affine(row, R_INV + 0, xp, yp),
                          affine(row, R_INV + 3, xp, yp),
                          affine(row, R_INV + 6, xp, yp)};
      const float wmin = fminf(fminf(w[0], w[1]), w[2]);
      const bool inside = wmin > 0.0f;
      const bool in_loose = wmin >= 0.0f;

      float frag;
      if (dist_func == HEAVISIDE) {
        frag = in_loose ? 1.0f : 0.0f;
      } else {
        const float dis2 = dis2_min(row, w, inside, xp, yp);
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
        const float denom = affine(row, R_DZ, xp, yp);
        const bool zvalid = denom >= inv_far && denom <= inv_near;
        const bool front_ok = double_side || row(R_FRONT) > 0.0f;
        if (in_loose && zvalid && front_ok) {
          const int oid = ids[f];
          if (denom > best || (denom == best && oid < best_id)) {
            best = denom;
            best_id = oid;
            cr = row(R_TEX + 0);
            cg = row(R_TEX + 1);
            cb = row(R_TEX + 2);
          }
        }
      }
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

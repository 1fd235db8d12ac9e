// Backward rasterization kernel for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel gendr_tpu/raster/pallas_backend.py:_bwd_kernel
// (the sub-kernel ROADMAP.md calls K2a): the gradient of the K1a envelope,
// channels 'alpha' and 'rgba' with hard RGB over one-texel surface
// textures, the alpha families hard, max, probabilistic and einstein, any
// of the 18 CDFs as a runtime id, and dist_squared either way.
//
// What it computes, per (pixel, face) pair: the recomputed coverage, the
// aggregate-inverse alpha rule (pallas_backend.py:1282-1288; hard alpha
// passes the incoming gradient through unmultiplied, cu:975-976), for hard
// RGB the texel gradient of the pixel's winning face
// (pallas_backend.py:1292-1302), the PDF chain and the closest-point
// weights (pallas_backend.py:1328-1351), and coef = 2 sign c when
// dist_squared, else sign c rdis.  Each face sums its pairs into 6 vertex
// xy gradients, plus 3 texel gradients for hard RGB.
//
// What bounds it on the card: per-pair ALU work and how few blocks there
// are.  The input is small (the chunk's packed rows, 2 or 6 pixel columns
// of 4 bytes per pixel); every pair the bbox gate admits costs some 100
// flops of pair math, CDF and PDF.  One block per (batch, face chunk)
// gives B * K blocks, 10 at the flagship (1280 faces, B=1): the card's 132
// SMs are mostly idle there.  That is the price of the design below and is
// left for a later redesign.
//
// What the design does: one block per (batch element, face chunk), one
// thread per face of the chunk, holding its face's packed rows and its
// gradient sums in registers.  The block walks the chunk's hit-tile list;
// for each tile it stages the tile's 256 pixel columns in shared memory
// (at most 6 KB) and every thread walks them in a fixed order.  A thread
// skips a whole tile whose rectangle misses its face's bbox + P_MARGIN,
// and any pair outside that gate.  No atomics: each sum has one owner and
// a fixed order, so the same inputs give bitwise-equal gradients.
//
// Semantics follow raster/pairmath.py (closest-feature branch) and
// raster/torch_backend.py:backward; raster/cuda_backend.py:
// rasterize_bwd_plain is the same function in plain PyTorch.  Hard-RGB
// winners are INPUT face ids (the forward kernel reports them so), so a
// face compares the winner with perm[b, k * FC + f], its input id.

#include <cuda_runtime.h>

#include "pairmath.cuh"

namespace {

using namespace gendr;

constexpr int MAX_FC = 256;  // threads per block: one per face of a chunk
// pixel columns (raster/cuda_backend.py PIX_*): alpha gradient, final
// alpha, then for hard RGB the colour gradient and the winner's input id
constexpr int PIX_GA = 0, PIX_FA = 1, PIX_GR = 2, PIX_WID = 5;

// One block per face chunk blockIdx.x of batch element blockIdx.y; one
// thread per face.  ALPHA: the alpha family; HARD_RGB: also the winner-
// masked texel gradient (channels 'rgba').  out rows: x0 y0 x1 y1 x2 y2
// (+ r g b for HARD_RGB), one column per sorted face.
template <int ALPHA, bool HARD_RGB>
__global__ void __launch_bounds__(MAX_FC) rasterize_bwd_kernel(
    const int* __restrict__ chunk_counts,  // [B, K]
    const int* __restrict__ chunk_ids,     // [B, K, T]
    const float* __restrict__ par,         // [16]
    const float* __restrict__ packed,      // [B, NI, Fp]
    const int* __restrict__ perm,          // [B, Fp] input id per sorted slot
    const float* __restrict__ pix,         // [B, NPIX, P]
    float* __restrict__ out,               // [B, NO, Fp]
    int NI, int Fp, int FC, int image_size, int tiles_x, int dist_func,
    int dist_squared) {
  constexpr int NPIX = HARD_RGB ? 6 : 2;
  constexpr int NO = HARD_RGB ? 9 : 6;
  __shared__ float cols[NPIX * THREADS];  // the tile's pixel columns

  const int K = gridDim.x;
  const int k = blockIdx.x;
  const int b = blockIdx.y;
  const int f = threadIdx.x;
  const int gf = k * FC + f;  // sorted face slot
  const int is = image_size;
  const int T = tiles_x * tiles_x;
  const size_t P = (size_t)is * is;

  const float scale = par[P_SCALE], shape = par[P_SHAPE];
  const float shift = par[P_SHIFT], thr = par[P_THR];
  const float ginv1 = par[P_GINV1], ginv = par[P_GINV];
  const float margin = par[P_MARGIN];
  const float inv_far = 1.0f / par[P_FAR], inv_near = 1.0f / par[P_NEAR];

  // the face's geometry rows, in registers for the whole block
  float fr[NI_BASE];
  const float* pk = packed + (size_t)b * NI * Fp + gf;
#pragma unroll
  for (int r = 0; r < NI_BASE; ++r) fr[r] = pk[(size_t)r * Fp];
  const auto row = [&](int i) { return fr[i]; };
  const bool face_valid = fr[R_FVALID] > 0.0f;
  const int my_id = HARD_RGB ? perm[(size_t)b * Fp + gf] : -1;

  float acc[NO];
#pragma unroll
  for (int c = 0; c < NO; ++c) acc[c] = 0.0f;

  const int n = chunk_counts[b * K + k];
  const int* my_tiles = chunk_ids + ((size_t)b * K + k) * T;
  const float* px = pix + (size_t)b * NPIX * P;

  for (int j = 0; j < n; ++j) {
    const int t = my_tiles[j];
    const int r0 = (t / tiles_x) * TILE;
    const int c0 = (t % tiles_x) * TILE;
    __syncthreads();  // every thread is done with the previous tile
    for (int i = f; i < NPIX * THREADS; i += FC) {
      const int c = i / THREADS, l = i - c * THREADS;
      const int prow = r0 + l / TILE, pcol = c0 + l % TILE;
      cols[i] = (prow < is && pcol < is)
                    ? px[(size_t)c * P + (size_t)prow * is + pcol]
                    : 0.0f;
    }
    __syncthreads();
    if (!face_valid) continue;
    // the tile's pixel-centre rectangle against the gate: a tile that
    // misses it holds no pair the gate admits (the same NDC expressions as
    // the pairs', so the skip is exact)
    if (pixel_x(c0 + TILE - 1, is) < row(R_BBOX + 0) - margin ||
        pixel_x(c0, is) > row(R_BBOX + 1) + margin ||
        pixel_y(r0, is) < row(R_BBOX + 2) - margin ||
        pixel_y(r0 + TILE - 1, is) > row(R_BBOX + 3) + margin)
      continue;

    for (int l = 0; l < THREADS; ++l) {
      const int prow = r0 + l / TILE, pcol = c0 + l % TILE;
      if (prow >= is || pcol >= is) continue;  // ragged edge tile
      const float xp = pixel_x(pcol, is);
      const float yp = pixel_y(prow, is);
      if (!in_gate(row, xp, yp, margin)) continue;
      const float w[3] = {affine(row, R_INV + 0, xp, yp),
                          affine(row, R_INV + 3, xp, yp),
                          affine(row, R_INV + 6, xp, yp)};
      const float wmin = fminf(fminf(w[0], w[1]), w[2]);
      const bool inside = wmin > 0.0f;
      const float sign = inside ? 1.0f : -1.0f;

      float frag, dis = 0.0f, rdis = 0.0f;
      Closest cf{0, 0.0f, 0.0f, 0.0f, 0.0f};
      if (dist_func == HEAVISIDE) {
        frag = wmin >= 0.0f ? 1.0f : 0.0f;
      } else {
        cf = closest_feature(row, w, inside, xp, yp);
        if (!inside && cf.dis2 >= thr) continue;  // distance cull (cu:769)
        if (dist_squared) {
          dis = cf.dis2;
        } else {
          const float r = rsqrtf(fmaxf(cf.dis2, 1e-30f));
          dis = cf.dis2 * r;
          rdis = fminf(r, 1e6f);  // the reference's |dis| >= 1e-6 (cu:1050)
        }
        frag = cdf(dist_func, sign, dis, scale, shape, shift, ginv1);
      }
      if (!(frag > 1e-6f)) continue;  // probability cull (cu:784)

      // aggregate-inverse alpha rule (tconorms.py:aggregate_backward)
      const float ga = cols[PIX_GA * THREADS + l];
      float c;
      if (ALPHA == ALPHA_HARD) {
        c = ga;
      } else if (ALPHA == MAX_TCN) {
        c = ga * (cols[PIX_FA * THREADS + l] == frag ? 1.0f : 0.0f);
      } else if (ALPHA == PROBABILISTIC_TCN) {
        const float fa = cols[PIX_FA * THREADS + l];
        c = ga * ((1.0f - fa) / fmaxf(1.0f - frag, 1e-6f));
      } else {
        const float fa = cols[PIX_FA * THREADS + l];
        c = ga * ((1.0f - fa * fa) / fmaxf(1.0f - frag * frag, 1e-6f));
      }

      if (HARD_RGB) {
        // the texel gradient flows only to the pixel's winner (cu:997-1004)
        const float denom = affine(row, R_DZ, xp, yp);
        const bool zvalid = denom >= inv_far && denom <= inv_near;
        if (zvalid && (int)cols[PIX_WID * THREADS + l] == my_id) {
          acc[6] += cols[(PIX_GR + 0) * THREADS + l];
          acc[7] += cols[(PIX_GR + 1) * THREADS + l];
          acc[8] += cols[(PIX_GR + 2) * THREADS + l];
        }
      }
      if (dist_func == HEAVISIDE) continue;  // its PDF is 0

      // PDF chain and closest-point weights (cu:1034-1052)
      c = c * pdf(dist_func, sign, dis, scale, shape, shift, ginv);
      const float coef = dist_squared ? 2.0f * sign * c : sign * c * rdis;
      const float cx = coef * cf.dis_x;
      const float cy = coef * cf.dis_y;
      // edge ksel runs vertex ksel -> ksel+1: weights tv and 1 - tv
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        const float tw = cf.ksel == v ? cf.tv
                         : cf.ksel == (v + 2) % 3 ? 1.0f - cf.tv
                                                  : 0.0f;
        acc[2 * v] += cx * tw;
        acc[2 * v + 1] += cy * tw;
      }
    }
  }

  float* o = out + (size_t)b * NO * Fp + gf;
#pragma unroll
  for (int c = 0; c < NO; ++c) o[(size_t)c * Fp] = acc[c];
}

template <bool HARD_RGB>
bool launch_family(int alpha_func, dim3 grid, int FC, cudaStream_t stream,
                   const int* chunk_counts, const int* chunk_ids,
                   const float* par, const float* packed, const int* perm,
                   const float* pix, float* out, int NI, int Fp,
                   int image_size, int tiles_x, int dist_func,
                   int dist_squared) {
#define GENDR_LAUNCH(A)                                                       \
  rasterize_bwd_kernel<A, HARD_RGB><<<grid, FC, 0, stream>>>(                \
      chunk_counts, chunk_ids, par, packed, perm, pix, out, NI, Fp, FC,      \
      image_size, tiles_x, dist_func, dist_squared)
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
// synchronizes and allocates nothing.  T is the row length of chunk_ids.
extern "C" int gendr_rasterize_bwd(
    const int* chunk_counts, const int* chunk_ids, int T, const float* par,
    const float* packed, const int* perm, const float* pix, float* out, int B,
    int NI, int Fp, int FC, int image_size, int dist_func, int dist_squared,
    int alpha_func, int hard_rgb, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (image_size + TILE - 1) / TILE;
  if (FC < 1 || FC > MAX_FC || Fp % FC != 0 || T != tiles_x * tiles_x ||
      NI < NI_BASE)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Fp / FC, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok =
      hard_rgb ? launch_family<true>(alpha_func, grid, FC, s, chunk_counts,
                                     chunk_ids, par, packed, perm, pix, out,
                                     NI, Fp, image_size, tiles_x, dist_func,
                                     dist_squared)
               : launch_family<false>(alpha_func, grid, FC, s, chunk_counts,
                                      chunk_ids, par, packed, perm, pix, out,
                                      NI, Fp, image_size, tiles_x, dist_func,
                                      dist_squared);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* gendr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

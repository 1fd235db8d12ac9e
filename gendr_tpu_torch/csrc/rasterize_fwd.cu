// Forward rasterization kernel for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel gendr_tpu/raster/pallas_backend.py:_fwd_kernel
// for the sub-kernels ROADMAP.md calls K1a to K1e: channels 'alpha', hard
// RGB and softmax RGB, over vertex textures or R x R surface textures of
// any R (the wrapper caps softmax RGB at 1024 texels per face, as the JAX
// package does), the alpha mode hard and all nine t-conorms, and any of
// the 18 CDFs as a runtime id; and (K1e) a band of image rows [row0, row0
// + height) alone, for the pixel-sharded path: the grid covers the band's
// tiles, a block's rows are band-local for the output and global for the
// NDC y, so a band is bitwise the same rows of a full render
// (pallas_backend.py:293-297).  A face shard's external fvalid is the
// packed R_FVALID row, and its base_offset is added to the winner ids by
// the wrapper (cuda_backend.forward_partial), so neither needs the kernel.
//
// What bounds it on the card: per-pair ALU work.  At the flagship size
// (256x256 pixels, 1280 faces, 56 packed rows) it reads about 0.3 MB of
// packed face rows and writes about 1.5 MB (6 channels x 65536 pixels x
// 4 B); between the two, every (pixel, face) pair it visits costs some 60
// flops of barycentric, distance and CDF arithmetic, and some 40 more on
// the softmax colour path (clipped depth, two exponentials, the texel
// gather and the blend).
//
// What the design does about it: the hit-list cull.  The prepass sorts the
// faces along a Morton curve (so a chunk of FC faces is spatially tight)
// and lists, for each 16x16 pixel tile, the chunks whose bbox + cull margin
// overlaps it.  One block owns one tile (one thread per pixel) and walks
// only that list; a thread then skips each pair outside the face's bbox +
// probability margin before any distance algebra.  Everything a pixel
// aggregates stays in its thread's registers; each chunk's 48 geometry rows
// are staged once in shared memory and read by all 256 threads as
// broadcasts.  Of the texture rows (3 per texel: 75 at texture_res 5, 768
// at 16, 3072 at 32) a thread reads the three it samples from global memory
// through the read-only cache, a gather by run-time texel index, so shared
// memory does not grow with the texture: staging the rows too was slower
// at 25 texels on every shape measured (PERF.md), and at 256 a chunk's
// would not fit.  The TPU kernel's one-hot selection over blocks of 8
// texels and its deferred hard-RGB sampling are not needed: hard RGB
// samples in the kernel whatever the size.  Rows past 3 R^2 (the layout
// pads texel rows above 36 texels to a multiple of 8) are never read: the
// texel index is clamped to R^2 - 1.
//
// The alpha fold is serial per thread, one fold_step per admitted pair in
// the order the thread visits them (the TPU kernel's 128-lane butterfly
// and its zero-padded tree are its vector unit's shape, not the
// function's).  hard, max, probabilistic and einstein are template values.
// The six parametric families (K1c) share ONE instantiation per mode,
// ALPHA_PARAMETRIC, and switch on the family at run time, as the CDF
// already does: the family is uniform over a launch, so the switch never
// diverges and costs a branch beside the two to five powf of a fold, while
// six more template values would take 30 instantiations to build, not 15.
// p is read from par (P_TCP), so a sweep over p never rebuilds; log p, 1/p
// and p - 1 are computed once per thread, outside the pair loop.
//
// The softmax is streamed per thread over the pairs it visits, in order:
// it carries (ssum, smax, rgb) and rescales the sums only when a pair
// raises the running max (pallas_backend.py:438-460, cu:824-839).  Hard
// RGB samples a colour only when a pair becomes the new winner.
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

constexpr size_t STATIC_SMEM = 48 * 1024;  // shared memory of one block

// One block per 16x16 pixel tile of batch element blockIdx.y; one thread
// per pixel.  ALPHA: the alpha family, or ALPHA_PARAMETRIC with the family
// in alpha_func; MODE: alpha only, hard RGB (the
// z-argmax and the winner's colour) or softmax RGB.  out rows: alpha, then
// depth, winner input id, r, g, b (hard) or ssum, smax, r, g, b (softmax).
template <int ALPHA, int MODE>
__global__ void __launch_bounds__(THREADS) rasterize_fwd_kernel(
    const int* __restrict__ tile_counts,  // [B, T]
    const int* __restrict__ tile_ids,     // [B, T, kcap]
    int kcap,
    const float* __restrict__ par,        // [16]
    const float* __restrict__ packed,     // [B, NI, Fp]
    const int* __restrict__ perm,         // [B, Fp] input id per sorted slot
    float* __restrict__ out,              // [B, NO, P], NO = 6 or 1
    int NI, int Fp, int FC, int image_size, int tiles_x, int row0,
    int height, int dist_func, int dist_squared, int alpha_func,
    int double_side, int texture_type, int texture_res) {
  extern __shared__ float smem[];
  float* rows = smem;                                       // [NI_BASE, FC]
  int* ids = reinterpret_cast<int*>(smem + NI_BASE * FC);   // [FC]

  const int T = gridDim.x;
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x;
  const int is = image_size;
  // prow: the pixel's row in the band; row0 + prow: its row in the image
  const int prow = (t / tiles_x) * TILE + lane / TILE;
  const int pcol = (t % tiles_x) * TILE + lane % TILE;
  const bool in_image = prow < height && pcol < is;
  const float xp = pixel_x(pcol, is);
  const float yp = pixel_y(row0 + prow, is);

  const float scale = par[P_SCALE], shape = par[P_SHAPE];
  const float shift = par[P_SHIFT], thr = par[P_THR];
  const float ginv1 = par[P_GINV1], margin = par[P_MARGIN];
  const float znear = par[P_NEAR], zfar = par[P_FAR], gamma = par[P_GAMMA];
  const float inv_far = 1.0f / zfar, inv_near = 1.0f / znear;
  const TcnParam tcp = tcn_param(par[P_TCP]);

  const int n = tile_counts[b * T + t];
  const int* my_ids = tile_ids + ((size_t)b * T + t) * kcap;
  const float* pk = packed + (size_t)b * NI * Fp;
  const int* pm = perm + (size_t)b * Fp;

  // per-pixel carry: the alpha statistic (product of (1 - frag) for
  // probabilistic, the running fold otherwise), the hard-RGB winner or the
  // streaming softmax (sum, max, weighted colour)
  float acc = ALPHA == PROBABILISTIC_TCN ? 1.0f : 0.0f;
  float best = NEG_INF;
  int best_id = -1;
  float ssum = 0.0f, smax = NEG_INF;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;

  for (int j = 0; j < n; ++j) {
    const int cid = my_ids[j];
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = lane; i < NI_BASE * FC; i += THREADS) {
      const int r = i / FC;
      rows[i] = pk[(size_t)r * Fp + (size_t)cid * FC + (i - r * FC)];
    }
    if (MODE == MODE_HARD) {
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
      } else if (ALPHA == EINSTEIN_TCN) {
        acc = (acc + frag) / (1.0f + acc * frag);
      } else {
        acc = parametric_fold(alpha_func, acc, frag, tcp);
      }
      if (MODE == MODE_ALPHA) continue;

      // the face's texture values, through the read-only cache
      const float* gt = pk + (size_t)R_TEX * Fp + (size_t)cid * FC + f;
      const auto tex = [&](int i) { return __ldg(gt + (size_t)i * Fp); };
      const bool front_ok = double_side || row(R_FRONT) > 0.0f;
      if (MODE == MODE_HARD) {
        // z-argmin as an argmax of the affine denom = 1/zp (cu:815-822)
        const float denom = affine(row, R_DZ, xp, yp);
        const bool zvalid = denom >= inv_far && denom <= inv_near;
        if (in_loose && zvalid && front_ok) {
          const int oid = ids[f];
          if (denom > best || (denom == best && oid < best_id)) {
            best = denom;
            best_id = oid;
            // winners are inside-loose, where the raw barycentrics are the
            // clipped, normalised ones
            float col[3];
            sample_color(tex, texture_type, texture_res, w, col);
            cr = col[0];
            cg = col[1];
            cb = col[2];
          }
        }
      } else {
        // streaming softmax over the normalised depth (cu:824-839)
        const SoftDepth d = softmax_depth(row, w, znear, zfar);
        if (!(d.zvalid && front_ok)) continue;
        const float zn = (zfar - d.zp) / (zfar - znear);
        if (zn > smax) {
          const float sc = expf((smax - zn) / gamma);
          ssum = ssum * sc;
          cr = cr * sc;
          cg = cg * sc;
          cb = cb * sc;
          smax = zn;
        }
        const float wgt = frag * expf((zn - smax) / gamma);
        float col[3];
        sample_color(tex, texture_type, texture_res, d.wcn, col);
        ssum = ssum + wgt;
        cr = cr + wgt * col[0];
        cg = cg + wgt * col[1];
        cb = cb + wgt * col[2];
      }
    }
  }

  if (!in_image) return;
  const size_t P = (size_t)height * is;
  const size_t NO = MODE == MODE_ALPHA ? 1 : 6;
  float* o = out + (size_t)b * NO * P + (size_t)prow * is + pcol;
  o[0] = ALPHA == PROBABILISTIC_TCN ? 1.0f - acc : acc;
  if (MODE == MODE_HARD) {
    const bool any = best > NEG_INF;
    o[P] = any ? 1.0f / best : BIG_DEPTH;
    o[2 * P] = any ? (float)best_id : -1.0f;
  } else if (MODE == MODE_SOFTMAX) {
    o[P] = ssum;
    o[2 * P] = smax;
  }
  if (MODE != MODE_ALPHA) {
    o[3 * P] = cr;
    o[4 * P] = cg;
    o[5 * P] = cb;
  }
}

struct Args {
  const int* tile_counts;
  const int* tile_ids;
  int kcap;
  const float* par;
  const float* packed;
  const int* perm;
  float* out;
  int NI, Fp, FC, image_size, tiles_x, row0, height, dist_func,
      dist_squared, alpha_func, double_side, texture_type, texture_res;
};

template <int ALPHA, int MODE>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream,
                   const Args& a) {
  rasterize_fwd_kernel<ALPHA, MODE><<<grid, THREADS, smem, stream>>>(
      a.tile_counts, a.tile_ids, a.kcap, a.par, a.packed, a.perm, a.out,
      a.NI, a.Fp, a.FC, a.image_size, a.tiles_x, a.row0, a.height,
      a.dist_func, a.dist_squared, a.alpha_func, a.double_side,
      a.texture_type, a.texture_res);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_family(dim3 grid, size_t smem, cudaStream_t stream,
                          const Args& a) {
  switch (a.alpha_func) {
    case ALPHA_HARD: return launch<ALPHA_HARD, MODE>(grid, smem, stream, a);
    case MAX_TCN: return launch<MAX_TCN, MODE>(grid, smem, stream, a);
    case PROBABILISTIC_TCN:
      return launch<PROBABILISTIC_TCN, MODE>(grid, smem, stream, a);
    case EINSTEIN_TCN: return launch<EINSTEIN_TCN, MODE>(grid, smem, stream, a);
    case HAMACHER_TCN:
    case FRANK_TCN:
    case YAGER_TCN:
    case ACZEL_ALSINA_TCN:
    case DOMBI_TCN:
    case SCHWEIZER_SKLAR_TCN:
      return launch<ALPHA_PARAMETRIC, MODE>(grid, smem, stream, a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// C interface, loaded with ctypes (gendr_tpu_torch/_build.py).  Launches on
// `stream` and returns the launch's error (0 on success); never
// synchronizes and allocates nothing.  texture_res is R of an R x R surface
// texture (1 for one texel).  The launch renders image rows [row0, row0 +
// height) into out [B, NO, height * image_size]; the hit lists are the
// band's tiles, ceil(image_size / 16) x ceil(height / 16) of them.
extern "C" int gendr_rasterize_fwd(
    const int* tile_counts, const int* tile_ids, int kcap, const float* par,
    const float* packed, const int* perm, float* out, int B, int NI, int Fp,
    int FC, int image_size, int row0, int height, int dist_func,
    int dist_squared, int alpha_func, int mode, int double_side,
    int texture_type, int texture_res, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (image_size + TILE - 1) / TILE;
  const int tiles_y = (height + TILE - 1) / TILE;
  const size_t smem = ((size_t)NI_BASE * sizeof(float) + sizeof(int)) * FC;
  if (NI < NI_BASE || texture_res < 1 || smem > STATIC_SMEM || row0 < 0 ||
      height < 1 || row0 + height > image_size ||
      (mode != MODE_ALPHA &&
       NI < R_TEX + (texture_type == TEXTURE_VERTEX
                          ? 9
                          : 3 * texture_res * texture_res)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(tiles_x * tiles_y, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{tile_counts, tile_ids,     kcap,         par,
               packed,      perm,         out,          NI,
               Fp,          FC,           image_size,   tiles_x,
               row0,        height,       dist_func,    dist_squared,
               alpha_func,  double_side,  texture_type, texture_res};
  switch (mode) {
    case MODE_ALPHA:
      return (int)launch_family<MODE_ALPHA>(grid, smem, s, a);
    case MODE_HARD:
      return (int)launch_family<MODE_HARD>(grid, smem, s, a);
    case MODE_SOFTMAX:
      return (int)launch_family<MODE_SOFTMAX>(grid, smem, s, a);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* gendr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

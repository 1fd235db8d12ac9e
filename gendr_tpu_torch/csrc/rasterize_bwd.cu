// Backward rasterization kernel for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel gendr_tpu/raster/pallas_backend.py:_bwd_kernel
// for the sub-kernels ROADMAP.md calls K2a to K2e: the gradient of the
// K1a-K1e envelope, channels 'alpha', hard RGB and softmax RGB, over vertex
// textures or R x R surface textures of any R, the alpha mode hard and all
// nine t-conorms, any of the 18 CDFs as a runtime id, and dist_squared
// either way; and (K2e) the sums over a band of image rows [row0, row0 +
// height) alone (pallas_backend.py:1252-1256): the pixel columns are the
// band's, a tile's rows band-local for reading them and global for the NDC
// y and the tile skip.  The caller sums the bands' rows; a face shard's
// winner ids are shifted back by its base_offset in the wrapper
// (cuda_backend.pixel_columns), so the kernel compares local input ids.
//
// What it computes, per (pixel, face) pair: the recomputed coverage, the
// aggregate-inverse alpha rule (pallas_backend.py:1282-1288; hard alpha
// passes the incoming gradient through unmultiplied, cu:975-976); for hard
// RGB the texture gradient of the pixel's winning face
// (pallas_backend.py:1292-1302); for softmax RGB the softmax chain
// (pallas_backend.py:1303-1326): the pair's softmax weight from the
// pixel's final (ssum, smax), its colour's pull on the final colour added
// to the coverage chain, the vertex z gradients and the texture gradient;
// then the PDF chain and the closest-point weights
// (pallas_backend.py:1328-1351), coef = 2 sign c when dist_squared, else
// sign c rdis.  A texture gradient goes to the texel the pair samples or,
// for vertex textures, to the three vertex colours by wcn
// (pallas_backend.py:1365-1384).  Each face sums its pairs into 6 vertex xy
// gradients, 3 vertex z gradients (softmax) and its texture gradients.
//
// How the pairs are spread over the card.  The TPU kernel runs a
// sequential grid over (batch, face chunk, hit tile) and carries each
// face's sums from one tile to the next; a step computes a whole 256 pixel
// x 128 face slab in lanes.  Here one thread owns one face of a chunk and
// walks pixels in series, so a block's time is the length of the tile list
// it walks.  Each chunk's hit-tile list of n entries is therefore cut into
// S slices, one block per (chunk k, batch element b, slice s): block s
// walks list positions [floor(s n / S), floor((s + 1) n / S)) in list
// order.  n is read on the device, so the host reads nothing back; S is a
// function of shapes alone (cuda_backend.bwd_slice_count: up to 128, fewer
// where the workspace below would pass 256 MiB).  Each block writes its
// sums, zeros included and even for an empty slice, into its own slot of a
// workspace [B, S, NO, Fp] that the wrapper allocates, and a second
// kernel, rasterize_bwd_reduce, sums the slots of each output entry in the
// fixed order s = 0, 1, ..., S - 1 (the wrapper's launch count,
// LAUNCHES['rasterize_bwd'], counts one per call for all its passes).  Where
// S = 1 the one slot is the output itself and the second pass is not
// launched, so the largest shapes need no memory beside the output.  No
// atomics: each sum has one owner and a fixed order, and S and the
// partition depend on shapes and n alone, so the same inputs give
// bitwise-equal gradients.  At the flagship (1280 faces, 256x256, B=1)
// that is 1280 blocks, none walking more than one tile, where one block
// per chunk gave 10 blocks and a walk of 48.
//
// Per-tile face compaction (RenderConfig.compact) appends one 128-face
// chunk (a slab) per tile and slab after the sorted faces, whose list
// holds that one tile, while the original chunks keep only the tiles that
// overflowed their slabs.  Slicing the appended chunks would only add
// empty blocks and workspace (at the flagship 34 048 columns, 157 MB of
// zeros for S = 128), so the C entry slices the first k_sliced chunks
// alone, into a workspace of their columns, and a third launch writes
// the appended chunks' columns of the result directly, with its own fixed
// order, still no atomics.  A slab's work is the transpose of a sorted
// chunk's: a few live slots (a slab holds the octets, 8 Morton-consecutive
// faces, that hit its tile) times a tile of pixels.  One thread per slot
// left most lanes idle and each live lane walking up to 256 dependent
// pairs, so where a slab's texture sums fit registers (alpha, and hard RGB
// over vertex colours or one texel) the third launch is
// rasterize_bwd_slab below, a block per tile holding all its slabs and a
// warp per surviving slot; softmax RGB and bigger surface textures keep
// rasterize_bwd_kernel, one block per appended chunk and batch element.
//
// Within a block: each thread holds its face's geometry rows and its
// gradient sums in registers.  The tile's NPIX x 256 pixel columns (2, 6
// or 10 floats a pixel) are staged in shared memory through a two-stage
// ring of cp.async copies (cuda_pipeline.h): the next tile's columns are
// in flight while the current tile is computed, as the Pallas kernel
// double-buffers them by DMA (pallas_backend.py:1213-1250).  Of a staged
// tile, a thread walks the pixels inside its face's bbox + P_MARGIN (the
// gate): a rectangle of the tile's columns and rows that it finds with the
// gate's own expressions, walked in the tile's row-major order, so a warp
// steps through as many pixels as its largest face's rectangle holds, not
// all 256 of the tile's.  A surface texture of TS > 1 texels has 3 TS
// sums per face, too many for registers.  While a chunk's fit beside the
// ring (TS up to 121 at FC 128, by opting in above 48 KB) they live in a
// shared-memory block [3 TS, FC] whose column f only thread f touches
// (TEX_SHARED); above that thread f sums straight into its own column of
// its workspace slot in global memory, which it zeroes first (TEX_GLOBAL):
// a 4-byte read-modify-write per admitted pair and channel, in the L2
// cache.  Either way a sum has one owner and a fixed order; the C entry
// picks by size alone.  Hard RGB adds only a pixel's winning pair.  The 9
// vertex-colour sums and the 3 of one texel stay in registers.  The six
// parametric t-conorms (K2c) share one instantiation per mode,
// ALPHA_PARAMETRIC, and switch on the family at run time as the forward
// kernel does (rasterize_fwd.cu says why); their aggregate-inverse rule is
// pairmath.cuh's parametric_aggregate_backward, up to four powf per pair.
//
// What bounds it on the card.  The pair math is a branchy closest-feature
// search, a CDF and a PDF per pair and a sum over pixels: no product of
// matrices appears, so the tensor cores do not apply, and every gated pair
// costs some 110-190 fp32 operations, some of them transcendental.  The
// inputs are small (the chunk's packed rows, the pixel columns), so the
// kernel is bound by latency: each warp's pixels run one dependent chain
// after another, and what hides that is how many warps an SM holds.
// Uncapped, the instantiations took 161-227 registers a thread, two blocks
// of 128 threads an SM; __maxnreg__(168) fits three with 0 spills in every
// instantiation (chip_smoke.py prints ptxas's report), 1.2-1.4x faster at
// the default GenDR.  (__launch_bounds__ cannot say it: its minimum of
// blocks counts blocks of MAX_FC = 256 threads, and two of those cap a
// thread at 128 registers, where the softmax ones spill 52-84 bytes.)  A
// shared block of the geometry rows in place of registers cost 5-25 %;
// the cp.async ring moved times by less than the noise against a one-stage
// build, since a tile's columns are 10 KB against tens of microseconds of
// pair math, and it takes the shared memory that held texel sums from TS
// 122 to 144 (at TS 144 the kernel is still 5x the unsplit one's, which
// kept them there).  The reduce pass moves S x B x NO x Fp floats and is
// bound by memory: microseconds where S x NO is small, about 0.1 ms at
// 1024 texels per face, where the workspace allows S = 4 and the longest
// slice (30 tiles at 512x512) bounds the kernel.  Measured against the
// unsplit kernel, NVIDIA H100 80GB HBM3 at 700.00 W, in one run
// (gendr_tpu_torch/tools/kernel_times.py; PERF.md): the flagship 0.25-0.29
// ms against 3.24-3.31, the default GenDR (4 views at 512x512, 25 texels)
// 1.76-1.80 ms against 16.9-17.2, with vertex colours 1.21-1.25 against
// 15.3-15.4, at 1024 texels 10.3-10.5 against 24.6-24.8.
//
// Semantics follow raster/pairmath.py (closest-feature branch) and
// raster/torch_backend.py:backward; raster/cuda_backend.py:
// rasterize_bwd_plain is the same function in plain PyTorch.  Hard-RGB
// winners are INPUT face ids (the forward kernel reports them so), so a
// face compares the winner with perm[b, k * FC + f], its input id.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "pairmath.cuh"

namespace {

using namespace gendr;

constexpr int MAX_FC = 256;  // threads per block: one per face of a chunk
constexpr int STAGES = 2;  // tiles of pixel columns in the cp.async ring
constexpr int REDUCE_THREADS = 256;
constexpr size_t STATIC_SMEM = 48 * 1024;  // above it a launch opts in
constexpr size_t MAX_SMEM = 232448;        // the most a block may opt in to
// where a face's texture gradients are summed: registers, the shared
// block, or the workspace slot itself
constexpr int TEX_REGS = 0, TEX_SHARED = 1, TEX_GLOBAL = 2;
// pixel columns (raster/cuda_backend.py PIX_*): alpha gradient, final
// alpha, then for RGB the colour gradient, and the winner's input id (hard)
// or the final colour, softmax sum and softmax max (softmax)
constexpr int PIX_GA = 0, PIX_FA = 1, PIX_GR = 2, PIX_WID = 5, PIX_FR = 5,
              PIX_SSUM = 8, PIX_SMAX = 9;

__host__ __device__ constexpr int npix(int mode) {
  return mode == MODE_SOFTMAX ? 10 : mode == MODE_HARD ? 6 : 2;
}

// One block per face chunk k0 + blockIdx.x (of the K the lists hold) of
// batch element blockIdx.y and slice blockIdx.z of the chunk's hit-tile
// list; one thread per face.  ALPHA: the alpha family, or ALPHA_PARAMETRIC
// with the family in alpha_func; MODE: alpha only, hard RGB or softmax
// RGB.  Its slot of ws [B, S, NO, W] gets NO rows: x0 y0 x1 y1 x2 y2, then
// z0 z1 z2 (softmax), then the texture gradients (RGB: 9 for vertex
// textures, 3 TS for surface), one column per sorted face (face slot gf at
// column gf: a workspace of the first W columns, or the result itself).
template <int ALPHA, int MODE>
__global__ void __maxnreg__(168) rasterize_bwd_kernel(
    const int* __restrict__ chunk_counts,  // [B, K]
    const int* __restrict__ chunk_ids,     // [B, K, T]
    const float* __restrict__ par,         // [16]
    const float* __restrict__ packed,      // [B, NI, Fp]
    const int* __restrict__ perm,          // [B, Fp] input id per sorted slot
    const float* __restrict__ pix,         // [B, NPIX, P]
    float* __restrict__ ws,                // [B, S, NO, W]
    int K, int k0, int W,
    int NI, int NO, int Fp, int FC, int image_size, int tiles_x, int row0,
    int height, int dist_func, int dist_squared, int alpha_func,
    int double_side, int texture_type, int texture_res, int tex_store) {
  constexpr int NPIX = npix(MODE);
  constexpr int NZ = MODE == MODE_SOFTMAX ? 3 : 0;
  constexpr int STAGE = NPIX * THREADS;  // floats of one staged tile
  extern __shared__ float smem[];
  float* ring = smem;                   // [STAGES, NPIX, THREADS]
  float* tsum = smem + STAGES * STAGE;  // [3 TS, FC] surface texel sums

  // a kernel launched after this one with programmatic stream
  // serialization (the appended chunks' rasterize_bwd_slab) may start now:
  // it reads nothing this one writes
  asm volatile("griddepcontrol.launch_dependents;");
  const int S = gridDim.z;
  const int k = k0 + blockIdx.x;
  const int b = blockIdx.y;
  const int s = blockIdx.z;
  const int f = threadIdx.x;
  const int gf = k * FC + f;  // sorted face slot
  const int is = image_size;
  const int T = tiles_x * ((height + TILE - 1) / TILE);  // the band's tiles
  const size_t P = (size_t)height * is;
  const int R = texture_res;
  const bool vertex = texture_type == TEXTURE_VERTEX;
  const int ntex = NO - 6 - NZ;  // texture gradient rows (0 for alpha)
  // texture sums in registers (vertex colours, one texel), in shared
  // memory or in this face's column of the slot's texture rows
  const bool tex_in_regs = tex_store == TEX_REGS;
  float* slot = ws + ((size_t)b * S + s) * NO * W + gf;  // row i: [i * W]
  float* otex = slot + (size_t)(6 + NZ) * W;

  const float scale = par[P_SCALE], shape = par[P_SHAPE];
  const float shift = par[P_SHIFT], thr = par[P_THR];
  const float ginv1 = par[P_GINV1], ginv = par[P_GINV];
  const float margin = par[P_MARGIN], gamma = par[P_GAMMA];
  const float znear = par[P_NEAR], zfar = par[P_FAR];
  const float inv_far = 1.0f / zfar, inv_near = 1.0f / znear;
  const TcnParam tcp = tcn_param(par[P_TCP]);

  // the face's geometry rows, in registers for the whole block
  float fr[NI_BASE];
  const float* pk = packed + (size_t)b * NI * Fp + gf;
#pragma unroll
  for (int r = 0; r < NI_BASE; ++r) fr[r] = pk[(size_t)r * Fp];
  const auto row = [&](int i) { return fr[i]; };
  const bool face_valid = fr[R_FVALID] > 0.0f;
  const int my_id = MODE == MODE_HARD ? perm[(size_t)b * Fp + gf] : -1;
  // its texture values: the 9 vertex colours in registers, a surface
  // texture's rows through the read-only cache
  float vt[9];
#pragma unroll
  for (int i = 0; i < 9; ++i)
    vt[i] = MODE != MODE_ALPHA && vertex ? pk[(size_t)(R_TEX + i) * Fp] : 0.0f;
  const float* gt = pk + (size_t)R_TEX * Fp;
  const auto vtex = [&](int i) { return vt[i]; };
  const auto stex = [&](int i) { return __ldg(gt + (size_t)i * Fp); };

  float acc[9];  // x0 y0 x1 y1 x2 y2, then z0 z1 z2 for softmax
#pragma unroll
  for (int c = 0; c < 9; ++c) acc[c] = 0.0f;
  float tacc[9];
#pragma unroll
  for (int c = 0; c < 9; ++c) tacc[c] = 0.0f;
  if (MODE != MODE_ALPHA && tex_store == TEX_SHARED)
    for (int i = 0; i < ntex; ++i) tsum[i * FC + f] = 0.0f;
  if (MODE != MODE_ALPHA && tex_store == TEX_GLOBAL)
    for (int i = 0; i < ntex; ++i) otex[(size_t)i * W] = 0.0f;

  // a pair's texture gradient coef[c] of channel c, routed by wcn: to the
  // vertex colours, the one texel, or the sampled texel's sums
  const auto add_tex_grad = [&](const float wcn[3], const float coef[3]) {
    if (vertex) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int c = 0; c < 3; ++c) tacc[3 * j + c] += wcn[j] * coef[c];
    } else if (R == 1) {
#pragma unroll
      for (int c = 0; c < 3; ++c) tacc[c] += coef[c];
    } else if (tex_store == TEX_SHARED) {
      const int t = surface_texel_index(wcn[0], wcn[1], wcn[2], R);
#pragma unroll
      for (int c = 0; c < 3; ++c) tsum[(3 * t + c) * FC + f] += coef[c];
    } else {
      const int t = surface_texel_index(wcn[0], wcn[1], wcn[2], R);
#pragma unroll
      for (int c = 0; c < 3; ++c) otex[(size_t)(3 * t + c) * W] += coef[c];
    }
  };

  // this block's slice of the chunk's list
  const int n = chunk_counts[b * K + k];
  const int j0 = (int)((long long)s * n / S);
  const int j1 = (int)((long long)(s + 1) * n / S);
  const int* my_tiles = chunk_ids + ((size_t)b * K + k) * T;
  const float* px = pix + (size_t)b * NPIX * P;

  // start the copies of list position j's pixel columns into a ring stage:
  // 4 bytes a copy (a tile row need not be 16-byte aligned); the ragged
  // edge tile's missing pixels are zeros
  const auto stage_tile = [&](int j) {
    const int t = my_tiles[j];
    const int r0 = (t / tiles_x) * TILE, c0 = (t % tiles_x) * TILE;
    float* dst = ring + ((j - j0) % STAGES) * STAGE;
    for (int i = f; i < STAGE; i += FC) {
      const int c = i / THREADS, l = i - c * THREADS;
      const int prow = r0 + l / TILE, pcol = c0 + l % TILE;
      if (prow < height && pcol < is)
        __pipeline_memcpy_async(
            dst + i, px + (size_t)c * P + (size_t)prow * is + pcol,
            sizeof(float));
      else
        dst[i] = 0.0f;
    }
  };

  for (int j = j0; j < j0 + STAGES - 1 && j < j1; ++j) stage_tile(j);
  __pipeline_commit();
  for (int j = j0; j < j1; ++j) {
    __syncthreads();  // every thread is done with the stage refilled next
    if (j + STAGES - 1 < j1) stage_tile(j + STAGES - 1);
    __pipeline_commit();  // a group per position, empty ones included
    __pipeline_wait_prior(STAGES - 1);  // this thread's copies of tile j
    __syncthreads();                    // and every other thread's
    if (!face_valid) continue;
    const float* cols = ring + ((j - j0) % STAGES) * STAGE;
    const int t = my_tiles[j];
    const int r0 = (t / tiles_x) * TILE;  // band-local; row0 + r0 in the image
    const int c0 = (t % tiles_x) * TILE;
    // the gate (in_gate) is a rectangle in NDC and pixel_x, pixel_y are
    // monotone, so the tile's pixels it admits are the columns [x0, x1]
    // times the rows [y0, y1] found by its halves, gate_x and gate_y; the
    // ragged edge tile's missing pixels are outside.  The walk visits
    // exactly them, in the tile's row-major order, and a warp's lanes each
    // walk their own face's rectangle
    int x0 = TILE, x1 = -1, y0 = TILE, y1 = -1;
    for (int i = 0; i < TILE; ++i) {
      const float xp = pixel_x(c0 + i, is);
      if (c0 + i < is && gate_x(row, xp, margin)) {
        x0 = min(x0, i);
        x1 = i;
      }
      const float yp = pixel_y(row0 + r0 + i, is);
      if (r0 + i < height && gate_y(row, yp, margin)) {
        y0 = min(y0, i);
        y1 = i;
      }
    }
    const int npx = x1 < x0 || y1 < y0 ? 0 : (x1 - x0 + 1) * (y1 - y0 + 1);

    for (int i = 0, tx = x0, ty = y0; i < npx; ++i) {
      const int l = ty * TILE + tx;
      const float xp = pixel_x(c0 + tx, is);
      const float yp = pixel_y(row0 + r0 + ty, is);
      if (++tx > x1) {
        tx = x0;
        ++ty;
      }
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
      } else if (ALPHA == EINSTEIN_TCN) {
        const float fa = cols[PIX_FA * THREADS + l];
        c = ga * ((1.0f - fa * fa) / fmaxf(1.0f - frag * frag, 1e-6f));
      } else {
        c = ga * parametric_aggregate_backward(
                     alpha_func, cols[PIX_FA * THREADS + l], frag, tcp);
      }

      float gr[3];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        gr[ch] = MODE == MODE_ALPHA ? 0.0f : cols[(PIX_GR + ch) * THREADS + l];
      if (MODE == MODE_HARD) {
        // the texture gradient flows only to the pixel's winner
        // (cu:997-1004), routed by the raw barycentrics (winners are
        // inside-loose, where they are the clipped, normalised ones)
        const float denom = affine(row, R_DZ, xp, yp);
        const bool zvalid = denom >= inv_far && denom <= inv_near;
        if (zvalid && (int)cols[PIX_WID * THREADS + l] == my_id)
          add_tex_grad(w, gr);
      } else if (MODE == MODE_SOFTMAX) {
        // softmax chain (cu:1008-1029)
        const SoftDepth d = softmax_depth(row, w, znear, zfar);
        const bool front_ok = double_side || row(R_FRONT) > 0.0f;
        if (d.zvalid && front_ok) {
          const float zn = (zfar - d.zp) / (zfar - znear);
          const float zps = frag *
                            expf((zn - cols[PIX_SMAX * THREADS + l]) / gamma) /
                            cols[PIX_SSUM * THREADS + l];
          float col[3];
          if (vertex)
            sample_color(vtex, TEXTURE_VERTEX, R, d.wcn, col);
          else
            sample_color(stex, TEXTURE_SURFACE, R, d.wcn, col);
          const float cxyz =
              (gr[0] * (col[0] - cols[(PIX_FR + 0) * THREADS + l]) +
               gr[1] * (col[1] - cols[(PIX_FR + 1) * THREADS + l]) +
               gr[2] * (col[2] - cols[(PIX_FR + 2) * THREADS + l])) *
              zps;
          const float coef[3] = {zps * gr[0], zps * gr[1], zps * gr[2]};
          add_tex_grad(d.wcn, coef);
          c = c + cxyz / frag;
          const float cz = cxyz / gamma / (znear - zfar) * d.zp * d.zp;
          // w_clip_j / z_j^2 == wcn_j * iz_j^2 (cu:1027-1029)
#pragma unroll
          for (int v = 0; v < 3; ++v)
            acc[6 + v] +=
                cz * d.wcn[v] * (row(R_IZ + v) * row(R_IZ + v));
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

#pragma unroll
  for (int c = 0; c < 6 + NZ; ++c) slot[(size_t)c * W] = acc[c];
  if (MODE == MODE_ALPHA) return;
  if (tex_in_regs) {
#pragma unroll
    for (int c = 0; c < 9; ++c)
      if (c < ntex) otex[(size_t)c * W] = tacc[c];
  } else if (tex_store == TEX_SHARED) {
    for (int i = 0; i < ntex; ++i) otex[(size_t)i * W] = tsum[i * FC + f];
  }
}

// The appended chunks' launch where the texture sums live in registers
// (alpha, and hard RGB over vertex colours or one texel).  Per-tile face
// compaction gives each band tile t `slabs` consecutive appended chunks,
// k0 + t slabs + j (j < slabs, pack.compact_plan's layout), each listing
// tile t or nothing.  One block per (tile, batch element) holds all of
// them: slabs x FC slots, at most one per thread (FC 128, at most 2 slabs
// a tile; the C entry sends other layouts to the chunk launch).
//
// Once per block: thread f stages pixel f's columns (NPIX floats) in
// shared memory and culls slot f against the tile with the forward
// kernel's rule (cuda_backend.tile_face_survivors): its slab lists the
// tile, its fvalid is set and its bbox + margin meets the tile's
// rectangle of pixel centres.  A ballot per warp and a prefix over the
// warps compact the survivors in ascending slot order and stage their
// geometry rows; a culled or dead slot's thread writes its column's
// zeros.  One barrier, and the warps walk the survivors: a warp owns a
// survivor (warp w takes survivor w first, then the next one a shared
// counter hands out), finds its gate rectangle in the tile with gate_x
// and gate_y (lane i tests column i, lane 16 + i row i, one ballot), and
// its 32 lanes walk the rectangle's pixels in row-major order, lane l
// pixels l, l + 32, ..., through the same culls and pair expressions as
// the kernel above (pairmath.cuh, so max's exact-equality gradient and
// the hard-RGB winner test stay exact), each summing its NO values (6
// xy, then NT texture values) in registers.  Then one __shfl_down_sync
// tree for all NO values, their levels interleaved, and lane 0 writes the
// survivor's column of out.  Each sum has one owner and a fixed order
// (lane order, then the tree), whichever warp takes the survivor, so two
// runs are bitwise equal; no atomics in global memory.
//
// The launch overlaps the sorted chunks' one before it (programmatic
// dependent launch): their outputs are disjoint, and where overflow tiles
// are listed that launch is a few dozen blocks each walking one tile a
// face a thread, which left the card idle while this launch waited its
// turn.  It waits for that launch only at its end, so the reduce after
// it still finds the workspace complete.
//
// What bounds it: the chain each warp walks a survivor at a time (gate
// ballot, pair math, tree, store), with few of its lanes holding a pixel.
// At camera.sharp128's shape (200 views of 1 280 faces at 128x128, 2 slabs
// a tile, tau 1e-7) a block keeps 26.7 survivors on average (73 where its
// tile is served, at most 139), so a warp walks 3.3, and a survivor's
// rectangle holds 8 pixels at the median (18 at the 90th percentile): a
// quarter of the lanes work, on 3.37 million gated pairs whose operations
// would take 5.5 us at the fp32 peak.  Measured on an NVIDIA H100 80GB
// HBM3 at 700 W (chip_smoke.py --times, PERF.md): 0.499 ms there, 0.30 ms
// a step in the benchmark's camera.sharp128 cell; 0.283 ms at opt_camera's
// defaults at tau 1e-1 (200 views of the cube at 64x64: 12 survivors a
// block, each rectangle the whole tile, every lane busy); 0.145 ms at the
// flagship, most of it the wait for the sorted chunks' launch.
// Registers: two blocks of 256 threads an SM by __launch_bounds__, which
// caps a thread at 128 (117-127 used, no spills); chip_smoke.py prints
// ptxas's report.
//
// History, each measured against its successor on an NVIDIA H100 80GB
// HBM3 at 700 W: a block per appended chunk with a thread per slot (the
// chunk launch) left most lanes idle and each live lane walking up to
// 256 dependent pairs (1.26 ms at opt_camera's defaults, 200 views at
// 64x64, against 0.30); a block per slab with a thread per pixel, which
// kept G survivors' sums in registers and met at a barrier after each
// group, waited for its slowest pair at every group (0.108 ms at the
// flagship against 0.086); a block per slab with a thread per pixel in
// which every warp walked every survivor for its 32 pixels, six shuffle
// trees one after another for each, then added the 8 warps' partials
// after a barrier, had a serial depth of the slab's survivors, not its
// pairs, and each tile's two slabs staged its pixel columns twice: 1.726
// ms at camera.sharp128's shape, 0.865 ms a step in its cell, 0.288 ms at
// opt_camera's defaults at tau 1e-1.
constexpr int SLAB_WARPS = THREADS / 32;
constexpr int SLAB_MIN_BLOCKS = 2;
// staged rows of a survivor: the rows [0, R_FRONT) (the bbox, then the
// barycentric, edge and distance rows) and, for hard RGB, the depth-key
// rows R_DZ at R_FRONT
__host__ __device__ constexpr int slab_rows(int mode) {
  return R_FRONT + (mode == MODE_HARD ? 3 : 0);
}
__device__ __forceinline__ constexpr int slab_row(int r) {
  return r < R_FRONT ? r : R_FRONT + r - R_DZ;
}
// dynamic shared memory of a slab block: the tile's pixel columns [NPIX,
// THREADS], the survivors' rows [slab_rows, THREADS], their input ids and
// slots [THREADS] each, the ballot masks and the work counter
__host__ __device__ constexpr size_t slab_smem(int mode) {
  return ((size_t)(npix(mode) + slab_rows(mode) + 2) * THREADS + SLAB_WARPS +
          1) *
         4;
}

// NT: texture values a pair adds (0 for alpha; hard RGB: 9 for vertex
// colours, 3 for one texel); out has NO = 6 + NT rows
template <int ALPHA, int MODE, int NT>
__global__ void __launch_bounds__(THREADS, SLAB_MIN_BLOCKS)
    rasterize_bwd_slab(
        const int* __restrict__ chunk_counts,  // [B, K]
        const float* __restrict__ par,         // [16]
        const float* __restrict__ packed,      // [B, NI, Fp]
        const int* __restrict__ perm,          // [B, Fp]
        const float* __restrict__ pix,         // [B, NPIX, P]
        float* __restrict__ out,               // [B, NO, Fp]
        int* __restrict__ survivors,           // [B, T] or null
        int K, int k0, int slabs, int NI, int Fp, int FC, int image_size,
        int tiles_x, int row0, int height, int dist_func, int dist_squared) {
  static_assert(MODE != MODE_SOFTMAX && ALPHA != ALPHA_PARAMETRIC,
                "softmax and the parametric folds keep the chunk launch");
  static_assert((MODE == MODE_ALPHA) == (NT == 0) && (NT == 0 || NT == 3 ||
                                                      NT == 9),
                "alpha adds no texture values, hard RGB 3 or 9");
  constexpr int NPIX = npix(MODE);
  constexpr int NO = 6 + NT;
  constexpr int NR = slab_rows(MODE);
  extern __shared__ float smem[];
  float* cols = smem;                                     // [NPIX, THREADS]
  float* rows = cols + NPIX * THREADS;                    // [NR, THREADS]
  int* ids = reinterpret_cast<int*>(rows + NR * THREADS);  // [THREADS]
  int* slots = ids + THREADS;                             // [THREADS]
  unsigned* masks = reinterpret_cast<unsigned*>(slots + THREADS);
  int* next = reinterpret_cast<int*>(masks + SLAB_WARPS);

  const int t = blockIdx.x;  // band tile
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int is = image_size;
  const size_t P = (size_t)height * is;
  const int r0 = (t / tiles_x) * TILE;  // band-local; row0 + r0 in the image
  const int c0 = (t % tiles_x) * TILE;
  // the tile's slabs are consecutive chunks, so its slots are the columns
  // kt FC .. (kt + slabs) FC - 1 of packed and of out; slot tid is this
  // thread's
  const int kt = k0 + t * slabs;
  const bool has_slot = tid < slabs * FC;
  const int gc = kt * FC + tid;
  const float* pk = packed + (size_t)b * NI * Fp;
  float* ob = out + (size_t)b * NO * Fp;

  const float scale = par[P_SCALE], shape = par[P_SHAPE];
  const float shift = par[P_SHIFT], thr = par[P_THR];
  const float ginv1 = par[P_GINV1], ginv = par[P_GINV];
  const float margin = par[P_MARGIN];
  const float znear = par[P_NEAR], zfar = par[P_FAR];
  const float inv_far = 1.0f / zfar, inv_near = 1.0f / znear;

  // pixel tid's columns; the ragged edge tile's missing pixels lie outside
  // every gate rectangle below
  {
    const int py = r0 + tid / TILE, px = c0 + tid % TILE;
    const bool in_image = py < height && px < is;
#pragma unroll
    for (int c = 0; c < NPIX; ++c)
      cols[c * THREADS + tid] =
          in_image ? pix[((size_t)b * NPIX + c) * P + (size_t)py * is + px]
                   : 0.0f;
  }
  // the cull: slot tid against the tile's extreme pixel centres inside the
  // image and the band (y falls as the row rises)
  bool keep = false;
  if (has_slot) {
    const float xlo = pixel_x(c0, is);
    const float xhi = pixel_x(min(c0 + TILE - 1, is - 1), is);
    const float ylo = pixel_y(row0 + min(r0 + TILE - 1, height - 1), is);
    const float yhi = pixel_y(row0 + r0, is);
    keep = chunk_counts[(size_t)b * K + kt + tid / FC] > 0 &&
           pk[(size_t)R_FVALID * Fp + gc] > 0.0f &&
           xhi >= pk[(size_t)(R_BBOX + 0) * Fp + gc] - margin &&
           xlo <= pk[(size_t)(R_BBOX + 1) * Fp + gc] + margin &&
           yhi >= pk[(size_t)(R_BBOX + 2) * Fp + gc] - margin &&
           ylo <= pk[(size_t)(R_BBOX + 3) * Fp + gc] + margin;
  }
  const unsigned vote = __ballot_sync(0xffffffffu, keep);
  if (lane == 0) masks[warp] = vote;
  if (tid == 0) *next = SLAB_WARPS;
  __syncthreads();
  int nsurv = 0, pos = __popc(vote & ((1u << lane) - 1u));
  for (int w = 0; w < SLAB_WARPS; ++w) {
    const int n = __popc(masks[w]);
    pos += w < warp ? n : 0;
    nsurv += n;
  }
  if (survivors != nullptr && tid == 0)
    survivors[(size_t)b * gridDim.x + t] = nsurv;
  if (keep) {
#pragma unroll
    for (int r = 0; r < NR; ++r)
      rows[r * THREADS + pos] =
          pk[(size_t)(r < R_FRONT ? r : R_DZ + r - R_FRONT) * Fp + gc];
    if (MODE == MODE_HARD) ids[pos] = perm[(size_t)b * Fp + gc];
    slots[pos] = tid;
  } else if (has_slot) {
#pragma unroll
    for (int i = 0; i < NO; ++i) ob[(size_t)i * Fp + gc] = 0.0f;
  }
  __syncthreads();

  for (int q = warp; q < nsurv;) {
    const auto row = [&](int i) { return rows[slab_row(i) * THREADS + q]; };
    // the gate (in_gate) is a rectangle in NDC and pixel_x, pixel_y are
    // monotone, so the tile's pixels it admits are the columns [x0, x1]
    // times the rows [y0, y1] that its halves admit; the ragged edge
    // tile's missing pixels are outside
    const int i = lane % TILE;
    const bool g =
        lane < TILE
            ? c0 + i < is && gate_x(row, pixel_x(c0 + i, is), margin)
            : r0 + i < height &&
                  gate_y(row, pixel_y(row0 + r0 + i, is), margin);
    const unsigned gm = __ballot_sync(0xffffffffu, g);
    const unsigned mx = gm & 0xffffu, my = gm >> TILE;
    float v[NO];
#pragma unroll
    for (int c = 0; c < NO; ++c) v[c] = 0.0f;
    bool live = false;
    if (mx != 0u && my != 0u) {
      const int x0 = __ffs(mx) - 1, wd = 32 - __clz(mx) - x0;
      const int y0 = __ffs(my) - 1, ht = 32 - __clz(my) - y0;
      for (int p = lane; p < wd * ht; p += 32) {
        const int ty = y0 + p / wd, tx = x0 + p % wd;
        const int l = ty * TILE + tx;
        const float xp = pixel_x(c0 + tx, is);
        const float yp = pixel_y(row0 + r0 + ty, is);
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
          if (!inside && cf.dis2 >= thr) continue;  // distance cull
          if (dist_squared) {
            dis = cf.dis2;
          } else {
            const float r = rsqrtf(fmaxf(cf.dis2, 1e-30f));
            dis = cf.dis2 * r;
            rdis = fminf(r, 1e6f);
          }
          frag = cdf(dist_func, sign, dis, scale, shape, shift, ginv1);
        }
        if (!(frag > 1e-6f)) continue;  // probability cull
        live = true;

        const float ga = cols[PIX_GA * THREADS + l];
        float c;
        if (ALPHA == ALPHA_HARD) {
          c = ga;
        } else if (ALPHA == MAX_TCN) {
          c = ga * (cols[PIX_FA * THREADS + l] == frag ? 1.0f : 0.0f);
        } else if (ALPHA == PROBABILISTIC_TCN) {
          c = ga * ((1.0f - cols[PIX_FA * THREADS + l]) /
                    fmaxf(1.0f - frag, 1e-6f));
        } else {
          const float fa = cols[PIX_FA * THREADS + l];
          c = ga * ((1.0f - fa * fa) / fmaxf(1.0f - frag * frag, 1e-6f));
        }
        if constexpr (MODE == MODE_HARD) {
          // the texture gradient flows only to the pixel's winner, routed
          // by the raw barycentrics
          const float denom = affine(row, R_DZ, xp, yp);
          const bool zvalid = denom >= inv_far && denom <= inv_near;
          if (zvalid && (int)cols[PIX_WID * THREADS + l] == ids[q]) {
            float gr[3];
#pragma unroll
            for (int ch = 0; ch < 3; ++ch)
              gr[ch] = cols[(PIX_GR + ch) * THREADS + l];
            if constexpr (NT == 9) {
#pragma unroll
              for (int k = 0; k < 3; ++k)
#pragma unroll
                for (int ch = 0; ch < 3; ++ch)
                  v[6 + 3 * k + ch] += w[k] * gr[ch];
            } else {
#pragma unroll
              for (int ch = 0; ch < 3; ++ch) v[6 + ch] += gr[ch];
            }
          }
        }
        if (dist_func == HEAVISIDE) continue;  // its PDF is 0

        c = c * pdf(dist_func, sign, dis, scale, shape, shift, ginv);
        const float coef = dist_squared ? 2.0f * sign * c : sign * c * rdis;
        const float cx = coef * cf.dis_x;
        const float cy = coef * cf.dis_y;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float tw = cf.ksel == k ? cf.tv
                           : cf.ksel == (k + 2) % 3 ? 1.0f - cf.tv
                                                    : 0.0f;
          v[2 * k] += cx * tw;
          v[2 * k + 1] += cy * tw;
        }
      }
    }
    // the survivor's sums over the lanes: one tree, its levels interleaved
    // over the NO values (skipped where no pair passed the culls)
    if (__any_sync(0xffffffffu, live)) {
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
#pragma unroll
        for (int c = 0; c < NO; ++c)
          v[c] += __shfl_down_sync(0xffffffffu, v[c], off);
    }
    int qn = 0;
    if (lane == 0) {
      const int gq = kt * FC + slots[q];
#pragma unroll
      for (int c = 0; c < NO; ++c) ob[(size_t)c * Fp + gq] = v[c];
      qn = atomicAdd(next, 1);
    }
    q = __shfl_sync(0xffffffffu, qn, 0);
  }
  // launched to overlap the sorted chunks' kernel: end only after it has,
  // so that what follows in the stream (the reduce of its workspace) finds
  // its sums
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// out[b, r, c] = sum over s of ws[b, s, r, c] in the order s = 0, 1, ...,
// S - 1, one thread per entry (r, c) of a batch element's per_b = NO x W
// (W: the workspace's columns, the first W of out's Fp)
__global__ void __launch_bounds__(REDUCE_THREADS) rasterize_bwd_reduce(
    const float* __restrict__ ws, float* __restrict__ out, int S,
    size_t per_b, size_t total, int W, int Fp) {
  const size_t i = (size_t)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (i >= total) return;
  const size_t b = i / per_b, e = i - b * per_b;
  const float* w = ws + b * S * per_b + e;
  float sum = w[0];
  for (int s = 1; s < S; ++s) sum += w[(size_t)s * per_b];
  out[(b * (per_b / W) + e / W) * Fp + e % W] = sum;
}

struct Args {
  const int* chunk_counts;
  const int* chunk_ids;
  const float* par;
  const float* packed;
  const int* perm;
  const float* pix;
  float* ws;
  int K, k0, W;
  int NI, NO, Fp, FC, image_size, tiles_x, row0, height, dist_func,
      dist_squared, alpha_func, double_side, texture_type, texture_res,
      tex_store;
};

template <int ALPHA, int MODE>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream,
                   const Args& a) {
  const auto kernel = rasterize_bwd_kernel<ALPHA, MODE>;
  if (smem > STATIC_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, a.FC, smem, stream>>>(
      a.chunk_counts, a.chunk_ids, a.par, a.packed, a.perm, a.pix, a.ws,
      a.K, a.k0, a.W, a.NI, a.NO, a.Fp, a.FC, a.image_size, a.tiles_x, a.row0, a.height,
      a.dist_func, a.dist_squared, a.alpha_func, a.double_side,
      a.texture_type, a.texture_res, a.tex_store);
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

cudaError_t launch_mode(int mode, dim3 grid, size_t smem, cudaStream_t s,
                        const Args& a) {
  switch (mode) {
    case MODE_ALPHA: return launch_family<MODE_ALPHA>(grid, smem, s, a);
    case MODE_HARD: return launch_family<MODE_HARD>(grid, smem, s, a);
    case MODE_SOFTMAX: return launch_family<MODE_SOFTMAX>(grid, smem, s, a);
  }
  return cudaErrorInvalidValue;
}

// rasterize_bwd_slab over the appended chunks k0 .. K - 1, slabs a tile:
// a block per (band tile, batch element), straight into out (a.ws); each
// block's survivors into survivors unless it is null
template <int ALPHA, int MODE, int NT>
cudaError_t launch_slab(dim3 grid, int slabs, int* survivors,
                        cudaStream_t stream, const Args& a) {
  const auto kernel = rasterize_bwd_slab<ALPHA, MODE, NT>;
  const size_t smem = slab_smem(MODE);
  if (smem > STATIC_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  // programmatic stream serialization: the launch may start while the
  // sorted chunks' kernel before it still runs (Hopper's dependent launch;
  // that kernel lets it go at its start, and this one waits for that
  // kernel at its end)
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute overlap[1];
  overlap[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  overlap[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = overlap;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, kernel, a.chunk_counts, a.par, a.packed, a.perm, a.pix, a.ws,
      survivors, a.K, a.k0, slabs, a.NI, a.Fp, a.FC, a.image_size,
      a.tiles_x, a.row0, a.height, a.dist_func, a.dist_squared);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the four alpha families compaction admits (cuda_backend.COMPACT_ALPHA);
// the parametric folds never reach the appended chunks
template <int MODE, int NT>
cudaError_t launch_slab_family(dim3 grid, int slabs, int* survivors,
                               cudaStream_t stream, const Args& a) {
  switch (a.alpha_func) {
    case ALPHA_HARD:
      return launch_slab<ALPHA_HARD, MODE, NT>(grid, slabs, survivors,
                                               stream, a);
    case MAX_TCN:
      return launch_slab<MAX_TCN, MODE, NT>(grid, slabs, survivors, stream,
                                            a);
    case PROBABILISTIC_TCN:
      return launch_slab<PROBABILISTIC_TCN, MODE, NT>(grid, slabs, survivors,
                                                      stream, a);
    case EINSTEIN_TCN:
      return launch_slab<EINSTEIN_TCN, MODE, NT>(grid, slabs, survivors,
                                                 stream, a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// C interface, loaded with ctypes (gendr_tpu_torch/_build.py).  Launches
// its passes on `stream` and returns the first launch error (0 on
// success); never synchronizes and allocates nothing.  T is the row length
// of chunk_ids [B, K, T] (K = Fp / FC chunks).  The first k_sliced chunks
// (1 to K) are cut into S slices (1 to 65535): ws is the workspace [B, S,
// NO, k_sliced x FC], a second pass sums its slices into their columns of
// out [B, NO, Fp]; with S = 1 ws must be out, the one slice writes the
// result and the second pass is not launched (with S > 1 ws must not be
// out).  The chunks after them (per-tile face compaction's appended slabs,
// each listing at most one tile) write their columns of out directly: for
// alpha and hard RGB over vertex colours or one texel (the alpha families
// of COMPACT_ALPHA alone), rasterize_bwd_slab, a block per tile: they
// must be slabs = (K - k_sliced) / T chunks a band tile with slabs x FC
// <= 256 (else cudaErrorInvalidValue), tile t's the chunks k_sliced +
// t slabs + j, each listing tile t or nothing (the kernel reads only
// their counts); otherwise rasterize_bwd_kernel, a block per chunk;
// *slab_launched (a host int) is set to 1 where rasterize_bwd_slab was
// launched, else 0; survivors, unless null, is a device [B, T] that it
// fills with each block's survivors of the cull (left alone where it was
// not launched).  texture_res is R of an R x R surface texture
// (1 for one texel); NO, the rows of out, must be the layout's: 6, the 3 z
// rows for softmax, and for RGB the 9 vertex-colour or 3 R^2 texel rows.
// A surface texture of R > 1 sums its texel gradients in the shared block
// while that fits MAX_SMEM beside the ring of pixel columns, and in the
// block's own columns of ws or out above.  The launch sums over image rows
// [row0, row0 + height): pix is [B, NPIX, height * image_size] and T =
// ceil(image_size / 16) x ceil(height / 16) the band's tiles.
extern "C" int gendr_rasterize_bwd(
    const int* chunk_counts, const int* chunk_ids, int T, const float* par,
    const float* packed, const int* perm, const float* pix, float* ws,
    float* out, int B, int NI, int NO, int Fp, int FC, int S, int k_sliced,
    int image_size, int row0, int height, int dist_func, int dist_squared,
    int alpha_func, int mode, int double_side, int texture_type,
    int texture_res, int device, void* stream, int* slab_launched,
    int* survivors) {
  *slab_launched = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (image_size + TILE - 1) / TILE;
  const int tiles_y = (height + TILE - 1) / TILE;
  const int ntex = mode == MODE_ALPHA ? 0
                   : texture_type == TEXTURE_VERTEX
                       ? 9
                       : 3 * texture_res * texture_res;
  const int K = FC > 0 ? Fp / FC : 0;
  if (FC < 1 || FC > MAX_FC || Fp % FC != 0 || T != tiles_x * tiles_y ||
      S < 1 || S > 65535 || (S == 1) != (ws == out) || k_sliced < 1 ||
      k_sliced > K || row0 < 0 || height < 1 || row0 + height > image_size ||
      NI < R_TEX + ntex || texture_res < 1 ||
      NO != 6 + (mode == MODE_SOFTMAX ? 3 : 0) + ntex)
    return (int)cudaErrorInvalidValue;
  const bool big = ntex > 0 && texture_type == TEXTURE_SURFACE &&
                   texture_res > 1;
  // the appended chunks of alpha and register texture sums must be slabs
  // a tile, at most one slot a thread
  const int appended = K - k_sliced, slabs = appended / T;
  const bool slab = appended > 0 && mode != MODE_SOFTMAX && !big;
  if (slab && (appended != slabs * T || slabs * FC > THREADS))
    return (int)cudaErrorInvalidValue;
  const size_t ring_smem =
      (size_t)STAGES * npix(mode) * THREADS * sizeof(float);
  const size_t tex_smem = (size_t)ntex * FC * sizeof(float);
  const int tex_store = !big                               ? TEX_REGS
                        : ring_smem + tex_smem <= MAX_SMEM ? TEX_SHARED
                                                           : TEX_GLOBAL;
  const size_t smem = ring_smem + (tex_store == TEX_SHARED ? tex_smem : 0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int W = S == 1 ? Fp : k_sliced * FC;  // columns of a row of ws
  Args a{chunk_counts, chunk_ids,  par,       packed,      perm,
         pix,          ws,         K,         0,           W,
         NI,           NO,         Fp,        FC,          image_size,
         tiles_x,      row0,       height,    dist_func,   dist_squared,
         alpha_func,   double_side, texture_type, texture_res, tex_store};
  err = launch_mode(mode, dim3(k_sliced, B, S), smem, s, a);
  if (err != cudaSuccess) return (int)err;
  if (k_sliced < K) {
    // the appended chunks, straight into out: a block per tile where the
    // texture sums live in registers, else a block per chunk
    a.ws = out;
    a.k0 = k_sliced;
    a.W = Fp;
    const dim3 tiles(T, B, 1);
    if (slab && mode == MODE_ALPHA)
      err = launch_slab_family<MODE_ALPHA, 0>(tiles, slabs, survivors, s, a);
    else if (slab && ntex == 9)
      err = launch_slab_family<MODE_HARD, 9>(tiles, slabs, survivors, s, a);
    else if (slab)
      err = launch_slab_family<MODE_HARD, 3>(tiles, slabs, survivors, s, a);
    else
      err = launch_mode(mode, dim3(appended, B, 1), smem, s, a);
    if (err != cudaSuccess) return (int)err;
    *slab_launched = slab;
  }
  if (S == 1) return (int)cudaSuccess;
  const size_t per_b = (size_t)NO * W, total = (size_t)B * per_b;
  rasterize_bwd_reduce<<<(unsigned)((total + REDUCE_THREADS - 1) /
                                    REDUCE_THREADS),
                         REDUCE_THREADS, 0, s>>>(ws, out, S, per_b, total, W,
                                                 Fp);
  return (int)cudaGetLastError();
}

extern "C" const char* gendr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

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
// What bounds it on the card.  The prepass sorts the faces along a Morton
// curve (so a chunk of FC faces is spatially tight) and lists, for each
// 16x16 pixel tile, the chunks whose bbox + cull margin overlaps it; one
// block owns one tile and walks that list.  Its bytes are few (at the
// flagship, 256x256 and 1280 faces, 0.3 MB of packed rows in and 1.5 MB
// out), so what it costs is pairs: 60-120 fp32 operations of barycentric,
// distance, CDF and colour arithmetic per (pixel, face) pair it admits
// (some 300 instructions with the IEEE divisions and the CDF), and before
// that the bbox gate of every pair it visits.  On a sparse frame (tau <=
// 1e-2) a listed chunk holds a few faces near the tile and many far from
// it: walking every face of the list, the gate test on faces that meet no
// pixel of the tile was most of the work, and the tile of the longest list
// (8 chunks at the flagship) set the time.  On a dense frame (tau = 1,
// 1536x1536) nearly every pair is admitted, 2.4-3.0e9 of them, and the
// time is the pairs' instructions over the warps an SM holds to hide
// their latency.
//
// What the design does about it.  A cull per block: before the pixels walk
// a chunk, one thread per face tests the face's fvalid and bbox + margin
// against the tile's rectangle of pixel centres (its least and greatest
// pixel_x and pixel_y, clipped to the image and the band), with the gate's
// own expressions.  pixel_x and pixel_y are monotone and the comparisons
// are the gate's, so a face that any pixel of the tile admits survives,
// and a culled face is one the per-pixel gate rejects everywhere: skipping
// it is exact.  The survivors are compacted in ascending slot order (a
// ballot per warp, then a prefix over the warps' masks; no atomics), and
// only their rows are staged in shared memory, and only the rows the
// forward reads, the bbox as the gate's bounds (bbox -/+ margin, one
// subtraction per face, not per pair).  The next chunk is culled at the
// end of the walk, into a second set of masks, so a chunk costs two
// barriers.  cuda_backend.tile_face_survivors is the cull's twin in
// Python.  At the flagship the longest tile's 8 chunks keep a few dozen
// faces each, and the kernel visits 8.5e5 pairs where the walk of every
// listed face visited 1.1e7.
//
// A thread owns a strip of PPT pixels of one column (rows k, k + 16 / PPT,
// ...), each with its own carry, and folds each surviving face into each
// of its pixels, the strip's barycentrics and distances in one stretch of
// code.  PPT = 1 was measured fastest on every sparse shape: a thread walks
// its pixels one after the other through branchy code, so PPT 2 and 4 put
// a tile's work on half or a quarter as many warps, and where few blocks
// run (the flagship's 256) that is what the time is.  On dense frames PPT
// 2 gained a few per cent only at 80 registers, where it spills (PERF.md).
// Registers are capped at 80, three blocks of 256 threads an SM, with no
// spills: the hard-RGB winner's colour is sampled after the walk from its
// packed rows (the walk keeps its sorted slot, not three colour values),
// and a texel's slot is read where it is used.  Every pixel still folds
// the faces of its tile's listed chunks in ascending chunk order and,
// within a chunk, in ascending slot order, through the same expressions
// (built without multiply-add contraction), so the output is bitwise that
// of the walk of every listed face, and the plain version's gates stand.
//
// Everything a pixel aggregates stays in registers.  Of the texture rows
// (3 per texel: 75 at texture_res 5, 768 at 16, 3072 at 32) a pair reads
// the three it samples from global memory through the read-only cache, a
// gather by run-time texel index, so shared memory does not grow with the
// texture: staging the rows too was slower at 25 texels on every shape
// measured (PERF.md), and at 256 a chunk's would not fit.  The TPU
// kernel's one-hot selection over blocks of 8 texels is not needed.  Rows
// past 3 R^2 (the layout pads texel rows above 36 texels to a multiple of
// 8) are never read: the texel index is clamped to R^2 - 1.
//
// The alpha fold is serial per pixel, one fold_step per admitted pair in
// the order the pixel visits them (the TPU kernel's 128-lane butterfly
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
// The softmax is streamed per pixel over the pairs it visits, in order:
// it carries (ssum, smax, rgb) and rescales the sums only when a pair
// raises the running max (pallas_backend.py:438-460, cu:824-839).  Hard
// RGB keeps the winner's depth key, input id and sorted slot, and samples
// the winner's colour once, after the walk, whatever the texture's size.
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

// pixels per thread, a column strip of rows k, k + TILE / PPT, ...; 1, 2
// and 4 were measured (PERF.md): see above
constexpr int PPT = 1;
constexpr int FWD_THREADS = THREADS / PPT;  // threads per block (one tile)
// at most 80 registers a thread, so three blocks of 256 threads fit an SM
// (24 warps) with no spills
constexpr int MAX_REGS = 80;
constexpr int MIN_BLOCKS = 65536 / (MAX_REGS * FWD_THREADS);
constexpr int MAX_FC = 256;             // faces per chunk: 8 ballot masks
constexpr int CULL_PASSES = MAX_FC / FWD_THREADS;  // faces a thread culls
constexpr size_t STATIC_SMEM = 48 * 1024;  // shared memory of one block

// the block's shared memory for chunks of FC faces: the survivors' rows
// [NI_BASE, FC], their input ids and slots [FC] each, two chunks' ballot
// masks and the tile's rectangle of pixel centres
__host__ __device__ constexpr size_t fwd_smem(int FC) {
  return ((size_t)(NI_BASE + 2) * FC + 2 * (MAX_FC / 32) + 4) * 4;
}

// the geometry rows the forward reads past the bbox (which is staged as
// the gate's bounds): the barycentric and edge-parameter rows, the edges'
// squared lengths and their MM terms, and per mode the front flag, the
// clipped-depth rows (softmax) or the depth key (hard).  R_E, R_M (the
// backward's) and R_FVALID (the cull has read it) are not staged.
template <int MODE>
__device__ __forceinline__ constexpr bool staged(int r) {
  return (r >= R_INV && r < R_E) || (r >= R_E2 && r < R_E2 + 3) ||
         (r >= R_MM && r < R_MM + 3) ||
         (MODE != MODE_ALPHA && r == R_FRONT) ||
         (MODE == MODE_SOFTMAX && r >= R_IZ && r < R_IZ + 3) ||
         (MODE == MODE_HARD && r >= R_DZ && r < R_DZ + 3);
}

// A pixel's carry: the alpha statistic (product of (1 - frag) for
// probabilistic, the running fold otherwise), the hard-RGB winner (its
// depth key, input id and sorted slot) or the streaming softmax (sum, max,
// weighted colour)
struct Carry {
  float acc, best;
  int best_id, best_slot;
  float ssum, smax, cr, cg, cb;
};

// What the cull reads of one face: fvalid and the gate's bounds, bbox -
// margin and bbox + margin (pairmath.cuh gate_x / gate_y's expressions)
struct Bounds {
  float fvalid, xlo, xhi, ylo, yhi;
};

// One block per 16x16 pixel tile of batch element blockIdx.y; a thread
// owns PPT pixels of one column.  ALPHA: the alpha family, or
// ALPHA_PARAMETRIC with the family in alpha_func; MODE: alpha only, hard
// RGB (the z-argmax and the winner's colour) or softmax RGB.  out rows:
// alpha, then depth, winner input id, r, g, b (hard) or ssum, smax, r, g,
// b (softmax).
template <int ALPHA, int MODE>
__global__ void __launch_bounds__(FWD_THREADS, MIN_BLOCKS)
    rasterize_fwd_kernel(
        const int* __restrict__ tile_counts,  // [B, T]
        const int* __restrict__ tile_ids,     // [B, T, kcap]
        int kcap,
        const float* __restrict__ par,        // [16]
        const float* __restrict__ packed,     // [B, NI, Fp]
        const int* __restrict__ perm,         // [B, Fp] input id per slot
        float* __restrict__ out,              // [B, NO, P], NO = 6 or 1
        int NI, int Fp, int FC, int image_size, int tiles_x, int row0,
        int height, int dist_func, int dist_squared, int alpha_func,
        int double_side, int texture_type, int texture_res) {
  extern __shared__ float smem[];
  float* rows = smem;                                      // [NI_BASE, FC]
  int* ids = reinterpret_cast<int*>(smem + NI_BASE * FC);  // [FC]
  int* slots = ids + FC;                                   // [FC]
  unsigned* masks = reinterpret_cast<unsigned*>(slots + FC);  // [2, 8]
  float* rect = reinterpret_cast<float*>(masks + 2 * (MAX_FC / 32));  // [4]

  const int T = gridDim.x;
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int is = image_size;
  // the tile's first row in the band and first column; this thread's
  // column and rows (row0 + a band row: the row in the image)
  const int trow = (t / tiles_x) * TILE, tcol = (t % tiles_x) * TILE;
  const int pcol = tcol + tid % TILE;
  const float xp = pixel_x(pcol, is);
  int prow[PPT];
  float yp[PPT];
  bool in_image[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    prow[i] = trow + tid / TILE + i * (TILE / PPT);
    yp[i] = pixel_y(row0 + prow[i], is);
    in_image[i] = prow[i] < height && pcol < is;
  }
  // the tile's extreme pixel centres inside the image and the band (y
  // falls as the row rises), read back at each cull rather than held in
  // registers through the walk
  if (tid == 0) {
    rect[0] = pixel_x(tcol, is);
    rect[1] = pixel_x(min(tcol + TILE - 1, is - 1), is);
    rect[2] = pixel_y(row0 + min(trow + TILE - 1, height - 1), is);
    rect[3] = pixel_y(row0 + trow, is);
  }

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
  const int nmasks = (FC + 31) / 32;

  // the cull of chunk cid into masks m: does any pixel centre of the tile
  // pass face f's gate?  Thread tid takes faces f = q FWD_THREADS + tid
  // (faces past FC vote no); one ballot per warp and pass.  The faces'
  // gate bounds stay in bd for the stage.
  Bounds bd[CULL_PASSES];
  const auto cull = [&](int cid, unsigned* m) {
    const float* pc = pk + (size_t)cid * FC;
    const float xlo = rect[0], xhi = rect[1], ylo = rect[2], yhi = rect[3];
#pragma unroll
    for (int q = 0; q < CULL_PASSES; ++q) {
      const int f = q * FWD_THREADS + tid;
      const auto g = [&](int i) { return pc[(size_t)i * Fp + f]; };
      Bounds& c = bd[q];
      c.fvalid = f < FC ? g(R_FVALID) : 0.0f;
      if (f < FC) {
        c.xlo = g(R_BBOX + 0) - margin;
        c.xhi = g(R_BBOX + 1) + margin;
        c.ylo = g(R_BBOX + 2) - margin;
        c.yhi = g(R_BBOX + 3) + margin;
      }
      const bool keep = c.fvalid > 0.0f && xhi >= c.xlo && xlo <= c.xhi &&
                        yhi >= c.ylo && ylo <= c.yhi;
      const unsigned v = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) m[q * (FWD_THREADS / 32) + warp] = v;
    }
  };

  Carry c[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    c[i].acc = ALPHA == PROBABILISTIC_TCN ? 1.0f : 0.0f;
    c[i].best = NEG_INF;
    c[i].best_id = -1;
    c[i].ssum = 0.0f;
    c[i].smax = NEG_INF;
    c[i].cr = c[i].cg = c[i].cb = 0.0f;
  }

  __syncthreads();  // the tile's rectangle is in
  if (n > 0) cull(my_ids[0], masks);
  for (int j = 0; j < n; ++j) {
    const int cid = my_ids[j];
    const float* pc = pk + (size_t)cid * FC;  // the chunk's slot 0, row 0
    const unsigned* m = masks + (j % 2) * (MAX_FC / 32);
    __syncthreads();  // the chunk's masks are in; the last walk is done

    // the survivors, staged in ascending slot order: a face's place is the
    // survivors of the masks before its own and of the lanes below it.
    // The bbox rows hold the gate's bounds.
    int nsurv = 0;
    for (int w = 0; w < nmasks; ++w) nsurv += __popc(m[w]);
#pragma unroll
    for (int q = 0; q < CULL_PASSES; ++q) {
      const int f = q * FWD_THREADS + tid;
      if (f >= FC) break;
      const unsigned mf = m[f / 32];
      if (!((mf >> lane) & 1u)) continue;
      int pos = __popc(mf & ((1u << lane) - 1u));
      for (int w = 0; w < f / 32; ++w) pos += __popc(m[w]);
      rows[(R_BBOX + 0) * FC + pos] = bd[q].xlo;
      rows[(R_BBOX + 1) * FC + pos] = bd[q].xhi;
      rows[(R_BBOX + 2) * FC + pos] = bd[q].ylo;
      rows[(R_BBOX + 3) * FC + pos] = bd[q].yhi;
#pragma unroll
      for (int r = 0; r < NI_BASE; ++r)
        if (staged<MODE>(r)) rows[r * FC + pos] = pc[(size_t)r * Fp + f];
      if (MODE == MODE_HARD) ids[pos] = pm[cid * FC + f];
      if (MODE != MODE_ALPHA) slots[pos] = f;
    }
    __syncthreads();

    for (int s = 0; s < nsurv; ++s) {
      const auto row = [&](int i) { return rows[i * FC + s]; };
      // the gate, x for the column and y per pixel; a pair outside it
      // contributes the identity to every fold, so skipping it is exact
      if (!(xp >= row(R_BBOX + 0) && xp <= row(R_BBOX + 1))) continue;
      bool gated[PPT];
      bool any = false;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        gated[i] = in_image[i] && yp[i] >= row(R_BBOX + 2) &&
                   yp[i] <= row(R_BBOX + 3);
        any = any || gated[i];
      }
      if (!any) continue;
      // the face's texture values, through the read-only cache
      const float* gt = pk + (size_t)R_TEX * Fp + (size_t)cid * FC;
      const auto tex = [&](int i) {
        return __ldg(gt + slots[s] + (size_t)i * Fp);
      };

      // the barycentrics and the squared distance of every pixel of the
      // strip, in one stretch of code
      float w[PPT][3], dis2[PPT];
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        w[i][0] = affine(row, R_INV + 0, xp, yp[i]);
        w[i][1] = affine(row, R_INV + 3, xp, yp[i]);
        w[i][2] = affine(row, R_INV + 6, xp, yp[i]);
        const bool inside = fminf(fminf(w[i][0], w[i][1]), w[i][2]) > 0.0f;
        if (dist_func != HEAVISIDE)
          dis2[i] = dis2_min(row, w[i], inside, xp, yp[i]);
      }

#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        if (!gated[i]) continue;
        Carry& q = c[i];
        const float wmin = fminf(fminf(w[i][0], w[i][1]), w[i][2]);
        const bool inside = wmin > 0.0f;
        const bool in_loose = wmin >= 0.0f;

        float frag;
        if (dist_func == HEAVISIDE) {
          frag = in_loose ? 1.0f : 0.0f;
        } else {
          if (!inside && dis2[i] >= thr) continue;  // distance cull (cu:769)
          const float dis = dist_squared
                                ? dis2[i]
                                : dis2[i] * rsqrtf(fmaxf(dis2[i], 1e-30f));
          frag = cdf(dist_func, inside ? 1.0f : -1.0f, dis, scale, shape,
                     shift, ginv1);
        }
        if (!(frag > 1e-6f)) continue;  // probability cull (cu:784)

        // alpha fold (cu:791-801)
        if (ALPHA == ALPHA_HARD) {
          if (frag > 0.5f) q.acc = 1.0f;
        } else if (ALPHA == MAX_TCN) {
          q.acc = fmaxf(q.acc, frag);
        } else if (ALPHA == PROBABILISTIC_TCN) {
          q.acc = q.acc * (1.0f - frag);
        } else if (ALPHA == EINSTEIN_TCN) {
          q.acc = (q.acc + frag) / (1.0f + q.acc * frag);
        } else {
          q.acc = parametric_fold(alpha_func, q.acc, frag, tcp);
        }
        if (MODE == MODE_ALPHA) continue;

        const bool front_ok = double_side || row(R_FRONT) > 0.0f;
        if (MODE == MODE_HARD) {
          // z-argmin as an argmax of the affine denom = 1/zp (cu:815-822);
          // the winner's colour is sampled once, after the walk
          const float denom = affine(row, R_DZ, xp, yp[i]);
          const bool zvalid = denom >= inv_far && denom <= inv_near;
          if (in_loose && zvalid && front_ok) {
            const int oid = ids[s];
            if (denom > q.best || (denom == q.best && oid < q.best_id)) {
              q.best = denom;
              q.best_id = oid;
              q.best_slot = cid * FC + slots[s];
            }
          }
        } else {
          // streaming softmax over the normalised depth (cu:824-839)
          const SoftDepth d = softmax_depth(row, w[i], znear, zfar);
          if (!(d.zvalid && front_ok)) continue;
          const float zn = (zfar - d.zp) / (zfar - znear);
          if (zn > q.smax) {
            const float sc = expf((q.smax - zn) / gamma);
            q.ssum = q.ssum * sc;
            q.cr = q.cr * sc;
            q.cg = q.cg * sc;
            q.cb = q.cb * sc;
            q.smax = zn;
          }
          const float wgt = frag * expf((zn - q.smax) / gamma);
          float col[3];
          sample_color(tex, texture_type, texture_res, d.wcn, col);
          q.ssum = q.ssum + wgt;
          q.cr = q.cr + wgt * col[0];
          q.cg = q.cg + wgt * col[1];
          q.cb = q.cb + wgt * col[2];
        }
      }
    }

    // the next chunk's cull, into the other masks
    if (j + 1 < n) cull(my_ids[j + 1], masks + ((j + 1) % 2) * (MAX_FC / 32));
  }

  const size_t P = (size_t)height * is;
  const size_t NO = MODE == MODE_ALPHA ? 1 : 6;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    if (!in_image[i]) continue;
    Carry& q = c[i];
    float* o = out + (size_t)b * NO * P + (size_t)prow[i] * is + pcol;
    o[0] = ALPHA == PROBABILISTIC_TCN ? 1.0f - q.acc : q.acc;
    if (MODE == MODE_HARD) {
      const bool any = q.best > NEG_INF;
      o[P] = any ? 1.0f / q.best : BIG_DEPTH;
      o[2 * P] = any ? (float)q.best_id : -1.0f;
      if (any) {
        // the winner's colour from its packed rows: winners are inside-
        // loose, where the raw barycentrics are the clipped, normalised
        // ones, and these are the walk's expressions
        const auto row = [&](int r) {
          return pk[(size_t)r * Fp + q.best_slot];
        };
        const float* gt = pk + (size_t)R_TEX * Fp + q.best_slot;
        const auto tex = [&](int k) { return __ldg(gt + (size_t)k * Fp); };
        const float w[3] = {affine(row, R_INV + 0, xp, yp[i]),
                            affine(row, R_INV + 3, xp, yp[i]),
                            affine(row, R_INV + 6, xp, yp[i])};
        float col[3];
        sample_color(tex, texture_type, texture_res, w, col);
        q.cr = col[0];
        q.cg = col[1];
        q.cb = col[2];
      }
    } else if (MODE == MODE_SOFTMAX) {
      o[P] = q.ssum;
      o[2 * P] = q.smax;
    }
    if (MODE != MODE_ALPHA) {
      o[3 * P] = q.cr;
      o[4 * P] = q.cg;
      o[5 * P] = q.cb;
    }
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
  rasterize_fwd_kernel<ALPHA, MODE><<<grid, FWD_THREADS, smem, stream>>>(
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
  const size_t smem = fwd_smem(FC);
  if (NI < NI_BASE || texture_res < 1 || FC < 1 || FC > MAX_FC ||
      smem > STATIC_SMEM || row0 < 0 || height < 1 ||
      row0 + height > image_size ||
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

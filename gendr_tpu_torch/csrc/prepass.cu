// The render's prepass for Hopper (sm_90a), hand-written CUDA C++: the
// Morton sort of the faces, their packed rows and both hit lists, in two
// launches; and the prepass of per-tile face compaction, the sort, the
// compaction plan and the packed rows of the sorted faces and of the
// tiles' slots, in three.
//
// It replaces no Pallas kernel.  It stands in for the XLA prepass of the
// JAX package, gendr_tpu/raster/pallas_backend.py:_sorted_faces (the
// Morton order of gendr_tpu/raster/pack.py:morton_order) followed by
// pack.py's pack_faces, tile_chunk_mask and compact_hits or, where
// compaction fires, pack.py's compact_plan and pack_faces over the sorted
// faces and the slots, which the port runs as plain PyTorch in
// raster/cuda_backend.py:prepass_plain.  There every row of every face is
// its own elementwise op: some 360 kernels and the argsorts' own, about
// 380 launches a render (0.96 ms at the camera cells' 200 x 1280 faces in
// a replayed CUDA graph); compacted, 433 kernels with the slots' gathers
// and concatenations, 6.58 ms at camera.sharp128's 200 x 1280 faces over
// 64 tiles of two slabs.  cuda_backend.prepass launches these kernels for
// CUDA tensors whose padded faces fit the block's sort
// (cuda_backend.prepass_path): gendr_prepass where compaction is off,
// gendr_compact_sort, gendr_compact_plan and gendr_compact_pack where it
// fires.
//
// What bounds it on the card: bytes.  At the camera cells' shape it reads
// 9.2 MB of projected vertices and writes 49 MB of packed rows ([200, 48,
// 1280] float32) and two lists of a few thousand ints: ~59 MB, 0.018 ms at
// 3.35 TB/s.  Compacted, at camera.sharp128's shape, the packed rows are
// [200, 48, 1280 + 16384] (678 MB), perm 14 MB, the lists and the octet
// ids 9 MB: ~710 MB, 0.21 ms.  The work per column is a few hundred float
// operations, far below the operations bound.
//
// What the design does about it.  Nothing is read back to the host
// between or after the launches (they are captured in the experiments'
// graphs):
//  1. prepass_sort, one block per batch element: each face's Morton key,
//     pack.morton_order's expressions, with 0x7FFFFFFF for faces past F
//     (chunk padding) and faces the caller's fvalid marks False; key and
//     face index as one 64-bit word in shared memory, so a bitonic sort of
//     the words, whose keys are then all distinct, gives the stable
//     argsort's order (ties by face index): the form whose merges all
//     sort upwards, so that the padding to a power of two is never
//     touched, and every comparator within 128 words in a warp's
//     registers; perm from the sorted words; then (uncompacted only) a
//     warp per chunk takes the union of its faces' bboxes (+-1e30
//     for faces whose packed fvalid is 0, as tile_chunk_mask), each face
//     gathered through the sorted words and its bbox and fvalid rows
//     computed by the very function that packs them, and a warp per tile,
//     then a warp per chunk, lists the hits in ascending order and then
//     the rest in ascending order (a ballot per 32 candidates), which is
//     what compact_hits' stable argsorts give;
//  2. (compacted) prepass_plan, one block per batch element: the bbox
//     union of each octet of 8 sorted faces in shared memory (compact_plan
//     fills +-1e30 where the sorted fvalid is False: not the packed fvalid
//     row, which also masks point-degenerate faces), 8 lanes an octet;
//     then a warp per tile ballots the octets that meet its rectangle +-
//     the margin, 32 at a time, counts them, writes its first slabs x 16
//     octet ids (hits ascending, then the rest: the stable argsort of 1 -
//     hit, cut), its forward list (an overflow tile's hit chunks, else
//     its slab chunks) and its live octets and slots; then a warp per
//     chunk writes the backward lists (a sorted chunk: the overflow tiles
//     it hits; slab chunk K + t slabs + j: tile t, counted while j is
//     below the tile's slabs).  A few kB of lists and ids a block;
//  3. prepass_pack, a thread per (batch element, column) over the whole
//     card: a sorted face's column gathers its face through perm, a slot's
//     through its octet id and perm (and writes that perm entry), and
//     writes the packed column with pack.pack_faces' expressions in their
//     order of operations (built without multiply-add contraction,
//     _build.NVCC_FLAGS; divisions IEEE), a column a lane, so the row
//     writes, most of the bytes, are coalesced; then the texture rows and
//     the zero rows.  A slot's fvalid is its face's and'ed with its slab
//     entry being live, so every other row of a slot is its face's.
// Measured at the camera cells' shape, captured in a graph (NVIDIA H100
// 80GB HBM3, 700 W): one block per batch element for everything, a single
// launch, took 0.089 ms, its 49 MB of rows written by 200 blocks in two
// waves of one 88-register block an SM; the pack over the whole card
// writes them in 0.020 ms.  The sort's stages through shared memory, a
// barrier and 16 KB of traffic a block each, then took 0.030 ms of the
// sort kernel's 0.053; in registers and shuffles where the comparators
// allow, on Fp words and not the power of two, the sort kernel takes
// 0.029 ms, the two launches 0.052 ms a replay.  Compacted, at
// camera.sharp128's shape, the three launches take 0.341 ms a replay, 62 %
// of the bound: the pack 0.289 (its 678 MB at 2.35 TB/s), the plan 0.027
// and the sort 0.023; the plain prepass 6.58 ms.
// torch.minimum / maximum, amin / amax and clamp propagate NaN on the
// card, and so do the helpers below; the tile rectangles divide by the
// image size as PyTorch's CUDA division by a Python number does,
// multiplying by its float reciprocal.  So every output is bitwise the
// plain prepass's on the card (tests/test_torch_prepass.py,
// chip_smoke.py's prepass phase).

#include <cuda_runtime.h>
#include <math.h>

#include "pairmath.cuh"

namespace {

using namespace gendr;

constexpr int SORT_THREADS = 512;   // prepass_sort: a block per element
constexpr int WARPS = SORT_THREADS / 32;
constexpr int PACK_THREADS = 256;   // prepass_pack: a thread per slot
// the most faces (padded to the chunk) a block sorts: 128 KB of keys
constexpr int SORT_CAP = 16384;
constexpr size_t SMEM_CAP = 232448;  // Hopper's dynamic shared memory
constexpr size_t STATIC_SMEM = 48 * 1024;
constexpr float DET_EPS = 1e-10f;     // config.DET_EPS
constexpr float BIG = 1e30f;          // pack.tile_chunk_mask's fill
constexpr unsigned FULL = 0xffffffffu;
// per-tile face compaction (pack.OCT, pack.OCT_CAP): octets of 8 sorted
// faces, 16 octets a slab, so a slab's 128 slots are one chunk of the
// compacted prepass's faces
constexpr int OCT = 8;
constexpr int OCT_CAP = 16;
constexpr int SLAB = OCT * OCT_CAP;
// the sort's comparators within this many words run in a warp's
// registers, four words a lane
constexpr int SEGMENT = 128;
static_assert(SEGMENT == 4 * 32, "a segment is four words a lane");

// prepass_sort's shared memory: the sort's 64-bit words, one a face
// (an even count, so that each chunk's bbox union after them is 16-byte
// aligned), then the unions (cuda_backend._prepass_smem); and the sort's
// span, the power of two N >= Fp (at least 4) its stages index
__host__ __device__ constexpr size_t prepass_smem(int Fp, int FC) {
  return (size_t)(Fp + Fp % 2) * 8 + (size_t)(Fp / FC) * 16;
}
// prepass_plan's shared memory (cuda_backend._plan_smem): each octet's
// bbox union and its valid faces, then each tile's slabs and its chunk-hit
// bits (a word per 32 chunks)
__host__ __device__ constexpr size_t plan_smem(int Fp, int T) {
  return (size_t)(Fp / OCT) * 20 +
         (size_t)T * 4 * (1 + (Fp / SLAB + 31) / 32);
}
__host__ __device__ constexpr int sort_width(int Fp) {
  int n = 4;
  while (n < Fp) n *= 2;
  return n;
}

// torch.minimum / torch.maximum on the card: NaN propagates, else ::min
// and ::max (fminf, fmaxf)
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
// torch.clamp with one bound: NaN propagates
__device__ __forceinline__ float clamp_lo(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_hi(float v, float hi) {
  return v != v ? v : fminf(v, hi);
}

// the bitonic sort's comparators: i with a 0 bit inserted at j (a power
// of two); a word pair put in ascending order, in registers or in shared
// memory, where a word past n counts as larger than every other
__device__ __forceinline__ int insert_zero(int i, int j) {
  return ((i & ~(j - 1)) << 1) | (i & (j - 1));
}
__device__ __forceinline__ void order(unsigned long long& a,
                                      unsigned long long& c) {
  if (a > c) {
    const unsigned long long t = a;
    a = c;
    c = t;
  }
}
__device__ __forceinline__ void compare_swap(unsigned long long* w, int lo,
                                             int hi, int n) {
  if (hi < n) {
    const unsigned long long a = w[lo], c = w[hi];
    if (a > c) {
      w[lo] = c;
      w[hi] = a;
    }
  }
}

// The bitonic sort's comparators within aligned segments of SEGMENT
// words, each warp on its own segments, a lane holding words 4 lane .. 4
// lane + 3 of one (words past n: larger than every other): merges k0 ..
// k1 whole where k1 <= SEGMENT; for k0 = k1 > SEGMENT merge k's
// half-cleaners from j = SEGMENT / 2 down.  Partners across lanes come by
// shuffles, the lower of a pair keeping the minimum; j = 2 and 1 (and
// merges 2 and 4) stay within a lane
__device__ __forceinline__ unsigned long long umin(unsigned long long a,
                                                   unsigned long long c) {
  return a < c ? a : c;
}
__device__ __forceinline__ unsigned long long umax(unsigned long long a,
                                                   unsigned long long c) {
  return a < c ? c : a;
}

__device__ __forceinline__ void segment_stages(unsigned long long* words,
                                               int n, int k0, int k1) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int seg = warp * SEGMENT; seg < n; seg += WARPS * SEGMENT) {
    unsigned long long w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = seg + 4 * lane + e;
      w[e] = i < n ? words[i] : ~0ull;
    }
    for (int k = k0; k <= k1; k <<= 1) {
      if (k >= 8 && k <= SEGMENT) {  // the mirror: lane ^ m, word 3 - e
        const int m = (k >> 2) - 1;
        const bool lower = (lane & (k >> 3)) == 0;
        unsigned long long o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] = __shfl_xor_sync(FULL, w[3 - e], m);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[e] = lower ? umin(w[e], o[e]) : umax(w[e], o[e]);
      } else if (k == 4) {
        order(w[0], w[3]);
        order(w[1], w[2]);
      } else if (k == 2) {
        order(w[0], w[1]);
        order(w[2], w[3]);
      }
      for (int j = k <= SEGMENT ? k >> 2 : SEGMENT >> 1; j >= 4; j >>= 1) {
        const int m = j >> 2;
        const bool lower = (lane & m) == 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const unsigned long long o = __shfl_xor_sync(FULL, w[e], m);
          w[e] = lower ? umin(w[e], o) : umax(w[e], o);
        }
      }
      if (k >= 8) {  // j = 2
        order(w[0], w[2]);
        order(w[1], w[3]);
      }
      if (k >= 4) {  // j = 1
        order(w[0], w[1]);
        order(w[2], w[3]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = seg + 4 * lane + e;
      if (i < n) words[i] = w[e];
    }
  }
}

// pack._spread
__device__ __forceinline__ int spread(int v) {
  v = (v | (v << 16)) & 0x030000FF;
  v = (v | (v << 8)) & 0x0300F00F;
  v = (v | (v << 4)) & 0x030C30C3;
  v = (v | (v << 2)) & 0x09249249;
  return v;
}

// pack.morton_order's key of a valid face: its bbox centre, quantised to
// 1024 steps a side, the two coordinates' bits interleaved
__device__ __forceinline__ int morton_key(const float* v) {
  const float cx =
      0.5f * (tmin(tmin(v[0], v[3]), v[6]) + tmax(tmax(v[0], v[3]), v[6]));
  const float cy =
      0.5f * (tmin(tmin(v[1], v[4]), v[7]) + tmax(tmax(v[1], v[4]), v[7]));
  const float fx = (cx + 1.0f) * 512.0f, fy = (cy + 1.0f) * 512.0f;
  const int qx = (int)(fx != fx ? fx : fminf(fmaxf(fx, 0.0f), 1023.0f));
  const int qy = (int)(fy != fy ? fy : fminf(fmaxf(fy, 0.0f), 1023.0f));
  return spread(qx) | (spread(qy) << 1);
}

// What the lists read of a face's packed column: its bbox rows and its
// fvalid row (fval, 1 or 0, zeroed for a point-degenerate face, whose
// edges all have length 0), pack.pack_faces' expressions
struct FaceBox {
  float xmin, xmax, ymin, ymax, valid;
};

__device__ __forceinline__ FaceBox face_box(const float* v, float fval) {
  FaceBox r;
  r.xmin = tmin(tmin(v[0], v[3]), v[6]);
  r.xmax = tmax(tmax(v[0], v[3]), v[6]);
  r.ymin = tmin(tmin(v[1], v[4]), v[7]);
  r.ymax = tmax(tmax(v[1], v[4]), v[7]);
  float e2sum = 0.0f;  // 0 + e2_0 is e2_0: the plain sum's order
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int a = 3 * k, b = 3 * ((k + 1) % 3);
    const float ex = v[a] - v[b], ey = v[a + 1] - v[b + 1];
    e2sum = e2sum + (ex * ex + ey * ey);
  }
  r.valid = fval * (e2sum <= 0.0f ? 0.0f : 1.0f);
  return r;
}

// pack.pack_faces' 48 geometry rows of one face (v: its 9 projected
// coordinates; fval: its fvalid as 1 or 0), written down its column (col
// = row 0 of the column, rows NC apart), in the plain version's order of
// operations
__device__ __forceinline__ void pack_geometry(const float* v, float fval,
                                              float* col, int NC) {
  const float x0 = v[0], y0 = v[1], z0 = v[2];
  const float x1 = v[3], y1 = v[4], z1 = v[5];
  const float x2 = v[6], y2 = v[7], z2 = v[8];
  const size_t ld = (size_t)NC;
  const FaceBox box = face_box(v, fval);
  col[R_BBOX * ld] = box.xmin;
  col[(R_BBOX + 1) * ld] = box.xmax;
  col[(R_BBOX + 2) * ld] = box.ymin;
  col[(R_BBOX + 3) * ld] = box.ymax;
  col[R_FVALID * ld] = box.valid;

  // barycentric inverse with the determinant clamp
  float inv[9] = {y1 - y2, x2 - x1, x1 * y2 - x2 * y1,
                  y2 - y0, x0 - x2, x2 * y0 - x0 * y2,
                  y0 - y1, x1 - x0, x0 * y1 - x1 * y0};
  float det = x2 * (y0 - y1) + x0 * (y1 - y2) + x1 * (y2 - y0);
  det = det > 0.0f ? clamp_lo(det, DET_EPS) : clamp_hi(det, -DET_EPS);
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    inv[i] = inv[i] / det;
    col[(R_INV + i) * ld] = inv[i];
  }

  // the Gram matrix's rows -> each edge's affine tv coefficients, its
  // vector, squared length and closed-form m
  const float xs[3] = {x0, x1, x2}, ys[3] = {y0, y1, y2};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int v0 = k, v1 = (k + 1) % 3;
    float a0[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float s0 = xs[v0] * xs[i] + ys[v0] * ys[i] + 1.0f;
      const float s1 = xs[v1] * xs[i] + ys[v1] * ys[i] + 1.0f;
      a0[i] = s0 - s1;
    }
    float den = a0[v0] - a0[v1];
    den = fabsf(den) < 1e-20f ? (den < 0.0f ? -1e-20f : 1e-20f) : den;
    col[(R_TV + 3 * k) * ld] =
        (inv[0] * a0[0] + inv[3] * a0[1] + inv[6] * a0[2]) / den;
    col[(R_TV + 3 * k + 1) * ld] =
        (inv[1] * a0[0] + inv[4] * a0[1] + inv[7] * a0[2]) / den;
    col[(R_TV + 3 * k + 2) * ld] =
        (inv[2] * a0[0] + inv[5] * a0[1] + inv[8] * a0[2] - a0[v1]) / den;
    const float ex = xs[v0] - xs[v1];
    const float ey = ys[v0] - ys[v1];
    col[(R_E + 2 * k) * ld] = ex;
    col[(R_E + 2 * k + 1) * ld] = ey;
    const float e2 = ex * ex + ey * ey;
    col[(R_E2 + k) * ld] = e2;
    const float c_over_e2 = det / clamp_lo(e2, 1e-20f);
    const float mx = -ey * c_over_e2;
    const float my = ex * c_over_e2;
    col[(R_M + 2 * k) * ld] = mx;
    col[(R_M + 2 * k + 1) * ld] = my;
    col[(R_MM + k) * ld] = mx * mx + my * my;
  }

  col[R_FRONT * ld] =
      (y2 - y0) * (x1 - x0) < (y1 - y0) * (x2 - x0) ? 1.0f : 0.0f;
  const float iz[3] = {1.0f / z0, 1.0f / z1, 1.0f / z2};
#pragma unroll
  for (int i = 0; i < 3; ++i) col[(R_IZ + i) * ld] = iz[i];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    col[(R_DZ + c) * ld] =
        inv[c] * iz[0] + inv[3 + c] * iz[1] + inv[6 + c] * iz[2];
}

// The tile's NDC rectangle of pack._tile_rects: its integers are exact in
// float32, and the division by the image size is, as PyTorch's CUDA
// division by a Python number, a multiplication by its float reciprocal
struct Rect {
  float xmin, xmax, ymin, ymax;
};

__device__ __forceinline__ Rect tile_rect(int t, int tiles_x, int is,
                                          int row0) {
  const float fis = (float)is;
  const float rcp = 1.0f / fis;
  const int c0 = (t % tiles_x) * TILE;
  const int r0 = row0 + (t / tiles_x) * TILE;
  Rect r;
  r.xmin = (2.0f * (float)c0 + 1.0f - fis) * rcp;
  r.xmax = (2.0f * (float)(c0 + TILE - 1) + 1.0f - fis) * rcp;
  r.ymax = (2.0f * (float)(is - 1 - r0) + 1.0f - fis) * rcp;
  r.ymin = (2.0f * (float)(is - 1 - (r0 + TILE - 1)) + 1.0f - fis) * rcp;
  return r;
}

// pack.tile_chunk_mask's test: does the chunk's bbox union + margin meet
// the tile's rectangle?
__device__ __forceinline__ bool hits(const Rect& r, const float4& cb,
                                     float m) {
  return (r.xmin <= cb.y + m) && (r.xmax >= cb.x - m) &&
         (r.ymin <= cb.w + m) && (r.ymax >= cb.z - m);
}

// One warp writes a list as compact_hits' stable argsort of (1 - hit)
// gives it: the n candidates that hit(i) admits in ascending order, then
// the others in ascending order; returns the number of hits
template <typename Hit>
__device__ __forceinline__ int write_list(int n, int* ids, Hit hit) {
  const int lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;
  int count = 0;
  for (int i0 = 0; i0 < n; i0 += 32)
    count += __popc(__ballot_sync(FULL, i0 + lane < n && hit(i0 + lane)));
  int nh = 0, nn = count;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    const bool in = i < n;
    const bool h = in && hit(i);
    const unsigned mh = __ballot_sync(FULL, h);
    const unsigned mn = __ballot_sync(FULL, in && !h);
    if (h)
      ids[nh + __popc(mh & below)] = i;
    else if (in)
      ids[nn + __popc(mn & below)] = i;
    nh += __popc(mh);
    nn += __popc(mn);
  }
  return count;
}

// prepass_sort: one block per batch element blockIdx.x.  fv [B, F, 9];
// fvalid [F] bytes or null; par [16].  Writes the first Fp columns of perm
// [B, NC] and, with LISTS, tile_counts [B, T], tile_ids [B, T, K],
// chunk_counts [B, K], chunk_ids [B, K, T].
template <bool LISTS>
__global__ void __launch_bounds__(SORT_THREADS)
    prepass_sort(const float* __restrict__ fv,
                 const unsigned char* __restrict__ fvalid,
                 const float* __restrict__ par, int* __restrict__ perm,
                 int* __restrict__ tile_counts, int* __restrict__ tile_ids,
                 int* __restrict__ chunk_counts, int* __restrict__ chunk_ids,
                 int F, int Fp, int NC, int FC, int image_size, int row0,
                 int tiles_x, int T) {
  extern __shared__ unsigned long long words[];  // [Fp + Fp % 2]
  const int N = sort_width(Fp);
  float4* cb = reinterpret_cast<float4*>(words + Fp + Fp % 2);  // [K]
  const int K = Fp / FC;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const float* fvb = fv + (size_t)b * F * 9;

  // the keys, each with its face index in the low word
  for (int f = tid; f < Fp; f += SORT_THREADS) {
    int key = 0x7FFFFFFF;
    if (f < F && (fvalid == nullptr || fvalid[f])) {
      float v[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) v[i] = fvb[(size_t)f * 9 + i];
      key = morton_key(v);
    }
    words[f] = ((unsigned long long)(unsigned)key << 32) | (unsigned)f;
  }
  __syncthreads();

  // bitonic sort, ascending, in the form whose every merge sorts upwards:
  // merge k first compares word lo of each k-block's lower half with its
  // mirror lo ^ (k - 1), then each half-cleaner j = k / 4 .. 1 compares lo
  // with lo + j.  Words past Fp count as larger than every key and are
  // never swapped in, so neither stored nor compared: the sort's work
  // follows Fp, not the power of two N.  Stages through shared memory
  // cost a barrier each and its bandwidth, so every comparator within 128
  // words runs in a warp's registers (segment_stages): merges 2 .. 128
  // whole, and each later merge's half-cleaners from j = 64 down
  segment_stages(words, Fp, 2, N < SEGMENT ? N : SEGMENT);
  __syncthreads();
  for (int k = 2 * SEGMENT; k <= N; k <<= 1) {
    for (int i = tid; i < N / 2; i += SORT_THREADS) {
      const int lo = insert_zero(i, k >> 1);
      compare_swap(words, lo, lo ^ (k - 1), Fp);
    }
    __syncthreads();
    for (int j = k >> 2; j >= SEGMENT; j >>= 1) {
      for (int i = tid; i < N / 2; i += SORT_THREADS) {
        const int lo = insert_zero(i, j);
        compare_swap(words, lo, lo + j, Fp);
      }
      __syncthreads();
    }
    segment_stages(words, Fp, k, k);
    __syncthreads();
  }
  for (int s = tid; s < Fp; s += SORT_THREADS)
    perm[(size_t)b * NC + s] = (int)(unsigned)(words[s] & 0xffffffffull);
  if (!LISTS) return;

  // each chunk's bbox union over its faces whose packed fvalid is set
  for (int k = warp; k < K; k += WARPS) {
    float xmin = INFINITY, xmax = -INFINITY, ymin = INFINITY,
          ymax = -INFINITY;
#pragma unroll 4
    for (int s = k * FC + lane; s < (k + 1) * FC; s += 32) {
      const int f = (int)(unsigned)(words[s] & 0xffffffffull);
      float v[9];
      float fval = 0.0f;
      if (f < F) {
#pragma unroll
        for (int i = 0; i < 9; ++i) v[i] = fvb[(size_t)f * 9 + i];
        fval = (fvalid == nullptr || fvalid[f]) ? 1.0f : 0.0f;
      } else {
#pragma unroll
        for (int i = 0; i < 9; ++i) v[i] = 0.0f;  // chunk padding
      }
      const FaceBox box = face_box(v, fval);
      const bool ok = box.valid > 0.0f;
      xmin = tmin(xmin, ok ? box.xmin : BIG);
      xmax = tmax(xmax, ok ? box.xmax : -BIG);
      ymin = tmin(ymin, ok ? box.ymin : BIG);
      ymax = tmax(ymax, ok ? box.ymax : -BIG);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      xmin = tmin(xmin, __shfl_xor_sync(FULL, xmin, o));
      xmax = tmax(xmax, __shfl_xor_sync(FULL, xmax, o));
      ymin = tmin(ymin, __shfl_xor_sync(FULL, ymin, o));
      ymax = tmax(ymax, __shfl_xor_sync(FULL, ymax, o));
    }
    if (lane == 0) cb[k] = make_float4(xmin, xmax, ymin, ymax);
  }
  __syncthreads();

  // the lists: per tile its chunks (the forward's), per chunk its tiles
  // (the backward's)
  const float m = par[P_MARGIN];
  for (int t = warp; t < T; t += WARPS) {
    const Rect r = tile_rect(t, tiles_x, image_size, row0);
    const int n = write_list(K, tile_ids + ((size_t)b * T + t) * K,
                             [&](int k) { return hits(r, cb[k], m); });
    if (lane == 0) tile_counts[(size_t)b * T + t] = n;
  }
  for (int k = warp; k < K; k += WARPS) {
    const float4 c = cb[k];
    const int n = write_list(
        T, chunk_ids + ((size_t)b * K + k) * T, [&](int t) {
          return hits(tile_rect(t, tiles_x, image_size, row0), c, m);
        });
    if (lane == 0) chunk_counts[(size_t)b * K + k] = n;
  }
}

// prepass_plan: one block per batch element blockIdx.x, pack.compact_plan
// of its Fp sorted faces over the T tiles of the band (slabs a tile, CAP =
// slabs x OCT_CAP octets; K = Fp / SLAB sorted chunks, K' = K + T slabs).
// fv [B, F, 9]; par [16]; perm [B, NC] (prepass_sort's first Fp columns).
// Writes oct_ids [B, T, CAP], tile_live [B, 2, T] (each tile's live
// octets, then its live slots: the slots whose fvalid compact_plan sets),
// tile_counts [B, T], tile_ids [B, T, max(K, slabs) + 1], chunk_counts
// [B, K'] and chunk_ids [B, K', T].
__global__ void __launch_bounds__(SORT_THREADS)
    prepass_plan(const float* __restrict__ fv, const float* __restrict__ par,
                 const int* __restrict__ perm, int* __restrict__ oct_ids,
                 int* __restrict__ tile_live, int* __restrict__ tile_counts,
                 int* __restrict__ tile_ids, int* __restrict__ chunk_counts,
                 int* __restrict__ chunk_ids, int F, int Fp, int NC,
                 int slabs, int image_size, int row0, int tiles_x, int T) {
  extern __shared__ float4 ob[];  // [noct] each octet's bbox union
  const int noct = Fp / OCT, K = Fp / SLAB, KW = (K + 31) / 32;
  const int CAP = slabs * OCT_CAP, Kcap = (K > slabs ? K : slabs) + 1;
  const int KK = K + T * slabs;
  int* valid_faces = reinterpret_cast<int*>(ob + noct);  // [noct]
  int* nslab = valid_faces + noct;                        // [T]
  // [T][KW]: the chunks each tile hits, kept for overflow tiles alone
  unsigned* chunk_bits = reinterpret_cast<unsigned*>(nslab + T);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const unsigned below = (1u << lane) - 1u;
  const float* fvb = fv + (size_t)b * F * 9;
  const int* pb = perm + (size_t)b * NC;

  // each octet's bbox union over its faces whose sorted fvalid is set
  // (+-1e30 for the others), a face a lane, 8 lanes an octet (Fp is a
  // multiple of SLAB, so every lane has a face)
  for (int s = tid; s < Fp; s += SORT_THREADS) {
    const int f = pb[s];
    const bool ok = f < F;
    float xmin = BIG, xmax = -BIG, ymin = BIG, ymax = -BIG;
    if (ok) {
      const float* v = fvb + (size_t)f * 9;
      xmin = tmin(tmin(v[0], v[3]), v[6]);
      xmax = tmax(tmax(v[0], v[3]), v[6]);
      ymin = tmin(tmin(v[1], v[4]), v[7]);
      ymax = tmax(tmax(v[1], v[4]), v[7]);
    }
#pragma unroll
    for (int o = 1; o < OCT; o <<= 1) {
      xmin = tmin(xmin, __shfl_xor_sync(FULL, xmin, o));
      xmax = tmax(xmax, __shfl_xor_sync(FULL, xmax, o));
      ymin = tmin(ymin, __shfl_xor_sync(FULL, ymin, o));
      ymax = tmax(ymax, __shfl_xor_sync(FULL, ymax, o));
    }
    const unsigned valid = __ballot_sync(FULL, ok);
    if (lane % OCT == 0) {
      ob[s / OCT] = make_float4(xmin, xmax, ymin, ymax);
      valid_faces[s / OCT] = __popc((valid >> lane) & ((1u << OCT) - 1u));
    }
  }
  __syncthreads();

  // a warp per tile: its octet hits (compact_plan's ov), 32 octets a
  // ballot, the two chunks of OCT_CAP octets each ballot covers
  const float m = par[P_MARGIN];
  for (int t = warp; t < T; t += WARPS) {
    const Rect r = tile_rect(t, tiles_x, image_size, row0);
    int n = 0;
    unsigned word = 0;
    for (int g = 0; g < noct; g += 32) {
      const int o = g + lane;
      const unsigned mask =
          __ballot_sync(FULL, o < noct && hits(r, ob[o], m));
      n += __popc(mask);
      const int k = g / OCT_CAP;  // even: chunks k and k + 1 share a word
      word |= ((mask & 0xffffu) != 0u ? 1u : 0u) << (k % 32);
      word |= ((mask >> 16) != 0u ? 1u : 0u) << ((k + 1) % 32);
      if ((k + 2) % 32 == 0 || k + 2 >= K) {
        if (lane == 0) chunk_bits[t * KW + k / 32] = word;
        word = 0;
      }
    }
    const bool overflow = n > CAP;
    const bool active = n > 0 && !overflow;
    const int ns = active ? (n + OCT_CAP - 1) / OCT_CAP : 0;
    // the first CAP of the stable argsort of (1 - hit): the hit octets in
    // ascending order, then the others; a live slab's faces are its hits'
    int* ids = oct_ids + ((size_t)b * T + t) * CAP;
    int nh = 0, nn = n, slots = 0;
    for (int g = 0; g < noct && (nh < CAP || nn < CAP); g += 32) {
      const int o = g + lane;
      const bool in = o < noct;
      const bool h = in && hits(r, ob[o], m);
      const unsigned mh = __ballot_sync(FULL, h);
      const unsigned mn = __ballot_sync(FULL, in && !h);
      const int ph = nh + __popc(mh & below), pn = nn + __popc(mn & below);
      if (h && ph < CAP) {
        ids[ph] = o;
        slots += valid_faces[o];
      } else if (in && !h && pn < CAP) {
        ids[pn] = o;
      }
      nh += __popc(mh);
      nn += __popc(mn);
    }
    slots = __reduce_add_sync(FULL, slots);
    if (lane == 0) {
      nslab[t] = ns;
      tile_live[(size_t)b * 2 * T + t] = active ? n : 0;
      tile_live[((size_t)b * 2 + 1) * T + t] = active ? slots : 0;
    }
    __syncwarp();
    // the forward's list: an overflow tile's hit chunks (compact_hits'
    // order), then zeros; any other tile its slab chunks K + t slabs + j
    int* list = tile_ids + ((size_t)b * T + t) * Kcap;
    const unsigned* bits = chunk_bits + t * KW;
    int count = ns;
    if (overflow) {
      count = write_list(K, list, [&](int k) {
        return ((bits[k / 32] >> (k % 32)) & 1u) != 0u;
      });
      for (int j = K + lane; j < Kcap; j += 32) list[j] = 0;
    } else {
      for (int j = lane; j < Kcap; j += 32) list[j] = K + t * slabs + j;
    }
    if (lane == 0) tile_counts[(size_t)b * T + t] = count;
    __syncwarp();
    // the sorted chunks serve the overflow tiles alone
    if (!overflow)
      for (int w = lane; w < KW; w += 32) chunk_bits[t * KW + w] = 0u;
  }
  __syncthreads();

  // the backward's lists over the K' chunks: a sorted chunk's overflow
  // tiles that it hits, then the other tiles, in ascending order; slab
  // chunk K + t slabs + j lists tile t in every entry, counted while j is
  // below the tile's slabs
  for (int k = warp; k < KK; k += WARPS) {
    int* list = chunk_ids + ((size_t)b * KK + k) * T;
    int count;
    if (k < K) {
      count = write_list(T, list, [&](int t) {
        return ((chunk_bits[t * KW + k / 32] >> (k % 32)) & 1u) != 0u;
      });
    } else {
      const int t = (k - K) / slabs;
      for (int i = lane; i < T; i += 32) list[i] = t;
      count = (k - K) % slabs < nslab[t] ? 1 : 0;
    }
    if (lane == 0) chunk_counts[(size_t)b * KK + k] = count;
  }
}

// prepass_pack: a thread per column blockIdx.y * PACK_THREADS +
// threadIdx.x of batch element blockIdx.x.  fv [B, F, 9]; tex [B, F, TS,
// 3] (read for ntex > 0: its first ntex texels or vertex colours); fvalid
// [F] bytes or null; perm [B, NC] (prepass_sort's first Fp columns).
// Columns below Fp are the sorted faces; with SLOTS, column Fp + 8 g + i is
// face i of octet oct_ids [B, T CAP] entry g, its slot live while g % CAP
// is below tile_live [B, 2, T]'s live octets of tile g / CAP, and the
// column's perm entry is written too.  Writes packed [B, NI, NC].
template <bool SLOTS>
__global__ void __launch_bounds__(PACK_THREADS)
    prepass_pack(const float* __restrict__ fv,
                 const float* __restrict__ tex,
                 const unsigned char* __restrict__ fvalid,
                 const int* __restrict__ oct_ids,
                 const int* __restrict__ tile_live, int* __restrict__ perm,
                 float* __restrict__ packed, int F, int Fp, int NC, int NI,
                 int TS, int ntex, int CAP, int T) {
  const int b = blockIdx.x;
  const int c = blockIdx.y * PACK_THREADS + threadIdx.x;
  if (c >= NC) return;
  int s = c;
  bool live = true;
  if (SLOTS && c >= Fp) {
    const int g = (c - Fp) / OCT;
    s = oct_ids[(size_t)b * T * CAP + g] * OCT + (c - Fp) % OCT;
    live = g % CAP < tile_live[(size_t)b * 2 * T + g / CAP];
  }
  const int f = perm[(size_t)b * NC + s];
  if (SLOTS && c >= Fp) perm[(size_t)b * NC + c] = f;
  float v[9];
  float fval = 0.0f;
  if (f < F) {
    const float* fvf = fv + ((size_t)b * F + f) * 9;
#pragma unroll
    for (int i = 0; i < 9; ++i) v[i] = fvf[i];
    fval = live && (fvalid == nullptr || fvalid[f]) ? 1.0f : 0.0f;
  } else {
#pragma unroll
    for (int i = 0; i < 9; ++i) v[i] = 0.0f;  // chunk padding
  }
  float* col = packed + (size_t)b * NI * NC + c;
  pack_geometry(v, fval, col, NC);
  // texel (or vertex) t, channel c at row R_TEX + 3 t + c, then zeros
  if (ntex > 0) {
    const float* tf = tex + ((size_t)b * F + (f < F ? f : 0)) * TS * 3;
    for (int r = 0; r < 3 * ntex; ++r)
      col[(size_t)(R_TEX + r) * NC] = f < F ? tf[r] : 0.0f;
  }
  for (int r = R_TEX + 3 * ntex; r < NI; ++r) col[(size_t)r * NC] = 0.0f;
}

// Opts a kernel into smem bytes of dynamic shared memory where they pass
// the static budget
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= STATIC_SMEM) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// The tiles of image rows [row0, row0 + height): their count T (0 where the
// band is not inside the image) and the tiles a row, tiles_x
int band_tiles(int image_size, int row0, int height, int* tiles_x) {
  if (row0 < 0 || height < 1 || row0 + height > image_size) return 0;
  *tiles_x = (image_size + TILE - 1) / TILE;
  return *tiles_x * ((height + TILE - 1) / TILE);
}

// A compacted prepass's shape: B batch elements of F faces padded to Fp,
// a multiple of SLAB that the sort holds, and slabs a tile (1 to Fp /
// SLAB) over the T tiles of the band.  Returns T (0: not such a shape)
// and sets NC = Fp + T slabs SLAB, the packed columns (the sorted faces,
// then the slots).
int compact_shape(int B, int F, int Fp, int slabs, int image_size, int row0,
                  int height, int* tiles_x, int* NC) {
  if (B < 1 || F < 1 || Fp % SLAB != 0 || F > Fp || F <= Fp - SLAB ||
      Fp > SORT_CAP || prepass_smem(Fp, SLAB) > SMEM_CAP || slabs < 1 ||
      slabs > Fp / SLAB)
    return 0;
  const int T = band_tiles(image_size, row0, height, tiles_x);
  *NC = Fp + T * slabs * SLAB;
  return T;
}

}  // namespace

// C interface, loaded with ctypes (gendr_tpu_torch/_build.py).  Each entry
// launches on `stream` and returns the launches' error (0 on success;
// cudaErrorInvalidValue for a shape it does not take); none synchronizes
// or allocates.
//
// gendr_prepass, the uncompacted prepass: prepass_sort, then prepass_pack.
// F faces padded to Fp (a multiple of FC, at most SORT_CAP); ntex texture
// rows' texels (0: geometry rows alone); the lists cover the tiles of
// image rows [row0, row0 + height).
extern "C" int gendr_prepass(const float* fv, const float* tex,
                             const unsigned char* fvalid, const float* par,
                             float* packed, int* perm, int* tile_counts,
                             int* tile_ids, int* chunk_counts, int* chunk_ids,
                             int B, int F, int Fp, int FC, int NI, int TS,
                             int ntex, int image_size, int row0, int height,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = FC >= 1 ? prepass_smem(Fp, FC) : 0;
  int tiles_x = 0;
  const int T = band_tiles(image_size, row0, height, &tiles_x);
  if (B < 1 || F < 1 || FC < 1 || Fp % FC != 0 || F > Fp ||
      F <= Fp - FC || Fp > SORT_CAP || smem > SMEM_CAP ||
      NI < R_TEX + 3 * ntex || ntex < 0 || (ntex > 0 && TS < ntex) || T < 1)
    return (int)cudaErrorInvalidValue;
  err = allow_smem(prepass_sort<true>, smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  prepass_sort<true><<<B, SORT_THREADS, smem, s>>>(
      fv, fvalid, par, perm, tile_counts, tile_ids, chunk_counts, chunk_ids,
      F, Fp, Fp, FC, image_size, row0, tiles_x, T);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B, (Fp + PACK_THREADS - 1) / PACK_THREADS);
  prepass_pack<false><<<grid, PACK_THREADS, 0, s>>>(
      fv, tex, fvalid, nullptr, nullptr, perm, packed, F, Fp, Fp, NI, TS,
      ntex, 0, 0);
  return (int)cudaGetLastError();
}

// The compacted prepass, one launch each, so that the caller can mark the
// plan's phase between them: of B batch elements of F faces (no fvalid:
// compaction never runs with one) padded to Fp, slabs a tile over the
// tiles of image rows [row0, row0 + height) (compact_shape), NC = Fp + T
// slabs 128 packed columns.  gendr_compact_sort: prepass_sort without its
// lists, perm's first Fp columns ([B, NC]).
extern "C" int gendr_compact_sort(const float* fv, int* perm, int B, int F,
                                  int Fp, int slabs, int image_size,
                                  int row0, int height, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int tiles_x = 0, NC = 0;
  const int T = compact_shape(B, F, Fp, slabs, image_size, row0, height,
                              &tiles_x, &NC);
  if (T < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = prepass_smem(Fp, SLAB);
  err = allow_smem(prepass_sort<false>, smem);
  if (err != cudaSuccess) return (int)err;
  prepass_sort<false><<<B, SORT_THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      fv, nullptr, nullptr, perm, nullptr, nullptr, nullptr, nullptr, F, Fp,
      NC, SLAB, image_size, row0, tiles_x, T);
  return (int)cudaGetLastError();
}

// gendr_compact_plan: prepass_plan, from perm's first Fp columns and the
// margin par[P_MARGIN]: oct_ids [B, T slabs 16], tile_live [B, 2, T]
// (for gendr_compact_pack and the plan's census), tile_counts [B, T],
// tile_ids [B, T, max(K, slabs) + 1], chunk_counts [B, K + T slabs] and
// chunk_ids [B, K + T slabs, T] (K = Fp / 128).
extern "C" int gendr_compact_plan(const float* fv, const float* par,
                                  const int* perm, int* oct_ids,
                                  int* tile_live, int* tile_counts,
                                  int* tile_ids, int* chunk_counts,
                                  int* chunk_ids, int B, int F, int Fp,
                                  int slabs, int image_size, int row0,
                                  int height, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int tiles_x = 0, NC = 0;
  const int T = compact_shape(B, F, Fp, slabs, image_size, row0, height,
                              &tiles_x, &NC);
  const size_t smem = plan_smem(Fp, T);
  if (T < 1 || smem > SMEM_CAP) return (int)cudaErrorInvalidValue;
  err = allow_smem(prepass_plan, smem);
  if (err != cudaSuccess) return (int)err;
  prepass_plan<<<B, SORT_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      fv, par, perm, oct_ids, tile_live, tile_counts, tile_ids, chunk_counts,
      chunk_ids, F, Fp, NC, slabs, image_size, row0, tiles_x, T);
  return (int)cudaGetLastError();
}

// gendr_compact_pack: prepass_pack over all NC columns, the sorted faces'
// and the slots' (perm's slot columns too), from gendr_compact_plan's
// oct_ids and tile_live: packed [B, NI, NC]; tex and ntex as gendr_prepass
// takes them.
extern "C" int gendr_compact_pack(const float* fv, const float* tex,
                                  const int* oct_ids, const int* tile_live,
                                  int* perm, float* packed, int B, int F,
                                  int Fp, int NI, int TS, int ntex,
                                  int slabs, int image_size, int row0,
                                  int height, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int tiles_x = 0, NC = 0;
  const int T = compact_shape(B, F, Fp, slabs, image_size, row0, height,
                              &tiles_x, &NC);
  if (T < 1 || NI < R_TEX + 3 * ntex || ntex < 0 || (ntex > 0 && TS < ntex))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B, (NC + PACK_THREADS - 1) / PACK_THREADS);
  prepass_pack<true><<<grid, PACK_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      fv, tex, nullptr, oct_ids, tile_live, perm, packed, F, Fp, NC, NI, TS,
      ntex, slabs * OCT_CAP, T);
  return (int)cudaGetLastError();
}

extern "C" const char* gendr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

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
//
// A launch runs a whole table of cases (a probe phase: the 111 cases of the
// three tools, 1.67 M elements).  A case is an op, its element count, the
// offset of its x (and of its output) and of its y in one packed input
// buffer, and its parameters.  ulp_elementwise takes the table by value, as
// a kernel argument (__grid_constant__, so indexing it reads the parameter
// space and copies nothing to local memory), at most TABLE_CASES cases a
// launch; ulp_param_vector reads it from device memory inside the kernel,
// the way the render kernels read `par`.
//
// What bounds them on the card: bytes, nominally (x and y read, the
// output written; a phase moves 17.9 MB, 0.0053 ms at 3.35 TB/s), but a
// few ops take thousands of instructions an element (the Kummer series'
// 31 IEEE divisions without contraction), and the phase's instructions
// take longer than its bytes.  One case a launch, as the kernels first ran,
// moved 64-196 KB and cost a launch's latency each; the table puts the
// phase in one launch.  A block takes BLOCK_ELEMS consecutive elements of
// one case, so the op's switch is uniform in a block, one element a thread
// (a thread's elements would run one after another, and a block of the
// heavy ops would then make the launch's tail).  The cases' x follow each
// other in block units, each rounded up to BLOCK_ELEMS alone (a case of
// 8192 elements takes 32 blocks beside one of 16384 taking 64, no block
// idle): a block finds its case in the table by a search.

#include <cstring>

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

// one case of a table (tools/_ulp.py CASE_DTYPE)
struct ProbeCase {
  int op;  // OP_<NAME>
  int n;   // elements
  int x;   // offset of x in the inputs and of the output in out: a multiple
           // of BLOCK_ELEMS, the cases' x in order, each rounded up to
           // BLOCK_ELEMS (table_blocks checks it)
  int y;   // offset of y in the inputs (x's where the op reads one input)
  float q[NQ];
};
static_assert(sizeof(ProbeCase) == 36, "tools/_ulp.py CASE_DTYPE");

constexpr int BLOCK_ELEMS = PROBE_THREADS;  // tools/_ulp.py
// cases of a table passed by value: with the inputs and the output it fills
// the 4 KB of a kernel's parameters (tools/_ulp.py TABLE_CASES)
constexpr int TABLE_CASES = 112;

struct CaseTable {
  int count;   // cases in c
  int block0;  // c[0].x / BLOCK_ELEMS: the launch's first block
  ProbeCase c[TABLE_CASES];
};
static_assert(2 * sizeof(void*) + sizeof(CaseTable) <= 4096,
              "ulp_elementwise's parameters over the 4 KB limit");

// The case of the block whose first element is start: the last whose x is
// at most start (the x's ascend).  In the by-value table, a binary search
// every thread makes alike: each read is one address for the whole warp, a
// broadcast from the parameter space, where a read a thread would serialize.
__device__ __forceinline__ int search_case(
    const ProbeCase (&cases)[TABLE_CASES], int count, int start) {
  int c = 0, hi = count;  // cases[c].x <= start < cases[hi].x
  while (hi - c > 1) {
    const int mid = (c + hi) >> 1;
    if (cases[mid].x <= start)
      c = mid;
    else
      hi = mid;
  }
  return c;
}

// In device memory, a thread reads one case's x (one round trip for the
// block, where a binary search would wait on seven) and the block counts
// those at most start.
__device__ __forceinline__ int count_case(const ProbeCase* cases, int count,
                                          int start) {
  int c = -1;
  for (int i0 = 0; i0 < count; i0 += PROBE_THREADS) {
    const int i = i0 + (int)threadIdx.x;
    c += __syncthreads_count(i < count && cases[i].x <= start);
  }
  return c;
}

// The block's first element: its index in the launch's table block0 on.
__device__ __forceinline__ int block_start(int block0) {
  return (block0 + (int)blockIdx.x) * BLOCK_ELEMS;
}

// A block's share of a table: BLOCK_ELEMS consecutive elements of its
// case c from start, one a thread (a case's op may take thousands of
// instructions an element, the Kummer series' 31 divisions, and a thread's
// elements would run one after another).  cases is the by-value table or a
// device pointer.
template <class Cases>
__device__ __forceinline__ void probe_block(const Cases& cases, int c,
                                            int start,
                                            const float* __restrict__ in,
                                            float* __restrict__ out) {
  const int i = start - cases[c].x + (int)threadIdx.x;
  if (i >= cases[c].n) return;
  out[cases[c].x + i] = probe_op(
      cases[c].op, in[cases[c].x + i], in[cases[c].y + i],
      [&](int j) { return cases[c].q[j]; });
}

// out[x + i] = op(in[x + i], in[y + i]) for every case of the table; the
// cases and their parameters arrive by value
__global__ void __launch_bounds__(PROBE_THREADS) ulp_elementwise_kernel(
    const float* __restrict__ in, float* __restrict__ out,
    const __grid_constant__ CaseTable table) {
  const int start = block_start(table.block0);
  probe_block(table.c, search_case(table.c, table.count, start), start, in,
              out);
}

// the same, the table read from the device array cases [count] inside the
// kernel, as the render kernels read par
__global__ void __launch_bounds__(PROBE_THREADS) ulp_param_vector_kernel(
    const ProbeCase* __restrict__ cases, int count, int block0,
    const float* __restrict__ in, float* __restrict__ out) {
  const int start = block_start(block0);
  probe_block(cases, count_case(cases, count, start), start, in, out);
}

// The blocks cases [0, count) take, or -1 where the table is not one the
// kernels read: every op known, n >= 1, the x's in order from a multiple of
// BLOCK_ELEMS, each rounded up to BLOCK_ELEMS, and every case inside the
// n_in inputs and the n_out outputs.
int table_blocks(const ProbeCase* cases, int count, int n_in, int n_out) {
  if (count < 1 || cases[0].x < 0 || cases[0].x % BLOCK_ELEMS) return -1;
  long long next = cases[0].x;
  for (int i = 0; i < count; ++i) {
    const ProbeCase& c = cases[i];
    if (c.op < 0 || c.op >= NUM_OPS || c.n < 1 || c.x != next || c.y < 0 ||
        (long long)c.x + c.n > n_out || (long long)c.x + c.n > n_in ||
        (long long)c.y + c.n > n_in)
      return -1;
    next += ((long long)c.n + BLOCK_ELEMS - 1) / BLOCK_ELEMS * BLOCK_ELEMS;
  }
  return (int)((next - cases[0].x) / BLOCK_ELEMS);
}

}  // namespace

// C interface, loaded with ctypes (gendr_tpu_torch/_build.py).  Each
// launches on `stream` and returns the launch's error (0 on success);
// neither synchronizes nor allocates.  table [count] is the case table
// (ProbeCase rows) on the host; in holds n_in floats, out n_out, both on
// the card.  The table is a void pointer: a type of the anonymous
// namespace in the signature would give the function internal linkage.

// ulp_elementwise over the table in launches of TABLE_CASES cases at most
extern "C" int gendr_ulp_elementwise(const void* table_rows, int count,
                                     const float* in, int n_in, float* out,
                                     int n_out, int device, void* stream) {
  const ProbeCase* cases = static_cast<const ProbeCase*>(table_rows);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (table_blocks(cases, count, n_in, n_out) < 0)
    return (int)cudaErrorInvalidValue;
  for (int first = 0; first < count; first += TABLE_CASES) {
    CaseTable table;
    table.count = count - first < TABLE_CASES ? count - first : TABLE_CASES;
    table.block0 = cases[first].x / BLOCK_ELEMS;
    memcpy(table.c, cases + first, table.count * sizeof(ProbeCase));
    ulp_elementwise_kernel<<<table_blocks(table.c, table.count, n_in, n_out),
                             PROBE_THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(in, out,
                                                                  table);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// ulp_param_vector over the table in one launch: device_table is the same
// table on the card, which the kernel reads
extern "C" int gendr_ulp_param_vector(const void* table_rows,
                                      const void* device_table, int count,
                                      const float* in, int n_in, float* out,
                                      int n_out, int device, void* stream) {
  const ProbeCase* cases = static_cast<const ProbeCase*>(table_rows);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = table_blocks(cases, count, n_in, n_out);
  if (blocks < 0) return (int)cudaErrorInvalidValue;
  ulp_param_vector_kernel<<<blocks, PROBE_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const ProbeCase*>(device_table), count,
      cases[0].x / BLOCK_ELEMS, in, out);
  return (int)cudaGetLastError();
}

extern "C" const char* gendr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Batched small-SPD solve x = M^-1 b by Cholesky.
//
// Replaces the TPU kernel _chol_solve_kernel (koopman_realizations_tpu/
// ops/pallas/batch_chol.py:28, called at :83 by solve_spd_pallas), the
// ops layer's public batched SPD solve: M (B, n, n) and b (B, n) in, x
// (B, n) out, f32.  The arithmetic is the TPU kernel's: per column an
// exact square root and one IEEE reciprocal, the column scaled by it and
// a rank-1 downdate of the rest (only the lower triangle is read and
// formed; the TPU kernel's full-width columns agree on it), no added
// regularization; then forward substitution L y = b and backward
// substitution L^T x = y, each row's sum subtracted in ascending column
// order and divided by the diagonal (IEEE divides).  n is the
// compile-time KM_N, one build per n.
//
// Bound on an H100: at the shapes chip_smoke.py runs (n=12 and n=27,
// B=65536) ~n^3/3 operations a system on 4 n (n + 2) bytes: ~1.4 and
// ~2.7 operations a byte, under the card's ~20 f32 operations a byte, so
// the bytes, once the loads are coalesced.
//
// Two designs, the plan's KC_GROUP (ops/kernels/batch_chol.py:CholPlan;
// each one's times, and those of the designs tried and dropped, in
// PERF.md §6):
// - 0, direct: a thread a system, read straight from its batch-major rows
//   (a warp's 32 loads fall in 32 systems, n^2 floats apart; the sectors
//   they share with the next rows are reused through L1), the factor in
//   registers -- at n=27 it would sit in thread-local memory.  Every n
//   but 27: at n=12 the factor fits the registers, and it ran fastest.
// - G = KC_GROUP > 1, staged: a block's KC_SPAN systems are one contiguous
//   span of M (32 systems at n=27: 93 KB); the block copies it, and the
//   span's b, into shared memory with 16-byte cp.async copies coalesced
//   over the threads, in a persistent loop over spans, and stores x from
//   shared memory in 16-byte stores.  The systems lie KC_STRIDE floats
//   apart, odd at n=27 (729), so threads reading the same entry of their
//   systems hit distinct banks.  A group of G threads a system, thread g
//   owning rows g, g + G, ... of L in registers (KC_O of them), the factor
//   column by column with the pivot's reciprocal and each L[k][j]
//   shuffled from its owner, the forward substitution a column at a time,
//   the backward row by row (the ascending sum) on every thread of the
//   group.  The rows leave shared memory as the solve starts, so the next
//   span's copies go out at once, into the same buffer, which holds one
//   round of the block's groups.  The n=27 build: 4 threads a system, 7
//   rows each, 4 warps a block, two blocks an SM.
// Built with -fmad=false, both designs' results are bitwise equal
// (kernel_ab.py).
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

#ifndef KM_N
#error "batch_chol.cu needs the generated configuration header"
#endif

struct BatchCholArgs {
  const float* M;      // (B, KM_N, KM_N) SPD systems
  const float* b;      // (B, KM_N) right-hand sides
  float* x;            // (B, KM_N) solutions
  long long B;
  int grid;            // staged design: blocks of the persistent grid
};

#if KC_GROUP == 0
// ------------------------------------------------ direct: a thread a system

__global__ void __launch_bounds__(KC_THREADS)
batch_chol_kernel(const BatchCholArgs a) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.B) return;
  const float* M = a.M + lane * (KM_N * KM_N);
  float L[KM_N][KM_N];
#pragma unroll
  for (int i = 0; i < KM_N; ++i) {
#pragma unroll
    for (int k = 0; k <= i; ++k) L[i][k] = M[i * KM_N + k];
  }
  // factor in place: column j scaled by 1 / sqrt of its pivot, then the
  // rank-1 downdate of the trailing lower triangle
#pragma unroll
  for (int j = 0; j < KM_N; ++j) {
    const float d = __fdiv_rn(1.0f, __fsqrt_rn(L[j][j]));
#pragma unroll
    for (int i = j; i < KM_N; ++i) L[i][j] = L[i][j] * d;
#pragma unroll
    for (int i = j + 1; i < KM_N; ++i) {
#pragma unroll
      for (int k = j + 1; k <= i; ++k) L[i][k] -= L[i][j] * L[k][j];
    }
  }
  float r[KM_N];
#pragma unroll
  for (int i = 0; i < KM_N; ++i) {          // L y = b
    float acc = a.b[lane * KM_N + i];
#pragma unroll
    for (int k = 0; k < i; ++k) acc -= L[i][k] * r[k];
    r[i] = __fdiv_rn(acc, L[i][i]);
  }
#pragma unroll
  for (int i = KM_N - 1; i >= 0; --i) {     // L^T x = y
    float acc = r[i];
#pragma unroll
    for (int k = i + 1; k < KM_N; ++k) acc -= L[k][i] * r[k];
    r[i] = __fdiv_rn(acc, L[i][i]);
  }
#pragma unroll
  for (int i = 0; i < KM_N; ++i) a.x[lane * KM_N + i] = r[i];
}

extern "C" int km_batch_chol(const BatchCholArgs* args, void* stream) {
  if (args->B <= 0) return 0;
  const unsigned grid = (unsigned)((args->B + KC_THREADS - 1) / KC_THREADS);
  batch_chol_kernel<<<grid, KC_THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

#else
// ------------------------- a group a system, spans staged in shared memory

#define KC_NN (KM_N * KM_N)
#define KC_BX (KC_SPAN * KC_STRIDE)             // the span's b
#define KC_XS (KC_SPAN * (KC_STRIDE + KM_N))    // the span's x
#define KC_O ((KM_N + KC_GROUP - 1) / KC_GROUP)   // rows a thread

__device__ __forceinline__ float4* kc_smem_base() {
  extern __shared__ float4 kc_smem[];
  return kc_smem;
}

// nf floats from src (device memory) to dst (shared memory), both 16-byte
// aligned: 16-byte cp.async copies over the block's threads, then the
// last nf % 4 floats one at a time.
__device__ __forceinline__ void copy_in(float* dst, const float* src,
                                        int nf) {
  const int n4 = nf >> 2;
  for (int c = threadIdx.x; c < n4; c += KC_THREADS)
    __pipeline_memcpy_async(dst + 4 * c, src + 4 * c, 16);
  for (int e = 4 * n4 + threadIdx.x; e < nf; e += KC_THREADS)
    __pipeline_memcpy_async(dst + e, src + e, 4);
}

// The copies of span's count systems and their b into shared memory.
__device__ __forceinline__ void stage(const BatchCholArgs& a, long long span,
                                      float* buf) {
  const long long s0 = span * KC_SPAN;
  const int count = (int)min((long long)KC_SPAN, a.B - s0);
#if KC_STRIDE == KC_NN
  copy_in(buf, a.M + s0 * KC_NN, count * KC_NN);
#else
  // n^2 a multiple of 4: each system's 16-byte pieces to its padded slot
  constexpr int CPS = KC_NN / 4;
  for (int c = threadIdx.x; c < count * CPS; c += KC_THREADS) {
    const int s = c / CPS, w = c - s * CPS;
    __pipeline_memcpy_async(buf + s * KC_STRIDE + 4 * w,
                            a.M + (s0 + s) * KC_NN + 4 * w, 16);
  }
#endif
  copy_in(buf + KC_BX, a.b + s0 * KM_N, count * KM_N);
}

// One system by its group, thread g owning rows g, g + G, ... (G =
// KC_GROUP) of L in registers, and their entries of b (acc); every
// thread of the group runs every shuffle.  x leaves to xs (null: the
// system is past the batch).
__device__ __forceinline__ void solve_system(float (&r)[KC_O][KM_N],
                                             float (&acc)[KC_O], int g,
                                             float* xs) {
  constexpr unsigned ALL = 0xffffffffu;
#pragma unroll
  for (int j = 0; j < KM_N; ++j) {          // the factor, column by column
    const float d = __fdiv_rn(1.0f, __fsqrt_rn(__shfl_sync(
        ALL, r[j / KC_GROUP][j], j % KC_GROUP, KC_GROUP)));
#pragma unroll
    for (int o = 0; o < KC_O; ++o)
      if (g + KC_GROUP * o >= j) r[o][j] = r[o][j] * d;
#pragma unroll
    for (int k = j + 1; k < KM_N; ++k) {
      const float lkj =
          __shfl_sync(ALL, r[k / KC_GROUP][j], k % KC_GROUP, KC_GROUP);
#pragma unroll
      for (int o = 0; o < KC_O; ++o)
        if (g + KC_GROUP * o >= k) r[o][k] -= r[o][j] * lkj;
    }
  }
  float y[KM_N];
#pragma unroll
  for (int k = 0; k < KM_N; ++k) {          // L y = b, a column at a time
    y[k] = __shfl_sync(ALL, __fdiv_rn(acc[k / KC_GROUP], r[k / KC_GROUP][k]),
                       k % KC_GROUP, KC_GROUP);
#pragma unroll
    for (int o = 0; o < KC_O; ++o)
      if (g + KC_GROUP * o > k) acc[o] -= r[o][k] * y[k];
  }
#pragma unroll
  for (int i = KM_N - 1; i >= 0; --i) {     // L^T x = y, on every thread
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < KM_N; ++k)
      s -= __shfl_sync(ALL, r[k / KC_GROUP][i], k % KC_GROUP, KC_GROUP) * y[k];
    y[i] = __fdiv_rn(s, __shfl_sync(ALL, r[i / KC_GROUP][i], i % KC_GROUP,
                                    KC_GROUP));
  }
  if (xs == nullptr) return;
#pragma unroll
  for (int i = 0; i < KM_N; ++i)
    if (g == i % KC_GROUP) xs[i] = y[i];
}

// The block's spans blockIdx.x, + gridDim.x, ..., a group a system (one
// round: KC_SPAN groups): each span's rows and b into registers, then --
// shared memory free -- the next span's copies go out while the groups
// factor, and x is stored from shared memory in 16-byte stores.
__global__ void __launch_bounds__(KC_THREADS)
batch_chol_kernel(const BatchCholArgs a) {
  float* sm = reinterpret_cast<float*>(kc_smem_base());
  float* xs = sm + KC_XS;
  const long long spans = (a.B + KC_SPAN - 1) / KC_SPAN;
  const int grp = threadIdx.x / KC_GROUP, g = threadIdx.x % KC_GROUP;
  long long span = blockIdx.x;             // the grid is at most spans
  stage(a, span, sm);
  __pipeline_commit();
#pragma unroll 1
  for (; span < spans; span += gridDim.x) {
    const long long next = span + gridDim.x, s0 = span * KC_SPAN;
    const int count = (int)min((long long)KC_SPAN, a.B - s0);
    __pipeline_wait_prior(0);
    __syncthreads();
    const float* Ms = sm + grp * KC_STRIDE;
    float r[KC_O][KM_N], acc[KC_O];
#pragma unroll
    for (int o = 0; o < KC_O; ++o) {
      const int row = g + KC_GROUP * o;
#pragma unroll
      for (int k = 0; k < KM_N; ++k)
        r[o][k] = (k <= row && row < KM_N) ? Ms[row * KM_N + k] : 0.0f;
      acc[o] = row < KM_N ? sm[KC_BX + grp * KM_N + row] : 0.0f;
    }
    __syncthreads();
    if (next < spans) stage(a, next, sm);
    __pipeline_commit();
    solve_system(r, acc, g, grp < count ? xs + grp * KM_N : nullptr);
    __syncthreads();
    float* x = a.x + s0 * KM_N;
    const int nf = count * KM_N, n4 = nf >> 2;
    for (int c = threadIdx.x; c < n4; c += KC_THREADS)
      reinterpret_cast<float4*>(x)[c] = reinterpret_cast<const float4*>(xs)[c];
    for (int e = 4 * n4 + threadIdx.x; e < nf; e += KC_THREADS) x[e] = xs[e];
  }
}

extern "C" int km_batch_chol(const BatchCholArgs* args, void* stream) {
  if (args->B <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      batch_chol_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      KC_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const long long spans = (args->B + KC_SPAN - 1) / KC_SPAN;
  const unsigned grid =
      (unsigned)(spans < args->grid ? spans : (long long)args->grid);
  batch_chol_kernel<<<grid, KC_THREADS, KC_SMEM_BYTES,
                      (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
#endif

// Tile-stream probes for Hopper (sm_90a): the three kernels of the DMA-stream
// benchmark, which split the packed SpMM's time into the pure stream of its
// tiles, the per-tile products, and what explicit asynchronous copies buy.
//
// Replaces the three Pallas TPU kernels of benchmarks/dma_stream_bench.py:
//   :65  make_stream      (body stream_kernel :52-63)
//   :83  make_stream_dot  (body :90-110)
//   :130 make_manual      (body :131-155)
// All three read vals (S·CH, 128) f32, a stream of S chunks of CH rows, and
// return an (8, 128) f32 result from an (8, 128) seed:
//   stream, manual  out[r][c] = seed[r][c] + Σ_i vals[i][c]
//   stream_dot      out[r][c] = seed[r][c] + Σ over every chunk, every tile
//                   u of its U tiles (bm, 128), of the (bm, 8) product
//                   tile · xtᵀ — FP32 fused multiply-adds, never TF32 (the
//                   TPU body's Precision.HIGHEST).
//
// What bounds them: the bytes of vals, read exactly once (stream_dot does
// 8 FMAs per value, 32 per 16-byte load, far below the FMA units' rate).
// The TPU ran its grid in order on one core and carried the sum in VMEM
// scratch from step to step; here the steps run in parallel, so each CTA
// writes its own partial and a second pass adds the partials:
//   - stream, stream_dot: one CTA per chunk (grid S), the twin of one
//     Pallas grid step.  Thread (row lane l of 8, 16-byte column group q of
//     32) reads rows l, l+8, ... of its chunk with 16-byte streaming loads
//     (__ldcs), kUnroll of them in flight, straight into registers — no
//     staging in shared memory, whatever the chunk's size.  stream_dot
//     keeps the thread's 32 values of xt (rows 0-7, its 4 columns) in
//     registers, since a thread's columns never change.
//   - manual: the TPU did the whole stream in ONE grid step with a 2-slot
//     VMEM ring filled by make_async_copy.  One CTA would use one SM of 132,
//     so the twin is a persistent grid: one CTA per SM (no more than S),
//     each walking a contiguous range of whole chunks through a 2-slot
//     shared-memory ring filled by 1-D bulk asynchronous copies
//     (cp.async.bulk, the copy engine) that signal an mbarrier per slot.
//     A TPU slot held a whole chunk (up to 512 KB); a ring stage here is
//     kStageRows rows (64 KB) and the chunk size only sets each CTA's range.
//   - the second pass adds the per-CTA partials in a fixed order (one
//     level of 64-row sums when there are many, then one CTA) and adds the
//     seed.  No float atomics: a run repeats bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads per CTA
constexpr int kVecs = 32;      // 16-byte vectors in a row of 128 floats
constexpr int kLanes = kThreads / kVecs;  // rows read side by side (8)
constexpr int kUnroll = 4;     // loads in flight per thread
constexpr int kStageRows = 128;  // rows in one ring stage of manual (64 KB)
constexpr int kRing = 2;       // ring slots
constexpr int kSumRows = 64;   // partial rows one CTA of the first level adds
constexpr int kDirect = 256;   // at most this many partials: one level only

__device__ __forceinline__ void add4(float4& a, const float4& v) {
  a.x += v.x; a.y += v.y; a.z += v.z; a.w += v.w;
}

// Column sums of the CTA: thread (l, q) holds the sum of its rows for
// columns 4q..4q+3; writes the 128 sums, lanes added in order, to row.
__device__ void column_partial(const float4& acc, float* row) {
  __shared__ float4 red[kLanes][kVecs];
  const int q = threadIdx.x % kVecs, l = threadIdx.x / kVecs;
  red[l][q] = acc;
  __syncthreads();
  if (threadIdx.x < kVecs) {
    float4 s = red[0][q];
#pragma unroll
    for (int j = 1; j < kLanes; ++j) add4(s, red[j][q]);
    reinterpret_cast<float4*>(row)[q] = s;
  }
}

// B5: one CTA per chunk; partial[blockIdx.x] = the chunk's 128 column sums.
__global__ void __launch_bounds__(kThreads)
stream_kernel(const float* __restrict__ vals, int CH, float* __restrict__ partial) {
  const int q = threadIdx.x % kVecs, l = threadIdx.x / kVecs;
  const float4* chunk = reinterpret_cast<const float4*>(vals) +
                        static_cast<long long>(blockIdx.x) * CH * kVecs;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r0 = l; r0 < CH; r0 += kLanes * kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * kLanes;
      v[u] = r < CH ? __ldcs(chunk + static_cast<long long>(r) * kVecs + q)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) add4(acc, v[u]);
  }
  column_partial(acc, partial + static_cast<long long>(blockIdx.x) * 128);
}

// B6: B5's stream plus the products.  Tile u of a chunk is its rows
// [u·bm, (u+1)·bm); the thread adds the 8 products of each of its rows'
// 4 columns with xt rows 0-7 into d[j], which is the (bm, 8) product's
// column j summed over the rows and columns the thread owns.
// partial[blockIdx.x] = the chunk's sum of all its products.
__global__ void __launch_bounds__(kThreads)
stream_dot_kernel(const float* __restrict__ vals, const float* __restrict__ xt,
                  int CH, float* __restrict__ partial) {
  const int q = threadIdx.x % kVecs, l = threadIdx.x / kVecs;
  float x[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 v = reinterpret_cast<const float4*>(xt)[j * kVecs + q];
    x[j][0] = v.x; x[j][1] = v.y; x[j][2] = v.z; x[j][3] = v.w;
  }
  const float4* chunk = reinterpret_cast<const float4*>(vals) +
                        static_cast<long long>(blockIdx.x) * CH * kVecs;
  float d[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) d[j] = 0.f;
  for (int r0 = l; r0 < CH; r0 += kLanes * kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * kLanes;
      v[u] = r < CH ? __ldcs(chunk + static_cast<long long>(r) * kVecs + q)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        d[j] = __fmaf_rn(v[u].x, x[j][0], d[j]);
        d[j] = __fmaf_rn(v[u].y, x[j][1], d[j]);
        d[j] = __fmaf_rn(v[u].z, x[j][2], d[j]);
        d[j] = __fmaf_rn(v[u].w, x[j][3], d[j]);
      }
    }
  }
  __shared__ float sm[kThreads];
  float s = d[0];
#pragma unroll
  for (int j = 1; j < 8; ++j) s += d[j];
  sm[threadIdx.x] = s;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h /= 2) {
    if (threadIdx.x < h) sm[threadIdx.x] += sm[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) partial[blockIdx.x] = sm[0];
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar), "r"(parity) : "memory");
}

// B7: persistent grid; CTA b owns chunks [b·S/n, (b+1)·S/n) of the n CTAs
// and walks their rows through the ring in stages of kStageRows rows.  The
// copy of stage k+1 starts before stage k is waited for and reduced, so
// up to two stages (128 KB) are in flight.  partial[blockIdx.x] = the
// range's 128 column sums.
__global__ void __launch_bounds__(kThreads)
manual_kernel(const float* __restrict__ vals, long long S, int CH,
              float* __restrict__ partial) {
  extern __shared__ __align__(128) float4 ring[];  // [kRing][kStageRows·kVecs]
  __shared__ __align__(8) unsigned long long bar[kRing];
  const int q = threadIdx.x % kVecs, l = threadIdx.x / kVecs;
  const long long c0 = blockIdx.x * S / gridDim.x;
  const long long c1 = (blockIdx.x + 1) * S / gridDim.x;
  const long long row0 = c0 * CH, nrows = (c1 - c0) * CH;
  const long long nst = (nrows + kStageRows - 1) / kStageRows;
  const float4* src = reinterpret_cast<const float4*>(vals) + row0 * kVecs;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   ::"r"(smem_addr(&bar[s])) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  auto stage_rows = [&](long long k) {
    const long long left = nrows - k * kStageRows;
    return static_cast<int>(left < kStageRows ? left : kStageRows);
  };
  // one thread: expect the stage's bytes on its slot's barrier, then copy
  auto start_copy = [&](long long k) {
    const int slot = static_cast<int>(k % kRing);
    const unsigned bytes = static_cast<unsigned>(stage_rows(k)) * kVecs * 16u;
    const unsigned b = smem_addr(&bar[slot]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(b), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(ring + slot * kStageRows * kVecs)),
          "l"(src + k * kStageRows * kVecs), "r"(bytes), "r"(b)
        : "memory");
  };

  if (threadIdx.x == 0 && nst > 0) start_copy(0);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long k = 0; k < nst; ++k) {
    // slot (k+1) % 2 was last read in step k-1, which ended in a barrier
    if (threadIdx.x == 0 && k + 1 < nst) start_copy(k + 1);
    const int slot = static_cast<int>(k % kRing);
    // the n-th use of a slot completes the barrier's phase n: parity n & 1
    mbar_wait(smem_addr(&bar[slot]), static_cast<unsigned>((k / kRing) & 1));
    const float4* st = ring + slot * kStageRows * kVecs;
    const int rows = stage_rows(k);
    for (int r = l; r < rows; r += kLanes) add4(acc, st[r * kVecs + q]);
    __syncthreads();  // every thread is done with the slot before its refill
  }
  column_partial(acc, partial + static_cast<long long>(blockIdx.x) * 128);
}

// Sums rows [r0, r1) of the row-major (·, W) array `in` (W = 1 or 128) in
// a fixed order; afterwards sm[c] holds column c's total, c < W.
__device__ void sum_rows_block(const float* __restrict__ in, long long r0,
                               long long r1, int W, float* sm) {
  const int t = threadIdx.x, c = t % W, l = t / W, L = kThreads / W;
  float s = 0.f;
  for (long long r = r0 + l; r < r1; r += L) s += in[r * W + c];
  sm[t] = s;  // t = l·W + c
  __syncthreads();
  for (int h = L / 2; h > 0; h /= 2) {
    if (l < h) sm[t] += sm[t + h * W];
    __syncthreads();
  }
}

// First level of the second pass: out row f = the sum of rows
// [f·kSumRows, (f+1)·kSumRows) of in (P, W).
__global__ void __launch_bounds__(kThreads)
sum_rows_kernel(const float* __restrict__ in, long long P, int W,
                float* __restrict__ out) {
  __shared__ float sm[kThreads];
  const long long r0 = static_cast<long long>(blockIdx.x) * kSumRows;
  const long long r1 = r0 + kSumRows < P ? r0 + kSumRows : P;
  sum_rows_block(in, r0, r1, W, sm);
  if (threadIdx.x < W) out[blockIdx.x * W + threadIdx.x] = sm[threadIdx.x];
}

// Last level: out (8, 128) = seed + the sum of all P rows of in, a column
// sum (W = 128) or a scalar broadcast to every entry (W = 1).
__global__ void __launch_bounds__(kThreads)
finish_kernel(const float* __restrict__ in, long long P, int W,
              const float* __restrict__ seed, float* __restrict__ out) {
  __shared__ float sm[kThreads];
  sum_rows_block(in, 0, P, W, sm);
  for (int e = threadIdx.x; e < 8 * 128; e += kThreads) {
    out[e] = seed[e] + sm[W == 1 ? 0 : e % 128];
  }
}

// The second pass over P partial rows of width W at work; the first level
// (when P > kDirect) writes its rows after them.
int finish(float* work, long long P, int W, const float* seed, float* out,
           cudaStream_t s) {
  const float* in = work;
  long long rows = P;
  if (P > kDirect) {
    rows = (P + kSumRows - 1) / kSumRows;
    float* level = work + P * W;
    sum_rows_kernel<<<static_cast<unsigned>(rows), kThreads, 0, s>>>(work, P, W, level);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    in = level;
  }
  finish_kernel<<<1, kThreads, 0, s>>>(in, rows, W, seed, out);
  return static_cast<int>(cudaGetLastError());
}

bool valid(const float* vals, int S, int CH) {
  return S >= 1 && CH >= 1 && reinterpret_cast<unsigned long long>(vals) % 16 == 0;
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of its launches (0 on success).  All
// pointers are device pointers, 16-byte aligned; vals is (S·CH, 128), seed,
// xt and out (8, 128), all f32 and row-major.  work holds (S + ⌈S/64⌉)·W
// floats of scratch (W = 128; 1 for stream_dot).  Launches are
// asynchronous on ``stream``.

// B5 (dma_stream_bench.py:65 make_stream).
int rbl_dma_stream_f32(const float* vals, const float* seed, float* out,
                       float* work, int S, int CH, void* stream) {
  if (!valid(vals, S, CH)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  stream_kernel<<<S, kThreads, 0, s>>>(vals, CH, work);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return finish(work, S, 128, seed, out, s);
}

// B6 (dma_stream_bench.py:83 make_stream_dot): chunks of U tiles (bm, 128).
int rbl_dma_stream_dot_f32(const float* vals, const float* seed,
                           const float* xt, float* out, float* work, int S,
                           int CH, int bm, int U, void* stream) {
  if (!valid(vals, S, CH) || bm < 1 || U < 1 ||
      static_cast<long long>(bm) * U != CH) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  stream_dot_kernel<<<S, kThreads, 0, s>>>(vals, xt, CH, work);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return finish(work, S, 1, seed, out, s);
}

// B7 (dma_stream_bench.py:130 make_manual).
int rbl_dma_stream_manual_f32(const float* vals, const float* seed,
                              float* out, float* work, int S, int CH,
                              void* stream) {
  if (!valid(vals, S, CH)) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  constexpr int kSmem = kRing * kStageRows * kVecs * 16;
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(manual_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n = S < sms ? S : sms;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  manual_kernel<<<n, kThreads, kSmem, s>>>(vals, S, CH, work);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return finish(work, n, 128, seed, out, s);
}

}  // extern "C"

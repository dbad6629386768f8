// Block-sparse SpMM, Y = A·X, from transposed panels, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package
//   rbl_tpu/ops/spmm/pallas_bsr.py:296 bsr_spmm_panel
//       (kernel body inline, :354-390; pallas_call :392)
// reached by BlockSparseOperator(panel=True).apply
// (rbl_tpu_torch/ops/spmm/bsr.py:bsr_spmm_panel).
//
// Layout: the packed tile list (block-row i owns the chunks
// [rptr[i], rptr[i] + hcount[i]) of U tiles each) with every chunk c
// stored as one (U·bk, bm) panel of vals_t (T/U, U·bk, bm): element
// (u·bk + kk, m) of chunk c's panel is A-tile c·U+u's (m, kk).  Flattened,
// tile t owns panel rows [t·bk, (t+1)·bk) of a (T·bk, bm) array and
// multiplies rows [tile_cols[t]·bk, +bk) of X (ncb·bk, b), row-major.  On
// the TPU the panel turned a chunk into one long-K MXU dot against a
// gathered, transposed stack of X tiles, with the sum kept as a (b, bm)
// accumulator and written transposed; the `gather` option chose how that
// stack was assembled in VMEM.  None of that exists here: the option is
// accepted and has no effect.
//
// What bounds it.  Each stored value is read once an apply and used in b
// fused multiply-adds: 2·b FLOP per 4 (8) bytes.  Where the panel layout
// runs on the card (X ≤ 8 MB, kept for parity with the JAX package: b ≤ 8
// in f32 and b ≤ 4 in f64 on fem_elasticity_3d(42)) that is at most 4
// FLOP/byte in f32 and 1 in f64, against the card's FP32 ridge of
// 67 TFLOP/s / 3.35 TB/s = 20 FLOP/byte: the stream of vals_t bounds it
// by 5-20×.  So no tensor cores: wgmma, 3xTF32 or DMMA would speed up
// what does not bound the kernel and put the 1e-5 (f32) and 1e-12 (f64)
// agreement with the plain version at risk.  The products are FP32 (FP64)
// fused multiply-adds, never TF32.  The layout stores 5%-full 64×128
// tiles on fem42, so even a bare stream of the same bytes (dma_stream.cu,
// B7) reaches under 10% of the bound that counts only the nonzeros; that
// is the layout's limit, not the loop's.
//
// The design (PERF.md §6 has its times):
//   - the copies are 1-D bulk asynchronous copies (cp.async.bulk, the copy
//     engine), issued by one thread, into a ring of 3-8 stages in shared
//     memory with one "full" and one "empty" mbarrier a stage.  A stage is
//     kc panel rows of one tile — ONE contiguous run of kc·bm values, kept
//     as it lies — and the kc rows of X that tile multiplies, again one
//     contiguous run of kc·b values.  Both sizes and source offsets are
//     multiples of 16 bytes because kc is a power of two ≥ 4 (so kc·bm·4
//     and kc·b·4 are), given a 16-byte-aligned vals_t and X, which the
//     launch checks.  For b > 32 each CTA computes one group of 32 columns
//     but copies the whole row range of X, all b columns: one copy a
//     stage, no per-row or per-element copies; the host shrinks kc so
//     that the ring still holds 3-4 stages, and refuses only a b whose 4
//     rows of X leave no room for 3 stages (about 2,000 f64 or 4,000 f32
//     columns).  The wider copy costs L2 reads only at b > 32, where X is
//     small enough to sit in the 50 MB L2;
//   - warp specialisation: one producer warp (one active lane) walks the
//     CTA's tiles and keeps the ring full; it reads the next tile's column
//     id one tile ahead, so no copy waits on an index load;
//   - persistent CTAs: the grid is the SM count times the CTAs whose rings
//     fit an SM (one at fem42's bm 64, 3-7 at bm 16), and each CTA walks
//     the work items (block-row, group of ≤ 32 columns) by a static
//     stride.  Its ring carries on across tiles, chunks and block-rows, so
//     the fill is paid once a CTA, not once a block-row;
//   - the consumer warps hold an R × C = 4 × 4 register block of the
//     (bm, ≤ 32) output each: rows contiguous in m, columns contiguous in
//     the group.  A panel row is contiguous in m and a row of X in its
//     columns, so a contraction row costs one 16-byte shared load of A
//     and one of X (two each in f64) for 16 FMAs; consecutive lanes take
//     consecutive row groups, so A loads are conflict-free and X loads are
//     broadcasts.  Where bm or b is not a multiple of 16 bytes' worth of
//     values the loads are scalar (the only variants: kAVec, kXVec).  No
//     predicate in the inner loop: rows past bm and columns past b are
//     computed on whatever follows them in shared memory (each slice ends
//     in a pad) and never written;
//   - bm·b is small (512 outputs at bm 64, b 8: 32 threads), so the CTA's
//     consumer warps also split each stage's contraction rows into S
//     groups of consecutive rows (S·groups ≤ 256 threads, ≥ 4 rows a
//     group).  At a block-row's end every group hands its partials over
//     through shared memory, and the consumer threads share out the
//     outputs: each adds one output's S partials in group order and
//     writes it to Y.  A block-row with no chunk writes zeros.  The order
//     of every sum is fixed, so a run repeats bit for bit;
//   - the host picks kc, S, the ring depth and the shared bytes for each
//     (bm, bk, b, dtype) (make_plan, exposed as rbl_bsr_spmm_panel_plan):
//     the largest kc (≤ 128, dividing bk) whose ring of 4 stages fits
//     beside the partials, then as many stages (≤ 8) as fit.

#include "spmm_common.cuh"

namespace {

using namespace rbl;

constexpr int kR = 4;              // rows of a thread's register block
constexpr int kC = 4;              // columns of it
constexpr int kMaxStages = 8;      // ring stages at most
constexpr int kWantStages = 4;     // ring stages the plan keeps kc down for
constexpr int kMinStages = 3;      // fewest: one read while two land
constexpr int kMaxConsumers = 256; // consumer threads a CTA
constexpr int kMinGroupRows = 4;   // contraction rows a K-split group takes
constexpr int kPadA = 32;          // bytes after a stage's A rows: rows past bm
constexpr int kPadX = kMaxBW * 8;  // bytes after its X rows: columns past b
// An H100 SM: 228 KB of shared memory, 1 KB of it reserved for each
// resident CTA and at most 227 KB for one, of which the barriers take 256.
constexpr int kSmemPerSM = 228 * 1024;
constexpr int kSmemPerBlock = 1024;
constexpr int kSmemBudget = 227 * 1024 - 256;

// Geometry of one launch, in bytes and threads.
struct Plan {
  int kc;          // panel rows (contraction rows) of a ring stage
  int stages;      // ring stages; 0: no plan
  int ksplit;      // S, the K-split groups of the consumer warps
  int groups;      // threads an output block takes (row groups × column groups)
  int rgroups;     // row groups of kR rows
  int consumers;   // consumer threads, a multiple of 32
  int threads;     // consumers and one producer warp
  int a_bytes;     // a stage's A rows and their pad
  int slot_bytes;  // a stage: A rows, pad, X rows, pad
  int smem;        // dynamic shared bytes: the ring and the partials
};

Plan make_plan(int bm, int bk, int b, int es) {
  Plan p{};
  if (bm < 1 || bm > kMaxBM || bk < kKC || bk % kKC || b < 1) return p;
  const int bw = b < kMaxBW ? b : kMaxBW;
  p.rgroups = (bm + kR - 1) / kR;
  p.groups = p.rgroups * ((bw + kC - 1) / kC);
  int split = 1;
  while (p.groups * split * 2 <= kMaxConsumers) split *= 2;
  for (int kc = 128; kc >= 4; kc /= 2) {
    if (bk % kc) continue;
    const int s = split < kc / kMinGroupRows ? split : kc / kMinGroupRows;
    const long long a = static_cast<long long>(kc) * bm * es + kPadA;
    const long long slot = a + static_cast<long long>(kc) * b * es + kPadX;
    const long long red =
        (s > 1 ? s : 0) * static_cast<long long>(kR) * kC * p.groups * es;
    const long long room = kSmemBudget - red;
    if (room < (kc == 4 ? kMinStages : kWantStages) * slot) continue;
    const long long fit = room / slot;
    p.kc = kc;
    p.stages = static_cast<int>(fit < kMaxStages ? fit : kMaxStages);
    p.ksplit = s;
    p.consumers = (p.groups * s + 31) / 32 * 32;
    p.threads = p.consumers + 32;
    p.a_bytes = static_cast<int>(a);
    p.slot_bytes = static_cast<int>(slot);
    p.smem = static_cast<int>(p.stages * slot + red);
    return p;
  }
  p.stages = 0;
  return p;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(bar), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the other threads and to the
// copy engine.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Arrives on `bar` and has its phase wait for `bytes` more of copies.
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// Returns once the phase of `bar` of parity `parity` has completed.
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

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// One 1-D bulk copy of `bytes` (a multiple of 16) from global memory to
// shared memory, which completes its bytes on the mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Waits for a named barrier's `count` threads (barrier 0 is __syncthreads).
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// N consecutive values from shared memory: 16-byte vectors, or scalars.
template <bool kVec, int N, typename T>
__device__ __forceinline__ void load_run(T (&v)[N], const T* p) {
  if constexpr (kVec) {
    using V = typename Vec16<T>::type;
    constexpr int W = Vec16<T>::n;
#pragma unroll
    for (int q = 0; q < N / W; ++q) {
      const V t = *reinterpret_cast<const V*>(p + q * W);
      const T* e = reinterpret_cast<const T*>(&t);
#pragma unroll
      for (int f = 0; f < W; ++f) v[q * W + f] = e[f];
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = p[j];
  }
}

template <typename T, bool kAVec, bool kXVec>
__global__ void __launch_bounds__(kMaxConsumers + 32)
bsr_spmm_panel_kernel(const int* __restrict__ tile_cols,
                      const int* __restrict__ hcount,
                      const int* __restrict__ rptr,
                      const T* __restrict__ vals_t,
                      const T* __restrict__ X, T* __restrict__ Y, int nb,
                      int bm, int bk, int b, int unroll, Plan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) unsigned long long full[kMaxStages];
  __shared__ __align__(8) unsigned long long empty[kMaxStages];
  const int tid = threadIdx.x, lane = tid % 32;
  const int nwarps = p.consumers / 32;  // consumer warps; the producer follows
  const int st = p.stages, kc = p.kc;
  const int ng = (b + kMaxBW - 1) / kMaxBW;  // column groups
  const long long items = static_cast<long long>(nb) * ng;

  if (tid == 0) {
    for (int s = 0; s < st; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), nwarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid / 32 == nwarps) {
    // producer: stage n goes to slot n % st once the consumers have
    // released that slot's previous use (the n/st-th phase of empty)
    if (lane != 0) return;
    const unsigned abytes = static_cast<unsigned>(kc * bm * sizeof(T));
    const unsigned xbytes = static_cast<unsigned>(kc * b * sizeof(T));
    long long n = 0;
    for (long long w = blockIdx.x; w < items; w += gridDim.x) {
      const int i = static_cast<int>(w / ng);
      const long long t0 = static_cast<long long>(rptr[i]) * unroll;
      const long long t1 = t0 + static_cast<long long>(hcount[i]) * unroll;
      int col = t0 < t1 ? tile_cols[t0] : 0;
      for (long long t = t0; t < t1; ++t) {
        const int next = t + 1 < t1 ? tile_cols[t + 1] : 0;
        const T* a = vals_t + t * bk * bm;
        const T* x = X + static_cast<long long>(col) * bk * b;
        for (int k0 = 0; k0 < bk; k0 += kc, ++n) {
          const int slot = static_cast<int>(n % st);
          mbar_wait(smem_addr(&empty[slot]),
                    static_cast<unsigned>(((n / st) & 1) ^ 1));
          unsigned char* dst = smem + static_cast<long long>(slot) * p.slot_bytes;
          const unsigned bar = smem_addr(&full[slot]);
          mbar_expect_tx(bar, abytes + xbytes);
          bulk_copy(dst, a + k0 * bm, abytes, bar);
          bulk_copy(dst + p.a_bytes, x + static_cast<long long>(k0) * b,
                    xbytes, bar);
        }
        col = next;
      }
    }
    return;
  }

  // consumers: thread (row group rg, column group cg, K-split group s)
  const int G = p.groups, S = p.ksplit;
  const int o = tid % G, s = tid / G;
  const bool active = s < S;
  const int m0 = (o % p.rgroups) * kR;
  const int cx = (o / p.rgroups) * kC;
  const int kpg = kc / S;
  const int kb = (active ? s : 0) * kpg;
  T* const red = reinterpret_cast<T*>(smem + static_cast<long long>(st) * p.slot_bytes);
  long long n = 0;
  for (long long w = blockIdx.x; w < items; w += gridDim.x) {
    const int i = static_cast<int>(w / ng);
    const int cb = static_cast<int>(w % ng) * kMaxBW;
    const long long nst = static_cast<long long>(hcount[i]) * unroll * (bk / kc);
    T acc[kR][kC];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[r][c] = T(0);
    }
    for (long long g = 0; g < nst; ++g, ++n) {
      const int slot = static_cast<int>(n % st);
      mbar_wait(smem_addr(&full[slot]), static_cast<unsigned>((n / st) & 1));
      if (active) {
        const unsigned char* base = smem + static_cast<long long>(slot) * p.slot_bytes;
        const T* As = reinterpret_cast<const T*>(base) + m0;
        const T* Xs = reinterpret_cast<const T*>(base + p.a_bytes) + cb + cx;
#pragma unroll 4
        for (int kk = kb; kk < kb + kpg; ++kk) {
          T a[kR], x[kC];
          load_run<kAVec>(a, As + kk * bm);
          load_run<kXVec>(x, Xs + kk * b);
#pragma unroll
          for (int r = 0; r < kR; ++r) {
#pragma unroll
            for (int c = 0; c < kC; ++c) acc[r][c] = fma_rn(a[r], x[c], acc[r][c]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_addr(&empty[slot]));
    }
    T* y = Y + static_cast<long long>(i) * bm * b;
    if (S == 1) {
      if (active) {
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          if (m0 + r >= bm) continue;
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            const int col = cb + cx + c;
            if (col < b) y[static_cast<long long>(m0 + r) * b + col] = acc[r][c];
          }
        }
      }
    } else {
      // every group hands over its partials; the consumers then share the
      // G·R·C outputs, each added over the groups in order and written
      if (active) {
#pragma unroll
        for (int j = 0; j < kR * kC; ++j) {
          red[(s * kR * kC + j) * G + o] = acc[j / kC][j % kC];
        }
      }
      bar_sync(1, p.consumers);
      for (int e = tid; e < G * kR * kC; e += p.consumers) {
        const int oe = e % G, j = e / G;
        T sum = red[j * G + oe];
        for (int q = 1; q < S; ++q) sum += red[(q * kR * kC + j) * G + oe];
        const int m = (oe % p.rgroups) * kR + j / kC;
        const int col = cb + (oe / p.rgroups) * kC + j % kC;
        if (m < bm && col < b) y[static_cast<long long>(m) * b + col] = sum;
      }
      bar_sync(1, p.consumers);  // the partials are read
    }
  }
}

template <typename T, bool kAVec, bool kXVec>
cudaError_t launch_variant(int grid, const Plan& p, cudaStream_t s,
                           const int* tile_cols, const int* hcount,
                           const int* rptr, const T* vals_t, const T* X, T* Y,
                           int nb, int bm, int bk, int b, int unroll) {
  auto kernel = bsr_spmm_panel_kernel<T, kAVec, kXVec>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, p.threads, p.smem, s>>>(tile_cols, hcount, rptr, vals_t, X,
                                         Y, nb, bm, bk, b, unroll, p);
  return cudaGetLastError();
}

template <typename T>
int launch(const int* tile_cols, const int* hcount, const int* rptr,
           const T* vals_t, const T* X, T* Y, int nb, int bm, int bk, int b,
           int unroll, void* stream) {
  if (!valid_launch(nb, bm, bk, b, vals_t) || unroll < 1 ||
      reinterpret_cast<unsigned long long>(X) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = make_plan(bm, bk, b, static_cast<int>(sizeof(T)));
  if (p.stages < kMinStages) return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = kSmemPerSM / (p.smem + 256 + kSmemPerBlock);
  if (per_sm < 1) per_sm = 1;
  const long long items = static_cast<long long>(nb) * ((b + kMaxBW - 1) / kMaxBW);
  const long long slots = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(items < slots ? items : slots);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kVW = Vec16<T>::n;
  const bool avec = bm % kVW == 0, xvec = b % kVW == 0;
  const auto args = [&](auto av, auto xv) {
    return launch_variant<T, decltype(av)::value, decltype(xv)::value>(
        grid, p, s, tile_cols, hcount, rptr, vals_t, X, Y, nb, bm, bk, b,
        unroll);
  };
  using Yes = std::true_type;
  using No = std::false_type;
  if (avec) {
    e = xvec ? args(Yes{}, Yes{}) : args(Yes{}, No{});
  } else {
    e = xvec ? args(No{}, Yes{}) : args(No{}, No{});
  }
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).  All pointers are
// device pointers, vals_t and X 16-byte aligned; the launch is asynchronous
// on ``stream``.
int rbl_bsr_spmm_panel_f32(const int* tile_cols, const int* hcount,
                           const int* rptr, const float* vals_t,
                           const float* X, float* Y, int nb, int bm, int bk,
                           int b, int unroll, void* stream) {
  return launch<float>(tile_cols, hcount, rptr, vals_t, X, Y, nb, bm, bk, b,
                       unroll, stream);
}

int rbl_bsr_spmm_panel_f64(const int* tile_cols, const int* hcount,
                           const int* rptr, const double* vals_t,
                           const double* X, double* Y, int nb, int bm,
                           int bk, int b, int unroll, void* stream) {
  return launch<double>(tile_cols, hcount, rptr, vals_t, X, Y, nb, bm, bk, b,
                        unroll, stream);
}

// The plan the entries above launch for (bm, bk, b) and the element size
// (4 or 8): out = {stages, kc, R, C, K-split groups, threads a CTA,
// dynamic shared bytes}.  Returns cudaErrorInvalidValue for a shape they
// refuse.
int rbl_bsr_spmm_panel_plan(int bm, int bk, int b, int elem_bytes, int* out) {
  if (elem_bytes != 4 && elem_bytes != 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = make_plan(bm, bk, b, elem_bytes);
  if (p.stages < kMinStages) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = p.stages; out[1] = p.kc; out[2] = kR; out[3] = kC;
  out[4] = p.ksplit; out[5] = p.threads; out[6] = p.smem;
  return 0;
}

}  // extern "C"

// Block-sparse SpMM, Y = A·X, for Hopper (sm_90a): packed and blocked-ELL
// layouts.
//
// Replaces three Pallas TPU kernels of the JAX package:
//   rbl_tpu/ops/spmm/pallas_bsr.py:418 bsr_spmm_packed_resident
//       (kernel body _make_packed_resident_kernel, :250-288)
//   rbl_tpu/ops/spmm/pallas_bsr.py:182 bsr_spmm_packed
//       (kernel body _make_packed_kernel, :146-175)
//   rbl_tpu/ops/spmm/pallas_bsr.py:80 bsr_spmm, blocked-ELL
//       (kernel body _make_bsr_kernel, :42-73)
// The two packed Python entry points (rbl_tpu_torch/ops/spmm/bsr.py)
// launch one kernel: the TPU needed two because X either fit its on-chip
// VMEM or had to be fetched tile by tile; here X is read from device
// memory and, at the solver's sizes (a few to tens of MB), stays in the
// 50 MB L2.  Blocked-ELL is the packed layout with L tiles in every
// block-row, so it is the same kernel body, templated on how a block-row
// finds its tile range: no hcount or rptr array exists for it.
//
// Layout (CSR of tiles, built by _packed_bsr_from_scipy): block-row i owns
// the tiles [rptr[i]·U, (rptr[i] + hcount[i])·U) of vals (T, bm, bk) —
// blocked-ELL: [i·L, (i+1)·L); tile t multiplies rows
// [tile_cols[t]·bk, +bk) of X (ncb·bk, b), row-major.
//
// What bounds it on this card.  Every tile is read once per apply, so the
// floor is the stream of vals (fem42 on plan (64, 4): 1.4 GB, 0.47 ms for
// the bare stream of dma_stream.cu, 89% of the 3.35 TB/s bound).  The
// products are FP32 (FP64) fused multiply-adds — never TF32, the
// Precision.HIGHEST contract of the TPU kernels (pallas_bsr.py:59-61) —
// b for every stored value; at b ≤ 16 they need ≤ 0.2 ms of issue.  What
// must not bound it is the shared-memory pipe, which serves one
// warp-wide load instruction (one 128-byte wavefront) a clock an SM
// against four warp-wide FMAs.  The first design of this kernel read one A
// value and then, because a thread's NC columns were interleaved
// (g + G·m), NC scalar X values: 1 + NC shared loads for NC FMAs.  Its
// time on fem42 plan (64, 4) grew with exactly that count: 0.598 / 0.782
// / 1.133 / 2.019 ms at b = 4 / 8 / 16 / 32 (3 / 5 / 9 / 17 loads a
// step, 0.09-0.11 ms for each at 1.98 GHz, against 0.084 ms predicted by
// one load a clock), and at b = 16 it lost to torch.sparse CSR (1.133
// against 1.047 ms; tools/bench_spmm.py, NVIDIA H100 80GB HBM3, 700 W).
//
// The design:
//   - one CTA per block-row (grid.x) and per group of up to kMaxBW columns
//     (grid.y), looping over exactly that row's tiles;
//   - register blocking: thread (row group rg, column group cg) keeps the
//     R × kC block Y[rg + j·RG, cg·kC + c] (j < R, c < kC = 4) in
//     registers, kC contiguous columns.  Per step of 16 bytes along k (4
//     f32 or 2 f64 values) it issues R 16-byte loads of A and kC of X for
//     4·R·kC (2·R·kC) FMAs.  Lanes of a warp are consecutive row groups
//     with one column group, so every X load is a broadcast and the A
//     loads are free of bank conflicts (rows padded by 16 bytes: a row
//     stride ≡ 4 words mod 32).  At R = 2 that is 6 loads for 32 FMAs,
//     against 9 for 8 before;
//   - tiles are staged by asynchronous copies (cp.async.cg, 16 bytes,
//     straight to shared memory, no registers): a ring of 2 or 3 stages,
//     each a 64-wide slice of the contraction (32-wide where bk is not a
//     multiple of 64) — the (bm, 64) slice of A in padded rows and the
//     (64, bw) slice of X beside it — the next stages in flight while one
//     is multiplied, and one barrier a stage (2 a 128-wide tile, against
//     8 before; 64-wide stages beat 32-wide ones at every shape tried).  X
//     columns that are not 16-byte aligned (b % 4 ≠ 0 in f32) are copied
//     element by element.  The next tile's column id is loaded a tile
//     ahead, so no copy waits on it;
//   - the host picks R and the ring depth per (bm, bk, b) (make_plan) by
//     what a sweep of every plan showed to set the time: first the warps
//     an SM holds, which a deep ring cuts, then the shared-load
//     instructions a FMA.  A small bm·b gives a smaller CTA rather than a
//     split of the contraction: one accumulator per output, tiles in order
//     and k ascending, so a run repeats bit for bit and every plan gives
//     the same bits.
// Result (tools/bench_spmm.py, same card, the two designs in one run):
// on fem42 plan (64, 4), back to back, b = 8 0.48 ms and b = 16 0.53 ms
// against the 0.47 ms stream (2% and 12% over it; 0.78 and 1.13 ms
// before); B3 at bm 128, b = 16 0.63 ms (1.16 before); all under
// torch.sparse CSR (1.04-1.06 ms at b = 16).
// No tensor cores: 95% of fem42's stored values are padding zeros, FP32
// FMA issue is below the stream at b ≤ 16, and 3xTF32 would change the
// error profile the 1e-5 tolerance was set for.

#include "spmm_common.cuh"

namespace {

using namespace rbl;

constexpr int kKS = 2 * kKC;        // contraction columns of a stage
constexpr int kC = 4;               // columns of a thread's register block
constexpr int kMaxThreads = 256;    // largest CTA
constexpr int kMinWarps = 12;       // warps an SM should hold (make_plan)
constexpr int kSmemDefault = 48 * 1024;  // above: opt in per launch
// An H100 SM: 228 KB of shared memory, 1 KB of it reserved for each
// resident CTA and at most 227 KB for one, at most 32 CTAs and 64 warps.
constexpr int kSmemPerSM = 228 * 1024;
constexpr int kSmemMax = 227 * 1024;
constexpr int kSmemPerBlock = 1024;
constexpr int kBlocksPerSM = 32;
constexpr int kWarpsPerSM = 64;

// Tile range of block-row i in the packed layout.
struct PackedRows {
  const int* hcount;
  const int* rptr;
  int unroll;
  __device__ void range(int i, long long& t0, long long& t1) const {
    t0 = static_cast<long long>(rptr[i]) * unroll;
    t1 = t0 + static_cast<long long>(hcount[i]) * unroll;
  }
};

// Tile range of block-row i in the blocked-ELL layout.
struct EllRows {
  int L;
  __device__ void range(int i, long long& t0, long long& t1) const {
    t0 = static_cast<long long>(i) * L;
    t1 = t0 + L;
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "n"(sizeof(T)) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most n of this thread's copy groups are pending
// (wait_group takes an immediate).
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
  }
}

// Shared-memory geometry of one ring stage, in elements of T: ks
// contraction columns (kKS, or kKC where bk is not a multiple of kKS), the
// (arows, ks) slice of A in rows padded by 16 bytes, then the (ks, bwp)
// slice of X.
template <typename T>
struct StageShape {
  static constexpr int kVW = Vec16<T>::n;    // elements per 16 bytes
  int ks, ap, rg, arows, bwp, a, x;
  __host__ __device__ StageShape(int bm, int bk, int b, int R) {
    const int bw = b < kMaxBW ? b : kMaxBW;
    ks = bk % kKS == 0 ? kKS : kKC;
    ap = ks + kVW;
    rg = (bm + R - 1) / R;
    arows = rg * R;
    bwp = (bw + kC - 1) / kC * kC;
    a = arows * ap;
    x = ks * bwp;
  }
  __host__ __device__ int elems() const { return a + x; }
};

template <typename T, int R, typename Rows>
__global__ void __launch_bounds__(kMaxThreads)
bsr_spmm_kernel(const int* __restrict__ tile_cols, Rows rows,
                const T* __restrict__ vals, const T* __restrict__ X,
                T* __restrict__ Y, int bm, int bk, int b, int stages,
                int xvec) {
  using V = typename Vec16<T>::type;
  using Shape = StageShape<T>;
  constexpr int kVW = Shape::kVW;
  constexpr int C = kC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const ring = reinterpret_cast<T*>(smem_raw);

  const Shape sh(bm, bk, b, R);
  const int lvpr = __ffs(sh.ks / kVW) - 1;  // log2 of 16-byte copies an A row
  const int i = blockIdx.x;
  const int c0 = blockIdx.y * kMaxBW;
  const int bw = min(kMaxBW, b - c0);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int rg = tid % sh.rg;
  const int cg = tid / sh.rg;
  const bool active = cg * C < bw;

  long long t0, t1;
  rows.range(i, t0, t1);
  const int kpt = bk / sh.ks;                    // stages a tile
  const long long nst = (t1 - t0) * kpt;         // stages of this row

  // producer cursor: the next stage to copy is (pt, pk); pcol is pt's
  // column block, ncol the one after it, loaded a tile ahead
  long long pt = t0;
  int pk = 0;
  int pcol = t0 < t1 ? tile_cols[t0] : 0;
  int ncol = t0 + 1 < t1 ? tile_cols[t0 + 1] : 0;
  auto issue = [&](int slot) {
    T* as = ring + slot * sh.elems();
    T* xs = as + sh.a;
    const T* tile = vals + pt * bm * bk + pk;
    for (int v = tid; v < bm << lvpr; v += nthr) {
      const int r = v >> lvpr, q = v & ((1 << lvpr) - 1);
      cp_async16(as + r * sh.ap + q * kVW,
                 tile + static_cast<long long>(r) * bk + q * kVW);
    }
    const T* xt = X + (static_cast<long long>(pcol) * bk + pk) * b + c0;
    if (xvec) {
      const int xpr = bw / kVW;
      for (int v = tid; v < sh.ks * xpr; v += nthr) {
        const int kk = v / xpr, q = v % xpr;
        cp_async16(xs + kk * sh.bwp + q * kVW,
                   xt + static_cast<long long>(kk) * b + q * kVW);
      }
    } else {
      for (int v = tid; v < sh.ks * bw; v += nthr) {
        const int kk = v / bw, c = v % bw;
        cp_async_elem(xs + kk * sh.bwp + c,
                      xt + static_cast<long long>(kk) * b + c);
      }
    }
    pk += sh.ks;
    if (pk == bk) {
      pk = 0;
      ++pt;
      pcol = ncol;
      if (pt + 1 < t1) ncol = tile_cols[pt + 1];
    }
  };

  T acc[R][C];
#pragma unroll
  for (int j = 0; j < R; ++j) {
#pragma unroll
    for (int c = 0; c < C; ++c) acc[j][c] = T(0);
  }

  // prologue: stages 0 .. stages−2 in flight (empty groups keep the count)
  for (int s = 0; s < stages - 1; ++s) {
    if (s < nst) issue(s);
    cp_async_commit();
  }
  for (long long g = 0; g < nst; ++g) {
    cp_async_wait(stages - 2);  // this thread's copies of stage g landed
    __syncthreads();            // everyone's did; stage g−1 is no longer read
    if (g + stages - 1 < nst) issue(static_cast<int>((g + stages - 1) % stages));
    cp_async_commit();
    const T* as = ring + static_cast<int>(g % stages) * sh.elems();
    for (int kc = 0; active && kc < sh.ks; kc += kKC) {
      const T* xs = as + sh.a + kc * sh.bwp + cg * C;
      const T* arow = as + rg * sh.ap + kc;
#pragma unroll
      for (int k = 0; k < kKC; k += kVW) {
        V a[R];
#pragma unroll
        for (int j = 0; j < R; ++j) {
          a[j] = *reinterpret_cast<const V*>(arow + j * sh.rg * sh.ap + k);
        }
#pragma unroll
        for (int e = 0; e < kVW; ++e) {
          const T* xrow = xs + (k + e) * sh.bwp;
#pragma unroll
          for (int q = 0; q < C / kVW; ++q) {
            const V xv = *reinterpret_cast<const V*>(xrow + q * kVW);
            const T* xe = reinterpret_cast<const T*>(&xv);
#pragma unroll
            for (int j = 0; j < R; ++j) {
              const T av = reinterpret_cast<const T*>(&a[j])[e];
#pragma unroll
              for (int f = 0; f < kVW; ++f) {
                acc[j][q * kVW + f] = fma_rn(av, xe[f], acc[j][q * kVW + f]);
              }
            }
          }
        }
      }
    }
  }

  if (active) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = rg + j * sh.rg;
      if (r >= bm) continue;
      T* yrow = Y + (static_cast<long long>(i) * bm + r) * b + c0 + cg * C;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (cg * C + c < bw) yrow[c] = acc[j][c];
      }
    }
  }
}

// Register block, CTA and ring of one launch: R rows a thread (and kC
// columns), threads a CTA, ring stages and the ring's shared bytes.
struct Plan {
  int R, threads, stages, smem;
};

// One candidate of the plan search: its plan, its shared-load
// instructions a useful FMA — (R + kC)/(kVW·R·kC), times the share of
// padded rows, columns and warp lanes — and the warps' worth of threads
// an SM holds (as many CTAs as its shared memory takes).
template <typename T>
struct Candidate {
  Plan plan;
  double lds, warps;
  Candidate(int bm, int bk, int b, int R, int stages) {
    constexpr int kVW = Vec16<T>::n;
    const int bw = b < kMaxBW ? b : kMaxBW;
    const StageShape<T> sh(bm, bk, b, R);
    const int threads = sh.rg * (sh.bwp / kC);
    const int smem = stages * sh.elems() * static_cast<int>(sizeof(T));
    plan = Plan{R, threads, stages, smem};
    const int nwarps = (threads + 31) / 32;
    lds = static_cast<double>(sh.arows) * sh.bwp / (bm * bw) *
          (32.0 * nwarps / threads) * (R + kC) / (kVW * R * kC);
    const int blocks = kSmemPerSM / (smem + kSmemPerBlock);
    warps = (blocks < kBlocksPerSM ? blocks : kBlocksPerSM) * threads / 32.0;
    if (warps > kWarpsPerSM) warps = kWarpsPerSM;
  }
  bool fits() const { return plan.threads <= kMaxThreads && plan.smem <= kSmemMax; }
};

// The R of a ring of `stages` stages: the fewest shared-load instructions a
// useful FMA among the CTAs that leave an SM ≥ kMinWarps warps of threads;
// if none does, the most warps.
template <typename T>
Candidate<T> pick_rows(int bm, int bk, int b, int stages) {
  Candidate<T> best(bm, bk, b, 1, stages);
  constexpr int kTaller[] = {2, 4};
  for (const int R : kTaller) {
    const Candidate<T> c(bm, bk, b, R, stages);
    if (!c.fits()) continue;
    const bool full = c.warps >= kMinWarps;
    const bool best_full = best.fits() && best.warps >= kMinWarps;
    if (!best.fits() || (full && !best_full) ||
        (full == best_full && (full ? c.lds < best.lds : c.warps > best.warps))) {
      best = c;
    }
  }
  return best;
}

// The plan of a launch.  What set the time in a sweep of every plan on
// fem42 (tools/bench_spmm.py --plans; PERF.md) was first the warps
// an SM holds, which a deep ring cuts (a CTA's ring takes tens of KB),
// then shared-load instructions a FMA, which a taller register block cuts
// (so kC = 4: 8 columns a thread never won).  So: a ring of 3 stages up to
// 8 columns, where a stage holds little work to hide the copies behind,
// if it still leaves kMinWarps warps an SM; else 2.  At bm 16-128 and
// b 4-32 that picks the best plan of the sweep or one within 0.2% of it.
template <typename T>
Plan make_plan(int bm, int bk, int b) {
  if ((b < kMaxBW ? b : kMaxBW) <= 8) {
    const Candidate<T> deep = pick_rows<T>(bm, bk, b, 3);
    if (deep.fits() && deep.warps >= kMinWarps) return deep.plan;
  }
  return pick_rows<T>(bm, bk, b, 2).plan;
}

template <typename T, int R, typename Rows>
cudaError_t launch_plan(const dim3& grid, const Plan& p, cudaStream_t s,
                        const int* tile_cols, Rows rows, const T* vals,
                        const T* X, T* Y, int bm, int bk, int b, int xvec) {
  auto kernel = bsr_spmm_kernel<T, R, Rows>;
  if (p.smem > kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, p.threads, p.smem, s>>>(tile_cols, rows, vals, X, Y, bm, bk,
                                         b, p.stages, xvec);
  return cudaGetLastError();
}

template <typename T, typename Rows>
int launch(const int* tile_cols, Rows rows, const T* vals, const T* X, T* Y,
           int nb, int bm, int bk, int b, void* stream, Plan p) {
  if (!valid_launch(nb, bm, bk, b, vals) || p.stages < 2 || p.stages > 8 ||
      p.threads > kMaxThreads || p.smem > kSmemMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nb == 0) return 0;
  const dim3 grid(nb, (b + kMaxBW - 1) / kMaxBW);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kVW = Vec16<T>::n;
  const int xvec = b % kVW == 0 &&
                   reinterpret_cast<unsigned long long>(X) % 16 == 0;
  const auto args = [&](auto r) {
    return launch_plan<T, decltype(r)::value, Rows>(
        grid, p, s, tile_cols, rows, vals, X, Y, bm, bk, b, xvec);
  };
  cudaError_t e = cudaErrorInvalidValue;
  switch (p.R) {
    case 1: e = args(std::integral_constant<int, 1>{}); break;
    case 2: e = args(std::integral_constant<int, 2>{}); break;
    case 4: e = args(std::integral_constant<int, 4>{}); break;
    default: break;
  }
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success).  All pointers
// are device pointers (vals 16-byte aligned); the launch is asynchronous
// on ``stream``.

// Packed layout (B1/B2).
int rbl_bsr_spmm_packed_f32(const int* tile_cols, const int* hcount,
                            const int* rptr, const float* vals,
                            const float* X, float* Y, int nb, int bm, int bk,
                            int b, int unroll, void* stream) {
  if (unroll < 1 || bm < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float>(tile_cols, PackedRows{hcount, rptr, unroll}, vals, X,
                       Y, nb, bm, bk, b, stream, make_plan<float>(bm, bk, b));
}

int rbl_bsr_spmm_packed_f64(const int* tile_cols, const int* hcount,
                            const int* rptr, const double* vals,
                            const double* X, double* Y, int nb, int bm,
                            int bk, int b, int unroll, void* stream) {
  if (unroll < 1 || bm < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch<double>(tile_cols, PackedRows{hcount, rptr, unroll}, vals, X,
                        Y, nb, bm, bk, b, stream, make_plan<double>(bm, bk, b));
}

// Blocked-ELL layout (B3): L tiles in every block-row.
int rbl_bsr_spmm_ell_f32(const int* block_cols, const float* block_vals,
                         const float* X, float* Y, int nb, int L, int bm,
                         int bk, int b, void* stream) {
  if (L < 1 || bm < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float>(block_cols, EllRows{L}, block_vals, X, Y, nb, bm, bk,
                       b, stream, make_plan<float>(bm, bk, b));
}

int rbl_bsr_spmm_ell_f64(const int* block_cols, const double* block_vals,
                         const double* X, double* Y, int nb, int L, int bm,
                         int bk, int b, void* stream) {
  if (L < 1 || bm < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch<double>(block_cols, EllRows{L}, block_vals, X, Y, nb, bm, bk,
                        b, stream, make_plan<double>(bm, bk, b));
}

// The plan the entries above launch for (bm, bk, b) and the element size
// (4 or 8): out = {R, C, stages, dynamic shared bytes, threads}.
int rbl_bsr_spmm_plan(int bm, int bk, int b, int elem_bytes, int* out) {
  if (bm < 1 || bm > kMaxBM || bk < kKC || bk % kKC || b < 1 ||
      (elem_bytes != 4 && elem_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = elem_bytes == 4 ? make_plan<float>(bm, bk, b)
                                 : make_plan<double>(bm, bk, b);
  out[0] = p.R; out[1] = kC; out[2] = p.stages; out[3] = p.smem;
  out[4] = p.threads;
  return 0;
}

// The packed f32 kernel with R rows a thread (1, 2 or 4) and a ring of
// `stages` stages (2-8) given: for measuring plans against each other
// (tools/bench_spmm.py --plans).
int rbl_bsr_spmm_packed_plan_f32(const int* tile_cols, const int* hcount,
                                 const int* rptr, const float* vals,
                                 const float* X, float* Y, int nb, int bm,
                                 int bk, int b, int unroll, int R, int stages,
                                 void* stream) {
  if (unroll < 1 || bm < 1 || bm > kMaxBM || (R != 1 && R != 2 && R != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<float>(tile_cols, PackedRows{hcount, rptr, unroll}, vals, X,
                       Y, nb, bm, bk, b, stream,
                       Candidate<float>(bm, bk, b, R, stages).plan);
}

}  // extern "C"

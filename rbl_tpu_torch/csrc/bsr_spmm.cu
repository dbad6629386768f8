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
// VMEM or had to be fetched tile by tile; here X is read straight from
// device memory and, at the solver's sizes (a few to tens of MB), stays in
// the 50 MB L2.  Blocked-ELL is the packed layout with L tiles in every
// block-row, so it is the same kernel body, templated on how a block-row
// finds its tile range: no hcount or rptr array exists for it.
//
// Layout (CSR of tiles, built by _packed_bsr_from_scipy): block-row i owns
// the tiles [rptr[i]·U, (rptr[i] + hcount[i])·U) of vals (T, bm, bk) —
// blocked-ELL: [i·L, (i+1)·L); tile t multiplies rows
// [tile_cols[t]·bk, +bk) of X (ncb·bk, b), row-major.
//
// What bounds it: the bytes of vals.  Every tile is read exactly once per
// apply and used for bm·bk·b multiply-adds, while X and Y are small.  The
// design therefore streams each tile once, with many bytes in flight, and
// keeps the sums in registers:
//   - one CTA per block-row (grid.x) and per group of up to 32 columns of
//     X (grid.y), looping over exactly that row's tiles — no grid over the
//     longest row, no no-op steps for short rows;
//   - each tile is staged through shared memory in slices of 32 columns
//     of the contraction (the vals slice and the matching 32 rows of X).
//     vals is read with 16-byte streaming loads into registers one slice
//     AHEAD, so the loads of slice s+1 are in flight while slice s is
//     multiplied; shared rows are padded to 33 so that stores and reads
//     are free of bank conflicts;
//   - thread (row r, column group g) accumulates Y[r, g + G·m] for its
//     columns with FP32 (or FP64) fused multiply-adds — never TF32, the
//     Precision.HIGHEST contract of the TPU kernels (pallas_bsr.py:59-61):
//     one shared read of vals per contraction step serves all its columns.
// No TMA or wgmma yet: the kernel is a plain CUDA C++ one.

#include "spmm_common.cuh"

namespace {

using namespace rbl;

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

template <typename T, int NC, typename Rows>
__global__ void __launch_bounds__(kThreads)
bsr_spmm_kernel(const int* __restrict__ tile_cols, Rows rows,
                const T* __restrict__ vals, const T* __restrict__ X,
                T* __restrict__ Y, int bm, int bk, int b) {
  using V = typename Vec16<T>::type;
  constexpr int kVW = Vec16<T>::n;                  // elements per 16 bytes
  constexpr int kVPR = kKC / kVW;                   // vectors per slice row
  constexpr int kLV = kMaxBM * kVPR / kThreads;     // vectors per thread

  __shared__ T vs[kMaxBM][kKC + 1];
  __shared__ T xs[kKC][kMaxBW + 1];

  const int i = blockIdx.x;
  const int c0 = blockIdx.y * kMaxBW;
  const int bw = min(kMaxBW, b - c0);
  const int tid = threadIdx.x;

  // compute mapping: row r, column group g of G, columns g + G·m
  const int G = kThreads / bm;
  const int r = tid % bm;
  const int g = tid / bm;
  const bool active = g < G && g < bw;
  const int ncol = active ? (bw - g + G - 1) / G : 0;

  const XStage xst(tid, bw, b);

  T acc[NC];
#pragma unroll
  for (int m = 0; m < NC; ++m) acc[m] = T(0);

  V vreg[kLV];
  T xreg[kLX];
  auto prefetch = [&](long long t, int k0) {
    const T* tile = vals + t * bm * bk + k0;
#pragma unroll
    for (int j = 0; j < kLV; ++j) {
      const int v = tid + j * kThreads;
      const int rr = v / kVPR, q = v % kVPR;
      if (rr < bm) {
        vreg[j] = __ldcs(reinterpret_cast<const V*>(
            tile + static_cast<long long>(rr) * bk + q * kVW));
      }
    }
    const T* xt = X + static_cast<long long>(tile_cols[t]) * bk * b +
                  static_cast<long long>(k0) * b + c0;
#pragma unroll
    for (int j = 0; j < kLX; ++j) {
      if (xst.src[j] >= 0) xreg[j] = xt[xst.src[j]];
    }
  };

  long long t0, t1;
  rows.range(i, t0, t1);
  if (t0 < t1) prefetch(t0, 0);
  for (long long t = t0; t < t1; ++t) {
    for (int k0 = 0; k0 < bk; k0 += kKC) {
      __syncthreads();  // the previous slice is no longer read
#pragma unroll
      for (int j = 0; j < kLV; ++j) {
        const int v = tid + j * kThreads;
        const int rr = v / kVPR, q = v % kVPR;
        if (rr < bm) Vec16<T>::unpack(vreg[j], &vs[rr][q * kVW]);
      }
#pragma unroll
      for (int j = 0; j < kLX; ++j) {
        if (xst.src[j] >= 0) (&xs[0][0])[xst.dst[j]] = xreg[j];
      }
      __syncthreads();
      // loads of the next slice fly while this one is multiplied
      if (k0 + kKC < bk) {
        prefetch(t, k0 + kKC);
      } else if (t + 1 < t1) {
        prefetch(t + 1, 0);
      }
      if (active) {
        const T* vrow = vs[r];
#pragma unroll 4
        for (int kk = 0; kk < kKC; ++kk) {
          const T a = vrow[kk];
          const T* xrow = xs[kk] + g;
#pragma unroll
          for (int m = 0; m < NC; ++m) {
            if (m < ncol) acc[m] = fma_rn(a, xrow[m * G], acc[m]);
          }
        }
      }
    }
  }

  if (active) {
    T* yrow = Y + (static_cast<long long>(i) * bm + r) * b + c0 + g;
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      if (m < ncol) yrow[m * G] = acc[m];
    }
  }
}

template <typename T, typename Rows>
int launch(const int* tile_cols, Rows rows, const T* vals, const T* X, T* Y,
           int nb, int bm, int bk, int b, void* stream) {
  if (!valid_launch(nb, bm, bk, b, vals)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nb == 0) return 0;
  const dim3 grid(nb, (b + kMaxBW - 1) / kMaxBW);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  dispatch_ncol(bm, b, [&](auto nc) {
    bsr_spmm_kernel<T, decltype(nc)::value, Rows><<<grid, kThreads, 0, s>>>(
        tile_cols, rows, vals, X, Y, bm, bk, b);
  });
  return static_cast<int>(cudaGetLastError());
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
  if (unroll < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float>(tile_cols, PackedRows{hcount, rptr, unroll}, vals, X,
                       Y, nb, bm, bk, b, stream);
}

int rbl_bsr_spmm_packed_f64(const int* tile_cols, const int* hcount,
                            const int* rptr, const double* vals,
                            const double* X, double* Y, int nb, int bm,
                            int bk, int b, int unroll, void* stream) {
  if (unroll < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch<double>(tile_cols, PackedRows{hcount, rptr, unroll}, vals, X,
                        Y, nb, bm, bk, b, stream);
}

// Blocked-ELL layout (B3): L tiles in every block-row.
int rbl_bsr_spmm_ell_f32(const int* block_cols, const float* block_vals,
                         const float* X, float* Y, int nb, int L, int bm,
                         int bk, int b, void* stream) {
  if (L < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float>(block_cols, EllRows{L}, block_vals, X, Y, nb, bm, bk,
                       b, stream);
}

int rbl_bsr_spmm_ell_f64(const int* block_cols, const double* block_vals,
                         const double* X, double* Y, int nb, int L, int bm,
                         int bk, int b, void* stream) {
  if (L < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch<double>(block_cols, EllRows{L}, block_vals, X, Y, nb, bm, bk,
                        b, stream);
}

}  // extern "C"

// Packed block-sparse SpMM, Y = A·X, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   rbl_tpu/ops/spmm/pallas_bsr.py:418 bsr_spmm_packed_resident
//       (kernel body _make_packed_resident_kernel, :250-288)
//   rbl_tpu/ops/spmm/pallas_bsr.py:182 bsr_spmm_packed
//       (kernel body _make_packed_kernel, :146-175)
// Both Python entry points (rbl_tpu_torch/ops/spmm/bsr.py) launch this one
// kernel: the TPU needed two because X either fit its on-chip VMEM or had
// to be fetched tile by tile; here X is read straight from device memory
// and, at the solver's sizes (a few to tens of MB), stays in the 50 MB L2.
//
// Layout (CSR of tiles, built by _packed_bsr_from_scipy): block-row i owns
// the tiles [rptr[i]·U, (rptr[i] + hcount[i])·U) of vals (T, bm, bk);
// tile t multiplies rows [tile_cols[t]·bk, +bk) of X (ncb·bk, b), row-major.
//
// What bounds it: the bytes of vals.  Every tile is read exactly once per
// apply and used for bm·bk·b multiply-adds, while X and Y are small.  The
// design therefore streams each tile once, with many bytes in flight, and
// keeps the sums in registers:
//   - one CTA per block-row (grid.x) and per group of up to 32 columns of
//     X (grid.y), looping over exactly that row's hcount[i]·U tiles — no
//     grid over the longest row, no no-op steps for short rows;
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

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // threads per CTA
constexpr int kKC = 32;        // contraction slice staged in shared memory
constexpr int kMaxBM = 128;    // tallest tile the kernel takes
constexpr int kMaxBW = 32;     // columns of X one CTA handles
constexpr int kLX = kKC * kMaxBW / kThreads;  // X elements per thread and slice

template <typename T> struct Vec16;
template <> struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
  __device__ static void unpack(const float4& v, float* out) {
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};
template <> struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
  __device__ static void unpack(const double2& v, double* out) {
    out[0] = v.x; out[1] = v.y;
  }
};

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// NC: the most columns one thread accumulates (a power of two ≥ its share
// of the CTA's columns), so that the unrolled column loop issues no more
// than twice the useful multiply-adds.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
bsr_spmm_packed_kernel(const int* __restrict__ tile_cols,
                       const int* __restrict__ hcount,
                       const int* __restrict__ rptr,
                       const T* __restrict__ vals,
                       const T* __restrict__ X,
                       T* __restrict__ Y,
                       int bm, int bk, int b, int unroll) {
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

  // X staging: element e = tid + j·kThreads of the (kKC, bw) slice; the
  // offsets are the same for every slice
  int xsrc[kLX], xdst[kLX];
#pragma unroll
  for (int j = 0; j < kLX; ++j) {
    const int e = tid + j * kThreads;
    const int kk = e / bw, c = e % bw;
    const bool ok = e < kKC * bw;
    xsrc[j] = ok ? kk * b + c : -1;
    xdst[j] = ok ? kk * (kMaxBW + 1) + c : 0;
  }

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
      if (xsrc[j] >= 0) xreg[j] = xt[xsrc[j]];
    }
  };

  const long long t0 = static_cast<long long>(rptr[i]) * unroll;
  const long long t1 = t0 + static_cast<long long>(hcount[i]) * unroll;
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
        if (xsrc[j] >= 0) (&xs[0][0])[xdst[j]] = xreg[j];
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

template <typename T, int NC>
void launch_nc(dim3 grid, cudaStream_t stream, const int* tile_cols,
               const int* hcount, const int* rptr, const T* vals, const T* X,
               T* Y, int bm, int bk, int b, int unroll) {
  bsr_spmm_packed_kernel<T, NC><<<grid, kThreads, 0, stream>>>(
      tile_cols, hcount, rptr, vals, X, Y, bm, bk, b, unroll);
}

template <typename T>
int launch(const int* tile_cols, const int* hcount, const int* rptr,
           const T* vals, const T* X, T* Y, int nb, int bm, int bk, int b,
           int unroll, void* stream) {
  if (bm < 1 || bm > kMaxBM || bk < kKC || bk % kKC != 0 || b < 1 ||
      unroll < 1 || nb < 0 ||
      reinterpret_cast<unsigned long long>(vals) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nb == 0) return 0;
  const dim3 grid(nb, (b + kMaxBW - 1) / kMaxBW);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int groups = kThreads / bm;
  const int ncol = ((b < kMaxBW ? b : kMaxBW) + groups - 1) / groups;
  if (ncol <= 1) {
    launch_nc<T, 1>(grid, s, tile_cols, hcount, rptr, vals, X, Y, bm, bk, b, unroll);
  } else if (ncol <= 2) {
    launch_nc<T, 2>(grid, s, tile_cols, hcount, rptr, vals, X, Y, bm, bk, b, unroll);
  } else if (ncol <= 4) {
    launch_nc<T, 4>(grid, s, tile_cols, hcount, rptr, vals, X, Y, bm, bk, b, unroll);
  } else if (ncol <= 8) {
    launch_nc<T, 8>(grid, s, tile_cols, hcount, rptr, vals, X, Y, bm, bk, b, unroll);
  } else if (ncol <= 16) {
    launch_nc<T, 16>(grid, s, tile_cols, hcount, rptr, vals, X, Y, bm, bk, b, unroll);
  } else {
    launch_nc<T, 32>(grid, s, tile_cols, hcount, rptr, vals, X, Y, bm, bk, b, unroll);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).  All pointers are
// device pointers (vals 16-byte aligned); the launch is asynchronous on
// ``stream``.
int rbl_bsr_spmm_packed_f32(const int* tile_cols, const int* hcount,
                            const int* rptr, const float* vals,
                            const float* X, float* Y, int nb, int bm, int bk,
                            int b, int unroll, void* stream) {
  return launch<float>(tile_cols, hcount, rptr, vals, X, Y, nb, bm, bk, b,
                       unroll, stream);
}

int rbl_bsr_spmm_packed_f64(const int* tile_cols, const int* hcount,
                            const int* rptr, const double* vals,
                            const double* X, double* Y, int nb, int bm,
                            int bk, int b, int unroll, void* stream) {
  return launch<double>(tile_cols, hcount, rptr, vals, X, Y, nb, bm, bk, b,
                        unroll, stream);
}

}  // extern "C"

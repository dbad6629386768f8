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
// (u·bk + kk, m) of chunk c's panel is A-tile c·U+u's (m, kk).  Tile
// c·U+u multiplies rows [tile_cols[c·U+u]·bk, +bk) of X (ncb·bk, b),
// row-major.  On the TPU the panel turned a chunk into one long-K MXU dot
// against a gathered, transposed stack of X tiles, with the sum kept as a
// (b, bm) accumulator and written transposed; the `gather` option chose
// how that stack was assembled in VMEM.  None of that exists here: the
// option is accepted and has no effect.
//
// What bounds it: the bytes of vals_t, as in bsr_spmm.cu — each panel is
// read once per apply.  The panel layout helps the load on this card: a
// contraction slice of kKC panel rows is ONE contiguous run of kKC·bm
// values, so it is read with fully coalesced 16-byte streaming loads and
// stored to shared memory as it lies, with no transpose.  The design is
// bsr_spmm.cu's otherwise:
//   - one CTA per block-row (grid.x) and per group of up to 32 columns of
//     X (grid.y), looping over that row's chunks, and over each chunk's
//     U·bk contraction rows in slices of kKC;
//   - the slice's gathered X rows (tile_cols[c·U + u]·bk + kk) are staged
//     in shared memory beside it; both are loaded into registers one
//     slice ahead of the multiply;
//   - thread (row m, column group g) reads the slice's column m, which
//     consecutive threads read at consecutive addresses (no bank
//     conflicts), and accumulates Y[i·bm + m, g + G·j] in registers with
//     FP32 (FP64) fused multiply-adds, never TF32; Y is written directly,
//     with no transposed accumulator.

#include "spmm_common.cuh"

namespace {

using namespace rbl;

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
bsr_spmm_panel_kernel(const int* __restrict__ tile_cols,
                      const int* __restrict__ hcount,
                      const int* __restrict__ rptr,
                      const T* __restrict__ vals_t,
                      const T* __restrict__ X,
                      T* __restrict__ Y,
                      int bm, int bk, int b, int unroll) {
  using V = typename Vec16<T>::type;
  constexpr int kVW = Vec16<T>::n;                    // elements per 16 B
  constexpr int kLV = kKC * kMaxBM / kVW / kThreads;  // vectors per thread

  __shared__ __align__(16) T ps[kKC * kMaxBM];  // (kKC, bm) slice, as stored
  __shared__ T xs[kKC][kMaxBW + 1];

  const int i = blockIdx.x;
  const int c0 = blockIdx.y * kMaxBW;
  const int bw = min(kMaxBW, b - c0);
  const int tid = threadIdx.x;

  // compute mapping: row m, column group g of G, columns g + G·j
  const int G = kThreads / bm;
  const int m = tid % bm;
  const int g = tid / bm;
  const bool active = g < G && g < bw;
  const int ncol = active ? (bw - g + G - 1) / G : 0;

  const XStage xst(tid, bw, b);
  const int K = unroll * bk;           // contraction rows of one panel
  const int nvec = kKC * bm / kVW;     // vectors of one slice

  T acc[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) acc[j] = T(0);

  V preg[kLV];
  T xreg[kLX];
  auto prefetch = [&](long long c, int k0) {
    const V* slice = reinterpret_cast<const V*>(
        vals_t + (c * K + k0) * static_cast<long long>(bm));
#pragma unroll
    for (int j = 0; j < kLV; ++j) {
      const int v = tid + j * kThreads;
      if (v < nvec) preg[j] = __ldcs(slice + v);
    }
    // a slice lies within one tile u of the chunk (kKC divides bk)
    const int u = k0 / bk, kk0 = k0 % bk;
    const T* xt = X + (static_cast<long long>(tile_cols[c * unroll + u]) * bk +
                       kk0) * b + c0;
#pragma unroll
    for (int j = 0; j < kLX; ++j) {
      if (xst.src[j] >= 0) xreg[j] = xt[xst.src[j]];
    }
  };

  const long long cb = rptr[i];
  const long long ce = cb + hcount[i];
  if (cb < ce) prefetch(cb, 0);
  for (long long c = cb; c < ce; ++c) {
    for (int k0 = 0; k0 < K; k0 += kKC) {
      __syncthreads();  // the previous slice is no longer read
#pragma unroll
      for (int j = 0; j < kLV; ++j) {
        const int v = tid + j * kThreads;
        if (v < nvec) reinterpret_cast<V*>(ps)[v] = preg[j];
      }
#pragma unroll
      for (int j = 0; j < kLX; ++j) {
        if (xst.src[j] >= 0) (&xs[0][0])[xst.dst[j]] = xreg[j];
      }
      __syncthreads();
      // loads of the next slice fly while this one is multiplied
      if (k0 + kKC < K) {
        prefetch(c, k0 + kKC);
      } else if (c + 1 < ce) {
        prefetch(c + 1, 0);
      }
      if (active) {
#pragma unroll 4
        for (int kk = 0; kk < kKC; ++kk) {
          const T a = ps[kk * bm + m];
          const T* xrow = xs[kk] + g;
#pragma unroll
          for (int j = 0; j < NC; ++j) {
            if (j < ncol) acc[j] = fma_rn(a, xrow[j * G], acc[j]);
          }
        }
      }
    }
  }

  if (active) {
    T* yrow = Y + (static_cast<long long>(i) * bm + m) * b + c0 + g;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      if (j < ncol) yrow[j * G] = acc[j];
    }
  }
}

template <typename T>
int launch(const int* tile_cols, const int* hcount, const int* rptr,
           const T* vals_t, const T* X, T* Y, int nb, int bm, int bk, int b,
           int unroll, void* stream) {
  if (!valid_launch(nb, bm, bk, b, vals_t) || unroll < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nb == 0) return 0;
  const dim3 grid(nb, (b + kMaxBW - 1) / kMaxBW);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  dispatch_ncol(bm, b, [&](auto nc) {
    bsr_spmm_panel_kernel<T, decltype(nc)::value><<<grid, kThreads, 0, s>>>(
        tile_cols, hcount, rptr, vals_t, X, Y, bm, bk, b, unroll);
  });
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).  All pointers are
// device pointers (vals_t 16-byte aligned); the launch is asynchronous on
// ``stream``.
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

}  // extern "C"

// Shared pieces of the block-sparse SpMM kernels (bsr_spmm.cu,
// bsr_spmm_panel.cu): the limits of a launch, 16-byte vector loads and
// FP32/FP64 fused multiply-adds.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace rbl {

constexpr int kKC = 32;        // contraction slice; bk is a multiple of it
constexpr int kMaxBM = 128;    // tallest tile the kernels take
constexpr int kMaxBW = 32;     // columns of X one CTA handles

template <typename T> struct Vec16;
template <> struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <> struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
};

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// Arguments every kernel launch checks before it starts.
template <typename T>
bool valid_launch(int nb, int bm, int bk, int b, const T* vals) {
  return bm >= 1 && bm <= kMaxBM && bk >= kKC && bk % kKC == 0 && b >= 1 &&
         nb >= 0 && reinterpret_cast<unsigned long long>(vals) % 16 == 0;
}

}  // namespace rbl

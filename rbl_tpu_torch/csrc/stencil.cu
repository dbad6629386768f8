// The 5-point Dirichlet stencil of Laplacian2D and one step of the
// Chebyshev product filter on it, for Hopper (sm_90a): K3.
//
//   s_c    = 1/sqrt(sumsq_in[c]) where sumsq_in[c] > 0, else 1 (and 1
//            with no sumsq_in)
//   Z[:,c] = ((A − r·I)·Y[:,c])·s_c               (r = 0 with no r)
//   sumsq_out[c] = Σ_rows Z[:,c]²                  (optional)
//
// A is the stencil in the folded layout of Laplacian2D.apply: row
// i = gx·ny + gy of the (n, b) block is grid point (gx, gy); 4 on the
// diagonal, −1 for rows i ± ny (grid rows gx ± 1) and i ± 1 (gy ± 1, within
// the grid row), absent neighbours being zero (Dirichlet).
//
// Replaces no TPU kernel: the JAX package's Laplacian2D.apply and its
// product filter are XLA expressions, which XLA fuses into one loop on the
// TPU.  Eager PyTorch ran them as ~14 launches and ~24 passes over the
// block a filter step (the stencil's 4·Y and four shifted in-place
// subtractions, then −r·Y, the square, the column sum, the square root,
// the where and the divide).  Here a step is one launch: the previous
// step's normalisation is linear, so it is folded into this step's read as
// a per-column scale, and the new column sums come out of the same pass.
//
// Byte bound: read Y once and write Z once, 2·n·b·sizeof(T) bytes over the
// HBM's 3.35 TB/s, plus b sums a CTA; 7-9 FLOP an element, far below the
// FP32/FP64 FMA rates.  So the design is about bytes, and about the L2:
// loading the four neighbours from global memory as well would ask the L2
// for each element five times, more than it serves at the HBM's rate.
// - A CTA owns a tile of ty grid points along y (threadIdx.y) by cgt
//   groups of VEC consecutive columns (threadIdx.x; a 16-byte unit where b,
//   the row stride and the pointer allow it, else 8, 4 or 2 bytes), and
//   marches it along x over gx grid rows.  Each thread keeps rows gx − 1,
//   gx and the next kU rows of its unit in registers: the x-neighbours come
//   from registers, and each element is loaded once (plus the rows before
//   and after the march).
// - The y-neighbours come from shared memory: a batch of kU rows of the
//   tile, with one halo point on each side (loaded by the first and last
//   thread rows), is stored there before one barrier (two tiles, so that a
//   batch never overwrites what the last one reads).
// - A batch's kU rows are loaded before any is used, to keep bytes in
//   flight; the CTAs number three a SM.
// - Offsets are 64-bit (a grid of 8192² at b = 64 passes 2³¹ elements);
//   grid indices 32-bit (n < 2³¹).
// - r and the sums are read on the device: the host never waits.
// - f32 and f64 compute in their own dtype with FP32/FP64 arithmetic (no
//   TF32); bf16 computes in f32 and rounds once.  With no r and no
//   sumsq_in, f32 and f64 give the torch expression's bits: 4·y is exact,
//   and the four subtractions run in its order.
//
// The column sums: each thread adds its points' Z² (Z as stored, in f32,
// f64 for f64), the thread rows of a CTA are added in a fixed tree in
// shared memory, the CTA stores its partial, and the last CTA of a column
// tile to finish (a ticket counter, reset by that CTA) adds every CTA's
// partial in the same fixed order.  No value atomics: two calls agree bit
// for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // most threads a CTA
constexpr int kMaxCgt = 16;    // most column groups a CTA
constexpr int kU = 4;          // grid rows a batch
constexpr int kMaxSmem = 48 * 1024;  // most dynamic shared bytes a CTA (no opt-in)

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

// The compute dtype: f64 for f64, else f32.
template <typename T> struct Compute { using type = float; };
template <> struct Compute<double> { using type = double; };

__device__ __forceinline__ float up(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float up(float x) { return x; }
__device__ __forceinline__ double up(double x) { return x; }

template <typename T> __device__ __forceinline__ T down(float x);
template <> __device__ __forceinline__ bf16 down<bf16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ float down<float>(float x) { return x; }
template <typename T> __device__ __forceinline__ T down(double x);
template <> __device__ __forceinline__ double down<double>(double x) { return x; }

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> zeros() {
  Pack<T, VEC> p;
#pragma unroll
  for (int k = 0; k < VEC; ++k) p.v[k] = down<T>(typename Compute<T>::type(0));
  return p;
}

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load(const T* p) {
  return *reinterpret_cast<const Pack<T, VEC>*>(p);
}

struct StencilArgs {
  long long ld;  // Y's row stride, in elements
  int nx, ny;    // the grid: row i of the block is (i / ny, i % ny)
  int b;         // columns
  int cgt;       // column groups of VEC columns a CTA (threadIdx.x)
  int ty;        // grid points along y a CTA (threadIdx.y), at least 2
  int gx;        // grid rows a CTA marches over
  int ytiles;    // CTAs along y: blockIdx.x = march · ytiles + y tile
};

// Adds the thread rows' VEC values in sh (row-major) in a fixed tree:
// halves rounded up, the upper half added onto the lower.  Row 0 holds the
// sum.
template <typename C, int VEC>
__device__ __forceinline__ void row_tree(C* sh, int cx, int ly, int cgt, int ty) {
  for (int w = ty; w > 1;) {
    const int h = (w + 1) / 2;
    if (ly < w - h) {
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        sh[(ly * cgt + cx) * VEC + k] += sh[((ly + h) * cgt + cx) * VEC + k];
    }
    w = h;
    __syncthreads();
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 3)
stencil_kernel(const T* __restrict__ Y, T* __restrict__ Z,
               const T* __restrict__ r,
               const typename Compute<T>::type* __restrict__ sumsq_in,
               typename Compute<T>::type* __restrict__ sumsq_out,
               typename Compute<T>::type* __restrict__ part,
               unsigned* __restrict__ tickets, const StencilArgs a) {
  using C = typename Compute<T>::type;
  using P = Pack<T, VEC>;
  // two batches' tiles, then (after the march) the column sums' tree
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool last;
  const int cx = threadIdx.x, ly = threadIdx.y;
  const int c0 = (blockIdx.y * a.cgt + cx) * VEC;  // this thread's first column
  const int gy = (blockIdx.x % a.ytiles) * a.ty + ly;
  const int g0 = (blockIdx.x / a.ytiles) * a.gx;
  const int g1 = min(a.nx, g0 + a.gx);
  const bool cols = c0 < a.b;
  const bool active = cols && gy < a.ny;
  // the first and last thread rows also load the tile's halo points
  const bool edge = ly == 0 || ly == a.ty - 1;
  const int hy = ly == 0 ? gy - 1 : gy + 1;
  const bool halo = edge && cols && hy >= 0 && hy < a.ny;
  const int hslot = ly == 0 ? 0 : a.ty + 1;
  const int width = (a.ty + 2) * a.cgt;  // units of a batch row
  const T* mine = Y + static_cast<long long>(gy) * a.ld + c0;
  const T* side = Y + static_cast<long long>(hy) * a.ld + c0;
  const long long xstep = static_cast<long long>(a.ny) * a.ld;

  const C rv = r != nullptr ? up(r[0]) : C(0);
  C s[VEC], acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    s[k] = C(1);
    acc[k] = C(0);
    if (sumsq_in != nullptr && cols) {
      const C q = sumsq_in[c0 + k];
      if (q > C(0)) s[k] = C(1) / sqrt(q);
    }
  }

  P prev = zeros<T, VEC>(), cur = zeros<T, VEC>();
  if (active && g0 > 0) prev = load<T, VEC>(mine + (g0 - 1) * xstep);
  if (active && g0 < g1) cur = load<T, VEC>(mine + g0 * xstep);
  for (int g = g0, buf = 0; g < g1; g += kU, buf ^= 1) {
    // a batch writes the tile the batch before last read: every thread
    // passed the last batch's barrier after it had read it
    P* tile = reinterpret_cast<P*>(smem) + buf * kU * width;
    // grid rows g + 1 .. g + kU of this point (the last one the x-neighbour
    // of the batch's last row)
    P nxt[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int row = g + 1 + u;
      nxt[u] = active && row <= g1 && row < a.nx
                   ? load<T, VEC>(mine + row * xstep) : zeros<T, VEC>();
    }
    if (edge) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int row = g + u;
        tile[u * width + hslot * a.cgt + cx] =
            halo && row < g1 ? load<T, VEC>(side + row * xstep) : zeros<T, VEC>();
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u)
      tile[u * width + (ly + 1) * a.cgt + cx] = u == 0 ? cur : nxt[u - 1];
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int row = g + u;
      if (active && row < g1) {
        const P c = u == 0 ? cur : nxt[u - 1];
        const P xm = u == 0 ? prev : (u == 1 ? cur : nxt[u - 2]);
        const P& xp = nxt[u];
        const P ym = tile[u * width + ly * a.cgt + cx];
        const P yp = tile[u * width + (ly + 2) * a.cgt + cx];
        P out;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const C y = up(c.v[k]);
          C t = C(4) * y;
          t -= up(xm.v[k]);
          t -= up(xp.v[k]);
          t -= up(ym.v[k]);
          t -= up(yp.v[k]);
          if (r != nullptr) t -= rv * y;
          if (sumsq_in != nullptr) t *= s[k];
          out.v[k] = down<T>(t);
          const C z = up(out.v[k]);
          acc[k] += z * z;
        }
        *reinterpret_cast<P*>(
            Z + (static_cast<long long>(row) * a.ny + gy) * a.b + c0) = out;
      }
    }
    prev = nxt[kU - 2];
    cur = nxt[kU - 1];
  }
  if (sumsq_out == nullptr) return;

  // this CTA's partial of its columns: the thread rows in a fixed tree
  __syncthreads();  // the march has read the tile
  C* sh = reinterpret_cast<C*>(smem);
  C* own = sh + (ly * a.cgt + cx) * VEC;
#pragma unroll
  for (int k = 0; k < VEC; ++k) own[k] = acc[k];
  __syncthreads();
  row_tree<C, VEC>(sh, cx, ly, a.cgt, a.ty);
  if (ly == 0 && cols) {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      __stcg(part + static_cast<long long>(blockIdx.x) * a.b + c0 + k, sh[cx * VEC + k]);
  }
  __threadfence();
  __syncthreads();
  const int tid = ly * a.cgt + cx;
  if (tid == 0) last = atomicAdd(tickets + blockIdx.y, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last CTA of this column tile: CTA j's partial to thread row
  // j mod ty, each row's in order of j, then the rows in the same tree
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = C(0);
  if (cols) {
    for (int j = ly; j < static_cast<int>(gridDim.x); j += a.ty) {
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        acc[k] += __ldcg(part + static_cast<long long>(j) * a.b + c0 + k);
    }
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) own[k] = acc[k];
  __syncthreads();
  row_tree<C, VEC>(sh, cx, ly, a.cgt, a.ty);
  if (ly == 0 && cols) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) sumsq_out[c0 + k] = sh[cx * VEC + k];
  }
  if (tid == 0) tickets[blockIdx.y] = 0u;
}

template <typename T, int VEC>
int launch_vec(const void* Y, void* Z, const void* r, const void* sin,
               void* sout, void* part, void* tickets, const StencilArgs& a,
               int ctas, int tiles, void* stream) {
  using C = typename Compute<T>::type;
  // two tiles of kU rows of (ty + 2) × cgt units, or the sums' tree
  const int tile = 2 * kU * (a.ty + 2) * a.cgt * VEC * static_cast<int>(sizeof(T));
  const int smem = max(tile, a.ty * a.cgt * VEC * static_cast<int>(sizeof(C)));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(ctas, tiles), block(a.cgt, a.ty);
  stencil_kernel<T, VEC><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Y), static_cast<T*>(Z), static_cast<const T*>(r),
      static_cast<const C*>(sin), static_cast<C*>(sout), static_cast<C*>(part),
      static_cast<unsigned*>(tickets), a);
  return static_cast<int>(cudaGetLastError());
}

// prm: nx, ny, ld, b, vec, cgt, ty, gx, ytiles, ctas, tiles
template <typename T>
int launch_stencil(const void* Y, void* Z, const void* r, const void* sin,
                   void* sout, void* part, void* tickets, const long long* prm,
                   void* stream) {
  const long long nx = prm[0], ny = prm[1], ld = prm[2], b = prm[3], vec = prm[4],
                  cgt = prm[5], ty = prm[6], gx = prm[7], ytiles = prm[8],
                  ctas = prm[9], tiles = prm[10];
  const auto misaligned = [&](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % (vec * sizeof(T)) != 0;
  };
  if (nx < 1 || ny < 1 || nx * ny >= (1LL << 31) || b < 1 || b > (1LL << 30) ||
      vec < 1 || (vec & (vec - 1)) || vec * static_cast<long long>(sizeof(T)) > 16 ||
      b % vec || ld % vec || ld < b || cgt < 1 || cgt > kMaxCgt || ty < 2 ||
      cgt * ty > kThreads || gx < 1 || ytiles < 1 || (ytiles - 1) * ty >= ny ||
      ytiles * ty < ny || ctas != ytiles * ((nx + gx - 1) / gx) ||
      ctas > (1LL << 31) - 1 || tiles < 1 || tiles > 65535 ||
      tiles * cgt * vec < b || (tiles - 1) * cgt * vec >= b ||
      misaligned(Y) || misaligned(Z) ||
      (sout != nullptr && (part == nullptr || tickets == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const StencilArgs a{ld, static_cast<int>(nx), static_cast<int>(ny),
                      static_cast<int>(b), static_cast<int>(cgt),
                      static_cast<int>(ty), static_cast<int>(gx),
                      static_cast<int>(ytiles)};
  const int g = static_cast<int>(ctas), t = static_cast<int>(tiles);
  switch (vec) {
    case 1: return launch_vec<T, 1>(Y, Z, r, sin, sout, part, tickets, a, g, t, stream);
    case 2: return launch_vec<T, 2>(Y, Z, r, sin, sout, part, tickets, a, g, t, stream);
    case 4:
      if constexpr (sizeof(T) <= 4)
        return launch_vec<T, 4>(Y, Z, r, sin, sout, part, tickets, a, g, t, stream);
      break;
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch_vec<T, 8>(Y, Z, r, sin, sout, part, tickets, a, g, t, stream);
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// rbl_stencil_<T>: Z (n, b), row-major, from Y (n, b) with row stride ld
// (column stride 1), both in T, n = nx·ny.  r: a device scalar of T, or null
// (r = 0); sumsq_in: b device values of the compute dtype (f64 for f64,
// else f32), or null (s = 1); sumsq_out: b of them, or null (no sums; part
// and tickets then unused); part: ctas·b of them of scratch; tickets: tiles
// zeroed unsigned counters (left zeroed).  prm is a host array of the shape
// and the plan that ops/spmm/_kernels.py computes.  Returns the cudaError_t
// of the launch, which is asynchronous on ``stream``.
#define RBL_STENCIL(NT, T)                                                      \
  int rbl_stencil_##NT(const void* Y, void* Z, const void* r, const void* sin,  \
                       void* sout, void* part, void* tickets,                   \
                       const long long* prm, void* stream) {                    \
    return launch_stencil<T>(Y, Z, r, sin, sout, part, tickets, prm, stream);   \
  }
RBL_STENCIL(bf16, bf16)
RBL_STENCIL(f32, float)
RBL_STENCIL(f64, double)
#undef RBL_STENCIL

}  // extern "C"

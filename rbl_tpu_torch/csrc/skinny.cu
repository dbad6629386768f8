// Tall-skinny contractions against the stored Krylov basis for Hopper
// (sm_90a): the Gram C = XᵀY (K1) and the update Out = W − V·round(G), or
// Out = V·G with no W (K2).
//
// Replaces no TPU kernel: the JAX package leaves these products to XLA's
// dot.  Added because on the card they were cuBLAS SIMT GEMMs fed by
// copies: every projection cast the whole stored prefix to f32 twice (once
// for the Gram, once for the update) before cuBLAS read it, and cuBLAS pads
// the 8- or 16-column side to tiles of 32-128 or falls back to gemmSN.  The
// Gram also ran its row chunks as one bmm and reduced the chunk partials in
// ~10 small launches.  Here each product is one launch that reads every
// operand in the dtype it is stored in (bf16, f32 or f64).
//
// Byte bound: a projection of W (n, q) against a prefix V (n, p) reads V
// twice (once per kernel) and W three times, so 2·n·p·sizeof(V) +
// 3·n·q·sizeof(W) bytes over the HBM's 3.35 TB/s.  At q = 8 or 16 both
// kernels sit at 2-16 FLOP a byte: bandwidth-bound on FP32 FFMA (67
// TFLOP/s) for f32 and f64 bases, close to both limits for a bf16 basis at
// q = 16 (16 FLOP a byte, 54 TFLOP/s at full bandwidth).  No tensor cores:
// TF32 or bf16 products would lower the stated precision.
//
// Both kernels stream their operands through a ring of kStages tiles in
// shared memory filled by asynchronous copies (cp.async: 16-, 8- or 4-byte
// units along the contiguous dimension, zero-filled past the matrix), so
// kStages − 1 tiles are in flight while one is used; an operand whose
// layout allows no such unit (a strided bf16 block) is staged with plain
// loads.  The tiles keep the stored dtypes; values are converted to the
// accumulation type as they are used.
//
// K1 (gram_kernel).  Row chunks of `chunk` rows, as ops/contract.py's plain
// version cuts them (the ragged tail is the last chunk).  A CTA takes one
// chunk (or a piece of one) and one tile of TP = nct·CP columns of X; the
// tiles narrow (down to 8 column groups) until the chunks and tiles fill
// two CTAs a SM.  Its
// threads are (nct column groups of CP columns, the fastest-varying) ×
// (nqt groups of 8 columns of Y) × (rgn row groups); a step of the ring
// holds 4 rows a row group (8 for a bf16 X).  The plan follows from the
// shapes and dtypes alone, never from the operands' layouts (the ring
// takes any strides), so the sums are the same bits whatever the layout.  Where chunks × tiles would leave SMs idle, each chunk is
// cut into `split` pieces, one a CTA; the last piece of a chunk to finish
// (a ticket counter) adds the pieces' partials in order.  The row groups' partials are added in a fixed tree in shared
// memory; the CTA writes its (TP, q) partial.  The last CTA of a column
// tile to finish (a ticket counter, reset by that CTA) stages the tile's
// partials of every chunk in shared memory, a batch of elements at a time,
// and adds each element's in exactly the plain version's pairwise tree:
// even + odd at each level, an odd tail carried.  No value atomics: two
// calls agree bit for bit.
//
// K2 (update_kernel).  The CTAs stay resident (two a SM) and walk row
// tiles of BM = ntm·4 rows, for a column tile of QT = ntq·4 columns of the
// output, 4×4 a thread; the column tiles are the grid's fastest index and
// share the resident CTAs, so that a row tile of V is read by all of them
// at once (from the L2 after the first).  G's rows (a panel of them when p·QT is large) are
// rounded to V's dtype, as the plain version rounds them, and staged in
// shared memory once a CTA, transposed.  V streams through a ring of
// slabs of BK = kg·KS columns, KS being 32 bytes of a row, so that a warp
// reads long row segments: the kg threads of a k group split the slab's
// columns between them (16-byte chunks, interleaved, which keeps both V's
// and G's reads free of bank conflicts) and add their partials in a warp
// butterfly at the tile's end.  W's tile rides with the tile's last slab.
// Each V element is read from HBM once when q ≤ 16 (larger q takes
// ⌈q/16⌉ column tiles, each reading V, the later ones mostly from the L2).  The epilogue subtracts from W in
// W's dtype as the plain version does (W − round(V·G)).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;         // most threads a CTA
constexpr int kStages = 4;            // tiles in the shared-memory ring
constexpr int kMaxSmem = 160 * 1024;  // most dynamic shared bytes a CTA
constexpr int kTM = 4;                // output rows a thread (K2)
constexpr int kTN = 4;                // output columns a thread (K2)

// dtype codes of the C interface
enum Code { kNone = 0, kBF16 = 1, kF32 = 2, kF64 = 3 };

template <typename T, int N>
struct alignas(sizeof(T) * N > 16 ? 16 : sizeof(T) * N) Pack {
  T v[N];
};

// Conversions (bf16 through float, as torch converts).
template <typename To> __device__ __forceinline__ To cvt(float x);
template <> __device__ __forceinline__ float cvt<float>(float x) { return x; }
template <> __device__ __forceinline__ double cvt<double>(float x) { return x; }
template <> __device__ __forceinline__ bf16 cvt<bf16>(float x) {
  return __float2bfloat16_rn(x);
}
template <typename To> __device__ __forceinline__ To cvt(double x);
template <> __device__ __forceinline__ float cvt<float>(double x) {
  return static_cast<float>(x);
}
template <> __device__ __forceinline__ double cvt<double>(double x) { return x; }
template <> __device__ __forceinline__ bf16 cvt<bf16>(double x) {
  return __float2bfloat16_rn(static_cast<float>(x));
}
template <typename To> __device__ __forceinline__ To cvt(bf16 x) {
  return static_cast<To>(__bfloat162float(x));
}

template <typename T> __device__ __forceinline__ T zero() { return T(0); }
template <> __device__ __forceinline__ bf16 zero<bf16>() {
  return __float2bfloat16_rn(0.f);
}

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// Element i of a tensor of dtype `code`, as TA.
template <typename TA>
__device__ __forceinline__ TA load_code(const void* p, int code, long long i) {
  switch (code) {
    case kBF16: return cvt<TA>(static_cast<const bf16*>(p)[i]);
    case kF32: return cvt<TA>(static_cast<const float*>(p)[i]);
    default: return cvt<TA>(static_cast<const double*>(p)[i]);
  }
}

// ------------------------------------------------------------- copies ----

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// src_bytes < B zero-fills the rest of the unit (0: all of it).
template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  if constexpr (B == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "n"(B), "r"(src_bytes));
  }
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Stage rows [r0, r0 + R) × columns [c0, c0 + C) of the strided n × ncols
// matrix M (element (r, c) at M[r·rs + c·cs]) into S, row stride lds
// elements, zero outside M.  mode > 0: copy units of `mode` bytes along the
// columns (cs == 1; C, c0 and the rows aligned to the unit); mode < 0:
// elements of −mode bytes, lanes along the rows; 0: plain loads and stores.
template <typename T>
__device__ __forceinline__ void stage(T* S, int lds, const T* M, long long rs,
                                      long long cs, long long n, int ncols,
                                      long long r0, int c0, int R, int C, int mode) {
  const int tid = threadIdx.x, nth = blockDim.x;
  if (mode > 0) {
    const int ve = mode / static_cast<int>(sizeof(T));
    const int upr = C / ve;
    for (int i = tid; i < R * upr; i += nth) {
      const int rr = i / upr, cc = (i % upr) * ve;
      const long long r = r0 + rr;
      const int c = c0 + cc;
      const int left =
          r < n ? max(0, min(ve, ncols - c)) * static_cast<int>(sizeof(T)) : 0;
      const T* src = left ? M + r * rs + c : M;
      T* dst = S + rr * lds + cc;
      if (mode == 16) cp_async<16>(dst, src, left);
      else if (mode == 8) cp_async<8>(dst, src, left);
      else cp_async<4>(dst, src, left);
    }
  } else if (mode < 0) {
    for (int i = tid; i < R * C; i += nth) {
      const int rr = i % R, cc = i / R;
      const long long r = r0 + rr;
      const int c = c0 + cc;
      const bool ok = r < n && c < ncols;
      const T* src = ok ? M + r * rs + c * cs : M;
      T* dst = S + rr * lds + cc;
      if (mode == -8) cp_async<8>(dst, src, ok ? 8 : 0);
      else cp_async<4>(dst, src, ok ? 4 : 0);
    }
  } else {
    for (int i = tid; i < R * C; i += nth) {
      int rr, cc;
      if (cs == 1) {
        rr = i / C;
        cc = i % C;
      } else {
        rr = i % R;
        cc = i / R;
      }
      const long long r = r0 + rr;
      const int c = c0 + cc;
      S[rr * lds + cc] = (r < n && c < ncols) ? M[r * rs + c * cs] : zero<T>();
    }
  }
}

// One thread's share of a tile copied in 16-byte units: the same units at
// every step, only the tile's first row moves, so each unit's place in the
// tile is worked out once (at most kUnits a thread; stage() takes other
// tiles).
constexpr int kUnits = 8;
struct Units {
  int n;               // units this thread copies a step
  int at[kUnits];      // row << 16 | column within the tile
};

template <typename T>
__device__ __forceinline__ bool plan_units(Units& u, int R, int C, int mode) {
  constexpr int ve = 16 / static_cast<int>(sizeof(T));
  const int upr = C / ve, total = R * upr;
  u.n = 0;
  if (mode != 16 || total > kUnits * static_cast<int>(blockDim.x) || C >= 1 << 16) {
    return false;
  }
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    u.at[k] = (i / upr) << 16 | (i % upr) * ve;
    if (i < total) u.n = k + 1;
  }
  return true;
}

// The units of the tile whose first element is `first` (row stride rs),
// `rows_left` rows and `cols_left` columns before the matrix ends, into S
// (row stride lds); `any` is a valid address for units all zero fill.
template <typename T>
__device__ __forceinline__ void copy_units(const Units& u, T* S, int lds,
                                           const T* first, long long rs,
                                           const void* any, long long rows_left,
                                           int cols_left) {
  constexpr int ve = 16 / static_cast<int>(sizeof(T));
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    if (k < u.n) {
      const int row = u.at[k] >> 16, col = u.at[k] & 0xffff;
      const int bytes = row < rows_left
                            ? max(0, min(ve, cols_left - col)) * static_cast<int>(sizeof(T))
                            : 0;
      cp_async<16>(S + row * lds + col, bytes ? first + row * rs + col : any, bytes);
    }
  }
}

// ---------------------------------------------------------------- K1 ----

constexpr int kCQ = 8;  // columns of Y a thread (K1)

struct GramArgs {
  long long n, xr, xc, yr, yc, chunk, sublen;
  int p, q, nchunks, split, nct, nqt, rgn, xmode, ymode, ldx, ldy, smem;
};

template <typename TX, typename TY, typename TA, int CP>
__global__ void __launch_bounds__(kThreads)
gram_kernel(const TX* __restrict__ X, const TY* __restrict__ Y, GramArgs a,
            TA* __restrict__ part, TA* __restrict__ out,
            unsigned* __restrict__ tickets) {
  constexpr int R = sizeof(TX) == 2 ? 8 : 4;  // rows a row group takes a step
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int cols = a.nct * a.nqt;
  const int ct = tid % a.nct, qt = (tid / a.nct) % a.nqt, rg = tid / cols;
  const int TP = a.nct * CP;
  const int QT = a.nqt * kCQ;
  const int c0 = blockIdx.y * TP;
  const int RB = a.rgn * R;
  const int xbytes = RB * a.ldx * static_cast<int>(sizeof(TX));
  const int sbytes = xbytes + RB * a.ldy * static_cast<int>(sizeof(TY));
  const int chunk_id = blockIdx.x / a.split, piece = blockIdx.x % a.split;
  const long long cbeg = static_cast<long long>(chunk_id) * a.chunk;
  const long long cend = min(cbeg + a.chunk, a.n);
  const long long rbeg = min(cbeg + piece * a.sublen, cend);
  const long long rend = min(rbeg + a.sublen, cend);
  const int nsteps = static_cast<int>((rend - rbeg + RB - 1) / RB);

  Units ux, uy;
  const bool fx = plan_units<TX>(ux, RB, TP, a.xmode);
  const bool fy = plan_units<TY>(uy, RB, QT, a.ymode);
  auto fetch = [&](int step) {
    if (step < nsteps) {
      unsigned char* b = smem + (step % kStages) * sbytes;
      const long long r0 = rbeg + static_cast<long long>(step) * RB;
      if (fx) {
        copy_units(ux, reinterpret_cast<TX*>(b), a.ldx, X + r0 * a.xr + c0, a.xr, X,
                   rend - r0, a.p - c0);
      } else {
        stage<TX>(reinterpret_cast<TX*>(b), a.ldx, X, a.xr, a.xc, rend, a.p, r0,
                  c0, RB, TP, a.xmode);
      }
      if (fy) {
        copy_units(uy, reinterpret_cast<TY*>(b + xbytes), a.ldy, Y + r0 * a.yr, a.yr,
                   Y, rend - r0, a.q);
      } else {
        stage<TY>(reinterpret_cast<TY*>(b + xbytes), a.ldy, Y, a.yr, a.yc, rend,
                  a.q, r0, 0, RB, QT, a.ymode);
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) fetch(st);

  TA acc[CP][kCQ];
#pragma unroll
  for (int i = 0; i < CP; ++i)
#pragma unroll
    for (int j = 0; j < kCQ; ++j) acc[i][j] = TA(0);

  for (int i = 0; i < nsteps; ++i) {
    cp_wait<kStages - 2>();
    __syncthreads();  // step i has landed; step i − 1's tile is free
    fetch(i + kStages - 1);
    const unsigned char* b = smem + (i % kStages) * sbytes;
    const TX* xs = reinterpret_cast<const TX*>(b) + ct * CP;
    const TY* ys = reinterpret_cast<const TY*>(b + xbytes) + qt * kCQ;
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int row = u * a.rgn + rg;
      const Pack<TX, CP> xv = *reinterpret_cast<const Pack<TX, CP>*>(xs + row * a.ldx);
      const Pack<TY, kCQ> yv = *reinterpret_cast<const Pack<TY, kCQ>*>(ys + row * a.ldy);
      TA x[CP], y[kCQ];
#pragma unroll
      for (int k = 0; k < CP; ++k) x[k] = cvt<TA>(xv.v[k]);
#pragma unroll
      for (int j = 0; j < kCQ; ++j) y[j] = cvt<TA>(yv.v[j]);
#pragma unroll
      for (int k = 0; k < CP; ++k)
#pragma unroll
        for (int j = 0; j < kCQ; ++j) acc[k][j] = fma_rn(x[k], y[j], acc[k][j]);
    }
  }
  cp_wait<0>();

  // the row groups' partials, in a fixed tree: [h, m) folds onto [0, m - h)
  TA* red = reinterpret_cast<TA*>(smem);
  const int cidx = qt * a.nct + ct;
  for (int m = a.rgn; m > 1;) {
    const int h = (m + 1) / 2;
    const int slots = (m - h) * cols;
    __syncthreads();
    if (rg >= h && rg < m) {
#pragma unroll
      for (int k = 0; k < CP; ++k)
#pragma unroll
        for (int j = 0; j < kCQ; ++j)
          red[(k * kCQ + j) * slots + (rg - h) * cols + cidx] = acc[k][j];
    }
    __syncthreads();
    if (rg < m - h) {
#pragma unroll
      for (int k = 0; k < CP; ++k)
#pragma unroll
        for (int j = 0; j < kCQ; ++j)
          acc[k][j] += red[(k * kCQ + j) * slots + rg * cols + cidx];
    }
    m = h;
  }

  const long long pq = static_cast<long long>(a.p) * a.q;
  const bool single = a.nchunks * a.split == 1;
  TA* dst = single ? out : part + blockIdx.x * pq;
  if (rg == 0) {
    const int cc = c0 + ct * CP, qq = qt * kCQ;
#pragma unroll
    for (int k = 0; k < CP; ++k)
#pragma unroll
      for (int j = 0; j < kCQ; ++j)
        if (cc + k < a.p && qq + j < a.q)
          __stcg(dst + static_cast<long long>(cc + k) * a.q + qq + j, acc[k][j]);
  }
  if (single) return;
  // the tile's elements are contiguous in each partial
  const long long lo = static_cast<long long>(c0) * a.q;
  const int total = min(TP, a.p - c0) * a.q;
  if (a.split > 1) {
    // the last piece of this chunk to finish adds the chunk's pieces in order
    __threadfence();
    __syncthreads();
    unsigned* t = tickets + chunk_id * gridDim.y + blockIdx.y;
    if (tid == 0) last = atomicAdd(t, 1u) == static_cast<unsigned>(a.split - 1);
    __syncthreads();
    if (!last) return;
    __threadfence();
    TA* pc = part + static_cast<long long>(chunk_id) * a.split * pq + lo;
    for (int e = tid; e < total; e += blockDim.x) {
      TA v = __ldcg(pc + e);
      for (int k = 1; k < a.split; ++k) v += __ldcg(pc + k * pq + e);
      if (a.nchunks == 1) out[lo + e] = v;
      else __stcg(pc + e, v);
    }
    if (tid == 0) *t = 0;
    if (a.nchunks == 1) return;
  }
  __threadfence();
  __syncthreads();
  unsigned* t = tickets + a.nchunks * gridDim.y + blockIdx.y;
  if (tid == 0) last = atomicAdd(t, 1u) == static_cast<unsigned>(a.nchunks - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last chunk of this column tile: a batch of E elements of every
  // chunk's partial at a time, each added in the plain version's tree
  const long long step = a.split * pq;
  const int E = min(total, a.smem / (a.nchunks * static_cast<int>(sizeof(TA))));
  TA* sp = reinterpret_cast<TA*>(smem);
  for (int e0 = 0; e0 < total; e0 += E) {
    const int ne = min(E, total - e0);
    __syncthreads();
#pragma unroll 4
    for (int i = tid; i < a.nchunks * ne; i += blockDim.x) {
      const int c = i / ne, e = i % ne;
      sp[c * ne + e] = __ldcg(part + c * step + lo + e0 + e);
    }
    __syncthreads();
    for (int e = tid; e < ne; e += blockDim.x) {
      for (int m = a.nchunks; m > 1;) {
        const int h = m / 2;
        for (int k = 0; k < h; ++k)
          sp[k * ne + e] = sp[2 * k * ne + e] + sp[(2 * k + 1) * ne + e];
        if (m & 1) sp[h * ne + e] = sp[(m - 1) * ne + e];
        m = h + (m & 1);
      }
      out[lo + e0 + e] = sp[e];
    }
  }
  if (tid == 0) *t = 0;
}

// ---------------------------------------------------------------- K2 ----

constexpr int kStages2 = 3;  // tiles in K2's ring (G takes shared memory too)

struct UpdArgs {
  long long n, vr, vc, gr, gc, wr, wc;
  int p, q, ntq, kg, ntm, vmode, wmode, gcode, wcode, ocode, lda, ldw, pg, ldgt;
};

// Out[i] from the accumulated product and, with W, W's element w: the
// plain version's W − (V·G).to(W.dtype), in W's dtype (bf16 arithmetic in
// float).
template <typename TA>
__device__ __forceinline__ void store_out(void* out, long long i, TA w,
                                          const UpdArgs& a, TA acc) {
  const bool sub = a.wcode != kNone;
  switch (a.ocode) {
    case kBF16: {
      const bf16 d = cvt<bf16>(acc);
      static_cast<bf16*>(out)[i] =
          sub ? __float2bfloat16_rn(cvt<float>(w) - __bfloat162float(d)) : d;
      break;
    }
    case kF32: {
      const float d = cvt<float>(acc);
      static_cast<float*>(out)[i] = sub ? cvt<float>(w) - d : d;
      break;
    }
    default: {
      const double d = cvt<double>(acc);
      static_cast<double*>(out)[i] = sub ? cvt<double>(w) - d : d;
    }
  }
}

// Raw elements of a given size (a tile copied whatever its dtype).
template <int S> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = unsigned long long; };

template <int S>
__device__ __forceinline__ void stage_raw(unsigned char* S_, int lds, const void* M,
                                          long long rs, long long cs, long long n,
                                          int ncols, long long r0, int c0, int R,
                                          int C, int mode) {
  using T = typename Raw<S>::type;
  stage<T>(reinterpret_cast<T*>(S_), lds, static_cast<const T*>(M), rs, cs, n, ncols,
           r0, c0, R, C, mode);
}

constexpr unsigned kFull = 0xffffffffu;
__device__ __forceinline__ float shfl_xor(float v, int m) {
  return __shfl_xor_sync(kFull, v, m);
}
__device__ __forceinline__ double shfl_xor(double v, int m) {
  return __shfl_xor_sync(kFull, v, m);
}

template <typename TV, typename TA>
__global__ void __launch_bounds__(kThreads)
update_kernel(const TV* __restrict__ V, const void* __restrict__ G,
              const void* __restrict__ W, void* __restrict__ Out, UpdArgs a) {
  constexpr int KS = 32 / sizeof(TV);  // k a thread takes a slab: 32 bytes of V
  constexpr int KV = 16 / sizeof(TA);  // k a thread takes at a time
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int kgi = tid % a.kg, tn = (tid / a.kg) % a.ntq, tm = tid / (a.kg * a.ntq);
  const int BM = a.ntm * kTM, QT = a.ntq * kTN, BK = a.kg * KS;
  const int q0 = blockIdx.x * QT;
  const int wsize = a.wcode == kNone ? 0 : (a.wcode == kBF16 ? 2 : (a.wcode == kF32 ? 4 : 8));
  TA* Gt = reinterpret_cast<TA*>(smem);
  const int gbytes = (QT * a.ldgt * static_cast<int>(sizeof(TA)) + 15) / 16 * 16;
  const int vbytes = BM * a.lda * static_cast<int>(sizeof(TV));
  const int sbytes = vbytes + (BM * a.ldw * wsize + 15) / 16 * 16;
  unsigned char* ring = smem + gbytes;
  const long long ntiles = (a.n + BM - 1) / BM;
  const int nslabs = (a.p + BK - 1) / BK;
  const long long mine = (ntiles - blockIdx.y + gridDim.y - 1) / gridDim.y;
  const long long nsteps = mine * nslabs;

  Units uv;
  const bool fv = plan_units<TV>(uv, BM, BK, a.vmode);
  auto fetch = [&](long long s) {
    if (s < nsteps) {
      unsigned char* b = ring + (s % kStages2) * sbytes;
      const long long r0 = (blockIdx.y + (s / nslabs) * gridDim.y) * BM;
      const int slab = static_cast<int>(s % nslabs), k0 = slab * BK;
      if (fv) {
        copy_units(uv, reinterpret_cast<TV*>(b), a.lda, V + r0 * a.vr + k0, a.vr, V,
                   a.n - r0, a.p - k0);
      } else {
        stage<TV>(reinterpret_cast<TV*>(b), a.lda, V, a.vr, a.vc, a.n, a.p, r0, k0,
                  BM, BK, a.vmode);
      }
      if (wsize && slab == nslabs - 1) {  // W's tile rides with the last slab
        unsigned char* w = b + vbytes;
        if (wsize == 2)
          stage_raw<2>(w, a.ldw, W, a.wr, a.wc, a.n, a.q, r0, q0, BM, QT, a.wmode);
        else if (wsize == 4)
          stage_raw<4>(w, a.ldw, W, a.wr, a.wc, a.n, a.q, r0, q0, BM, QT, a.wmode);
        else
          stage_raw<8>(w, a.ldw, W, a.wr, a.wc, a.n, a.q, r0, q0, BM, QT, a.wmode);
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int st = 0; st < kStages2 - 1; ++st) fetch(st);

  TA acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = TA(0);
  int staged = -1;  // the panel of G in Gt
  for (long long s = 0; s < nsteps; ++s) {
    cp_wait<kStages2 - 2>();
    __syncthreads();  // step s has landed; step s − 1 is done with its tile
    const int slab = static_cast<int>(s % nslabs);
    const int panel = slab * BK / a.pg;
    if (panel != staged) {  // G's rows of this panel, rounded to V's dtype
      const int k0 = panel * a.pg;
      for (int e = tid; e < QT * a.pg; e += blockDim.x) {
        const int j = e / a.pg, k = e % a.pg, kk = k0 + k, c = q0 + j;
        Gt[j * a.ldgt + k] =
            (kk < a.p && c < a.q)
                ? cvt<TA>(cvt<TV>(load_code<TA>(G, a.gcode, kk * a.gr + c * a.gc)))
                : TA(0);
      }
      __syncthreads();
      staged = panel;
    }
    fetch(s + kStages2 - 1);
    const unsigned char* b = ring + (s % kStages2) * sbytes;
    const TV* As = reinterpret_cast<const TV*>(b);
    const int goff = slab * BK - panel * a.pg;
#pragma unroll
    for (int c = 0; c < KS / KV; ++c) {  // the thread's chunks of KV columns
      const int k = (c * a.kg + kgi) * KV;
      TA av[kTM][KV];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const Pack<TV, KV> pv =
            *reinterpret_cast<const Pack<TV, KV>*>(As + (tm + i * a.ntm) * a.lda + k);
#pragma unroll
        for (int t = 0; t < KV; ++t) av[i][t] = cvt<TA>(pv.v[t]);
      }
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const Pack<TA, KV> bv =
            *reinterpret_cast<const Pack<TA, KV>*>(Gt + (tn * kTN + j) * a.ldgt + goff + k);
#pragma unroll
        for (int t = 0; t < KV; ++t)
#pragma unroll
          for (int i = 0; i < kTM; ++i) acc[i][j] = fma_rn(av[i][t], bv.v[t], acc[i][j]);
      }
    }
    if (slab == nslabs - 1) {
      // the k groups' partials, added in a butterfly (every lane of a group
      // ends with the same sums); then the group's first lane stores
      for (int m = a.kg / 2; m >= 1; m /= 2)
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] += shfl_xor(acc[i][j], m);
      if (kgi == 0) {
        const long long r0 = (blockIdx.y + (s / nslabs) * gridDim.y) * BM;
        const unsigned char* w = b + vbytes;
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const int rr = tm + i * a.ntm;
          if (r0 + rr >= a.n) continue;
#pragma unroll
          for (int j = 0; j < kTN; ++j) {
            const int cc = tn * kTN + j;
            if (q0 + cc >= a.q) continue;
            const TA wv = wsize ? load_code<TA>(w, a.wcode, rr * a.ldw + cc) : TA(0);
            store_out<TA>(Out, (r0 + rr) * a.q + q0 + cc, wv, a, acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = TA(0);
    }
  }
  cp_wait<0>();
}

// ------------------------------------------------------------ launches ----

// Dynamic shared memory past 48 KiB less the kernel's static bytes needs
// an opt-in, per kernel and device; each kernel (a template argument, so
// that two kernels of one signature keep their own flags) opts in once a
// device for the most any launch takes.
template <auto Kernel>
cudaError_t allow_smem() {
  constexpr int kDevices = 64;
  static bool allowed[kDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < kDevices && allowed[dev])) return e;
  e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e == cudaSuccess && dev < kDevices) allowed[dev] = true;
  return e;
}

// prm: n, xr, xc, yr, yc, chunk, sublen, p, q, nchunks, split, nct, nqt,
// rgn, xmode, ymode, ldx, ldy, smem bytes
template <typename TX, typename TY, typename TA>
int launch_gram(const void* X, const void* Y, void* part, void* out,
                void* tickets, const long long* prm, void* stream) {
  const GramArgs a{prm[0], prm[1], prm[2], prm[3], prm[4], prm[5], prm[6],
                   static_cast<int>(prm[7]), static_cast<int>(prm[8]),
                   static_cast<int>(prm[9]), static_cast<int>(prm[10]),
                   static_cast<int>(prm[11]), static_cast<int>(prm[12]),
                   static_cast<int>(prm[13]), static_cast<int>(prm[14]),
                   static_cast<int>(prm[15]), static_cast<int>(prm[16]),
                   static_cast<int>(prm[17]), static_cast<int>(prm[18])};
  constexpr int CP = sizeof(TX) == 8 ? 2 : 4;
  const long long threads = static_cast<long long>(a.nct) * a.nqt * a.rgn;
  const long long ring = static_cast<long long>(kStages) * a.rgn *
                         (sizeof(TX) == 2 ? 8 : 4) *
                         (a.ldx * sizeof(TX) + a.ldy * sizeof(TY));
  if (a.n < 1 || a.p < 1 || a.q < 1 || a.chunk < 1 || a.nct < 1 ||
      a.split < 1 || a.sublen < 1 || a.sublen * a.split < min(a.chunk, a.n) ||
      a.nqt < 1 || a.rgn < 1 || threads > kThreads ||
      static_cast<long long>(a.nqt) * kCQ < a.q ||
      a.nchunks != (a.n + a.chunk - 1) / a.chunk || a.smem > kMaxSmem ||
      a.smem < ring || a.smem < a.nchunks * static_cast<int>(sizeof(TA)) ||
      (a.ldx * sizeof(TX)) % 16 || (a.ldy * sizeof(TY)) % 16 ||
      a.ldx < a.nct * CP || a.ldy < a.nqt * kCQ) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr auto kernel = gram_kernel<TX, TY, TA, CP>;
  cudaError_t e = allow_smem<kernel>();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(a.nchunks * a.split, (a.p + a.nct * CP - 1) / (a.nct * CP));
  kernel<<<grid, static_cast<int>(threads), a.smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TX*>(X), static_cast<const TY*>(Y), a,
      static_cast<TA*>(part), static_cast<TA*>(out),
      static_cast<unsigned*>(tickets));
  return static_cast<int>(cudaGetLastError());
}

// prm: n, vr, vc, gr, gc, wr, wc, p, q, ntq, kg, ntm, vmode, wmode, gcode,
// wcode, ocode, lda, ldw, pg, ldgt, smem bytes, CTAs a column tile
template <typename TV, typename TA>
int launch_update(const void* V, const void* G, const void* W, void* out,
                  const long long* prm, void* stream) {
  auto i32 = [&](int i) { return static_cast<int>(prm[i]); };
  const UpdArgs a{prm[0], prm[1], prm[2], prm[3], prm[4], prm[5], prm[6],
                  i32(7), i32(8), i32(9), i32(10), i32(11), i32(12), i32(13),
                  i32(14), i32(15), i32(16), i32(17), i32(18), i32(19), i32(20)};
  const int smem = static_cast<int>(prm[21]);
  const long long ctas = prm[22];
  constexpr int KS = 32 / sizeof(TV), KV = 16 / sizeof(TA);
  const long long threads = static_cast<long long>(a.ntm) * a.ntq * a.kg;
  const int wsize = a.wcode == kNone ? 0 : (a.wcode == kBF16 ? 2 : (a.wcode == kF32 ? 4 : 8));
  const long long BM = static_cast<long long>(a.ntm) * kTM, BK = static_cast<long long>(a.kg) * KS;
  const long long need =
      (a.ntq * kTN * static_cast<long long>(a.ldgt) * sizeof(TA) + 15) / 16 * 16 +
      kStages2 * (BM * a.lda * sizeof(TV) + (BM * a.ldw * wsize + 15) / 16 * 16);
  if (a.n < 1 || a.p < 1 || a.q < 1 || a.ntm < 1 || a.ntq < 1 || a.kg < 1 ||
      a.kg > 32 || (a.kg & (a.kg - 1)) || threads % 32 || threads > kThreads ||
      KS % KV || a.lda < BK || (a.lda * sizeof(TV)) % 16 || a.pg < BK || a.pg % BK ||
      a.ldgt < a.pg || (a.ldgt * sizeof(TA)) % 16 || (wsize && a.ldw < a.ntq * kTN) ||
      smem < need || smem > kMaxSmem || ctas < 1 || ctas > 65535 ||
      a.gcode < kBF16 || a.gcode > kF64 || (a.wcode != kNone && a.wcode != a.ocode)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr auto kernel = update_kernel<TV, TA>;
  cudaError_t e = allow_smem<kernel>();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.q + a.ntq * kTN - 1) / (a.ntq * kTN), static_cast<unsigned>(ctas));
  kernel<<<grid, static_cast<int>(threads), smem,
           static_cast<cudaStream_t>(stream)>>>(static_cast<const TV*>(V), G, W, out, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of its launch (0 on success).  Pointers are
// device pointers but prm, a host array of the shape, strides (in
// elements) and plan that ops/spmm/_kernels.py computes.  Launches are
// asynchronous on ``stream``.
//
// rbl_skinny_gram_<X>_<Y>_<acc>: out (p, q) = XᵀY in acc (f64 where X or Y
// is f64, else f32), row-major; part holds nchunks·split·p·q acc values of
// scratch; tickets (nchunks + 1) × column tiles zeroed unsigned counters
// (left zeroed).
#define RBL_GRAM(NX, TX, NY, TY, NA, TA)                                        \
  int rbl_skinny_gram_##NX##_##NY##_##NA(const void* X, const void* Y,          \
                                         void* part, void* out, void* tickets,  \
                                         const long long* prm, void* stream) {  \
    return launch_gram<TX, TY, TA>(X, Y, part, out, tickets, prm, stream);      \
  }
RBL_GRAM(bf16, bf16, bf16, bf16, f32, float)
RBL_GRAM(bf16, bf16, f32, float, f32, float)
RBL_GRAM(f32, float, bf16, bf16, f32, float)
RBL_GRAM(f32, float, f32, float, f32, float)
RBL_GRAM(bf16, bf16, f64, double, f64, double)
RBL_GRAM(f32, float, f64, double, f64, double)
RBL_GRAM(f64, double, bf16, bf16, f64, double)
RBL_GRAM(f64, double, f32, float, f64, double)
RBL_GRAM(f64, double, f64, double, f64, double)
#undef RBL_GRAM

// rbl_skinny_update_<V>_<acc>: out (n, q), row-major in the dtype ocode,
// = W − (V·round_V(G)) with W (wcode == ocode), or V·round_V(G) (wcode 0).
#define RBL_UPDATE(NV, TV, NA, TA)                                              \
  int rbl_skinny_update_##NV##_##NA(const void* V, const void* G,               \
                                    const void* W, void* out,                   \
                                    const long long* prm, void* stream) {       \
    return launch_update<TV, TA>(V, G, W, out, prm, stream);                    \
  }
RBL_UPDATE(bf16, bf16, f32, float)
RBL_UPDATE(f32, float, f32, float)
RBL_UPDATE(f64, double, f32, float)
RBL_UPDATE(bf16, bf16, f64, double)
RBL_UPDATE(f32, float, f64, double)
RBL_UPDATE(f64, double, f64, double)
#undef RBL_UPDATE

}  // extern "C"

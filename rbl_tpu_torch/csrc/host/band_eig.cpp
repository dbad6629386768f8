// Symmetric banded eigensolver on the host: the port's copy of the JAX
// package's native/band_eig.cpp, the in-repo replacement for the
// reference's raw LAPACK ccall (dsbev_64_, Julia/common.jl:28-48).  It
// serves RBLConfig(eig_backend="native") (rbl_tpu_torch/native.py builds
// it with g++ at first use and loads it with ctypes).
// T is small (m ≤ ~1400), so an O(m^3) dense path is acceptable:
//   1. expand LAPACK lower-band storage to dense symmetric,
//   2. Householder tridiagonalization with accumulated transform (the
//      classical tred2 algorithm),
//   3. implicit-shift QL iteration on the tridiagonal with eigenvector
//      accumulation (the classical tql2 algorithm).
// Eigenvalues return ascending with orthonormal eigenvectors, matching
// scipy.linalg.eig_banded(lower=True) / LAPACK dsbev (jobz='V', uplo='L').
//
// C ABI: rbl_band_eigh(m, bw1, band, w, V) — band is (bw1, m) row-major
// with band[r*m + c] = T[c + r, c]; outputs w (m) and V (m, m) row-major
// with V[i*m + j] = component i of eigenvector j.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

inline double hypot2(double a, double b) { return std::hypot(a, b); }

// Householder reduction of the dense symmetric matrix stored in V (row
// major, m x m) to tridiagonal (d, e); V is overwritten with the
// accumulated orthogonal transform.
void tred2(int m, std::vector<double>& V, std::vector<double>& d,
           std::vector<double>& e) {
  for (int j = 0; j < m; j++) d[j] = V[(size_t)(m - 1) * m + j];

  for (int i = m - 1; i > 0; i--) {
    double scale = 0.0, h = 0.0;
    for (int k = 0; k < i; k++) scale += std::fabs(d[k]);
    if (scale == 0.0) {
      e[i] = d[i - 1];
      for (int j = 0; j < i; j++) {
        d[j] = V[(size_t)(i - 1) * m + j];
        V[(size_t)i * m + j] = 0.0;
        V[(size_t)j * m + i] = 0.0;
      }
    } else {
      for (int k = 0; k < i; k++) {
        d[k] /= scale;
        h += d[k] * d[k];
      }
      double f = d[i - 1];
      double g = std::sqrt(h);
      if (f > 0) g = -g;
      e[i] = scale * g;
      h = h - f * g;
      d[i - 1] = f - g;
      for (int j = 0; j < i; j++) e[j] = 0.0;

      for (int j = 0; j < i; j++) {
        f = d[j];
        V[(size_t)j * m + i] = f;
        g = e[j] + V[(size_t)j * m + j] * f;
        for (int k = j + 1; k <= i - 1; k++) {
          g += V[(size_t)k * m + j] * d[k];
          e[k] += V[(size_t)k * m + j] * f;
        }
        e[j] = g;
      }
      f = 0.0;
      for (int j = 0; j < i; j++) {
        e[j] /= h;
        f += e[j] * d[j];
      }
      double hh = f / (h + h);
      for (int j = 0; j < i; j++) e[j] -= hh * d[j];
      for (int j = 0; j < i; j++) {
        f = d[j];
        g = e[j];
        for (int k = j; k <= i - 1; k++)
          V[(size_t)k * m + j] -= (f * e[k] + g * d[k]);
        d[j] = V[(size_t)(i - 1) * m + j];
        V[(size_t)i * m + j] = 0.0;
      }
    }
    d[i] = h;
  }

  // accumulate transformations
  for (int i = 0; i < m - 1; i++) {
    V[(size_t)(m - 1) * m + i] = V[(size_t)i * m + i];
    V[(size_t)i * m + i] = 1.0;
    double h = d[i + 1];
    if (h != 0.0) {
      for (int k = 0; k <= i; k++) d[k] = V[(size_t)k * m + (i + 1)] / h;
      for (int j = 0; j <= i; j++) {
        double g = 0.0;
        for (int k = 0; k <= i; k++)
          g += V[(size_t)k * m + (i + 1)] * V[(size_t)k * m + j];
        for (int k = 0; k <= i; k++) V[(size_t)k * m + j] -= g * d[k];
      }
    }
    for (int k = 0; k <= i; k++) V[(size_t)k * m + (i + 1)] = 0.0;
  }
  for (int j = 0; j < m; j++) {
    d[j] = V[(size_t)(m - 1) * m + j];
    V[(size_t)(m - 1) * m + j] = 0.0;
  }
  V[(size_t)(m - 1) * m + (m - 1)] = 1.0;
  e[0] = 0.0;
}

// Implicit-shift QL iteration on the symmetric tridiagonal (d, e) with
// eigenvector accumulation into V.  Returns 0 on success, >0 if an
// eigenvalue failed to converge in 50 sweeps.
int tql2(int m, std::vector<double>& d, std::vector<double>& e,
         std::vector<double>& V) {
  for (int i = 1; i < m; i++) e[i - 1] = e[i];
  e[m - 1] = 0.0;

  double f = 0.0, tst1 = 0.0;
  const double eps = 2.220446049250313e-16;
  for (int l = 0; l < m; l++) {
    tst1 = std::fmax(tst1, std::fabs(d[l]) + std::fabs(e[l]));
    int mm = l;
    while (mm < m) {
      if (std::fabs(e[mm]) <= eps * tst1) break;
      mm++;
    }
    if (mm > l) {
      int iter = 0;
      do {
        if (++iter > 50) return l + 1;
        double g = d[l];
        double p = (d[l + 1] - g) / (2.0 * e[l]);
        double r = hypot2(p, 1.0);
        if (p < 0) r = -r;
        d[l] = e[l] / (p + r);
        d[l + 1] = e[l] * (p + r);
        double dl1 = d[l + 1];
        double h = g - d[l];
        for (int i = l + 2; i < m; i++) d[i] -= h;
        f += h;

        p = d[mm];
        double c = 1.0, c2 = c, c3 = c;
        double el1 = e[l + 1];
        double s = 0.0, s2 = 0.0;
        for (int i = mm - 1; i >= l; i--) {
          c3 = c2;
          c2 = c;
          s2 = s;
          g = c * e[i];
          h = c * p;
          r = hypot2(p, e[i]);
          e[i + 1] = s * r;
          s = e[i] / r;
          c = p / r;
          p = c * d[i] - s * g;
          d[i + 1] = h + s * (c * g + s * d[i]);
          for (int k = 0; k < m; k++) {
            h = V[(size_t)k * m + (i + 1)];
            V[(size_t)k * m + (i + 1)] = s * V[(size_t)k * m + i] + c * h;
            V[(size_t)k * m + i] = c * V[(size_t)k * m + i] - s * h;
          }
        }
        p = -s * s2 * c3 * el1 * e[l] / dl1;
        e[l] = s * p;
        d[l] = c * p;
      } while (std::fabs(e[l]) > eps * tst1);
    }
    d[l] += f;
    e[l] = 0.0;
  }

  // sort ascending (selection sort, swapping eigenvector columns)
  for (int i = 0; i < m - 1; i++) {
    int kmin = i;
    double p = d[i];
    for (int j = i + 1; j < m; j++)
      if (d[j] < p) { kmin = j; p = d[j]; }
    if (kmin != i) {
      d[kmin] = d[i];
      d[i] = p;
      for (int k = 0; k < m; k++)
        std::swap(V[(size_t)k * m + i], V[(size_t)k * m + kmin]);
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// band: (bw1, m) row-major lower-band storage; w: (m); V: (m, m) row-major.
// Returns 0 on success; >0: QL failed at that eigenvalue index; <0: bad args.
int rbl_band_eigh(int64_t m64, int64_t bw1_64, const double* band, double* w,
                  double* Vout) {
  if (m64 <= 0 || bw1_64 <= 0) return -1;
  const int m = (int)m64;
  // band rows beyond m are padding (LAPACK allows bw1 > m for tiny T)
  const int bw1 = (int)(bw1_64 > m64 ? m64 : bw1_64);
  std::vector<double> V((size_t)m * m, 0.0);
  for (int r = 0; r < bw1; r++)
    for (int c = 0; c + r < m; c++) {
      double v = band[(size_t)r * m + c];
      V[(size_t)(c + r) * m + c] = v;
      V[(size_t)c * m + (c + r)] = v;
    }
  std::vector<double> d(m), e(m);
  tred2(m, V, d, e);
  int info = tql2(m, d, e, V);
  if (info != 0) return info;
  std::memcpy(w, d.data(), sizeof(double) * m);
  std::memcpy(Vout, V.data(), sizeof(double) * (size_t)m * m);
  return 0;
}

}  // extern "C"

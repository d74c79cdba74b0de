// Native CPU baseline: the reference's compute pattern (Fortran 90 +
// OpenMP, SURVEY §2 C14) re-implemented from scratch in C++/OpenMP.
//
// Purpose: gfortran is absent from this image (BASELINE.md), so the
// reference programs cannot be compiled here. This library plays their
// role — a shared-memory OpenMP Krylov solver with the same algorithmic
// structure (sequential Householder reflector sweeps, fused reduction
// regions, degree-2 Chebyshev preconditioning on the matrix-free
// 5-point stencil) — giving bench.py an honest compiled-CPU baseline
// for vs_baseline, and the tests a second independent oracle.
//
// Structure mirrors what SURVEY.md documents of the reference
// (src/gmres_hh.f90:388-566 gmres_hh_prec_omp, src/cg.f90:154-234
// pcg_omp, src/preconds/chebyshev.f90:8-38 cbpr2,
// src/problems/poisson.f90:33-77 stvec); no reference code was copied —
// this is written from the survey's algebraic description.
//
// Build: g++ -O3 -march=native -funroll-loops -fopenmp -shared -fPIC

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// y = A x : 5-point Laplacian on an n×n grid (row-major), homogeneous
// Dirichlet by truncation.
void stencil(const double* x, double* y, int64_t n) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const int64_t row = i * n;
    for (int64_t j = 0; j < n; ++j) {
      double v = 4.0 * x[row + j];
      if (i > 0) v -= x[row - n + j];
      if (i < n - 1) v -= x[row + n + j];
      if (j > 0) v -= x[row + j - 1];
      if (j < n - 1) v -= x[row + j + 1];
      y[row + j] = v;
    }
  }
}

// Degree-2 Chebyshev preconditioner z = M^{-1} r on eigen bounds
// [lo, hi]: z = r/d; z += alpha*(r - A z).
struct Cheb {
  double d, alpha;
  Cheb(double lo, double hi) {
    const double c = (hi - lo) / 2.0;
    d = (hi + lo) / 2.0;
    double a = 1.0 / d;
    const double beta = (c * a / 2.0) * (c * a / 2.0);
    alpha = 1.0 / (d - beta);
  }
  void apply(const double* r, double* z, double* aux, int64_t n) const {
    const int64_t nn = n * n;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nn; ++i) z[i] = r[i] / d;
    stencil(z, aux, n);
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nn; ++i) z[i] += alpha * (r[i] - aux[i]);
  }
};

double dot(const double* a, const double* b, int64_t nn) {
  double s = 0.0;
#pragma omp parallel for reduction(+ : s) schedule(static)
  for (int64_t i = 0; i < nn; ++i) s += a[i] * b[i];
  return s;
}

}  // namespace

extern "C" {

void krylov_ref_set_threads(int t) {
#ifdef _OPENMP
  if (t > 0) omp_set_num_threads(t);
#endif
}

void krylov_ref_stencil(const double* x, double* y, int64_t n) {
  stencil(x, y, n);
}

// Preconditioned CG on the n×n Poisson stencil with Chebyshev(lo,hi).
// Returns iterations; *out_res = final ||r||2 (absolute criterion).
int64_t krylov_ref_pcg(int64_t n, const double* b, double* x, double tol,
                       int64_t max_iter, double lo, double hi,
                       double* out_res) {
  const int64_t nn = n * n;
  std::vector<double> r(b, b + nn), z(nn), p(nn), ap(nn), aux(nn);
  std::memset(x, 0, nn * sizeof(double));
  const Cheb M(lo, hi);
  M.apply(r.data(), z.data(), aux.data(), n);
  p = z;
  double rz = dot(r.data(), z.data(), nn);
  double res = std::sqrt(dot(r.data(), r.data(), nn));
  int64_t it = 0;
  for (; it < max_iter && res >= tol; ++it) {
    stencil(p.data(), ap.data(), n);
    const double pap = dot(p.data(), ap.data(), nn);
    const double alpha = rz / pap;
    double res2 = 0.0;
#pragma omp parallel for reduction(+ : res2) schedule(static)
    for (int64_t i = 0; i < nn; ++i) {
      x[i] += alpha * p[i];
      r[i] -= alpha * ap[i];
      res2 += r[i] * r[i];
    }
    res = std::sqrt(res2);
    M.apply(r.data(), z.data(), aux.data(), n);
    const double rz_new = dot(r.data(), z.data(), nn);
    const double beta = rz_new / rz;
    rz = rz_new;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nn; ++i) p[i] = z[i] + beta * p[i];
  }
  *out_res = res;
  return it;
}

// Chebyshev-preconditioned restarted Householder GMRES(m) on the n×n
// Poisson stencil: Walker-'84 sequential reflector sweeps (the
// reference's hot loop shape), Givens QR of H, back-substitution,
// reflector-based solution update. Relative criterion |g(j+1)|/||b||,
// or with certify_true the TRUE residual ||b - A x||/||b|| checked after
// every full m-step cycle (gmres(certify="true") semantics).
// Returns total inner iterations; fills *out_restarts, *out_res.
int64_t krylov_ref_hh_gmres(int64_t n, const double* b, double* x,
                            int64_t m, double tol, int64_t max_restarts,
                            double lo, double hi, int64_t* out_restarts,
                            double* out_res, int64_t certify_true) {
  const int64_t nn = n * n;
  const Cheb M(lo, hi);
  std::vector<double> P((m + 1) * nn), w(nn), z(nn), aux(nn), v(nn);
  std::vector<double> H((m + 1) * m), cs(m), sn(m), g(m + 1), y(m);
  std::memset(x, 0, nn * sizeof(double));
  const double beta0 = std::sqrt(dot(b, b, nn));
  if (beta0 == 0.0) {
    *out_restarts = 0;
    *out_res = 0.0;
    return 0;
  }
  int64_t total_iters = 0;
  double rel = 1.0;
  int64_t st = 0;
  for (; st < max_restarts; ++st) {
    // True preconditioned residual.
    stencil(x, w.data(), n);
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nn; ++i) z[i] = b[i] - w[i];
    M.apply(z.data(), w.data(), aux.data(), n);
    const double beta = std::sqrt(dot(w.data(), w.data(), nn));
    // Initial reflector from w.
    const double s = (w[0] >= 0 ? beta : -beta);
    std::fill(g.begin(), g.end(), 0.0);
    g[0] = -s;
    w[0] += s;
    double un = std::sqrt(dot(w.data(), w.data(), nn));
    if (un == 0.0) un = 1.0;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nn; ++i) P[i] = w[i] / un;
    std::fill(H.begin(), H.end(), 0.0);

    int64_t k = 0;
    bool converged = false;
    for (int64_t j = 0; j < m && !converged; ++j) {
      // v = P1..P_{j+1} e_j  (sequential reflector sweep).
      std::memset(v.data(), 0, nn * sizeof(double));
      v[j] = 1.0;
      for (int64_t q = j; q >= 0; --q) {
        const double* pq = &P[q * nn];
        const double d2 = 2.0 * dot(pq, v.data(), nn);
#pragma omp parallel for schedule(static)
        for (int64_t i = 0; i < nn; ++i) v[i] -= d2 * pq[i];
      }
      stencil(v.data(), z.data(), n);
      M.apply(z.data(), w.data(), aux.data(), n);
      // w = P_{j+1}..P1 w.
      for (int64_t q = 0; q <= j; ++q) {
        const double* pq = &P[q * nn];
        const double d2 = 2.0 * dot(pq, w.data(), nn);
#pragma omp parallel for schedule(static)
        for (int64_t i = 0; i < nn; ++i) w[i] -= d2 * pq[i];
      }
      // New reflector from tail w[j+1:], H column j.
      double tail = 0.0;
#pragma omp parallel for reduction(+ : tail) schedule(static)
      for (int64_t i = j + 1; i < nn; ++i) tail += w[i] * w[i];
      tail = std::sqrt(tail);
      const double hsub = (w[j + 1] > 0 ? -tail : tail);
      for (int64_t i = 0; i <= j; ++i) H[i * m + j] = w[i];
      H[(j + 1) * m + j] = hsub;
      // Reflector p_{j+1}: zero prefix, w[j+1]-hsub at j+1, normalized.
      double* pn = &P[(j + 1) * nn];
#pragma omp parallel for schedule(static)
      for (int64_t i = 0; i < nn; ++i) pn[i] = (i <= j ? 0.0 : w[i]);
      pn[j + 1] -= hsub;
      double pnn = std::sqrt(dot(pn, pn, nn));
      if (pnn == 0.0) pnn = 1.0;
#pragma omp parallel for schedule(static)
      for (int64_t i = 0; i < nn; ++i) pn[i] /= pnn;
      // Givens update of column j.
      for (int64_t q = 0; q < j; ++q) {
        const double t1 = H[q * m + j], t2 = H[(q + 1) * m + j];
        H[q * m + j] = cs[q] * t1 + sn[q] * t2;
        H[(q + 1) * m + j] = -sn[q] * t1 + cs[q] * t2;
      }
      const double hj = H[j * m + j], hj1 = H[(j + 1) * m + j];
      const double dd = std::hypot(hj1, hj);
      cs[j] = (dd > 0 ? hj / dd : 1.0);
      sn[j] = (dd > 0 ? hj1 / dd : 0.0);
      H[j * m + j] = cs[j] * hj + sn[j] * hj1;
      H[(j + 1) * m + j] = 0.0;
      const double gj = g[j];
      g[j] = cs[j] * gj;
      g[j + 1] = -sn[j] * gj;
      k = j + 1;
      ++total_iters;
      rel = std::fabs(g[j + 1]) / beta0;
      if (!certify_true && rel < tol) converged = true;
    }
    // Back-substitution H y = g.
    for (int64_t i = k - 1; i >= 0; --i) {
      double acc = g[i];
      for (int64_t q = i + 1; q < k; ++q) acc -= H[i * m + q] * y[q];
      y[i] = acc / H[i * m + i];
    }
    // Update direction: apply P_k..P_1 to [y; 0].
    std::memset(w.data(), 0, nn * sizeof(double));
    for (int64_t i = 0; i < k; ++i) w[i] = y[i];
    for (int64_t q = k; q >= 0; --q) {
      const double* pq = &P[q * nn];
      const double d2 = 2.0 * dot(pq, w.data(), nn);
#pragma omp parallel for schedule(static)
      for (int64_t i = 0; i < nn; ++i) w[i] -= d2 * pq[i];
    }
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nn; ++i) x[i] += w[i];
    if (certify_true) {
      stencil(x, w.data(), n);
#pragma omp parallel for schedule(static)
      for (int64_t i = 0; i < nn; ++i) z[i] = b[i] - w[i];
      rel = std::sqrt(dot(z.data(), z.data(), nn)) / beta0;
      converged = rel < tol;
    }
    if (converged) {
      ++st;
      break;
    }
  }
  *out_restarts = st;
  *out_res = rel;
  return total_iters;
}

}  // extern "C"

// C++ embedding surface for the sparse_solvers_tpu host engine.
//
// The reference library is embedded as `#include <ss/ss.h>` with
// templated construct-once solvers returning report structs
// (include/ss/ss.h:28-66, policies.h:25-74 — rayglover-ibm/
// sparse-solvers). This header is the analog for this framework's
// native host engine: a header-only C++17 facade over the C ABI
// exported by sparsesolvers_cpu.cpp. Same contract, different
// machinery — no kernelpp variant protocol, no ndspan; plain
// row-major pointers/std::vector and a tiny result<R> that either
// holds a report or an error string.
//
//   #include "ss_tpu.h"
//   sstpu::homotopy<float> solver(A.data(), m, n);   // A row-major
//   std::vector<float> x(n);
//   auto res = solver.solve(y.data(), tol, max_iter, x.data());
//   if (res) { res->iter; res->solution_error; }
//
// Link against libsparsesolvers_cpu.so (make -C csrc) or compile
// sparsesolvers_cpu.cpp into the embedding target.
//
// Semantics parity notes:
//  * homotopy/irls solve the reference problem min ||x||_1 s.t. Ax=y
//    with the identical fast-path trajectories as the Python engines
//    (tests/test_native.py pins them against the JAX engine).
//  * irls requires m >= n at construction, like the reference's
//    irls_state (solve on a moved-from/failed solver reports an error
//    instead of the reference's abort-on-bad-input).
//  * irls_cg is this framework's extension (underdetermined m <= n
//    basis pursuit; no reference analog).
//  * reconstruct_signal / norm_l1 mirror ss.h:69-93.

#pragma once

#include <cmath>
#include <cstdint>
#include <string>
#include <vector>

extern "C" {
int ss_homotopy_solve_f32(const float*, int, int, const float*, float, int,
                          int, float*, float*);
int ss_homotopy_solve_f64(const double*, int, int, const double*, double,
                          int, int, double*, double*);
void ss_homotopy_solve_batch_f32(const float*, int, int, const float*, int,
                                 float, int, int, int, float*, int*, float*);
void ss_homotopy_solve_batch_f64(const double*, int, int, const double*,
                                 int, double, int, int, int, double*, int*,
                                 double*);
void* ss_irls_create_f32(const float*, int, int);
int ss_irls_solve_f32(void*, const float*, float, int, float*, float*, int*);
void ss_irls_destroy_f32(void*);
void ss_irls_solve_batch_f32(void*, const float*, int, float, int, int,
                             float*, int*, float*, int*);
void* ss_irls_create_f64(const double*, int, int);
int ss_irls_solve_f64(void*, const double*, double, int, double*, double*,
                      int*);
void ss_irls_destroy_f64(void*);
void ss_irls_solve_batch_f64(void*, const double*, int, double, int, int,
                             double*, int*, double*, int*);
int ss_irls_cg_solve_f32(const float*, int, int, const float*, float, int,
                         float, int, int, float, float*, float*, int*);
int ss_irls_cg_solve_f64(const double*, int, int, const double*, double, int,
                         double, int, int, double, double*, double*, int*);
int ss_omp_solve_f32(const float*, int, int, const float*, float, int, int,
                     float*, float*);
int ss_omp_solve_f64(const double*, int, int, const double*, double, int,
                     int, double*, double*);
void ss_omp_solve_batch_f32(const float*, int, int, const float*, int,
                            float, int, int, int, float*, int*, float*);
void ss_omp_solve_batch_f64(const double*, int, int, const double*, int,
                            double, int, int, int, double*, int*, double*);
int ss_omp_solve_pk_f32(const float*, int, int, const float*, float, int,
                        int, int, float*, float*);
int ss_omp_solve_pk_f64(const double*, int, int, const double*, double, int,
                        int, int, double*, double*);
void ss_omp_solve_batch_pk_f32(const float*, int, int, const float*, int,
                               float, int, int, int, int, float*, int*,
                               float*);
void ss_omp_solve_batch_pk_f64(const double*, int, int, const double*, int,
                               double, int, int, int, int, double*, int*,
                               double*);
int ss_blas_load(const char*, const char*, const char*, int);
int ss_blas_active();
int ss_native_version();
}

namespace sstpu {

// ------------------------------------------------------------- reports
// Field names follow the reference's policies.h:25-74 (and the Python
// reports.py) so embedding code ports by search-and-replace.

struct homotopy_report {
  std::uint32_t iter = 0;
  double solution_error = 0.0;
};

struct irls_report {
  std::uint32_t iter = 0;
  double solution_error = 0.0;
  bool spd_failure = false;
};

struct omp_report {
  std::uint32_t iter = 0;
  double solution_error = 0.0;  // final residual norm ‖y − Ax‖₂
};

// ------------------------------------------------------------- result<R>
// The reference returns kernelpp::maybe<report> (report-or-error).
// Plain C++17 equivalent without the variant protocol: truthy iff a
// report is present; error() is a human-readable reason otherwise.

template <typename R>
class result {
 public:
  static result ok(R r) { return result(r, {}); }
  static result fail(std::string why) { return result({}, std::move(why)); }
  explicit operator bool() const { return err_.empty(); }
  const R& operator*() const { return report_; }
  const R* operator->() const { return &report_; }
  const std::string& error() const { return err_; }

 private:
  result(R r, std::string e) : report_(r), err_(std::move(e)) {}
  R report_;
  std::string err_;
};

namespace detail {

inline bool bad_dims(int m, int n) { return m <= 0 || n <= 0; }

template <typename T>
struct abi;  // per-dtype C-ABI selection

template <>
struct abi<float> {
  static int homotopy(const float* A, int m, int n, const float* y,
                      float tol, int mi, int k, float* x, float* e) {
    return ss_homotopy_solve_f32(A, m, n, y, tol, mi, k, x, e);
  }
  static void homotopy_batch(const float* A, int m, int n, const float* Y,
                             int b, float tol, int mi, int k, int nt,
                             float* X, int* it, float* e) {
    ss_homotopy_solve_batch_f32(A, m, n, Y, b, tol, mi, k, nt, X, it, e);
  }
  static void* irls_create(const float* A, int m, int n) {
    return ss_irls_create_f32(A, m, n);
  }
  static int irls_solve(void* h, const float* y, float tol, int mi, float* x,
                        float* e, int* spd) {
    return ss_irls_solve_f32(h, y, tol, mi, x, e, spd);
  }
  static void irls_batch(void* h, const float* Y, int b, float tol, int mi,
                         int nt, float* X, int* it, float* e, int* spd) {
    ss_irls_solve_batch_f32(h, Y, b, tol, mi, nt, X, it, e, spd);
  }
  static void irls_destroy(void* h) { ss_irls_destroy_f32(h); }
  static int irls_cg(const float* A, int m, int n, const float* y, float tol,
                     int mi, float* x, float* e, int* broke) {
    return ss_irls_cg_solve_f32(A, m, n, y, tol, mi, 0.9f, 0, 0, 0.0f, x, e,
                                broke);
  }
  static int omp_pk(const float* A, int m, int n, const float* y,
                    float tol, int mi, int k, int picks, float* x,
                    float* e) {
    return ss_omp_solve_pk_f32(A, m, n, y, tol, mi, k, picks, x, e);
  }
  static void omp_batch_pk(const float* A, int m, int n, const float* Y,
                           int b, float tol, int mi, int k, int picks,
                           int nt, float* X, int* it, float* e) {
    ss_omp_solve_batch_pk_f32(A, m, n, Y, b, tol, mi, k, picks, nt, X,
                              it, e);
  }
  static int omp(const float* A, int m, int n, const float* y, float tol,
                 int mi, int k, float* x, float* e) {
    return ss_omp_solve_f32(A, m, n, y, tol, mi, k, x, e);
  }
  static void omp_batch(const float* A, int m, int n, const float* Y, int b,
                        float tol, int mi, int k, int nt, float* X, int* it,
                        float* e) {
    ss_omp_solve_batch_f32(A, m, n, Y, b, tol, mi, k, nt, X, it, e);
  }
};

template <>
struct abi<double> {
  static int homotopy(const double* A, int m, int n, const double* y,
                      double tol, int mi, int k, double* x, double* e) {
    return ss_homotopy_solve_f64(A, m, n, y, tol, mi, k, x, e);
  }
  static void homotopy_batch(const double* A, int m, int n, const double* Y,
                             int b, double tol, int mi, int k, int nt,
                             double* X, int* it, double* e) {
    ss_homotopy_solve_batch_f64(A, m, n, Y, b, tol, mi, k, nt, X, it, e);
  }
  static void* irls_create(const double* A, int m, int n) {
    return ss_irls_create_f64(A, m, n);
  }
  static int irls_solve(void* h, const double* y, double tol, int mi,
                        double* x, double* e, int* spd) {
    return ss_irls_solve_f64(h, y, tol, mi, x, e, spd);
  }
  static void irls_batch(void* h, const double* Y, int b, double tol, int mi,
                         int nt, double* X, int* it, double* e, int* spd) {
    ss_irls_solve_batch_f64(h, Y, b, tol, mi, nt, X, it, e, spd);
  }
  static void irls_destroy(void* h) { ss_irls_destroy_f64(h); }
  static int irls_cg(const double* A, int m, int n, const double* y,
                     double tol, int mi, double* x, double* e, int* broke) {
    return ss_irls_cg_solve_f64(A, m, n, y, tol, mi, 0.9, 0, 0, 0.0, x, e,
                                broke);
  }
  static int omp_pk(const double* A, int m, int n, const double* y,
                    double tol, int mi, int k, int picks, double* x,
                    double* e) {
    return ss_omp_solve_pk_f64(A, m, n, y, tol, mi, k, picks, x, e);
  }
  static void omp_batch_pk(const double* A, int m, int n, const double* Y,
                           int b, double tol, int mi, int k, int picks,
                           int nt, double* X, int* it, double* e) {
    ss_omp_solve_batch_pk_f64(A, m, n, Y, b, tol, mi, k, picks, nt, X,
                              it, e);
  }
  static int omp(const double* A, int m, int n, const double* y, double tol,
                 int mi, int k, double* x, double* e) {
    return ss_omp_solve_f64(A, m, n, y, tol, mi, k, x, e);
  }
  static void omp_batch(const double* A, int m, int n, const double* Y,
                        int b, double tol, int mi, int k, int nt, double* X,
                        int* it, double* e) {
    ss_omp_solve_batch_f64(A, m, n, Y, b, tol, mi, k, nt, X, it, e);
  }
};

}  // namespace detail

// ------------------------------------------------------------- solvers
// Construct-once / solve-many, like the reference's solver<T, Policy>
// (ss.h:28-56). A is row-major (m x n), NOT owned past the constructor:
// homotopy snapshots it (the engine re-lays it column-major anyway);
// irls factors it at construction (lib.cpp:51-57 semantics).

template <typename T>
class homotopy {
 public:
  homotopy(const T* A, int m, int n)
      : A_(A, A + (detail::bad_dims(m, n) ? 0 : size_t(m) * n)),
        m_(m), n_(n) {}

  // min ||x||_1 s.t. Ax = y. x_out has length n. k_max caps the active
  // set (0 = engine default: full path capacity).
  result<homotopy_report> solve(const T* y, T tolerance,
                                std::uint32_t max_iterations, T* x_out,
                                int k_max = 0) const {
    if (detail::bad_dims(m_, n_))
      return result<homotopy_report>::fail("invalid dimensions");
    T err = 0;
    int it = detail::abi<T>::homotopy(
        A_.data(), m_, n_, y, tolerance, int(max_iterations),
        k_max > 0 ? k_max : n_ + 1, x_out, &err);
    return result<homotopy_report>::ok(
        {std::uint32_t(it), double(err)});
  }

  // Threaded batch over shared A: Y is (batch x m) row-major, X_out is
  // (batch x n). nthreads 0 = hardware concurrency.
  std::vector<homotopy_report> solve_batch(const T* Y, int batch,
                                           T tolerance,
                                           std::uint32_t max_iterations,
                                           T* X_out, int k_max = 0,
                                           int nthreads = 0) const {
    if (detail::bad_dims(m_, n_) || batch <= 0) return {};
    std::vector<int> iters(batch);
    std::vector<T> errs(batch);
    detail::abi<T>::homotopy_batch(
        A_.data(), m_, n_, Y, batch, tolerance, int(max_iterations),
        k_max > 0 ? k_max : n_ + 1, nthreads, X_out, iters.data(),
        errs.data());
    std::vector<homotopy_report> out(batch);
    for (int b = 0; b < batch; ++b)
      out[b] = {std::uint32_t(iters[b]), double(errs[b])};
    return out;
  }

 private:
  std::vector<T> A_;
  int m_, n_;
};

template <typename T>
class irls {
 public:
  // Factors A (QR) at construction; requires m >= n (irls_state
  // contract). A failed construction is reported by solve(), not by
  // abort() — check ok() to pre-flight.
  irls(const T* A, int m, int n)
      : h_(detail::bad_dims(m, n) ? nullptr
                                  : detail::abi<T>::irls_create(A, m, n)) {}
  ~irls() {
    if (h_) detail::abi<T>::irls_destroy(h_);
  }
  irls(irls&& o) noexcept : h_(o.h_) { o.h_ = nullptr; }
  irls& operator=(irls&& o) noexcept {
    if (this != &o) {
      if (h_) detail::abi<T>::irls_destroy(h_);
      h_ = o.h_;
      o.h_ = nullptr;
    }
    return *this;
  }
  irls(const irls&) = delete;
  irls& operator=(const irls&) = delete;

  bool ok() const { return h_ != nullptr; }

  result<irls_report> solve(const T* y, T tolerance,
                            std::uint32_t max_iterations, T* x_out) const {
    if (!h_)
      return result<irls_report>::fail(
          "irls requires m >= n and positive dimensions");
    T err = 0;
    int spd = 0;
    int it = detail::abi<T>::irls_solve(h_, y, tolerance,
                                        int(max_iterations), x_out, &err,
                                        &spd);
    return result<irls_report>::ok(
        {std::uint32_t(it), double(err), spd != 0});
  }

  std::vector<irls_report> solve_batch(const T* Y, int batch, T tolerance,
                                       std::uint32_t max_iterations,
                                       T* X_out, int nthreads = 0) const {
    if (!h_) return {};
    std::vector<int> iters(batch), spd(batch);
    std::vector<T> errs(batch);
    detail::abi<T>::irls_batch(h_, Y, batch, tolerance,
                               int(max_iterations), nthreads, X_out,
                               iters.data(), errs.data(), spd.data());
    std::vector<irls_report> out(batch);
    for (int b = 0; b < batch; ++b)
      out[b] = {std::uint32_t(iters[b]), double(errs[b]), spd[b] != 0};
    return out;
  }

 private:
  void* h_;
};

// Orthogonal Matching Pursuit — greedy pursuit companion to homotopy
// (this framework's extension; solvers/omp.py is the jax twin).
// solution_error is the final residual norm ‖y − Ax‖₂.
template <typename T>
class omp {
 public:
  omp(const T* A, int m, int n)
      : A_(A, A + (detail::bad_dims(m, n) ? 0 : size_t(m) * n)),
        m_(m), n_(n) {}

  // k_max caps the support (0 = min(m, n, max_iterations)); picks >= 2
  // selects the generalized-OMP rounds (solvers/omp.py picks).
  result<omp_report> solve(const T* y, T tolerance,
                           std::uint32_t max_iterations, T* x_out,
                           int k_max = 0, int picks = 1) const {
    if (detail::bad_dims(m_, n_))
      return result<omp_report>::fail("invalid dimensions");
    T err = 0;
    int cap = k_max > 0 ? k_max : int(max_iterations);
    int it = picks > 1
                 ? detail::abi<T>::omp_pk(A_.data(), m_, n_, y, tolerance,
                                          int(max_iterations), cap, picks,
                                          x_out, &err)
                 : detail::abi<T>::omp(A_.data(), m_, n_, y, tolerance,
                                       int(max_iterations), cap, x_out,
                                       &err);
    return result<omp_report>::ok({std::uint32_t(it), double(err)});
  }

  std::vector<omp_report> solve_batch(const T* Y, int batch, T tolerance,
                                      std::uint32_t max_iterations,
                                      T* X_out, int k_max = 0,
                                      int nthreads = 0,
                                      int picks = 1) const {
    if (detail::bad_dims(m_, n_) || batch <= 0) return {};
    std::vector<int> iters(batch);
    std::vector<T> errs(batch);
    int cap = k_max > 0 ? k_max : int(max_iterations);
    if (picks > 1)
      detail::abi<T>::omp_batch_pk(A_.data(), m_, n_, Y, batch, tolerance,
                                   int(max_iterations), cap, picks,
                                   nthreads, X_out, iters.data(),
                                   errs.data());
    else
      detail::abi<T>::omp_batch(A_.data(), m_, n_, Y, batch, tolerance,
                                int(max_iterations), cap, nthreads, X_out,
                                iters.data(), errs.data());
    std::vector<omp_report> out(batch);
    for (int b = 0; b < batch; ++b)
      out[b] = {std::uint32_t(iters[b]), double(errs[b])};
    return out;
  }

 private:
  std::vector<T> A_;
  int m_, n_;
};

// Factorization-free CG-IRLS basis pursuit for the underdetermined
// regime (m <= n) — this framework's extension; the reference rejects
// such problems (irls_test.cpp:53).
template <typename T>
class irls_cg {
 public:
  irls_cg(const T* A, int m, int n)
      : A_(A, A + (detail::bad_dims(m, n) ? 0 : size_t(m) * n)),
        m_(m), n_(n) {}

  result<irls_report> solve(const T* y, T tolerance,
                            std::uint32_t max_iterations, T* x_out) const {
    if (detail::bad_dims(m_, n_) || m_ > n_)
      return result<irls_report>::fail(
          "irls_cg requires m <= n and positive dimensions");
    T eps = 0;
    int broke = 0;
    int it = detail::abi<T>::irls_cg(A_.data(), m_, n_, y, tolerance,
                                     int(max_iterations), x_out, &eps,
                                     &broke);
    return result<irls_report>::ok(
        {std::uint32_t(it), double(eps), broke != 0});
  }

 private:
  std::vector<T> A_;
  int m_, n_;
};

// ------------------------------------------------------------ utilities
// reconstruct_signal / norm_l1 — ss.h:69-93 contract on row-major
// buffers.

template <typename T>
inline void reconstruct_signal(const T* A, int m, int n, const T* x, T* y) {
  for (int i = 0; i < m; ++i) {
    T acc = 0;
    const T* row = A + size_t(i) * n;
    for (int j = 0; j < n; ++j) acc += row[j] * x[j];
    y[i] = acc;
  }
}

template <typename T>
inline void norm_l1(T* A, int m, int n) {
  for (int j = 0; j < n; ++j) {
    T s = 0;
    for (int i = 0; i < m; ++i) s += std::abs(A[size_t(i) * n + j]);
    if (s > 0)
      for (int i = 0; i < m; ++i) A[size_t(i) * n + j] /= s;
  }
}

// Engine introspection: ABI version and whether the runtime CBLAS
// loaded (0 scalar / 1 LP64 / 2 ILP64) — blas_wrapper.cpp:27-66 analog.
inline int engine_version() { return ss_native_version(); }
inline int runtime_blas_active() { return ss_blas_active(); }

// Hand the engine a CBLAS shared library so its O(m·n) streams run
// through vendor gemv/gemm/ger (the Python wrapper does this
// automatically; standalone embedders opt in here). Symbol resolved as
// prefix + "cblas_sgemv" + suffix etc.; ilp64 selects 64-bit dims.
// Returns true on success; the scalar fallbacks remain otherwise.
inline bool load_runtime_blas(const char* path, const char* prefix = "",
                              const char* suffix = "", bool ilp64 = false) {
  return ss_blas_load(path, prefix, suffix, ilp64 ? 1 : 0) != 0;
}

}  // namespace sstpu

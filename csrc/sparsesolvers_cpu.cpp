// Native host backend — C++17 implementations of the homotopy and IRLS
// l1-minimization solvers, exposed through a C ABI for ctypes.
//
// Role in the framework (mirrors the reference library's C++ core,
// reference: src/solvers/homotopy-cpu.cpp, irls-cpu.cpp, linalg/*):
//   * the CPU execution backend for problems too small to amortize an
//     accelerator dispatch, and for hosts without one;
//   * the measured CPU baseline for the benchmark harness (the reference
//     publishes no numbers; this is the strongest same-algorithm CPU
//     implementation we can field, so speedups are hardware+design, not
//     a strawman).
//
// This is a fresh implementation from the algorithm specs (SURVEY.md §3,
// docs/algorithms in the reference): insertion-ordered active set with an
// incrementally bordered Gram inverse, gamma scan with leftmost-min
// tie-breaking, sign deadzone, correlation recurrence. Not a translation
// of the reference sources.
//
// Build: make -C csrc   (g++ -O3 -march=native -shared -fPIC)

#include <dlfcn.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <string>
#include <thread>
#include <vector>

// ------------------------------------------------- runtime BLAS loader
//
// The reference's whole backend story is a dlopen'd OpenBLAS chosen at
// runtime (blas_wrapper.cpp:27-66, BlasUtils.cmake:20-50). This is the
// same mechanism for this host engine: the Python wrapper discovers a
// CBLAS shared library (numpy/scipy bundle one; SS_NATIVE_BLAS
// overrides) and hands it to ss_blas_load(); the O(m·n) streaming loops
// below then run through vendor gemv/gemm/ger instead of the scalar
// fallbacks. Symbol names are parameterized (prefix/suffix/int-width)
// because wheel-bundled OpenBLAS builds mangle them (scipy_cblas_sgemv,
// scipy_cblas_sgemv64_, cblas_sgemv64_, ...). Unlike the reference,
// which abort()s when no BLAS loads (blas_wrapper.cpp:46-48), every
// call site keeps its scalar fallback — the engine degrades, never
// dies.

namespace rtblas {

enum { kRowMajor = 101, kNoTrans = 111, kTrans = 112 };

// CBLAS order/trans enums stay C `int` in ILP64 builds; only the
// dimension/stride arguments widen to 64-bit.
template <typename I, typename T>
using gemv_fn = void (*)(int, int, I, I, T, const T*, I, const T*, I, T,
                         T*, I);
template <typename I, typename T>
using gemm_fn = void (*)(int, int, int, I, I, I, T, const T*, I, const T*,
                         I, T, T*, I);
template <typename I, typename T>
using ger_fn = void (*)(int, I, I, T, const T*, I, const T*, I, T*, I);
// openblas_set/get_num_threads take/return blasint; passing an int64_t
// is ABI-safe for both widths on x86-64/aarch64 (callee reads the low
// half in LP64 builds).
using set_thr_fn = void (*)(int64_t);
using get_thr_fn = int64_t (*)();

struct Table {
  void* handle = nullptr;
  bool ilp64 = false;
  void* sgemv = nullptr;
  void* dgemv = nullptr;
  void* sgemm = nullptr;
  void* dgemm = nullptr;
  void* sger = nullptr;
  void* dger = nullptr;
  set_thr_fn set_threads = nullptr;
  get_thr_fn get_threads = nullptr;
  bool complete() const {
    return sgemv && dgemv && sgemm && dgemm && sger && dger;
  }
};

inline Table g;
// separate kill switch so tests can force the scalar fallbacks in the
// same process (a dlopen'd library cannot be meaningfully unloaded)
inline std::atomic<bool> g_enabled{true};

inline bool active() {
  return g_enabled.load(std::memory_order_relaxed) && g.complete();
}

// y = alpha * op(A) x + beta * y; A row-major (rows x cols), leading
// dimension lda >= cols (lda > cols strides over a wider parent buffer).
inline void gemv(bool trans, int rows, int cols, float alpha,
                 const float* A, int lda, const float* x, float beta,
                 float* y) {
  if (g.ilp64)
    reinterpret_cast<gemv_fn<int64_t, float>>(g.sgemv)(
        kRowMajor, trans ? kTrans : kNoTrans, rows, cols, alpha, A, lda,
        x, 1, beta, y, 1);
  else
    reinterpret_cast<gemv_fn<int32_t, float>>(g.sgemv)(
        kRowMajor, trans ? kTrans : kNoTrans, rows, cols, alpha, A, lda,
        x, 1, beta, y, 1);
}

inline void gemv(bool trans, int rows, int cols, double alpha,
                 const double* A, int lda, const double* x, double beta,
                 double* y) {
  if (g.ilp64)
    reinterpret_cast<gemv_fn<int64_t, double>>(g.dgemv)(
        kRowMajor, trans ? kTrans : kNoTrans, rows, cols, alpha, A, lda,
        x, 1, beta, y, 1);
  else
    reinterpret_cast<gemv_fn<int32_t, double>>(g.dgemv)(
        kRowMajor, trans ? kTrans : kNoTrans, rows, cols, alpha, A, lda,
        x, 1, beta, y, 1);
}

// C (M x N, row-major, ldc=N) = A (M x K, lda) * B^T (B is N x K, ldb)
inline void gemm_nt(int M, int N, int K, float alpha, const float* A,
                    int lda, const float* B, int ldb, float beta,
                    float* C) {
  if (g.ilp64)
    reinterpret_cast<gemm_fn<int64_t, float>>(g.sgemm)(
        kRowMajor, kNoTrans, kTrans, M, N, K, alpha, A, lda, B, ldb, beta,
        C, N);
  else
    reinterpret_cast<gemm_fn<int32_t, float>>(g.sgemm)(
        kRowMajor, kNoTrans, kTrans, M, N, K, alpha, A, lda, B, ldb, beta,
        C, N);
}

inline void gemm_nt(int M, int N, int K, double alpha, const double* A,
                    int lda, const double* B, int ldb, double beta,
                    double* C) {
  if (g.ilp64)
    reinterpret_cast<gemm_fn<int64_t, double>>(g.dgemm)(
        kRowMajor, kNoTrans, kTrans, M, N, K, alpha, A, lda, B, ldb, beta,
        C, N);
  else
    reinterpret_cast<gemm_fn<int32_t, double>>(g.dgemm)(
        kRowMajor, kNoTrans, kTrans, M, N, K, alpha, A, lda, B, ldb, beta,
        C, N);
}

// A (rows x cols, row-major, lda) += alpha * x y^T
inline void ger(int rows, int cols, float alpha, const float* x,
                const float* y, float* A, int lda) {
  if (g.ilp64)
    reinterpret_cast<ger_fn<int64_t, float>>(g.sger)(
        kRowMajor, rows, cols, alpha, x, 1, y, 1, A, lda);
  else
    reinterpret_cast<ger_fn<int32_t, float>>(g.sger)(
        kRowMajor, rows, cols, alpha, x, 1, y, 1, A, lda);
}

inline void ger(int rows, int cols, double alpha, const double* x,
                const double* y, double* A, int lda) {
  if (g.ilp64)
    reinterpret_cast<ger_fn<int64_t, double>>(g.dger)(
        kRowMajor, rows, cols, alpha, x, 1, y, 1, A, lda);
  else
    reinterpret_cast<ger_fn<int32_t, double>>(g.dger)(
        kRowMajor, rows, cols, alpha, x, 1, y, 1, A, lda);
}

// Scoped BLAS-internal thread clamp for the solver thread pools: the
// pool is the parallelism, nested vendor threading would oversubscribe
// the cores (the batch workers each issue their own gemvs).
struct ThreadClamp {
  // Clamp the vendor BLAS to 1 thread only when its previous count can
  // be read back and restored: a getter-less CBLAS (set_threads without
  // get_threads) would otherwise be left permanently clamped for the
  // whole process — including numpy sharing the same OpenBLAS (advisor
  // finding, round 4).
  int64_t prev = -1;
  explicit ThreadClamp(int nworkers) {
    if (active() && nworkers > 1 && g.set_threads && g.get_threads) {
      prev = g.get_threads();
      if (prev > 0) g.set_threads(1);
    }
  }
  ~ThreadClamp() {
    if (prev > 0 && g.set_threads) g.set_threads(prev);
  }
};

}  // namespace rtblas

namespace {

// ---------------------------------------------------------------- helpers

template <typename T>
T dot(const T* a, const T* b, int n) {
  T s = 0;
  for (int i = 0; i < n; ++i) s += a[i] * b[i];
  return s;
}

template <typename T>
void axpy(T alpha, const T* x, T* y, int n) {
  for (int i = 0; i < n; ++i) y[i] += alpha * x[i];
}

// sign with a +-tol deadzone (reference semantics: homotopy-cpu.cpp:59-67)
template <typename T>
T sign_deadzone(T v, T tol) {
  if (v > tol) return T(1);
  if (v < -tol) return T(-1);
  return T(0);
}

// ------------------------------------------------- insertion-ordered inverse
//
// Maintains B = (A_G^T A_G)^-1 for the active columns G in *insertion*
// order inside a fixed (cap x cap) row-major buffer, exactly the update
// math of the jax path (linalg/online_inverse.py insert_unordered /
// remove_unordered; reference math: online_inverse.h:184-293).

template <typename T>
struct OnlineInverse {
  int cap, k = 0;
  std::vector<T> B;           // cap*cap, live k*k block
  std::vector<int> cols;      // cap, column id per slot
  std::vector<T> u1, u2;      // scratch, cap

  explicit OnlineInverse(int capacity)
      : cap(capacity), B(size_t(capacity) * capacity, T(0)),
        cols(capacity, -1), u1(capacity), u2(capacity) {}

  T& at(int i, int j) { return B[size_t(i) * cap + j]; }

  int slot_of(int col) const {
    for (int i = 0; i < k; ++i)
      if (cols[i] == col) return i;
    return -1;
  }

  // u1[i] = <A[:,cols[i]], A[:,col]> supplied by the caller; vtv = |A col|^2.
  // Returns false (state untouched) when the insert is numerically
  // degenerate: |den| at subnormal scale, where 1/den overflows to inf
  // (den = vtv - u1^T B u1, the Schur complement of the bordered Gram;
  // the reference divides unguarded, online_inverse.h:219). Tiny and
  // even negative dens proceed exactly as the reference's arithmetic
  // does — coherent dictionaries produce noise-level dens whose paths
  // still converge via the per-iteration sign recomputation. Same rule
  // as the JAX engines (solvers/homotopy.py, ops/slot.py);
  // run_solver additionally breaks on a non-finite direction.
  bool insert(int col, const T* u1_in, T vtv) {
    for (int i = 0; i < k; ++i) u1[i] = u1_in[i];
    // u2 = B u1 over the live block
    for (int i = 0; i < k; ++i) u2[i] = dot(&B[size_t(i) * cap], u1.data(), k);
    T den = vtv - dot(u1.data(), u2.data(), k);
    if (!(std::abs(den) > T(256) * std::numeric_limits<T>::min()))
      return false;
    T d = T(1) / den;
    // B += d u2 u2^T ; border row/col k = -d u2 ; corner = d
    for (int i = 0; i < k; ++i) {
      T* row = &B[size_t(i) * cap];
      T s = d * u2[i];
      for (int j = 0; j < k; ++j) row[j] += s * u2[j];
      row[k] = -s;
      at(k, i) = -s;
    }
    at(k, k) = d;
    cols[k] = col;
    ++k;
    return true;
  }

  void remove(int col) {
    int pos = slot_of(col);
    int last = k - 1;
    if (pos != last) {
      for (int j = 0; j < k; ++j) std::swap(at(pos, j), at(last, j));
      for (int i = 0; i < k; ++i) std::swap(at(i, pos), at(i, last));
      std::swap(cols[pos], cols[last]);
    }
    T d = at(last, last);
    for (int i = 0; i < last; ++i) {
      T s = at(i, last) / d;
      for (int j = 0; j < last; ++j) at(i, j) -= s * at(last, j);
    }
    for (int j = 0; j < k; ++j) { at(last, j) = 0; at(j, last) = 0; }
    cols[last] = -1;
    --k;
  }
};

// ------------------------------------------------------------- homotopy

// A is stored column-major (each column of length m contiguous) so that
// column dots and the correlation gemv stream unit-stride.
template <typename T>
struct HomotopyWork {
  int m, n, cap;
  const T* At;                 // n x m row-major = A columns contiguous
  std::vector<T> c, x, d, p, q, u1col;
  OnlineInverse<T> inv;

  HomotopyWork(const T* At_, int m_, int n_, int capacity)
      : m(m_), n(n_), cap(capacity), At(At_), c(n_), x(n_), d(n_), p(m_),
        q(n_), u1col(capacity), inv(capacity) {}

  const T* col(int j) const { return At + size_t(j) * m; }

  int solve(const T* y, T tol, int max_iter, T* x_out, T* err_out) {
    std::fill(c.begin(), c.end(), T(0));
    std::fill(x.begin(), x.end(), T(0));
    std::fill(d.begin(), d.end(), T(0));
    inv.k = 0;
    std::fill(inv.B.begin(), inv.B.end(), T(0));
    std::fill(inv.cols.begin(), inv.cols.end(), -1);

    // c0 = A^T y ; first index = argmax |c| (leftmost on ties, matching
    // cblas ixamax semantics the reference relies on)
    int idx = 0;
    T c_inf = 0;
    if (rtblas::active()) {
      rtblas::gemv(false, n, m, T(1), At, m, y, T(0), c.data());
      for (int j = 0; j < n; ++j)
        if (std::abs(c[j]) > c_inf) { c_inf = std::abs(c[j]); idx = j; }
    } else {
      for (int j = 0; j < n; ++j) {
        c[j] = dot(col(j), y, m);
        if (std::abs(c[j]) > c_inf) { c_inf = std::abs(c[j]); idx = j; }
      }
    }

    toggle(idx);
    d[idx] = sign_deadzone(c_inf, tol) * inv.at(0, 0);

    int iter = 0;
    const T big = std::numeric_limits<T>::max();
    do {
      ++iter;
      // q = A^T (A d) with d supported on the active set:
      // p = sum_s d[cols_s] * A[:,cols_s]   (k columns, not n)
      std::fill(p.begin(), p.end(), T(0));
      for (int s = 0; s < inv.k; ++s)
        axpy(d[inv.cols[s]], col(inv.cols[s]), p.data(), m);
      // the solve's dominant O(m·n) stream: one pass over A per iteration
      if (rtblas::active())
        rtblas::gemv(false, n, m, T(1), At, m, p.data(), T(0), q.data());
      else
        for (int j = 0; j < n; ++j) q[j] = dot(col(j), p.data(), m);

      // gamma scan, leftmost running-min (homotopy-cpu.cpp:100-164)
      T gmin = big;
      int gidx = -1;
      for (int j = 0; j < n; ++j) {
        T cand;
        if (inv.slot_of(j) >= 0) {
          cand = -x[j] / d[j];
        } else {
          T lo = (c_inf - c[j]) / (T(1) - q[j]);
          T hi = (c_inf + c[j]) / (T(1) + q[j]);
          cand = big;
          if (std::isfinite(lo) && lo > 0 && lo < cand) cand = lo;
          if (std::isfinite(hi) && hi > 0 && hi < cand) cand = hi;
        }
        if (cand > 0 && cand < gmin) { gmin = cand; gidx = j; }
      }
      // no valid candidate: proceed with idx=0, gamma=FLT_MAX — the
      // reference's running-min initialization (homotopy-cpu.cpp:123)
      // and the JAX engines' argmin-of-all-big behavior; all engines
      // agree on this degenerate state (round-1 advisor finding 3)
      if (gidx < 0) gidx = 0;
      T gamma = gmin;

      // a full-capacity insert breaks the path cleanly, like the JAX
      // engines (solvers/homotopy.py k_max overflow guard) and the
      // empty-set case below — continuing with a stale support would
      // re-select the same column forever; likewise a degenerate insert
      // (Schur complement at rounding noise — see inverse::insert)
      if (inv.slot_of(gidx) < 0 && inv.k >= cap) break;
      if (!toggle(gidx)) break;
      if (inv.k == 0) break;

      // x += gamma d ; c -= gamma q (correlation recurrence); new c_inf
      for (int j = 0; j < n; ++j) x[j] += gamma * d[j];
      c_inf = 0;
      for (int j = 0; j < n; ++j) {
        c[j] -= gamma * q[j];
        if (std::abs(c[j]) > c_inf) c_inf = std::abs(c[j]);
      }

      // direction = B * sign(c_G) scattered to the active columns
      std::fill(d.begin(), d.end(), T(0));
      for (int s = 0; s < inv.k; ++s)
        u1col[s] = sign_deadzone(c[inv.cols[s]], tol);
      bool dbad = false;
      for (int s = 0; s < inv.k; ++s) {
        T ds = dot(&inv.B[size_t(s) * inv.cap], u1col.data(), inv.k);
        d[inv.cols[s]] = ds;
        dbad |= !std::isfinite(ds);
      }
      // finiteness break: on rank-deficient supports the (deliberately
      // reference-faithful) tiny/negative-den inserts can overflow the
      // inverse; stop with the committed finite x/c instead of stepping
      // a non-finite direction (same rule as the batch driver)
      if (dbad) break;
    } while (iter < max_iter && c_inf > tol);

    std::memcpy(x_out, x.data(), sizeof(T) * n);
    *err_out = c_inf;
    return iter;
  }

  bool toggle(int j) {
    if (inv.slot_of(j) >= 0) {
      inv.remove(j);
      return true;
    }
    if (inv.k >= cap) return true;  // caller breaks on capacity first
    const T* v = col(j);
    for (int s = 0; s < inv.k; ++s) u1col[s] = dot(col(inv.cols[s]), v, m);
    return inv.insert(j, u1col.data(), dot(v, v, m));
  }
};

// ------------------------------------------------------------------- OMP
//
// Orthogonal Matching Pursuit — host twin of solvers/omp.py (the
// framework's beyond-reference greedy solver; no reference analog).
// Same trajectory as the jax fast path: leftmost argmax pick over the
// inactive correlations, insertion-ordered OnlineInverse LS re-solve,
// true materialized residual for c and ||r||^2.
template <typename T>
struct OmpWork {
  int m, n, cap;
  const T* At;  // n x m row-major = A columns contiguous
  std::vector<T> c, coef, b_act, r, u1col;
  std::vector<char> active;
  OnlineInverse<T> inv;

  OmpWork(const T* At_, int m_, int n_, int capacity)
      : m(m_), n(n_), cap(capacity), At(At_), c(n_), coef(capacity),
        b_act(capacity), r(m_), u1col(capacity), active(n_, 0),
        inv(capacity) {}

  const T* col(int j) const { return At + size_t(j) * m; }

  void correlations(const T* v) {  // c = A^T v
    if (rtblas::active())
      rtblas::gemv(false, n, m, T(1), At, m, v, T(0), c.data());
    else
      for (int j = 0; j < n; ++j) c[j] = dot(col(j), v, m);
  }

  int solve(const T* y, T tol, int max_iter, T* x_out, T* err_out,
            int picks = 1) {
    inv.k = 0;
    std::fill(inv.B.begin(), inv.B.end(), T(0));
    std::fill(inv.cols.begin(), inv.cols.end(), -1);
    std::fill(active.begin(), active.end(), 0);

    std::memcpy(r.data(), y, sizeof(T) * m);
    correlations(y);
    std::vector<T> c0(c);  // A^T y — every LS rhs is a gather of this
    T rss = dot(y, y, m);
    T prev_rss = std::numeric_limits<T>::max();
    int iter = 0;
    while (iter < max_iter && inv.k < cap && rss > tol * tol
           && rss < prev_rss) {
      prev_rss = rss;
      // gOMP round (picks >= 1, twin of solvers/omp.py picks): insert
      // up to `picks` columns — descending |c| over the inactive set,
      // leftmost tie-break — then ONE LS re-solve and ONE correlation
      // update. Degenerate sub-inserts are skipped individually; a
      // round committing nothing ends the solve with the previous LS
      // solution standing.
      int committed = 0;
      for (int p_ = 0; p_ < picks && iter < max_iter && inv.k < cap;
           ++p_) {
        int idx = -1;
        T best = T(-1);
        for (int j = 0; j < n; ++j)
          if (!active[j] && std::abs(c[j]) > best) {
            best = std::abs(c[j]);
            idx = j;
          }
        if (idx < 0) break;
        // gOMP rounds require a strictly positive correlation (the
        // oracle's degenerate-round guard); the picks=1 path keeps the
        // legacy argmax semantics bit-for-bit
        if (picks > 1 && !(best > T(0))) break;
        // mark considered either way so a degenerate pick is not
        // re-selected within this round; only committed inserts stay
        // active beyond it
        const T* v = col(idx);
        for (int s = 0; s < inv.k; ++s)
          u1col[s] = dot(col(inv.cols[s]), v, m);
        if (!inv.insert(idx, u1col.data(), dot(v, v, m))) {
          if (picks == 1) break;  // single-pick: legacy trajectory
          active[idx] = 2;        // degenerate — skip for this round
          continue;
        }
        active[idx] = 1;
        ++iter;
        ++committed;
      }
      // un-mark round-local degenerate skips
      for (int j = 0; j < n; ++j)
        if (active[j] == 2) active[j] = 0;
      if (committed == 0) break;

      // LS re-solve on the grown support: coef = B (c0[cols])
      for (int s = 0; s < inv.k; ++s) b_act[s] = c0[inv.cols[s]];
      for (int i = 0; i < inv.k; ++i)
        coef[i] = dot(&inv.B[size_t(i) * inv.cap], b_act.data(), inv.k);

      // true residual r = y - A_G coef, then c = A^T r and ||r||^2
      std::memcpy(r.data(), y, sizeof(T) * m);
      for (int s = 0; s < inv.k; ++s)
        axpy(-coef[s], col(inv.cols[s]), r.data(), m);
      correlations(r.data());
      rss = dot(r.data(), r.data(), m);
      if (!std::isfinite(rss)) break;
    }

    std::fill(x_out, x_out + n, T(0));
    for (int s = 0; s < inv.k; ++s) x_out[inv.cols[s]] = coef[s];
    *err_out = std::sqrt(std::max(rss, T(0)));
    return iter;
  }
};

// ---------------------------------------------------------------- QR / IRLS

// Economy Householder QR of column-major A (m x n, m >= n): V holds the
// reflectors, R upper-triangular (n x n), Q materialized m x n.
template <typename T>
struct QRFactors {
  int m, n;
  std::vector<T> Q;   // m x n column-major
  std::vector<T> R;   // n x n row-major
  std::vector<T> G0;  // n x n row-major: G0[i][j] = <Q_i, Q_j>

  QRFactors(const T* At, int m_, int n_) : m(m_), n(n_) {
    std::vector<T> W(At, At + size_t(n) * m);  // working copy, cols contiguous
    std::vector<T> tau(n);
    std::vector<std::vector<T>> V(n);
    std::vector<T> sbuf(n);
    for (int j = 0; j < n; ++j) {
      T* wj = &W[size_t(j) * m];
      T normx = std::sqrt(dot(wj + j, wj + j, m - j));
      if (normx == 0) { tau[j] = 0; V[j].assign(m - j, T(0)); continue; }
      T alpha = wj[j] >= 0 ? -normx : normx;
      std::vector<T> v(wj + j, wj + m);
      v[0] -= alpha;
      T vnorm2 = dot(v.data(), v.data(), m - j);
      tau[j] = vnorm2 > 0 ? T(2) / vnorm2 : T(0);
      // apply reflector to remaining columns: column-major W's trailing
      // block is, viewed row-major, an (n-j) x (m-j) matrix with lda=m —
      // s = blk·v then blk -= tau s v^T (BLAS-2 when a runtime BLAS is
      // loaded; same arithmetic as the scalar loops)
      if (rtblas::active() && tau[j] != 0) {
        T* blk = &W[size_t(j) * m + j];
        rtblas::gemv(false, n - j, m - j, T(1), blk, m, v.data(), T(0),
                     sbuf.data());
        rtblas::ger(n - j, m - j, -tau[j], sbuf.data(), v.data(), blk, m);
      } else {
        for (int jj = j; jj < n; ++jj) {
          T* w = &W[size_t(jj) * m];
          T s = tau[j] * dot(v.data(), w + j, m - j);
          for (int i = 0; i < m - j; ++i) w[j + i] -= s * v[i];
        }
      }
      V[j] = std::move(v);
    }
    R.assign(size_t(n) * n, T(0));
    for (int i = 0; i < n; ++i)
      for (int j = i; j < n; ++j) R[size_t(i) * n + j] = W[size_t(j) * m + i];
    // materialize Q = H_0 ... H_{n-1} [I_n ; 0]
    Q.assign(size_t(n) * m, T(0));
    for (int j = 0; j < n; ++j) Q[size_t(j) * m + j] = T(1);
    for (int j = n - 1; j >= 0; --j) {
      if (tau[j] == 0) continue;
      if (rtblas::active()) {
        T* blk = &Q[j];  // rows = all n columns of Q, cols = m - j, lda=m
        rtblas::gemv(false, n, m - j, T(1), blk, m, V[j].data(), T(0),
                     sbuf.data());
        rtblas::ger(n, m - j, -tau[j], sbuf.data(), V[j].data(), blk, m);
      } else {
        for (int jj = 0; jj < n; ++jj) {
          T* qcol = &Q[size_t(jj) * m];
          T s = tau[j] * dot(V[j].data(), qcol + j, m - j);
          for (int i = 0; i < m - j; ++i) qcol[j + i] -= s * V[j][i];
        }
      }
    }
    // w-independent Gram of Q's columns, computed ONCE: the IRLS Newton
    // system is G[i][j] = w_j * G0[i][j] (irls-cpu.cpp:48 rebuilds the
    // full Q^T(Q∘w) product every iteration, O(n²m); scaling a cached
    // G0 is the identical arithmetic — each entry is w_j·<Q_i,Q_j>
    // either way — at O(n²) per iteration).
    G0.assign(size_t(n) * n, T(0));
    if (rtblas::active()) {
      rtblas::gemm_nt(n, n, m, T(1), Q.data(), m, Q.data(), m, T(0),
                      G0.data());
    } else {
      for (int i = 0; i < n; ++i)
        for (int j = 0; j <= i; ++j) {
          T s = dot(&Q[size_t(i) * m], &Q[size_t(j) * m], m);
          G0[size_t(i) * n + j] = s;
          G0[size_t(j) * n + i] = s;
        }
    }
  }
};

// Cholesky of a row-major n x n SPD matrix, in place lower; false if not SPD.
template <typename T>
bool cholesky(std::vector<T>& A, int n) {
  for (int j = 0; j < n; ++j) {
    T s = A[size_t(j) * n + j];
    for (int p = 0; p < j; ++p) s -= A[size_t(j) * n + p] * A[size_t(j) * n + p];
    // SPD criterion: pivot sqrt > machine eps (matches linalg/cholesky.py
    // and the reference's pivot check, cholesky_decomposition.h:80-83);
    // negated comparison also rejects NaN pivots.
    const T eps = std::numeric_limits<T>::epsilon();
    if (!(s > eps * eps)) return false;
    T ljj = std::sqrt(s);
    A[size_t(j) * n + j] = ljj;
    for (int i = j + 1; i < n; ++i) {
      T t = A[size_t(i) * n + j];
      for (int p = 0; p < j; ++p)
        t -= A[size_t(i) * n + p] * A[size_t(j) * n + p];
      A[size_t(i) * n + j] = t / ljj;
    }
  }
  return true;
}

template <typename T>
void chol_solve(const std::vector<T>& L, int n, std::vector<T>& b) {
  for (int i = 0; i < n; ++i) {
    T s = b[i];
    for (int j = 0; j < i; ++j) s -= L[size_t(i) * n + j] * b[j];
    b[i] = s / L[size_t(i) * n + i];
  }
  for (int i = n - 1; i >= 0; --i) {
    T s = b[i];
    for (int j = i + 1; j < n; ++j) s -= L[size_t(j) * n + i] * b[j];
    b[i] = s / L[size_t(i) * n + i];
  }
}

// IRLS (Chartrand–Yin p=0.9 reweighting) over a cached QR — the same
// iteration as solvers/irls.py (reference: irls-cpu.cpp:39-124).
template <typename T>
struct IrlsWork {
  const QRFactors<T>& qr;
  int m, n;
  std::vector<T> w, xv, G, rhs, s, t;

  explicit IrlsWork(const QRFactors<T>& f)
      : qr(f), m(f.m), n(f.n), w(f.n), xv(f.n), G(size_t(f.n) * f.n),
        rhs(f.n), s(f.n), t(f.m) {}

  int solve(const T* y, T tol, int max_iter, T* x_out, T* err_out,
            int* spd_fail) {
    const T p = T(0.9);
    std::fill(w.begin(), w.end(), T(1));
    T eps = 1, abstol = 1, x2 = 1;
    int iter = 0;
    *spd_fail = 0;
    // rhs = Q^T y is weight-independent: computed once per solve (the
    // reference recomputes it every iteration, irls-cpu.cpp:53 — same
    // values, hoisted)
    if (rtblas::active())
      rtblas::gemv(false, n, m, T(1), qr.Q.data(), m, y, T(0), rhs.data());
    else
      for (int i = 0; i < n; ++i) rhs[i] = dot(&qr.Q[size_t(i) * m], y, m);
    do {
      // G = Q^T (Q o w) with w scaling Q's *columns*: G[i][j] =
      // w_j <Q_i,Q_j> = w_j * G0[i][j] over the construction-time Gram
      for (int i = 0; i < n; ++i) {
        const T* g0 = &qr.G0[size_t(i) * n];
        T* gi = &G[size_t(i) * n];
        for (int j = 0; j < n; ++j) gi[j] = w[j] * g0[j];
      }
      if (!cholesky(G, n)) { *spd_fail = 1; break; }
      s = rhs;
      chol_solve(G, n, s);
      // t = Q s ; xv = Q^T t ; solve R xv
      if (rtblas::active()) {
        rtblas::gemv(true, n, m, T(1), qr.Q.data(), m, s.data(), T(0),
                     t.data());
        rtblas::gemv(false, n, m, T(1), qr.Q.data(), m, t.data(), T(0),
                     xv.data());
      } else {
        std::fill(t.begin(), t.end(), T(0));
        for (int j = 0; j < n; ++j)
          axpy(s[j], &qr.Q[size_t(j) * m], t.data(), m);
        for (int j = 0; j < n; ++j)
          xv[j] = dot(&qr.Q[size_t(j) * m], t.data(), m);
      }
      for (int i = n - 1; i >= 0; --i) {
        T acc = xv[i];
        for (int j = i + 1; j < n; ++j) acc -= qr.R[size_t(i) * n + j] * xv[j];
        xv[i] = acc / qr.R[size_t(i) * n + i];
      }
      ++iter;
      // threshold + eps + weight update (irls-cpu.cpp:100-114)
      T amax = *std::max_element(xv.begin(), xv.end());
      abstol = amax * tol;
      for (auto& v : xv)
        if (v < abstol) v = 0;
      if (n < 2) {
        x2 = 0;  // no second-largest; the loop exits below
      } else {
        std::vector<T> srt(xv);
        std::nth_element(srt.begin(), srt.begin() + 1, srt.end(),
                         std::greater<T>());
        x2 = srt[1];
      }
      eps = std::min(eps, x2 / T(n));
      T wsum = 0;
      for (int j = 0; j < n; ++j) {
        w[j] = std::pow(xv[j] * xv[j] + eps, p / 2 - 1);
        wsum += w[j];
      }
      for (auto& v : w) v /= wsum;
    } while (iter < max_iter && x2 > abstol);
    T xsum = 0;
    for (auto v : xv) xsum += v;
    for (int j = 0; j < n; ++j) x_out[j] = xsum != 0 ? xv[j] / xsum : xv[j];
    *err_out = eps;
    return iter;
  }
};

// CG-IRLS (DDFG basis pursuit for m <= n) — the same iteration as
// solvers/irls_cg.py (arXiv:1509.04063): inverse weights
// D = (x^2 + eps^2)^(1 - p/2), warm-started conjugate-gradient solve of
// (A D A^T) z = y, x = D o (A^T z), eps <- min(eps, r_{K+1}(x)/n),
// termination on the relative sup-norm change of x (do-while). A CG
// breakdown (pBp <= 0 / non-finite, or an overflowing step) maps to the
// jax engine's spd_failure, with the iterate left at its last finite
// value. No reference analog (its IRLS rejects m < n, irls_test.cpp:53).
template <typename T>
struct IrlsCgWork {
  const T* A;  // row-major m x n
  int m, n;
  std::vector<T> D, x, xn, z, r, pv, Bp, tn, srt;

  IrlsCgWork(const T* a, int m_, int n_)
      : A(a), m(m_), n(n_), D(n_), x(n_), xn(n_), z(m_), r(m_), pv(m_),
        Bp(m_), tn(n_), srt(n_) {}

  void rmatvec(const T* u, T* out) {  // out = A^T u
    if (rtblas::active()) {
      rtblas::gemv(true, m, n, T(1), A, n, u, T(0), out);
      return;
    }
    std::fill(out, out + n, T(0));
    for (int i = 0; i < m; ++i) axpy(u[i], A + size_t(i) * n, out, n);
  }

  void bmatvec(const T* v, T* out) {  // out = A (D o (A^T v))
    rmatvec(v, tn.data());
    for (int j = 0; j < n; ++j) tn[j] *= D[j];
    if (rtblas::active()) {
      rtblas::gemv(false, m, n, T(1), A, n, tn.data(), T(0), out);
      return;
    }
    for (int i = 0; i < m; ++i)
      out[i] = dot(A + size_t(i) * n, tn.data(), n);
  }

  // CG for (A D A^T) z = y, warm-started at the current z; false on
  // curvature breakdown (z rolled back to its last finite value)
  bool cg(const T* y, T tol2, int max_cg) {
    bmatvec(z.data(), Bp.data());
    for (int i = 0; i < m; ++i) r[i] = y[i] - Bp[i];
    pv = r;
    T rs = dot(r.data(), r.data(), m);
    for (int it = 0; it < max_cg && rs > tol2; ++it) {
      bmatvec(pv.data(), Bp.data());
      T pBp = dot(pv.data(), Bp.data(), m);
      if (!(std::isfinite(pBp) && pBp > 0)) return false;
      T alpha = rs / pBp;
      axpy(alpha, pv.data(), z.data(), m);
      axpy(-alpha, Bp.data(), r.data(), m);
      T rs2 = dot(r.data(), r.data(), m);
      if (!std::isfinite(rs2)) {  // alpha overflowed: roll back, break
        axpy(-alpha, pv.data(), z.data(), m);
        axpy(alpha, Bp.data(), r.data(), m);
        return false;
      }
      T beta = rs2 / rs;
      for (int i = 0; i < m; ++i) pv[i] = r[i] + beta * pv[i];
      rs = rs2;
    }
    return true;
  }

  int solve(const T* y, T tol, int max_iter, T p, int K, int max_cg,
            T cg_rel, T* x_out, T* eps_out, int* broke_out) {
    std::fill(x.begin(), x.end(), T(0));
    std::fill(z.begin(), z.end(), T(0));
    T eps = 1;
    int iter = 0;
    *broke_out = 0;
    const T tol2 = cg_rel * cg_rel * dot(y, y, m);
    const T tiny = std::numeric_limits<T>::min();
    T change = std::numeric_limits<T>::infinity();
    do {
      const T pexp = T(1) - p / 2;
      for (int j = 0; j < n; ++j)
        D[j] = std::pow(x[j] * x[j] + eps * eps, pexp);
      if (!cg(y, tol2, max_cg)) { *broke_out = 1; break; }
      rmatvec(z.data(), xn.data());
      for (int j = 0; j < n; ++j) xn[j] *= D[j];
      T xmax = 0, dmax = 0;
      for (int j = 0; j < n; ++j) {
        xmax = std::max(xmax, std::abs(xn[j]));
        dmax = std::max(dmax, std::abs(xn[j] - x[j]));
      }
      change = dmax / std::max(xmax, tiny);
      for (int j = 0; j < n; ++j) srt[j] = std::abs(xn[j]);
      int kk = std::min(K, n - 1);  // (K+1)-th largest, 0-based index K
      std::nth_element(srt.begin(), srt.begin() + kk, srt.end(),
                       std::greater<T>());
      eps = std::min(eps, srt[kk] / T(n));
      x = xn;
      ++iter;
    } while (iter < max_iter && change > tol);
    std::copy(x.begin(), x.end(), x_out);
    *eps_out = eps;
    return iter;
  }
};

// <=0 / non-positive knobs select the engine defaults (the jax engine's:
// K = m/4, max_cg = min(m, 128), cg_rel = tol/10 clamped to
// [10*eps_mach, sqrt(eps_mach)])
template <typename T>
void resolve_cg_defaults(int m, T tol, int& k_sparsity, int& max_cg,
                         T& cg_rel) {
  if (k_sparsity <= 0) k_sparsity = std::max(1, m / 4);
  if (max_cg <= 0) max_cg = std::min(m, 128);
  if (!(cg_rel > 0)) {
    const T me = std::numeric_limits<T>::epsilon();
    cg_rel = std::max(T(10) * me, std::min(std::sqrt(me), tol / 10));
  }
}

template <typename T>
int irls_cg_impl(const T* A, int m, int n, const T* y, T tol, int max_iter,
                 T p, int k_sparsity, int max_cg, T cg_rel, T* x_out,
                 T* eps_out, int* broke_out) {
  resolve_cg_defaults(m, tol, k_sparsity, max_cg, cg_rel);
  IrlsCgWork<T> w(A, m, n);
  return w.solve(y, tol, max_iter, p, k_sparsity, max_cg, cg_rel, x_out,
                 eps_out, broke_out);
}

template <typename T>
void transpose_to_colmajor(const T* A, int m, int n, std::vector<T>& At) {
  At.resize(size_t(n) * m);
  for (int i = 0; i < m; ++i)
    for (int j = 0; j < n; ++j) At[size_t(j) * m + i] = A[size_t(i) * n + j];
}

}  // namespace

// ------------------------------------------------------------------ C ABI

// Batched homotopy across a thread pool; Y row-major batch x m, X batch x n,
// iters/errs length batch. nthreads<=0 = hardware concurrency. Both dtypes,
// like every reference instantiation pair (homotopy-cpu.cpp:277-297).
template <typename T>
static void homotopy_batch_impl(const T* A, int m, int n, const T* Y,
                                int batch, T tol, int max_iter, int k_max,
                                int nthreads, T* X_out, int* iters_out,
                                T* errs_out) {
  std::vector<T> At;
  transpose_to_colmajor(A, m, n, At);
  int cap = std::min(k_max, n);
  int nt = nthreads > 0 ? nthreads
                        : int(std::thread::hardware_concurrency());
  nt = std::max(1, std::min(nt, batch));
  rtblas::ThreadClamp clamp(nt);
  std::atomic<int> next(0);
  auto worker = [&]() {
    HomotopyWork<T> w(At.data(), m, n, cap);
    for (;;) {
      int b = next.fetch_add(1);
      if (b >= batch) return;
      iters_out[b] = w.solve(Y + size_t(b) * m, tol, max_iter,
                             X_out + size_t(b) * n, errs_out + b);
    }
  };
  std::vector<std::thread> ts;
  for (int i = 0; i < nt; ++i) ts.emplace_back(worker);
  for (auto& t : ts) t.join();
}

// Batched OMP across the same thread pool; one workspace per worker,
// results bit-identical to sequential solves regardless of thread count.
template <typename T>
static void omp_batch_impl(const T* A, int m, int n, const T* Y, int batch,
                           T tol, int max_iter, int k_max, int nthreads,
                           T* X_out, int* iters_out, T* errs_out,
                           int picks = 1) {
  std::vector<T> At;
  transpose_to_colmajor(A, m, n, At);
  int cap = std::max(1, std::min(k_max, std::min(m, n)));
  int nt = nthreads > 0 ? nthreads
                        : int(std::thread::hardware_concurrency());
  nt = std::max(1, std::min(nt, batch));
  rtblas::ThreadClamp clamp(nt);
  std::atomic<int> next(0);
  auto worker = [&]() {
    OmpWork<T> w(At.data(), m, n, cap);
    for (;;) {
      int b = next.fetch_add(1);
      if (b >= batch) return;
      iters_out[b] = w.solve(Y + size_t(b) * m, tol, max_iter,
                             X_out + size_t(b) * n, errs_out + b, picks);
    }
  };
  std::vector<std::thread> ts;
  for (int i = 0; i < nt; ++i) ts.emplace_back(worker);
  for (auto& t : ts) t.join();
}

// Batched CG-IRLS across the same thread pool. One workspace per worker
// (solve() fully re-initializes it), defaults resolved once; each solve
// runs the identical single-solve iteration, so batch results are
// bit-identical to sequential solves regardless of thread count.
template <typename T>
static void irls_cg_batch_impl(const T* A, int m, int n, const T* Y,
                               int batch, T tol, int max_iter, T p,
                               int k_sparsity, int max_cg, T cg_rel,
                               int nthreads, T* X_out, int* iters_out,
                               T* eps_out, int* broke_out) {
  resolve_cg_defaults(m, tol, k_sparsity, max_cg, cg_rel);
  int nt = nthreads > 0 ? nthreads
                        : int(std::thread::hardware_concurrency());
  nt = std::max(1, std::min(nt, batch));
  rtblas::ThreadClamp clamp(nt);
  std::atomic<int> next(0);
  auto worker = [&]() {
    IrlsCgWork<T> w(A, m, n);
    for (;;) {
      int b = next.fetch_add(1);
      if (b >= batch) return;
      iters_out[b] = w.solve(Y + size_t(b) * m, tol, max_iter, p,
                             k_sparsity, max_cg, cg_rel,
                             X_out + size_t(b) * n, eps_out + b,
                             broke_out + b);
    }
  };
  std::vector<std::thread> ts;
  for (int i = 0; i < nt; ++i) ts.emplace_back(worker);
  for (auto& t : ts) t.join();
}

// Batched IRLS over a shared const QRFactors handle, same thread-pool
// shape as the other batches: one IrlsWork per worker (solve() fully
// re-initializes its weights/eps state), so batch results are
// bit-identical to sequential per-signal solves regardless of thread
// count. Y row-major batch x m.
template <typename T>
static void irls_batch_impl(const QRFactors<T>& qr, const T* Y, int batch,
                            T tol, int max_iter, int nthreads, T* X_out,
                            int* iters_out, T* errs_out, int* spd_out) {
  int nt = nthreads > 0 ? nthreads
                        : int(std::thread::hardware_concurrency());
  nt = std::max(1, std::min(nt, batch));
  rtblas::ThreadClamp clamp(nt);
  std::atomic<int> next(0);
  auto worker = [&]() {
    IrlsWork<T> w(qr);
    for (;;) {
      int b = next.fetch_add(1);
      if (b >= batch) return;
      iters_out[b] = w.solve(Y + size_t(b) * qr.m, tol, max_iter,
                             X_out + size_t(b) * qr.n, errs_out + b,
                             spd_out + b);
    }
  };
  std::vector<std::thread> ts;
  for (int i = 0; i < nt; ++i) ts.emplace_back(worker);
  for (auto& t : ts) t.join();
}

extern "C" {

// Homotopy, single solve. A row-major m x n. Returns iterations.
int ss_homotopy_solve_f32(const float* A, int m, int n, const float* y,
                          float tol, int max_iter, int k_max, float* x_out,
                          float* err_out) {
  std::vector<float> At;
  transpose_to_colmajor(A, m, n, At);
  HomotopyWork<float> w(At.data(), m, n, std::min(k_max, n));
  return w.solve(y, tol, max_iter, x_out, err_out);
}

int ss_homotopy_solve_f64(const double* A, int m, int n, const double* y,
                          double tol, int max_iter, int k_max, double* x_out,
                          double* err_out) {
  std::vector<double> At;
  transpose_to_colmajor(A, m, n, At);
  HomotopyWork<double> w(At.data(), m, n, std::min(k_max, n));
  return w.solve(y, tol, max_iter, x_out, err_out);
}

void ss_homotopy_solve_batch_f32(const float* A, int m, int n, const float* Y,
                                 int batch, float tol, int max_iter, int k_max,
                                 int nthreads, float* X_out, int* iters_out,
                                 float* errs_out) {
  homotopy_batch_impl<float>(A, m, n, Y, batch, tol, max_iter, k_max,
                             nthreads, X_out, iters_out, errs_out);
}

void ss_homotopy_solve_batch_f64(const double* A, int m, int n,
                                 const double* Y, int batch, double tol,
                                 int max_iter, int k_max, int nthreads,
                                 double* X_out, int* iters_out,
                                 double* errs_out) {
  homotopy_batch_impl<double>(A, m, n, Y, batch, tol, max_iter, k_max,
                              nthreads, X_out, iters_out, errs_out);
}

// OMP, single solve and threaded batch. A row-major m x n; k_max caps
// the support. Returns iterations; err_out = final ||y - Ax||_2.
int ss_omp_solve_f32(const float* A, int m, int n, const float* y,
                     float tol, int max_iter, int k_max, float* x_out,
                     float* err_out) {
  std::vector<float> At;
  transpose_to_colmajor(A, m, n, At);
  OmpWork<float> w(At.data(), m, n,
                   std::max(1, std::min(k_max, std::min(m, n))));
  return w.solve(y, tol, max_iter, x_out, err_out);
}

int ss_omp_solve_f64(const double* A, int m, int n, const double* y,
                     double tol, int max_iter, int k_max, double* x_out,
                     double* err_out) {
  std::vector<double> At;
  transpose_to_colmajor(A, m, n, At);
  OmpWork<double> w(At.data(), m, n,
                    std::max(1, std::min(k_max, std::min(m, n))));
  return w.solve(y, tol, max_iter, x_out, err_out);
}

void ss_omp_solve_batch_f32(const float* A, int m, int n, const float* Y,
                            int batch, float tol, int max_iter, int k_max,
                            int nthreads, float* X_out, int* iters_out,
                            float* errs_out) {
  omp_batch_impl<float>(A, m, n, Y, batch, tol, max_iter, k_max, nthreads,
                        X_out, iters_out, errs_out);
}

void ss_omp_solve_batch_f64(const double* A, int m, int n, const double* Y,
                            int batch, double tol, int max_iter, int k_max,
                            int nthreads, double* X_out, int* iters_out,
                            double* errs_out) {
  omp_batch_impl<double>(A, m, n, Y, batch, tol, max_iter, k_max, nthreads,
                         X_out, iters_out, errs_out);
}

// Generalized OMP (picks per round) — new entry points so pre-round-5
// binaries keep their exact ABI; the picks=1 path is the legacy
// trajectory bit-for-bit.
int ss_omp_solve_pk_f32(const float* A, int m, int n, const float* y,
                        float tol, int max_iter, int k_max, int picks,
                        float* x_out, float* err_out) {
  std::vector<float> At;
  transpose_to_colmajor(A, m, n, At);
  OmpWork<float> w(At.data(), m, n,
                   std::max(1, std::min(k_max, std::min(m, n))));
  return w.solve(y, tol, max_iter, x_out, err_out, std::max(1, picks));
}

int ss_omp_solve_pk_f64(const double* A, int m, int n, const double* y,
                        double tol, int max_iter, int k_max, int picks,
                        double* x_out, double* err_out) {
  std::vector<double> At;
  transpose_to_colmajor(A, m, n, At);
  OmpWork<double> w(At.data(), m, n,
                    std::max(1, std::min(k_max, std::min(m, n))));
  return w.solve(y, tol, max_iter, x_out, err_out, std::max(1, picks));
}

void ss_omp_solve_batch_pk_f32(const float* A, int m, int n,
                               const float* Y, int batch, float tol,
                               int max_iter, int k_max, int picks,
                               int nthreads, float* X_out, int* iters_out,
                               float* errs_out) {
  omp_batch_impl<float>(A, m, n, Y, batch, tol, max_iter, k_max, nthreads,
                        X_out, iters_out, errs_out, std::max(1, picks));
}

void ss_omp_solve_batch_pk_f64(const double* A, int m, int n,
                               const double* Y, int batch, double tol,
                               int max_iter, int k_max, int picks,
                               int nthreads, double* X_out, int* iters_out,
                               double* errs_out) {
  omp_batch_impl<double>(A, m, n, Y, batch, tol, max_iter, k_max, nthreads,
                         X_out, iters_out, errs_out, std::max(1, picks));
}

// IRLS with construct-once QR: create returns an opaque handle.
void* ss_irls_create_f32(const float* A, int m, int n) {
  if (m < n) return nullptr;
  std::vector<float> At;
  transpose_to_colmajor(A, m, n, At);
  return new QRFactors<float>(At.data(), m, n);
}

int ss_irls_solve_f32(void* handle, const float* y, float tol, int max_iter,
                      float* x_out, float* err_out, int* spd_fail) {
  auto* qr = static_cast<QRFactors<float>*>(handle);
  IrlsWork<float> w(*qr);
  return w.solve(y, tol, max_iter, x_out, err_out, spd_fail);
}

void ss_irls_destroy_f32(void* handle) {
  delete static_cast<QRFactors<float>*>(handle);
}

void ss_irls_solve_batch_f32(void* handle, const float* Y, int batch,
                             float tol, int max_iter, int nthreads,
                             float* X_out, int* iters_out, float* errs_out,
                             int* spd_out) {
  irls_batch_impl<float>(*static_cast<QRFactors<float>*>(handle), Y, batch,
                         tol, max_iter, nthreads, X_out, iters_out,
                         errs_out, spd_out);
}

void* ss_irls_create_f64(const double* A, int m, int n) {
  if (m < n) return nullptr;
  std::vector<double> At;
  transpose_to_colmajor(A, m, n, At);
  return new QRFactors<double>(At.data(), m, n);
}

int ss_irls_solve_f64(void* handle, const double* y, double tol, int max_iter,
                      double* x_out, double* err_out, int* spd_fail) {
  auto* qr = static_cast<QRFactors<double>*>(handle);
  IrlsWork<double> w(*qr);
  return w.solve(y, tol, max_iter, x_out, err_out, spd_fail);
}

void ss_irls_destroy_f64(void* handle) {
  delete static_cast<QRFactors<double>*>(handle);
}

void ss_irls_solve_batch_f64(void* handle, const double* Y, int batch,
                             double tol, int max_iter, int nthreads,
                             double* X_out, int* iters_out, double* errs_out,
                             int* spd_out) {
  irls_batch_impl<double>(*static_cast<QRFactors<double>*>(handle), Y, batch,
                          tol, max_iter, nthreads, X_out, iters_out,
                          errs_out, spd_out);
}

// CG-IRLS single solve (m <= n); returns iterations, broke -> the jax
// engine's spd_failure. k_sparsity <= 0, max_cg <= 0 and cg_rel <= 0
// select the engine defaults (m/4, min(m,128), tol/10 clamped).
int ss_irls_cg_solve_f32(const float* A, int m, int n, const float* y,
                         float tol, int max_iter, float p, int k_sparsity,
                         int max_cg, float cg_rel, float* x_out,
                         float* eps_out, int* broke_out) {
  return irls_cg_impl<float>(A, m, n, y, tol, max_iter, p, k_sparsity,
                             max_cg, cg_rel, x_out, eps_out, broke_out);
}

int ss_irls_cg_solve_f64(const double* A, int m, int n, const double* y,
                         double tol, int max_iter, double p, int k_sparsity,
                         int max_cg, double cg_rel, double* x_out,
                         double* eps_out, int* broke_out) {
  return irls_cg_impl<double>(A, m, n, y, tol, max_iter, p, k_sparsity,
                              max_cg, cg_rel, x_out, eps_out, broke_out);
}

void ss_irls_cg_solve_batch_f32(const float* A, int m, int n, const float* Y,
                                int batch, float tol, int max_iter, float p,
                                int k_sparsity, int max_cg, float cg_rel,
                                int nthreads, float* X_out, int* iters_out,
                                float* eps_out, int* broke_out) {
  irls_cg_batch_impl<float>(A, m, n, Y, batch, tol, max_iter, p, k_sparsity,
                            max_cg, cg_rel, nthreads, X_out, iters_out,
                            eps_out, broke_out);
}

void ss_irls_cg_solve_batch_f64(const double* A, int m, int n,
                                const double* Y, int batch, double tol,
                                int max_iter, double p, int k_sparsity,
                                int max_cg, double cg_rel, int nthreads,
                                double* X_out, int* iters_out,
                                double* eps_out, int* broke_out) {
  irls_cg_batch_impl<double>(A, m, n, Y, batch, tol, max_iter, p, k_sparsity,
                             max_cg, cg_rel, nthreads, X_out, iters_out,
                             eps_out, broke_out);
}

// ---- runtime BLAS control (see the rtblas namespace at the top).
// ss_blas_load: dlopen `path` and resolve `prefix + cblas_<op> + suffix`
// for the six ops the solvers stream through (s/d gemv, gemm, ger),
// plus optional openblas thread controls. ilp64 selects 64-bit
// dimension arguments. First successful load wins; returns 1 on
// success, 0 leaves the scalar fallbacks in place. Mirrors the
// reference's runtime loader contract (blas_wrapper.cpp:27-66) minus
// the abort() on failure.
int ss_blas_load(const char* path, const char* prefix, const char* suffix,
                 int ilp64) {
  if (rtblas::g.complete()) return 1;
  if (!path || !prefix || !suffix) return 0;
  void* h = dlopen(path, RTLD_NOW | RTLD_LOCAL);
  if (!h) return 0;
  auto sym = [&](const char* base) -> void* {
    std::string s = std::string(prefix) + base + suffix;
    return dlsym(h, s.c_str());
  };
  rtblas::Table t;
  t.handle = h;
  t.ilp64 = ilp64 != 0;
  t.sgemv = sym("cblas_sgemv");
  t.dgemv = sym("cblas_dgemv");
  t.sgemm = sym("cblas_sgemm");
  t.dgemm = sym("cblas_dgemm");
  t.sger = sym("cblas_sger");
  t.dger = sym("cblas_dger");
  t.set_threads =
      reinterpret_cast<rtblas::set_thr_fn>(sym("openblas_set_num_threads"));
  t.get_threads =
      reinterpret_cast<rtblas::get_thr_fn>(sym("openblas_get_num_threads"));
  if (!t.complete()) {
    dlclose(h);
    return 0;
  }
  rtblas::g = t;
  return 1;
}

// 0 = scalar fallbacks, 1 = LP64 BLAS active, 2 = ILP64 BLAS active
int ss_blas_active() {
  if (!rtblas::active()) return 0;
  return rtblas::g.ilp64 ? 2 : 1;
}

// Test hook: force the scalar fallbacks without unloading (0) / re-enable
// a loaded table (nonzero).
void ss_blas_set_enabled(int enabled) {
  rtblas::g_enabled.store(enabled != 0, std::memory_order_relaxed);
}

int ss_native_version() { return 6; }

}  // extern "C"

// Native runtime for the online convex optimization framework.
//
// Two roles (SURVEY.md §2.5 — the reference's "native" layer is Numba
// LLVM-JIT kernels plus CVXPY's C solver backends; neither exists in this
// image):
//
//  1. Golden oracle: f64 scalar-loop implementations of the reference's
//     simulation semantics with the *same operation order* as the Numba
//     kernels (sequential dot products, sequential accumulation;
//     /root/reference/fast_algorithms.py:11-164).  This is the highest-
//     fidelity parity target available, batched with OpenMP.
//
//  2. Exact-FTL solver: warm-started per-prefix ADMM for
//     min_{||x||<=1} 0.5*sum_i |<z_i,x>-y_i| (the ECOS/CVXPY replacement;
//     /root/reference/exact_ftl.py:62-193), used for cross-validating the
//     on-device batched ADMM and for CPU-side golden generation.
//
// Built with -ffp-contract=off: GCC's default FMA contraction would change
// rounding versus the per-op IEEE semantics the Numba reference has.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline double dot_seq(const double* a, const double* b, int64_t d) {
  // Sequential accumulation, matching fast_algorithms.py:11-16.
  double total = 0.0;
  for (int64_t i = 0; i < d; ++i) total += a[i] * b[i];
  return total;
}

inline double hinge(double q, double y) {
  double diff = q - y;
  if (diff < 0.0) diff = -diff;
  return 0.5 * diff;
}

inline double grad(double q, double y) {
  double diff = q - y;
  if (diff > 0.0) return 0.5;
  if (diff < 0.0) return -0.5;
  return 0.0;  // exact tie -> zero subgradient (fast_algorithms.py:27-34)
}

inline void action_ftl(const double* theta, double* out, int64_t d) {
  double norm_sq = 0.0;
  for (int64_t j = 0; j < d; ++j) norm_sq += theta[j] * theta[j];
  if (norm_sq == 0.0) {
    for (int64_t j = 0; j < d; ++j) out[j] = 0.0;
    return;
  }
  const double scale = -(1.0 / std::sqrt(norm_sq));
  for (int64_t j = 0; j < d; ++j) out[j] = scale * theta[j];
}

inline void action_ftrl(const double* theta, int64_t t, double eta0,
                        double* out, int64_t d) {
  const double scale = -(eta0 / std::sqrt((double)(t < 1 ? 1 : t)));
  for (int64_t j = 0; j < d; ++j) out[j] = scale * theta[j];
  double norm_sq = 0.0;
  for (int64_t j = 0; j < d; ++j) norm_sq += out[j] * out[j];
  if (norm_sq <= 1.0) return;
  const double factor = 1.0 / std::sqrt(norm_sq);
  for (int64_t j = 0; j < d; ++j) out[j] *= factor;
}

double comparator_loss_prefix(const double* z, const double* y,
                              const double* action, int64_t length,
                              int64_t d) {
  double total = 0.0;
  for (int64_t i = 0; i < length; ++i)
    total += hinge(dot_seq(z + i * d, action, d), y[i]);
  return total;
}

double simulate_alg_one(const double* z, const double* y, int64_t T,
                        int64_t d, int alg_flag, double eta0) {
  std::vector<double> theta(d, 0.0), x(d, 0.0);
  double cum_loss = 0.0;
  for (int64_t t = 0; t < T; ++t) {
    if (alg_flag == 0)
      action_ftrl(theta.data(), t + 1, eta0, x.data(), d);
    else
      action_ftl(theta.data(), x.data(), d);
    const double q = dot_seq(z + t * d, x.data(), d);
    const double y_t = y[t];
    cum_loss += hinge(q, y_t);
    const double g = grad(q, y_t);
    for (int64_t j = 0; j < d; ++j) theta[j] += g * z[t * d + j];
  }
  action_ftl(theta.data(), x.data(), d);
  const double comp = comparator_loss_prefix(z, y, x.data(), T, d);
  return cum_loss - comp;
}

double simulate_smart_one(const double* z, const double* y, int64_t T,
                          int64_t d, double thresh, double eta0,
                          int64_t* switch_out) {
  std::vector<double> theta_ftl(d, 0.0), theta_ftrl(d, 0.0), x(d, 0.0),
      s(d, 0.0);
  bool switched = false;
  int64_t switch_t = T;
  double ftl_loss = 0.0, total_loss = 0.0;
  for (int64_t t = 0; t < T; ++t) {
    const double* zt = z + t * d;
    const double yt = y[t];

    action_ftl(theta_ftl.data(), x.data(), d);
    const double pred_ftl = dot_seq(zt, x.data(), d);
    const double g_ftl = grad(pred_ftl, yt);
    for (int64_t j = 0; j < d; ++j) theta_ftl[j] += g_ftl * zt[j];
    const double loss_ftl = hinge(pred_ftl, yt);
    ftl_loss += loss_ftl;

    if (switched) {
      action_ftrl(theta_ftrl.data(), t + 1, eta0, x.data(), d);
      const double pred = dot_seq(zt, x.data(), d);
      total_loss += hinge(pred, yt);
      const double g = grad(pred, yt);
      for (int64_t j = 0; j < d; ++j) theta_ftrl[j] += g * zt[j];
    } else {
      total_loss += loss_ftl;
      action_ftl(theta_ftl.data(), s.data(), d);
      const double s_loss = comparator_loss_prefix(z, y, s.data(), t + 1, d);
      if (ftl_loss - s_loss >= thresh) {
        switched = true;
        switch_t = t;
      }
    }
  }
  action_ftl(theta_ftl.data(), s.data(), d);
  const double comp = comparator_loss_prefix(z, y, s.data(), T, d);
  if (switch_out) *switch_out = switch_t;
  return total_loss - comp;
}

// ---------------- exact FTL: warm-started per-prefix ADMM ----------------

struct Chol {
  // d x d lower-triangular Cholesky of A = Z'Z + I (row-major).
  std::vector<double> L;
  int64_t d;
  void factor(const std::vector<double>& A, int64_t dd) {
    d = dd;
    L.assign(d * d, 0.0);
    for (int64_t i = 0; i < d; ++i) {
      for (int64_t j = 0; j <= i; ++j) {
        double sum = A[i * d + j];
        for (int64_t k = 0; k < j; ++k) sum -= L[i * d + k] * L[j * d + k];
        if (i == j)
          L[i * d + j] = std::sqrt(sum);
        else
          L[i * d + j] = sum / L[j * d + j];
      }
    }
  }
  void solve(const double* b, double* out) const {
    std::vector<double> ytmp(d);
    for (int64_t i = 0; i < d; ++i) {
      double sum = b[i];
      for (int64_t k = 0; k < i; ++k) sum -= L[i * d + k] * ytmp[k];
      ytmp[i] = sum / L[i * d + i];
    }
    for (int64_t i = d - 1; i >= 0; --i) {
      double sum = ytmp[i];
      for (int64_t k = i + 1; k < d; ++k) sum -= L[k * d + i] * out[k];
      out[i] = sum / L[i * d + i];
    }
  }
};

inline void project_ball(double* x, int64_t d, int norm) {
  if (norm == 0) {  // l2
    double nsq = 0.0;
    for (int64_t j = 0; j < d; ++j) nsq += x[j] * x[j];
    if (nsq > 1.0) {
      const double f = 1.0 / std::sqrt(nsq);
      for (int64_t j = 0; j < d; ++j) x[j] *= f;
    }
  } else if (norm == 1) {  // linf
    for (int64_t j = 0; j < d; ++j) {
      if (x[j] > 1.0) x[j] = 1.0;
      if (x[j] < -1.0) x[j] = -1.0;
    }
  } else {  // l1: Duchi et al. simplex projection on |x|
    double l1 = 0.0;
    for (int64_t j = 0; j < d; ++j) l1 += std::fabs(x[j]);
    if (l1 <= 1.0) return;
    std::vector<double> u(d);
    for (int64_t j = 0; j < d; ++j) u[j] = std::fabs(x[j]);
    // descending insertion sort (d is tiny)
    for (int64_t i = 1; i < d; ++i) {
      double key = u[i];
      int64_t j = i - 1;
      while (j >= 0 && u[j] < key) { u[j + 1] = u[j]; --j; }
      u[j + 1] = key;
    }
    // Duchi et al. threshold: css is the TRUE running prefix sum over all
    // sorted entries; the passing indices form a prefix (u is descending),
    // so the last passing candidate is the correct theta.
    double css = 0.0, theta = 0.0;
    for (int64_t i = 0; i < d; ++i) {
      css += u[i];
      const double cand = (css - 1.0) / (double)(i + 1);
      if (u[i] - cand > 0.0) theta = cand;
    }
    for (int64_t j = 0; j < d; ++j) {
      const double mag = std::fabs(x[j]) - theta;
      x[j] = (x[j] > 0.0 ? 1.0 : -1.0) * (mag > 0.0 ? mag : 0.0);
    }
  }
}

// ADMM on: min 0.5*||s||_1  s.t.  s = Zx - y, w = x, ||w|| <= 1.
// State is carried across prefixes (warm start), mirroring the reference's
// warm-started repeated solves (exact_ftl.py:119-128).
void exact_prefix_actions(const double* z, const double* y, int64_t T,
                          int64_t d, int norm, int iters_first,
                          int iters_warm, double rho, double alpha,
                          double tol, double* out /* (T+1) x d */) {
  std::vector<double> A(d * d, 0.0);
  for (int64_t i = 0; i < d; ++i) A[i * d + i] = 1.0;  // + I
  std::vector<double> x(d, 0.0), w(d, 0.0), v(d, 0.0), rhs(d), x_old(d);
  std::vector<double> s(T, 0.0), u(T, 0.0);
  const double kappa = 0.5 / rho;

  for (int64_t j = 0; j < d; ++j) out[j] = 0.0;  // prefix 0 -> zero action

  Chol chol;
  for (int64_t p = 1; p <= T; ++p) {
    // rank-1 Gram update with row p-1, then refactor (d is tiny).
    const double* zr = z + (p - 1) * d;
    for (int64_t i = 0; i < d; ++i)
      for (int64_t j = 0; j < d; ++j) A[i * d + j] += zr[i] * zr[j];
    chol.factor(A, d);

    const int iters = (p == 1) ? iters_first : iters_warm;
    for (int it = 0; it < iters; ++it) {
      for (int64_t j = 0; j < d; ++j) x_old[j] = x[j];
      // rhs = Z_p' (y + s - u) + (w - v)
      for (int64_t j = 0; j < d; ++j) rhs[j] = w[j] - v[j];
      for (int64_t i = 0; i < p; ++i) {
        const double c = y[i] + s[i] - u[i];
        const double* zi = z + i * d;
        for (int64_t j = 0; j < d; ++j) rhs[j] += zi[j] * c;
      }
      chol.solve(rhs.data(), x.data());
      // s, u updates with over-relaxation
      double pri_res = 0.0;
      for (int64_t i = 0; i < p; ++i) {
        const double r = dot_seq(z + i * d, x.data(), d) - y[i];
        const double r_hat = alpha * r + (1.0 - alpha) * s[i];
        double val = r_hat + u[i];
        const double mag = std::fabs(val) - kappa;
        const double s_new = (val > 0.0 ? 1.0 : -1.0) * (mag > 0.0 ? mag : 0.0);
        u[i] += r_hat - s_new;
        const double dr = r - s_new;
        pri_res += dr * dr;
        s[i] = s_new;
      }
      // w, v updates: x_hat uses the OLD w (over-relaxation), then
      // w = project(x_hat + v), v += x_hat - w.
      double wv_res = 0.0;
      std::vector<double> xh(d);
      for (int64_t j = 0; j < d; ++j) {
        xh[j] = alpha * x[j] + (1.0 - alpha) * w[j];
        w[j] = xh[j] + v[j];
      }
      project_ball(w.data(), d, norm);
      for (int64_t j = 0; j < d; ++j) {
        v[j] += xh[j] - w[j];
        const double dw = x[j] - w[j];
        wv_res += dw * dw;
      }
      double dx = 0.0;
      for (int64_t j = 0; j < d; ++j) {
        const double t2 = x[j] - x_old[j];
        dx += t2 * t2;
      }
      if (it > 10 && pri_res < tol * tol && wv_res < tol * tol &&
          dx < tol * tol * 1e-2)
        break;
    }
    for (int64_t j = 0; j < d; ++j) out[p * d + j] = w[j];
  }
}

// Certified closed-form exact FTL — the native twin of
// online_convex_optimization/models/linear_regime.py.  For +-1
// labels, |q - y| >= 1 - q*y with equality iff |q| <= 1, so when the
// per-prefix certificate max_{i<=t} |<z_i, x*_t>| <= 1 holds, the linear
// argmin x*_t (l2: w_t/||w_t||) is the EXACT unique prefix minimizer.
// Returns 1 and fills out ((T+1) x d) when EVERY prefix certifies;
// returns 0 with out untouched otherwise (caller falls back to the
// warm-started ADMM above).  No interpolation rescue here: f64 data with
// exact row norms <= 1 never needs it, and anything else belongs to the
// general solver.
int certified_prefix_actions(const double* z, const double* y, int64_t T,
                             int64_t d, int norm, double* out) {
  const double kUnique = 1e-6;
  const double kSlack = 1e-14;
  for (int64_t i = 0; i < T; ++i) {  // contract check
    if (y[i] == 1.0 || y[i] == -1.0) continue;
    if (y[i] == 0.0) {
      bool zero = true;
      for (int64_t j = 0; j < d; ++j) zero = zero && (z[i * d + j] == 0.0);
      if (zero) continue;
    }
    return 0;
  }
  std::vector<double> w(d, 0.0), X((size_t)T * d);
  for (int64_t t = 0; t < T; ++t) {
    const double* zr = z + t * d;
    for (int64_t j = 0; j < d; ++j) w[j] += y[t] * zr[j];
    double* xt = X.data() + t * d;
    if (norm == 0) {  // l2: w/||w||
      double nsq = 0.0;
      for (int64_t j = 0; j < d; ++j) nsq += w[j] * w[j];
      const double n = std::sqrt(nsq);
      if (n <= kUnique) return 0;  // non-unique argmin: general solver
      for (int64_t j = 0; j < d; ++j) xt[j] = w[j] / n;
    } else if (norm == 1) {  // linf: sign(w)
      for (int64_t j = 0; j < d; ++j) {
        if (std::fabs(w[j]) <= kUnique) return 0;
        xt[j] = w[j] > 0.0 ? 1.0 : -1.0;
      }
    } else {  // l1: +-e_j at the strict max coordinate
      int64_t jm = 0;
      double top = -1.0, second = -1.0;
      for (int64_t j = 0; j < d; ++j) {
        const double a = std::fabs(w[j]);
        if (a > top) { second = top; top = a; jm = j; }
        else if (a > second) { second = a; }
      }
      if (top - second <= kUnique) return 0;
      for (int64_t j = 0; j < d; ++j) xt[j] = 0.0;
      xt[jm] = w[jm] > 0.0 ? 1.0 : -1.0;
    }
  }
  for (int64_t t = 0; t < T; ++t) {  // optimality certificate
    const double* xt = X.data() + t * d;
    for (int64_t i = 0; i <= t; ++i) {
      const double q = dot_seq(z + i * d, xt, d);
      if (std::fabs(q) > 1.0 + kSlack) return 0;
    }
  }
  for (int64_t j = 0; j < d; ++j) out[j] = 0.0;  // prefix 0: zero action
  std::copy(X.begin(), X.end(), out + d);
  return 1;
}

}  // namespace

extern "C" {

void oco_simulate_alg_batch(const double* z, const double* y, int64_t B,
                            int64_t T, int64_t d, int alg_flag, double eta0,
                            double* out_regret) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (int64_t b = 0; b < B; ++b)
    out_regret[b] =
        simulate_alg_one(z + b * T * d, y + b * T, T, d, alg_flag, eta0);
}

void oco_simulate_smart_batch(const double* z, const double* y, int64_t B,
                              int64_t T, int64_t d, const double* thresh,
                              double eta0, double* out_regret,
                              int64_t* out_switch) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (int64_t b = 0; b < B; ++b)
    out_regret[b] =
        simulate_smart_one(z + b * T * d, y + b * T, T, d, thresh[b], eta0,
                           out_switch ? out_switch + b : nullptr);
}

void oco_exact_prefix_actions(const double* z, const double* y, int64_t T,
                              int64_t d, int norm, int iters_first,
                              int iters_warm, double rho, double alpha,
                              double tol, double* out) {
  exact_prefix_actions(z, y, T, d, norm, iters_first, iters_warm, rho, alpha,
                       tol, out);
}

void oco_exact_prefix_actions_batch(const double* z, const double* y,
                                    int64_t B, int64_t T, int64_t d, int norm,
                                    int iters_first, int iters_warm,
                                    double rho, double alpha, double tol,
                                    double* out /* B x (T+1) x d */) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (int64_t b = 0; b < B; ++b)
    exact_prefix_actions(z + b * T * d, y + b * T, T, d, norm, iters_first,
                         iters_warm, rho, alpha, tol, out + b * (T + 1) * d);
}

int oco_certified_prefix_actions(const double* z, const double* y,
                                 int64_t T, int64_t d, int norm,
                                 double* out) {
  return certified_prefix_actions(z, y, T, d, norm, out);
}

int oco_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"

"""Double-word (compensated) float arithmetic for f32 certificates.

An f32 solve (the production pipeline's device precision) still needs
a rigorous certificate: the SSN duality-gap certificate
(models/ssn.py) needs the prefix residuals  r_i = <z_i, x> - y_i  to
ABSOLUTE accuracy far below the Huber continuation floor mu ~ 2e-5:
the dual candidate reads  psi = clip(r/mu, +-1), so the ~2e-7 absolute
rounding error of a plain f32 dot product becomes ~1e-2 of dual noise —
the measured f32 noise floor that kept the semismooth-Newton solver
f64-only (see docs/BENCHMARKS.md and the round-2 verdict).

These are the classical error-free transformations (Dekker 1971, Knuth;
the double-double building blocks), expressed as branch-free elementwise
JAX ops so they vectorize over the batch:

  * two_sum(a, b)      -> (s, e) with s = fl(a+b), a+b = s+e EXACTLY.
  * two_prod(a, b)     -> (p, e) with p = fl(a*b), a*b = p+e EXACTLY
                          (Dekker splitting; no FMA assumption — if XLA
                          does contract mul-sub into an FMA the error
                          term only becomes MORE exact).
  * df_add / fast_two_sum — normalized double-word accumulation.
  * df_sum(hi, lo)     -> pairwise double-word reduction along an axis
                          (error O(eps^2), vs O(depth*eps) plain f32).
  * dot_compensated(a, b) — double-word sum of exact products along an
                          axis: a correctly-rounded-grade dot product.
  * residual_rows(X, z, y) — hi/lo words of  X @ z.T - y  (each element
                          accumulated in double-f32), the residual
                          kernel the SSN certificate needs.

XLA-safety (the round-3 ADVICE.md finding): under jit the compensation
silently degenerated to plain f32.  Root cause (measured by diffing
optimized HLO at a working vs failing shape — the HLO was IDENTICAL, so
it is a CODEGEN effect, not a simplifier rewrite): XLA duplicates the
rounded sum ``s = a + p`` into several kLoop fusions, and LLVM contracts
``add(a, mul(x, y))`` into an FMA only in the fusions where the mul has
a single use — so the "same" s takes DIFFERENT values in different
fusions and the error words reconstruct garbage.  jax.lax.
optimization_barrier does NOT survive to codegen (the expander removes
it before fusion), so every rounding that the transforms depend on is
instead pinned with ``jax.lax.reduce_precision`` at the input dtype's
own width — an identity op that persists into the fused computation and
blocks both FMA contraction and simplifier cancellation.
tests/test_df32.py locks the jit path to the eager path against a NumPy
f64 oracle.

Input domain: f32 and f64 only (bf16 has no usable double-word regime —
raise early rather than silently lose the certificate), and the Dekker
splitter ``4097*a`` overflows f32 for |a| > ~8.3e34.  Every user in this
repo feeds unit-ball actions and clipped data rows (|a| <= O(1)), far
inside the domain.

Validity note: the certificate only needs a FEASIBLE dual candidate and
an accurate objective value; these transforms make the candidate
near-optimal and the evaluation correctly rounded, so the f32 gap floor
drops from ~1e-2 to ~1e-6 (tested against the f64 oracle in
tests/test_df32.py, eager AND jit).

Reference parity: enables the reference's general-regime exact oracle
(the reference's exact_ftl.py:119-128) to run in f32 with a
rigorous optimality certificate instead of requiring emulated f64.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Dekker splitters: 2^ceil(p/2) + 1 for a p-bit significand.
_SPLITTERS = {
    jnp.dtype(jnp.float32): 4097.0,          # 2^12 + 1 (p = 24)
    jnp.dtype(jnp.float64): 134217729.0,     # 2^27 + 1 (p = 53)
}


def _splitter(dtype):
    dt = jnp.dtype(dtype)
    if dt not in _SPLITTERS:
        raise TypeError(
            f"df32 supports float32/float64 only, got {dt} — bf16 inputs "
            "must be widened to f32 before compensated accumulation")
    return _SPLITTERS[dt]


def _rnd(x):
    """Pin x to ONE correctly-rounded value of its own dtype.

    reduce_precision at the dtype's native (nexp, nmant) is a value
    identity that survives into codegen, so (a) LLVM cannot contract a
    feeding mul+add into an FMA (which would skip the rounding the error
    words reconstruct), and (b) each rounded intermediate is computed
    once, not re-derived differently inside every fusion that uses it.
    """
    fi = jnp.finfo(x.dtype)
    return jax.lax.reduce_precision(x, fi.nexp, fi.nmant)


def two_sum(a, b):
    """Knuth branch-free TwoSum: s = fl(a+b), e exact error."""
    s = _rnd(a + b)
    bb = _rnd(s - a)
    e = _rnd(a - _rnd(s - bb)) + _rnd(b - bb)
    return s, e


def fast_two_sum(a, b):
    """Dekker FastTwoSum, valid when |a| >= |b| (or a == 0)."""
    s = _rnd(a + b)
    e = b - _rnd(s - a)
    return s, e


def _split(a):
    c = _rnd(_splitter(a.dtype) * a)
    t = _rnd(c - a)
    hi = _rnd(c - t)
    return hi, a - hi


def two_prod(a, b):
    """Dekker TwoProduct: p = fl(a*b), e exact error (no FMA needed —
    if codegen contracts a mul-sub inside the error expression into an
    FMA the error term only becomes MORE exact; only ``p`` itself must
    be the plainly rounded product, which _rnd pins)."""
    p = _rnd(a * b)
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def df_add(hi, lo, b_hi, b_lo):
    """Normalized double-word += double-word (Dekker add2)."""
    s, e = two_sum(hi, b_hi)
    e = e + (lo + b_lo)
    return fast_two_sum(s, e)


def df_neg_abs(hi, lo):
    """|hi + lo| as a double word (hi is the rounded value, so its sign
    is the sign of the true value whenever |true| > ulp — exact for the
    certificate's residual magnitudes)."""
    neg = hi < 0
    return jnp.where(neg, -hi, hi), jnp.where(neg, -lo, lo)


def df_sum(hi, lo, axis: int = -1):
    """Pairwise double-word reduction along ``axis``.

    log2(n) vectorized df_add rounds: the result is accurate to
    O(eps^2 * sum|x|) — effectively exact for the certificate sums —
    where a plain f32 reduction carries O(depth * eps * sum|x|).
    Static-shape friendly (pads to a power of two with exact zeros).
    """
    hi = jnp.moveaxis(hi, axis, -1)
    lo = jnp.moveaxis(lo, axis, -1)
    n = hi.shape[-1]
    m = 1
    while m < n:
        m *= 2
    if m != n:
        pad = [(0, 0)] * (hi.ndim - 1) + [(0, m - n)]
        hi = jnp.pad(hi, pad)
        lo = jnp.pad(lo, pad)
    while m > 1:
        m //= 2
        hi, lo = df_add(hi[..., :m], lo[..., :m],
                        hi[..., m:], lo[..., m:])
    return hi[..., 0], lo[..., 0]


def dot_compensated(a, b, axis: int = -1):
    """Double-word dot product along ``axis``: sum_i a_i * b_i with each
    product exact (two_prod) and the reduction pairwise double-word.
    Returns (hi, lo); hi is the correctly-rounded-grade value."""
    p, e = two_prod(a, b)
    return df_sum(p, e, axis=axis)


def residual_rows(X, z, y):
    """Correctly rounded residuals  R[r, t] = <X[r], z[t]> - y[t].

    X (rows, d), z (T, d), y (T,) -> (R_hi, R_lo), each (rows, T), with
    R_hi the correctly rounded value (|R_lo| <= ulp(R_hi)/2).  The d
    products are unrolled (d is a compile-time constant ~5 across the
    framework) and accumulated in double-word arithmetic: the absolute
    error of R_hi is ~ulp(|R_true|) — RELATIVE accuracy — instead of the
    ~eps * max_j |x_j z_tj| ABSOLUTE error of a plain f32 dot, which is
    what the SSN dual candidate cannot tolerate.
    """
    rows, d = X.shape
    _splitter(X.dtype)  # dtype guard up front
    hi = jnp.broadcast_to(-y[None, :], (rows, y.shape[0]))
    lo = jnp.zeros_like(hi)
    for j in range(d):
        p, e = two_prod(X[:, j:j + 1], z[None, :, j])
        hi, lo = df_add(hi, lo, p, e)
    return hi, lo

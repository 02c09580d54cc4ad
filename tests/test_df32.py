"""Error-free transforms (ops/df32.py): eager AND jit against f64 oracles.

The jit coverage is the point (round-3 ADVICE.md): XLA codegen can
FMA-contract a mul feeding an add and silently destroy the compensation
while the eager path stays exact.  Every property here is asserted on
both paths; the jit path must match the f64 oracle, not merely the f32
baseline.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from online_convex_optimization.ops import df32


def _rng(seed=0):
    return np.random.default_rng(seed)


def _pairs(n=4096, seed=0):
    """f32 pairs spanning benign and catastrophic-cancellation regimes."""
    rng = _rng(seed)
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    # heavy cancellation block: b ~ -a + tiny
    k = n // 4
    b[:k] = (-a[:k] + rng.standard_normal(k).astype(np.float32) * 1e-6)
    # scale-mismatch block
    b[k:2 * k] *= 1e6
    return a, b


@pytest.mark.parametrize("use_jit", [False, True], ids=["eager", "jit"])
def test_two_sum_exact(use_jit):
    a, b = _pairs()
    fn = jax.jit(df32.two_sum) if use_jit else df32.two_sum
    s, e = fn(jnp.asarray(a), jnp.asarray(b))
    s = np.asarray(s, np.float64)
    e = np.asarray(e, np.float64)
    # s must be the rounded f32 sum; s + e must be the EXACT real sum
    # (f64 holds f32+f32 exactly).
    np.testing.assert_array_equal(s, (a + b).astype(np.float64))
    np.testing.assert_array_equal(
        s + e, a.astype(np.float64) + b.astype(np.float64))


@pytest.mark.parametrize("use_jit", [False, True], ids=["eager", "jit"])
def test_two_prod_exact(use_jit):
    a, b = _pairs(seed=1)
    fn = jax.jit(df32.two_prod) if use_jit else df32.two_prod
    p, e = fn(jnp.asarray(a), jnp.asarray(b))
    p = np.asarray(p, np.float64)
    e = np.asarray(e, np.float64)
    # f64 holds the product of two f32 exactly (24+24 <= 53 bits).
    exact = a.astype(np.float64) * b.astype(np.float64)
    np.testing.assert_array_equal(p, (a * b).astype(np.float64))
    np.testing.assert_array_equal(p + e, exact)


@pytest.mark.parametrize("use_jit", [False, True], ids=["eager", "jit"])
def test_df_add_normalized(use_jit):
    """df_add keeps |lo| <= ulp(hi)/2-grade normalization and tracks the
    f64 running value through a worst-case alternating accumulation."""
    rng = _rng(2)
    n = 2048
    terms = rng.standard_normal((8, n)).astype(np.float32)
    terms[1::2] *= -1.0001  # alternate signs: heavy cancellation

    def accumulate(t):
        hi = t[0]
        lo = jnp.zeros_like(hi)
        for i in range(1, t.shape[0]):
            p, e = df32.two_prod(t[i], jnp.ones_like(t[i]))
            hi, lo = df32.df_add(hi, lo, p, e)
        return hi, lo

    fn = jax.jit(accumulate) if use_jit else accumulate
    hi, lo = fn(jnp.asarray(terms))
    hi = np.asarray(hi, np.float64)
    lo = np.asarray(lo, np.float64)
    exact = terms.astype(np.float64).sum(axis=0)
    assert np.abs(hi + lo - exact).max() < 1e-12
    # normalization: the lo word never carries hi-scale mass
    ulp = np.spacing(np.abs(hi).astype(np.float32)).astype(np.float64)
    assert (np.abs(lo) <= ulp).all()


@pytest.mark.parametrize("use_jit", [False, True], ids=["eager", "jit"])
def test_df_sum_vs_f64(use_jit):
    """Pairwise double-word reduction tracks the f64 sum where plain f32
    reduction loses ~1e-4 relative on an adversarial cancellation sum."""
    rng = _rng(3)
    rowsT = (16, 3000)  # non-power-of-two: exercises the zero padding
    x = rng.standard_normal(rowsT).astype(np.float32)
    x[:, 1::2] = -x[:, ::2][:, : rowsT[1] // 2]  # telescoping pairs
    x[:, -1] = 1e-3

    def summed(x):
        p, e = df32.two_prod(x, jnp.ones_like(x))
        return df32.df_sum(p, e, axis=-1)

    fn = jax.jit(summed) if use_jit else summed
    hi, lo = fn(jnp.asarray(x))
    exact = x.astype(np.float64).sum(axis=-1)
    err = np.abs(np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
                 - exact)
    assert err.max() < 1e-10
    plain = np.abs(np.asarray(jnp.sum(jnp.asarray(x), axis=-1), np.float64)
                   - exact)
    assert plain.max() > 10 * max(err.max(), 1e-16)  # compensation earns it


@pytest.mark.parametrize("use_jit", [False, True], ids=["eager", "jit"])
def test_dot_compensated_vs_f64(use_jit):
    rng = _rng(4)
    a = rng.standard_normal((32, 1024)).astype(np.float32)
    b = rng.standard_normal((32, 1024)).astype(np.float32)
    fn = jax.jit(df32.dot_compensated) if use_jit else df32.dot_compensated
    hi, lo = fn(jnp.asarray(a), jnp.asarray(b))
    exact = np.einsum("rt,rt->r", a.astype(np.float64), b.astype(np.float64))
    err = np.abs(np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
                 - exact)
    assert (err / np.maximum(np.abs(exact), 1e-30)).max() < 1e-11


@pytest.mark.parametrize("use_jit", [False, True], ids=["eager", "jit"])
def test_residual_rows_vs_f64_oracle(use_jit):
    """The SSN certificate kernel: residuals to near-f64 ABSOLUTE accuracy
    on unit-ball data, where the plain f32 dot sits at ~1e-7."""
    rng = _rng(5)
    rows, T, d = 64, 257, 5
    X = rng.standard_normal((rows, d)).astype(np.float32)
    X /= np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1.0)
    z = rng.standard_normal((T, d)).astype(np.float32)
    z /= np.maximum(np.linalg.norm(z, axis=1, keepdims=True), 1.0)
    y = rng.choice(np.asarray([-1.0, 1.0], np.float32), T)

    fn = jax.jit(df32.residual_rows) if use_jit else df32.residual_rows
    hi, lo = fn(jnp.asarray(X), jnp.asarray(z), jnp.asarray(y))
    ref = X.astype(np.float64) @ z.astype(np.float64).T - y.astype(np.float64)
    err = np.abs(np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
                 - ref).max()
    assert err < 1e-12, f"compensated residual error {err:.3e}"
    plain = np.abs((X @ z.T - y).astype(np.float64) - ref).max()
    assert plain > 1e-8  # the f32 baseline really is ~1e-7-scale
    # hi alone is the correctly rounded value: within one ulp of the truth
    ulp_bound = np.spacing(np.abs(ref).astype(np.float32)).astype(np.float64)
    assert (np.abs(np.asarray(hi, np.float64) - ref) <= ulp_bound).all()


def test_residual_rows_rejects_bf16():
    X = jnp.zeros((4, 5), jnp.bfloat16)
    z = jnp.zeros((8, 5), jnp.bfloat16)
    y = jnp.zeros((8,), jnp.bfloat16)
    with pytest.raises(TypeError, match="float32/float64"):
        df32.residual_rows(X, z, y)


def test_f64_words_supported():
    """f64 inputs use the f64 splitter (double-double regime)."""
    rng = _rng(6)
    a = rng.standard_normal(512)
    b = rng.standard_normal(512)
    p, e = df32.two_prod(jnp.asarray(a), jnp.asarray(b))
    # p + e reconstructs a*b beyond f64: check |e| <= ulp(p)
    assert (np.abs(np.asarray(e)) <=
            np.spacing(np.abs(np.asarray(p)))).all()
    np.testing.assert_array_equal(np.asarray(p), a * b)


@pytest.mark.parametrize("use_jit", [False, True], ids=["eager", "jit"])
def test_objective_sum_gap_floor(use_jit):
    """End-to-end certificate arithmetic: f = 0.5 * sum|<z_i,x> - y_i|
    evaluated in double-f32 matches the f64 oracle to ~1e-10 at T = 4096,
    where the plain f32 evaluation drifts by >1e-5 — the measured source
    of the SSN f32 gap noise floor."""
    rng = _rng(7)
    T, d = 4096, 5
    z = rng.standard_normal((T, d)).astype(np.float32)
    z /= np.maximum(np.linalg.norm(z, axis=1, keepdims=True), 1.0)
    y = rng.choice(np.asarray([-1.0, 1.0], np.float32), T)
    x = rng.standard_normal(d).astype(np.float32)
    x /= max(np.linalg.norm(x), 1.0)

    def f_comp(x, z, y):
        hi, lo = df32.residual_rows(x[None, :], z, y)
        ahi, alo = df32.df_neg_abs(hi, lo)
        shi, slo = df32.df_sum(ahi, alo, axis=-1)
        return 0.5 * shi[0], 0.5 * slo[0]

    fn = jax.jit(f_comp) if use_jit else f_comp
    hi, lo = fn(jnp.asarray(x), jnp.asarray(z), jnp.asarray(y))
    exact = 0.5 * np.abs(
        z.astype(np.float64) @ x.astype(np.float64) - y.astype(np.float64)
    ).sum()
    err = abs(float(np.asarray(hi, np.float64))
              + float(np.asarray(lo, np.float64)) - exact)
    assert err < 1e-9, f"compensated objective error {err:.3e}"
    plain = abs(float(0.5 * np.abs(z @ x - y).sum()) - exact)
    assert err < plain / 100

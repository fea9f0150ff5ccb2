"""Vectorized Bayesian log-marginal-likelihood scores for DMR.

Reference equivalent: ``src/dmr/llr_model.rs:227-330``. The reference
computes, per region, ``llk(control) + llk(exp) - llk(combined)`` where
``llk`` is the log marginal likelihood of the counts under the *posterior*
distribution used as the prior (rv's ``prior.posterior(data).ln_m(data)``):

- 2 categories (one mod code): Beta-Bernoulli with Jeffreys prior
  Beta(1/2, 1/2).  ``beta_llk(k, j) = lnB(1/2 + 2k, 1/2 + 2j) -
  lnB(1/2 + k, 1/2 + j)``.
- >2 categories: Dirichlet-Categorical with Jeffreys prior alpha_i = 1/2,
  category 0 = canonical.

Scores agree with the reference to ~1e-10 relative precision (the reference
uses the Rust `special` crate's ln_gamma; we use lgamma via scipy/libm --
the last couple of float64 digits can differ).

All entry points are numpy-vectorized over regions so scoring N regions or
millions of single sites is a handful of array ops, not a Python loop.
"""

from __future__ import annotations

import numpy as np

try:  # scipy's gammaln is vectorized C (Cephes)
    from scipy.special import gammaln as _lgamma
except ImportError:  # pragma: no cover
    import math

    _lgamma = np.vectorize(math.lgamma, otypes=[np.float64])


def ln_beta(a, b):
    return _lgamma(a) + _lgamma(b) - _lgamma(a + b)


def beta_llk(k, j):
    """Log marginal likelihood of (k successes, j failures) under the
    Jeffreys-Beta posterior-as-prior (llr_model.rs:273-279)."""
    k = np.asarray(k, dtype=np.float64)
    j = np.asarray(j, dtype=np.float64)
    return ln_beta(0.5 + 2.0 * k, 0.5 + 2.0 * j) - ln_beta(0.5 + k, 0.5 + j)


def llk_ratio_beta(k_a, n_a, k_b, n_b):
    """Vectorized 2-category score (llr_model.rs:281-312).

    k_* = modified counts, n_* = total counts per region."""
    k_a = np.asarray(k_a, dtype=np.float64)
    n_a = np.asarray(n_a, dtype=np.float64)
    k_b = np.asarray(k_b, dtype=np.float64)
    n_b = np.asarray(n_b, dtype=np.float64)
    j_a = n_a - k_a
    j_b = n_b - k_b
    return (
        beta_llk(k_a, j_a)
        + beta_llk(k_b, j_b)
        - beta_llk(k_a + k_b, j_a + j_b)
    )


def dirichlet_llk(counts):
    """Log marginal likelihood of categorical counts under the
    Jeffreys-Dirichlet posterior-as-prior (llr_model.rs:227-237).

    counts: [..., K] array; category 0 is canonical."""
    counts = np.asarray(counts, dtype=np.float64)
    alpha = 0.5 + counts  # posterior used as prior
    n = counts.sum(axis=-1)
    a_sum = alpha.sum(axis=-1)
    return (
        _lgamma(a_sum)
        - _lgamma(a_sum + n)
        + (_lgamma(alpha + counts) - _lgamma(alpha)).sum(axis=-1)
    )


def llk_ratio_dirichlet(counts_a, counts_b):
    """Vectorized k-category score (llr_model.rs:239-264).

    counts_*: [..., K] arrays with category 0 = canonical."""
    counts_a = np.asarray(counts_a, dtype=np.float64)
    counts_b = np.asarray(counts_b, dtype=np.float64)
    return (
        dirichlet_llk(counts_a)
        + dirichlet_llk(counts_b)
        - dirichlet_llk(counts_a + counts_b)
    )

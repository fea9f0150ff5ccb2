"""MAP-based p-value via the Beta-difference distribution, vectorized.

Reference equivalent: ``src/dmr/beta_diff.rs``. Per site, the density of
the difference of two Beta posteriors is evaluated at the (adjusted)
empirical effect size and at 0 (Pham-Gia's piecewise closed form built on
the Appell F1 function); the MAP-based p-value is
``exp(ln p(0) - ln p(d))`` clamped to [0, 1].

The Appell F1 integral is evaluated with 16-point Gauss-Legendre
quadrature over [1e-5, 1 - 1e-5] exactly as the reference does
(beta_diff.rs:12-23), and the whole estimator is vectorized over sites:
one call scores an entire batch with numpy array ops.
"""

from __future__ import annotations

import numpy as np

try:
    from scipy.special import betaln as _betaln
except ImportError:  # pragma: no cover
    from .llk import ln_beta as _betaln

_LOWER = 1e-5
_UPPER = 1.0 - _LOWER

# 16-point Gauss-Legendre nodes/weights on [-1, 1]
_GL_T, _GL_W = np.polynomial.legendre.leggauss(16)
# mapped to [LOWER, UPPER]
_GL_U = 0.5 * (_UPPER - _LOWER) * _GL_T + 0.5 * (_UPPER + _LOWER)
_GL_WU = 0.5 * (_UPPER - _LOWER) * _GL_W

MAX_COV_ALLOWED = 300


def appell_f1_stable(x, y, a, b1, b2, c):
    """ln F1(a; b1, b2; c; x, y) * B(a, c-a), vectorized over leading dims
    (beta_diff.rs:12-23). All args broadcastable arrays."""
    x = np.asarray(x, dtype=np.float64)[..., None]
    y = np.asarray(y, dtype=np.float64)[..., None]
    a = np.asarray(a, dtype=np.float64)[..., None]
    b1 = np.asarray(b1, dtype=np.float64)[..., None]
    b2 = np.asarray(b2, dtype=np.float64)[..., None]
    c = np.asarray(c, dtype=np.float64)[..., None]
    u = _GL_U
    numer = (a - 1.0) * np.log(u) + (-a + c - 1.0) * np.log1p(-u)
    denom = b1 * np.log1p(-u * x) + b2 * np.log1p(-y * u)
    vals = np.exp(numer - denom)
    integral = (vals * _GL_WU).sum(axis=-1)
    with np.errstate(divide="ignore"):
        out = np.log(integral) - _betaln(a[..., 0], c[..., 0] - a[..., 0])
    return out


def _ln_beta_diff(d, a1, be1, a2, be2, rope):
    """ln p(D = d) where D = X1 - X2, X_i ~ Beta(a_i, be_i), vectorized
    (beta_diff.rs:168-224 calc_beta_diff). d, a1, be1, a2, be2 arrays."""
    d = np.asarray(d, dtype=np.float64)
    a1 = np.asarray(a1, dtype=np.float64)
    be1 = np.asarray(be1, dtype=np.float64)
    a2 = np.asarray(a2, dtype=np.float64)
    be2 = np.asarray(be2, dtype=np.float64)
    ln_A = _betaln(a1, be1) + _betaln(a2, be2)
    out = np.full(np.broadcast(d, a1).shape, np.nan)

    central = np.abs(d) < rope
    if central.any():
        # requires a1+a2 > 1 and be1+be2 > 1 (beta_diff.rs:177-189)
        valid = (a1 + a2 >= 1.0) & (be1 + be2 >= 1.0)
        with np.errstate(invalid="ignore"):
            ln_p = _betaln(a1 + a2 - 1.0, be1 + be2 - 1.0) - ln_A
        out = np.where(central & valid, ln_p, out)

    pos = (~central) & (d > 0)
    if pos.any():
        f1 = appell_f1_stable(
            1.0 - d,
            1.0 - d**2,
            be1,
            a1 + be1 + a2 + be2 - 2.0,
            1.0 - a1,
            a2 + be1,
        )
        with np.errstate(divide="ignore", invalid="ignore"):
            ln_p = (
                _betaln(a2, be1)
                + np.log(d) * (be1 + be2 - 1.0)
                + np.log1p(-d) * (a2 + be1 - 1.0)
                + f1
                - ln_A
            )
        out = np.where(pos, ln_p, out)

    neg = (~central) & (d < 0)
    if neg.any():
        f1 = appell_f1_stable(
            1.0 - d**2,
            1.0 + d,
            be2,
            1.0 - a2,
            a1 + be1 + a2 + be2 - 2.0,
            a1 + be2,
        )
        with np.errstate(divide="ignore", invalid="ignore"):
            ln_p = (
                _betaln(a1, be2)
                + np.log(-d) * (be1 + be2 - 1.0)
                + np.log1p(d) * (a1 + be2 - 1.0)
                + f1
                - ln_A
            )
        out = np.where(neg, ln_p, out)
    return out


class PMapEstimator:
    """beta_diff.rs:127-279 PMapEstimator, vectorized over sites."""

    def __init__(
        self,
        max_coverages: tuple[int, int],
        num_a: int,
        num_b: int,
        prior: tuple[float, float] = (0.55, 0.55),
        rope: float = 0.05,
        cap_coverages: bool = False,
    ):
        if not cap_coverages:
            max_coverages = (
                max_coverages[0] * num_a,
                max_coverages[1] * num_b,
            )
        self.max_coverages = tuple(
            min(x, MAX_COV_ALLOWED) for x in max_coverages
        )
        self.prior = prior
        self.rope = rope

    def predict_batch(self, n_mod_a, cov_a, n_mod_b, cov_b):
        """(e_pmap, effect_size) arrays for per-site modified/total counts.

        Follows beta_diff.rs:226-268 run(): resize to max coverage, ROPE
        short-circuit, +-0.005 adjustment, posterior Beta params, density
        ratio at 0 vs the adjusted effect size."""
        n_mod_a = np.asarray(n_mod_a, dtype=np.float64)
        cov_a = np.asarray(cov_a, dtype=np.float64)
        n_mod_b = np.asarray(n_mod_b, dtype=np.float64)
        cov_b = np.asarray(cov_b, dtype=np.float64)

        def resize(n_mod, cov, max_cov):
            frac = n_mod / cov
            over = cov > max_cov
            n_mod2 = np.where(over, np.round(frac * max_cov), n_mod)
            cov2 = np.where(over, float(max_cov), cov)
            return n_mod2, cov2, n_mod2 / cov2

        n_mod_a, cov_a, frac_a = resize(n_mod_a, cov_a, self.max_coverages[0])
        n_mod_b, cov_b, frac_b = resize(n_mod_b, cov_b, self.max_coverages[1])
        effect = frac_a - frac_b
        in_rope = np.abs(effect) <= self.rope
        adj = np.where(effect > 0, effect - 0.005, effect + 0.005)

        a1 = self.prior[0] + n_mod_a
        be1 = self.prior[1] + (cov_a - n_mod_a)
        a2 = self.prior[0] + n_mod_b
        be2 = self.prior[1] + (cov_b - n_mod_b)

        with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
            effect_prob = _ln_beta_diff(adj, a1, be1, a2, be2, self.rope)
            null_prob = _ln_beta_diff(
                np.zeros_like(adj), a1, be1, a2, be2, self.rope
            )
            e_pmap = np.exp(null_prob - effect_prob)
        # effect_prob underflow -> pmap 1 (beta_diff.rs:257-258)
        e_pmap = np.where(np.exp(effect_prob) == 0.0, 1.0, e_pmap)
        e_pmap = np.where(in_rope, 1.0, np.minimum(e_pmap, 1.0))
        # nan (invalid central-branch params) propagates as error marker
        return e_pmap, effect

    def predict_counts(self, counts_a, counts_b):
        """Scalar convenience over AggregatedCounts (beta_diff.rs:271-279)."""
        e_pmap, effect = self.predict_batch(
            np.array([counts_a.modified_counts()]),
            np.array([counts_a.total]),
            np.array([counts_b.modified_counts()]),
            np.array([counts_b.total]),
        )
        return float(e_pmap[0]), float(effect[0])

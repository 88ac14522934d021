"""Tests for the batched Newton solvers replacing NLopt LD_MMA.

Objective/gradient values are checked against independently re-derived
formulas, porting the reference's hand-expanded fixtures
(test/common.jl:35-97 for λ; test/mmctm.jl ν/α fixtures), and the
maximizers are checked to (a) ascend, (b) zero the gradient, (c) agree
with scipy reference optimizers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize
from scipy.special import digamma as sp_digamma, gammaln as sp_gammaln

from multimodalmusig_tpu.ops import solvers

jax.config.update("jax_enable_x64", True)


# --- fixture from test/common.jl:35-66: K=[2,3], doc 1 of the tiny corpus ---
MU = np.array([1.0, 1.0, 2.0, 2.0, 1.0])
INV_SIGMA = np.eye(5)
LAM = np.array([1.0, 2.0, 3.0, 4.0, 1.0])
NU = np.array([1.0, 1.0, 1.0, 2.0, 1.0])
ZETA = np.array([2.0, 1.0])
THETA = [np.array([[0.4, 0.1], [0.6, 0.9]]), np.array([[0.3, 0.4], [0.3, 0.5], [0.4, 0.1]])]
COUNTS = [np.array([5.0, 8.0]), np.array([2.0, 5.0])]  # X[1][m][:, 2]
N = np.array([13.0, 7.0])


def _fixture_sumtheta():
    return np.concatenate([(THETA[m] * COUNTS[m][None, :]).sum(axis=1) for m in range(2)])


def _fixture_Ndivzeta():
    return np.concatenate([np.full(k, N[m] / ZETA[m]) for m, k in enumerate([2, 3])])


def _expected_lambda_obj(lam):
    diff = lam - MU
    Eeta = np.exp(lam + 0.5 * NU)
    return (
        -0.5 * diff @ INV_SIGMA @ diff
        + np.sum(lam * _fixture_sumtheta())
        - np.sum(_fixture_Ndivzeta() * Eeta)
    )


def _expected_lambda_grad(lam):
    Eeta = np.exp(lam + 0.5 * NU)
    return -INV_SIGMA @ (lam - MU) + _fixture_sumtheta() - _fixture_Ndivzeta() * Eeta


class TestLambdaObjective:
    def test_value(self):
        got = float(
            solvers.lambda_objective(
                jnp.asarray(LAM), jnp.asarray(NU), jnp.asarray(_fixture_Ndivzeta()),
                jnp.asarray(_fixture_sumtheta()), jnp.asarray(MU), jnp.asarray(INV_SIGMA),
            )
        )
        np.testing.assert_allclose(got, _expected_lambda_obj(LAM), rtol=1e-12)

    def test_grad(self):
        got = np.asarray(
            solvers.lambda_grad(
                jnp.asarray(LAM), jnp.asarray(NU), jnp.asarray(_fixture_Ndivzeta()),
                jnp.asarray(_fixture_sumtheta()), jnp.asarray(MU), jnp.asarray(INV_SIGMA),
            )
        )
        np.testing.assert_allclose(got, _expected_lambda_grad(LAM), rtol=1e-12)

    def test_grad_matches_autodiff(self):
        auto = jax.grad(solvers.lambda_objective)(
            jnp.asarray(LAM), jnp.asarray(NU), jnp.asarray(_fixture_Ndivzeta()),
            jnp.asarray(_fixture_sumtheta()), jnp.asarray(MU), jnp.asarray(INV_SIGMA),
        )
        np.testing.assert_allclose(np.asarray(auto), _expected_lambda_grad(LAM), rtol=1e-10)


class TestMaximizeLambda:
    def _solve(self, lam0):
        return solvers.maximize_lambda(
            jnp.asarray(lam0)[None], jnp.asarray(NU)[None],
            jnp.asarray(_fixture_Ndivzeta())[None], jnp.asarray(_fixture_sumtheta())[None],
            jnp.asarray(MU), jnp.asarray(INV_SIGMA),
        )[0]

    def test_ascends_and_stationary(self):
        lam0 = np.zeros(5)
        opt = np.asarray(self._solve(lam0))
        assert _expected_lambda_obj(opt) > _expected_lambda_obj(lam0)
        np.testing.assert_allclose(_expected_lambda_grad(opt), 0.0, atol=1e-8)

    def test_matches_scipy(self):
        res = scipy.optimize.minimize(
            lambda x: -_expected_lambda_obj(x),
            np.zeros(5),
            jac=lambda x: -_expected_lambda_grad(x),
            method="BFGS",
            options={"gtol": 1e-12},
        )
        opt = np.asarray(self._solve(np.zeros(5)))
        np.testing.assert_allclose(opt, res.x, atol=1e-6)

    def test_warm_start_idempotent(self):
        opt = np.asarray(self._solve(np.zeros(5)))
        again = np.asarray(self._solve(opt))
        np.testing.assert_allclose(again, opt, atol=1e-10)

    def test_no_nans_from_extreme_start(self):
        opt = np.asarray(self._solve(np.full(5, 30.0)))
        assert np.all(np.isfinite(opt))
        np.testing.assert_allclose(_expected_lambda_grad(opt), 0.0, atol=1e-6)


def _expected_nu_obj(nu):
    Eeta = np.exp(LAM + 0.5 * nu)
    return (
        -0.5 * np.sum(nu * np.diag(INV_SIGMA))
        - np.sum(_fixture_Ndivzeta() * Eeta)
        + 0.5 * np.sum(np.log(nu))
    )


def _expected_nu_grad(nu):
    Eeta = np.exp(LAM + 0.5 * nu)
    return -0.5 * np.diag(INV_SIGMA) - 0.5 * _fixture_Ndivzeta() * Eeta + 0.5 / nu


class TestNuObjective:
    def test_value_and_grad(self):
        nu = NU
        got = float(
            solvers.nu_objective(
                jnp.asarray(nu), jnp.asarray(LAM), jnp.asarray(_fixture_Ndivzeta()),
                jnp.asarray(np.diag(INV_SIGMA)),
            )
        )
        np.testing.assert_allclose(got, _expected_nu_obj(nu), rtol=1e-12)
        g = np.asarray(
            solvers.nu_grad(
                jnp.asarray(nu), jnp.asarray(LAM), jnp.asarray(_fixture_Ndivzeta()),
                jnp.asarray(np.diag(INV_SIGMA)),
            )
        )
        np.testing.assert_allclose(g, _expected_nu_grad(nu), rtol=1e-12)


class TestMaximizeNu:
    def test_stationary_positive(self):
        nu0 = jnp.ones(5)
        opt = np.asarray(
            solvers.maximize_nu(
                nu0, jnp.asarray(LAM), jnp.asarray(_fixture_Ndivzeta()),
                jnp.asarray(np.diag(INV_SIGMA)),
            )
        )
        assert np.all(opt >= solvers.NU_LOWER_BOUND)
        np.testing.assert_allclose(_expected_nu_grad(opt), 0.0, atol=1e-8)
        assert _expected_nu_obj(opt) >= _expected_nu_obj(np.ones(5))

    def test_batched_matches_loop(self):
        rng = np.random.default_rng(0)
        lam = rng.normal(size=(4, 5))
        ndz = rng.uniform(1, 10, size=(4, 5))
        nu0 = np.ones((4, 5))
        batched = np.asarray(
            solvers.maximize_nu(
                jnp.asarray(nu0), jnp.asarray(lam), jnp.asarray(ndz),
                jnp.asarray(np.diag(INV_SIGMA))[None].repeat(4, 0),
            )
        )
        for d in range(4):
            single = np.asarray(
                solvers.maximize_nu(
                    jnp.asarray(nu0[d]), jnp.asarray(lam[d]), jnp.asarray(ndz[d]),
                    jnp.asarray(np.diag(INV_SIGMA)),
                )
            )
            np.testing.assert_allclose(batched[d], single, atol=1e-12)


def _expected_alpha_obj(a, S, K, V):
    return K * (sp_gammaln(V * a) - V * sp_gammaln(a)) + a * S


class TestAlpha:
    # values echo the reference's α-objective tests (test/mmctm.jl:268-293)
    S, K, V = -40.0, 2, 4

    def test_value_and_grad(self):
        a = 0.5
        got = float(solvers.alpha_objective(jnp.float64(a), self.S, self.K, self.V))
        # rtol bounded by jax-vs-scipy gammaln/digamma implementation precision
        np.testing.assert_allclose(got, _expected_alpha_obj(a, self.S, self.K, self.V), rtol=1e-8)
        g = float(solvers.alpha_grad(jnp.float64(a), self.S, self.K, self.V))
        expected_g = self.K * self.V * (sp_digamma(self.V * a) - sp_digamma(a)) + self.S
        np.testing.assert_allclose(g, expected_g, rtol=1e-8)

    def test_maximize_improves_and_matches_scalar_opt(self):
        a0 = 0.1
        opt = float(solvers.maximize_alpha(jnp.float64(a0), self.S, self.K, self.V))
        assert _expected_alpha_obj(opt, self.S, self.K, self.V) >= _expected_alpha_obj(
            a0, self.S, self.K, self.V
        )
        res = scipy.optimize.minimize_scalar(
            lambda a: -_expected_alpha_obj(a, self.S, self.K, self.V),
            bounds=(1e-7, 100.0),
            method="bounded",
            options={"xatol": 1e-12},
        )
        np.testing.assert_allclose(opt, res.x, rtol=1e-5)


class TestIllConditionedRobustness:
    """The failure class behind the round-2 NaN lane: ill-conditioned Σ⁻¹ in
    float32. PCG + the polish trust region must keep every solve finite and
    stationary across condition numbers up to ~1e6."""

    def _random_spd(self, rng, mk, cond):
        q, _ = np.linalg.qr(rng.standard_normal((mk, mk)))
        eigs = np.logspace(0.0, np.log10(cond), mk)
        return (q * eigs) @ q.T

    @pytest.mark.parametrize("cond", [1e2, 1e4, 1e6])
    def test_lambda_finite_and_stationary_f32(self, cond):
        rng = np.random.default_rng(int(cond))
        B, MK = 257, 14
        invS = jnp.asarray(self._random_spd(rng, MK, cond), jnp.float32)
        lam0 = jnp.asarray(rng.standard_normal((B, MK)) * 3.0, jnp.float32)
        nu = jnp.asarray(rng.uniform(1e-5, 2.0, (B, MK)), jnp.float32)
        ndz = jnp.asarray(
            rng.uniform(0.0, 10.0, (B, MK)) * rng.integers(0, 2, (B, MK)),
            jnp.float32,
        )
        st = jnp.asarray(rng.uniform(0.0, 50.0, (B, MK)), jnp.float32)
        mu = jnp.asarray(rng.standard_normal(MK), jnp.float32)

        lam = solvers.maximize_lambda(lam0, nu, ndz, st, mu, invS)
        lam = np.asarray(lam)
        assert np.isfinite(lam).all()
        # stationarity at f32-appropriate scale: gradient components are
        # O(cond)-scaled, so normalize by the gradient at the start
        g_end = np.asarray(
            jax.vmap(lambda l, n, z, s: solvers.lambda_grad(l, n, z, s, mu, invS))(
                jnp.asarray(lam), nu, ndz, st
            )
        )
        g_start = np.asarray(
            jax.vmap(lambda l, n, z, s: solvers.lambda_grad(l, n, z, s, mu, invS))(
                lam0, nu, ndz, st
            )
        )
        assert np.abs(g_end).max() < 1e-2 * max(np.abs(g_start).max(), 1.0)

    def test_nu_finite_under_extreme_inputs(self):
        rng = np.random.default_rng(0)
        B, MK = 127, 14
        nu0 = jnp.asarray(rng.uniform(1e-7, 5.0, (B, MK)), jnp.float32)
        lam = jnp.asarray(rng.uniform(-40.0, 40.0, (B, MK)), jnp.float32)
        ndz = jnp.asarray(
            rng.uniform(0.0, 1e4, (B, MK)) * rng.integers(0, 2, (B, MK)),
            jnp.float32,
        )
        diag = jnp.asarray(rng.uniform(1e-3, 1e3, (MK,)), jnp.float32)
        nu = np.asarray(solvers.maximize_nu(nu0, lam, ndz, diag[None, :]))
        assert np.isfinite(nu).all()
        assert (nu >= solvers.NU_LOWER_BOUND).all()


class TestBudgetPlumbing:
    """The λ Newton/CG budgets must be raisable by callers —
    solve_lambda/solve_eta accept overrides and CTMBaseConfig threads them
    into the fit step, so harsher-geometry datasets aren't silently stuck
    with the BRCA-tuned defaults."""

    def _problem(self):
        rng = np.random.default_rng(3)
        B, MK = 16, 5
        A = rng.normal(size=(MK, MK))
        invS = jnp.asarray(np.eye(MK) + 0.1 * A @ A.T, jnp.float32)
        return (
            jnp.zeros((B, MK), jnp.float32),
            jnp.asarray(rng.uniform(0.5, 1.5, (B, MK)), jnp.float32),
            jnp.asarray(rng.uniform(1, 10, (B, MK)), jnp.float32),
            jnp.asarray(rng.uniform(0, 5, (B, MK)), jnp.float32),
            jnp.asarray(rng.normal(size=MK), jnp.float32),
            invS,
        )

    def test_solve_lambda_accepts_budget_overrides(self):
        from multimodalmusig_tpu.models.ctm_base import solve_lambda

        lam0, nu, ndz, st, mu, invS = self._problem()
        dflt = np.asarray(solve_lambda(lam0, nu, ndz, st, mu, invS))
        big = np.asarray(
            solve_lambda(lam0, nu, ndz, st, mu, invS, n_iter=20, cg_iter=10)
        )
        # both budgets solve this easy problem; the override path must run
        # and land on the same optimum
        np.testing.assert_allclose(big, dflt, rtol=1e-4, atol=1e-5)

    def test_config_threads_budgets_through_fit(self, rng):
        from multimodalmusig_tpu.models.mmctm import MMCTM

        X = [
            [np.array([[1, 4], [2, 2]]), np.array([[1, 3], [3, 2]])],
            [np.array([[2, 2], [1, 5]]), np.array([[1, 2], [2, 1]])],
        ]
        m_default = MMCTM([2, 2], [0.1, 0.1], X)
        assert m_default.config.lambda_n_iter is None
        m_big = MMCTM([2, 2], [0.1, 0.1], X)
        m_big.config = m_big.config.__class__(
            **{
                **{f.name: getattr(m_big.config, f.name)
                   for f in __import__("dataclasses").fields(m_big.config)},
                "lambda_n_iter": 12,
                "lambda_cg_iter": 6,
            }
        )
        m_default.fit(maxiter=3)
        m_big.fit(maxiter=3)
        np.testing.assert_allclose(
            np.asarray(m_big.ll), np.asarray(m_default.ll), rtol=1e-3
        )


class TestF32CGCapDefault:
    """Pins the dtype-dependent cg_iter default: float32 caps at
    CG_ITER_F32_CAP (the f32 PCG residual floors there — measured 18-30%
    fit speedups, see maximize_lambda docstring), float64 keeps the exact
    cg_iter = MK Krylov termination that the machine-precision oracle
    parity tests rely on."""

    def _problem(self, dtype):
        rng = np.random.default_rng(5)
        B, MK = 32, 14  # MK above the cap
        A = rng.normal(size=(MK, MK))
        invS = jnp.asarray(np.eye(MK) + 0.1 * A @ A.T, dtype)
        return (
            jnp.zeros((B, MK), dtype),
            jnp.asarray(rng.uniform(0.5, 1.5, (B, MK)), dtype),
            jnp.asarray(rng.uniform(1, 10, (B, MK)), dtype),
            jnp.asarray(rng.uniform(0, 5, (B, MK)), dtype),
            jnp.asarray(rng.normal(size=MK), dtype),
            invS,
        )

    def test_f32_default_equals_capped_budget(self):
        args = self._problem(jnp.float32)
        dflt = np.asarray(solvers.maximize_lambda(*args))
        capped = np.asarray(
            solvers.maximize_lambda(*args, cg_iter=solvers.CG_ITER_F32_CAP)
        )
        full = np.asarray(solvers.maximize_lambda(*args, cg_iter=14))
        np.testing.assert_array_equal(dflt, capped)
        assert not np.array_equal(dflt, full)  # the cap genuinely engages

    def test_f64_default_equals_full_budget(self):
        args = self._problem(jnp.float64)
        dflt = np.asarray(solvers.maximize_lambda(*args))
        full = np.asarray(solvers.maximize_lambda(*args, cg_iter=14))
        np.testing.assert_array_equal(dflt, full)


class TestF32CaviNewtonBudget:
    """Pins the dtype-dependent Newton budget inside the FIT loops: an f32
    fit's warm-started λ solves default to LAMBDA_NITER_F32_CAVI (measured:
    holds iteration counts and best-ll to the 6th decimal on BRCA and
    PCAWG while cutting the R=1000 benchmark 5.13 → 3.60 s — see
    ops/solvers.py), while f64 fits keep the solver's cold-start n_iter=7
    (the machine-precision trajectory-parity suite depends on it), and
    lambda_n_iter still overrides both."""

    X = [
        [np.array([[1, 4], [2, 2]]), np.array([[1, 3], [3, 2]])],
        [np.array([[2, 2], [1, 5]]), np.array([[1, 2], [2, 1]])],
    ]

    def _fit(self, dtype, lambda_n_iter=None, maxiter=6):
        from multimodalmusig_tpu.models.mmctm import MMCTM
        import dataclasses

        m = MMCTM([2, 2], [0.1, 0.1], self.X, dtype=dtype)
        if lambda_n_iter is not None:
            m.config = dataclasses.replace(m.config, lambda_n_iter=lambda_n_iter)
        m.fit(maxiter=maxiter)
        return np.asarray(m.ll)

    def _spy_budgets(self, monkeypatch):
        """Record the (n_iter, polish_iter) every fit-loop λ solve receives
        and the n_iter every ν solve receives. The tiny fixture's solves
        converge identically under any budget, so the resolution contract
        is asserted structurally (what solve_eta passes), not numerically."""
        from multimodalmusig_tpu.models import ctm_base
        from multimodalmusig_tpu.ops import solvers as sv

        seen = {"lambda": set(), "nu": set()}
        orig_l, orig_n = ctm_base.solve_lambda, sv.maximize_nu

        def spy_lambda(*a, **kw):
            seen["lambda"].add(
                (kw.get("n_iter"), kw.get("polish_iter"), kw.get("cg_iter"))
            )
            return orig_l(*a, **kw)

        def spy_nu(*a, **kw):
            seen["nu"].add(kw.get("n_iter"))
            return orig_n(*a, **kw)

        # patch the names ctm_base actually calls through (its module
        # globals — solve_eta's call sites resolve there, not in ops.solvers)
        monkeypatch.setattr(ctm_base, "solve_lambda", spy_lambda)
        monkeypatch.setattr(ctm_base, "maximize_nu", spy_nu)
        jax.clear_caches()  # budgets resolve at trace time
        return seen

    def test_f32_default_resolves_to_cavi_budgets(self, monkeypatch):
        from multimodalmusig_tpu.ops.solvers import (
            CG_F32_CAVI,
            LAMBDA_NITER_F32_CAVI,
            LAMBDA_POLISH_F32_CAVI,
            NU_FP_F32_CAVI,
        )

        seen = self._spy_budgets(monkeypatch)
        dflt = self._fit(jnp.float32)
        assert seen["lambda"] == {
            (LAMBDA_NITER_F32_CAVI, LAMBDA_POLISH_F32_CAVI, CG_F32_CAVI)
        }
        assert seen["nu"] == {NU_FP_F32_CAVI}
        jax.clear_caches()
        # quality pin: the warm-start budgets land on the same optimum as
        # the full cold-start budgets
        full = self._fit(jnp.float32, lambda_n_iter=7)
        np.testing.assert_allclose(dflt, full, rtol=1e-4)
        jax.clear_caches()

    def test_f32_overrides_beat_the_caps(self, monkeypatch):
        import dataclasses
        from multimodalmusig_tpu.models.mmctm import MMCTM

        seen = self._spy_budgets(monkeypatch)
        m = MMCTM([2, 2], [0.1, 0.1], self.X, dtype=jnp.float32)
        m.config = dataclasses.replace(
            m.config, lambda_n_iter=9, lambda_polish_iter=2, nu_n_iter=8
        )
        m.fit(maxiter=3)
        assert seen["lambda"] == {(9, 2, solvers.CG_F32_CAVI)}
        assert seen["nu"] == {8}
        jax.clear_caches()

    def test_f64_default_keeps_full_budgets(self, monkeypatch):
        seen = self._spy_budgets(monkeypatch)
        self._fit(jnp.float64, maxiter=3)
        # None = the solvers' cold-start defaults (7 Newton, 2 polish, 8 ν
        # sweeps, exact cg = MK) — the machine-precision parity suite
        # depends on them
        assert seen["lambda"] == {(None, None, None)}
        assert seen["nu"] == {None}
        jax.clear_caches()

    def test_f64_default_equals_full_budget(self):
        dflt = self._fit(jnp.float64)
        full = self._fit(jnp.float64, lambda_n_iter=7)
        np.testing.assert_array_equal(dflt, full)

    def test_f32_transform_quality_holds_at_cavi_budget(self):
        """The inference paths (transform/fit_heldout/predict) share
        solve_eta's budget resolution; their warm-started solves must land
        on the same fold-in posteriors as the full budget."""
        from multimodalmusig_tpu.models.mmctm import MMCTM, transform
        import dataclasses

        def run(lambda_n_iter):
            m = MMCTM([2, 2], [0.1, 0.1], self.X, dtype=jnp.float32)
            if lambda_n_iter is not None:
                m.config = dataclasses.replace(
                    m.config, lambda_n_iter=lambda_n_iter
                )
            m.fit(maxiter=6)
            t = transform(m, self.X, maxiter=6)
            return np.concatenate([np.asarray(p) for p in t.props], axis=1)

        np.testing.assert_allclose(run(None), run(7), rtol=1e-3, atol=1e-5)


class TestLambdaExtrapWarmStart:
    """Pins the secant-extrapolated λ warm start (CTMBaseConfig.lambda_extrap):
    the fit loops may hand the λ maximizer the predictor
    λ_t + clip(c·(λ_t − λ_{t-1}), ±4) instead of λ_t. Only the solve's
    *initial point* changes — the maximizer is monotone from any start —
    so the fit must land on the same optimum, and with lambda_extrap unset
    (the default) the initial point must be exactly λ_t."""

    X = [
        [np.array([[1, 4], [2, 2]]), np.array([[1, 3], [3, 2]])],
        [np.array([[2, 2], [1, 5]]), np.array([[1, 2], [2, 1]])],
    ]

    def _spy_lam0(self, monkeypatch):
        """Record every initial point handed to solve_lambda alongside the
        λ solve_eta was called with, so the start-point contract can be
        asserted structurally (the tiny fixture converges identically from
        either start)."""
        from multimodalmusig_tpu.models import ctm_base

        calls = []
        orig_solve_eta = ctm_base.solve_eta
        orig_solve_lambda = ctm_base.solve_lambda
        current = {}

        def spy_eta(lam, *a, **kw):
            current["lam"] = lam
            current["lam_prev"] = kw.get("lam_prev")
            return orig_solve_eta(lam, *a, **kw)

        def spy_lambda(lam0, *a, **kw):
            calls.append((current.get("lam"), current.get("lam_prev"), lam0))
            return orig_solve_lambda(lam0, *a, **kw)

        # ctm_base.solve_eta resolves solve_lambda through its module
        # globals; the models resolve solve_eta the same way, so patch both
        # in ctm_base AND in the model modules that imported the name
        from multimodalmusig_tpu.models import immctm, mmctm

        monkeypatch.setattr(ctm_base, "solve_lambda", spy_lambda)
        monkeypatch.setattr(ctm_base, "solve_eta", spy_eta)
        monkeypatch.setattr(mmctm, "solve_eta", spy_eta)
        monkeypatch.setattr(immctm, "solve_eta", spy_eta)
        jax.clear_caches()  # the extrap coefficient resolves at trace time
        return calls

    def _fit(self, dtype, lambda_extrap=None, maxiter=6):
        import dataclasses

        from multimodalmusig_tpu.models.mmctm import MMCTM

        m = MMCTM([2, 2], [0.1, 0.1], self.X, dtype=dtype)
        if lambda_extrap is not None:
            m.config = dataclasses.replace(m.config, lambda_extrap=lambda_extrap)
        m.fit(maxiter=maxiter)
        return np.asarray(m.ll)

    def test_default_start_is_identity(self, monkeypatch):
        calls = self._spy_lam0(monkeypatch)
        self._fit(jnp.float32, maxiter=3)
        assert calls
        for lam, _, lam0 in calls:
            assert lam0 is lam  # unset extrap must not touch the start point
        jax.clear_caches()

    def test_extrap_start_matches_clipped_secant(self, monkeypatch):
        calls = self._spy_lam0(monkeypatch)
        self._fit(jnp.float32, lambda_extrap=1.0, maxiter=4)
        assert calls
        # The spy captured tracers, so the secant arithmetic can't be
        # re-evaluated here; assert the structural contract instead: with
        # extrap set and lam_prev supplied, the start point is a derived
        # value, not the incoming λ.
        saw_extrap = False
        for lam, lam_prev, lam0 in calls:
            if lam_prev is not None:
                assert lam0 is not lam
                saw_extrap = True
        assert saw_extrap
        jax.clear_caches()

    def test_extrap_reaches_the_same_optimum(self):
        base = self._fit(jnp.float64, maxiter=12)
        ext = self._fit(jnp.float64, lambda_extrap=1.0, maxiter=12)
        np.testing.assert_allclose(base, ext, rtol=1e-6)

    def test_extrap_clip_bounds_the_step(self):
        """The per-coordinate clip: a huge previous-iterate swing cannot
        move the start more than ±4 in any coordinate (which would overflow
        exp(λ) in f32 in the solver's first gradient)."""
        import dataclasses

        from multimodalmusig_tpu.models import ctm_base
        from multimodalmusig_tpu.models.mmctm import MMCTM

        m = MMCTM([2, 2], [0.1, 0.1], self.X, dtype=jnp.float64)
        cfg = dataclasses.replace(m.config, lambda_extrap=1.0)
        captured = {}
        orig = ctm_base.solve_lambda

        def spy(lam0, *a, **kw):
            captured["lam0"] = lam0
            return orig(lam0, *a, **kw)

        lam = jnp.zeros((4, 4), jnp.float64)
        lam_prev = jnp.full((4, 4), -100.0, jnp.float64)  # swing of +100
        nu = jnp.ones_like(lam)
        N = jnp.full((4, 2), 10.0, jnp.float64)  # (D, M) per-modality counts
        sumtheta = jnp.ones_like(lam)
        mu = jnp.zeros((4,), jnp.float64)
        invSigma = jnp.eye(4, dtype=jnp.float64)
        try:
            ctm_base.solve_lambda = spy
            with jax.disable_jit():
                ctm_base.solve_eta(
                    lam, nu, N, sumtheta, mu, invSigma, cfg, lam_prev=lam_prev
                )
        finally:
            ctm_base.solve_lambda = orig
        np.testing.assert_array_equal(np.asarray(captured["lam0"]), 4.0)


class TestCholDirectSolver:
    """The direct unrolled-Cholesky Newton direction (ops/solvers.py
    _chol_solve, maximize_lambda solver="chol") — the structural alternative
    to the PCG chain. Both solvers are machine-exact in f64, so they must
    agree at the optimum, and the direct solve must match a dense numpy
    solve of (Σ⁻¹ + diag(w))δ = g entry for entry."""

    def _random_spd(self, rng, mk, cond):
        q, _ = np.linalg.qr(rng.standard_normal((mk, mk)))
        eigs = np.logspace(0.0, np.log10(cond), mk)
        return (q * eigs) @ q.T

    def test_chol_solve_matches_dense_solve(self):
        rng = np.random.default_rng(7)
        B, MK = 31, 14
        invS = self._random_spd(rng, MK, 1e4)
        w = rng.gamma(1.0, 2.0, (B, MK))
        g = rng.standard_normal((B, MK))
        x = np.asarray(
            solvers._chol_solve(jnp.asarray(w), jnp.asarray(g), jnp.asarray(invS))
        )
        xref = np.stack(
            [np.linalg.solve(invS + np.diag(w[b]), g[b]) for b in range(B)]
        )
        np.testing.assert_allclose(x, xref, rtol=1e-9, atol=1e-11)

    def test_chol_solve_batched_invsigma(self):
        # a leading batch dim on Σ⁻¹ (the vmapped-restart materialized shape)
        rng = np.random.default_rng(8)
        B, MK = 5, 6
        invS = np.stack([self._random_spd(rng, MK, 1e2) for _ in range(B)])
        w = rng.gamma(1.0, 2.0, (B, MK))
        g = rng.standard_normal((B, MK))
        x = np.asarray(
            solvers._chol_solve(jnp.asarray(w), jnp.asarray(g), jnp.asarray(invS))
        )
        xref = np.stack(
            [np.linalg.solve(invS[b] + np.diag(w[b]), g[b]) for b in range(B)]
        )
        np.testing.assert_allclose(x, xref, rtol=1e-9, atol=1e-11)

    def test_same_optimum_as_pcg(self):
        rng = np.random.default_rng(9)
        B, MK = 64, 14
        invS = jnp.asarray(self._random_spd(rng, MK, 1e3))
        lam0 = jnp.asarray(rng.standard_normal((B, MK)))
        nu = jnp.asarray(rng.uniform(1e-5, 2.0, (B, MK)))
        ndz = jnp.asarray(rng.uniform(0.0, 10.0, (B, MK)))
        st = jnp.asarray(rng.uniform(0.0, 50.0, (B, MK)))
        mu = jnp.asarray(rng.standard_normal(MK))
        a = solvers.maximize_lambda(lam0, nu, ndz, st, mu, invS)
        b = solvers.maximize_lambda(lam0, nu, ndz, st, mu, invS, solver="chol")
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-9)

    def test_f32_ill_conditioned_finite_and_stationary(self):
        # the round-2 NaN-lane failure class must hold for the direct solve too
        rng = np.random.default_rng(1_000_000)
        B, MK = 257, 14
        invS = jnp.asarray(self._random_spd(rng, MK, 1e6), jnp.float32)
        lam0 = jnp.asarray(rng.standard_normal((B, MK)) * 3.0, jnp.float32)
        nu = jnp.asarray(rng.uniform(1e-5, 2.0, (B, MK)), jnp.float32)
        ndz = jnp.asarray(
            rng.uniform(0.0, 10.0, (B, MK)) * rng.integers(0, 2, (B, MK)),
            jnp.float32,
        )
        st = jnp.asarray(rng.uniform(0.0, 50.0, (B, MK)), jnp.float32)
        mu = jnp.asarray(rng.standard_normal(MK), jnp.float32)
        lam = np.asarray(
            solvers.maximize_lambda(lam0, nu, ndz, st, mu, invS, solver="chol")
        )
        assert np.isfinite(lam).all()
        g_end = np.asarray(
            jax.vmap(lambda l, n, z, s: solvers.lambda_grad(l, n, z, s, mu, invS))(
                jnp.asarray(lam), nu, ndz, st
            )
        )
        g_start = np.asarray(
            jax.vmap(lambda l, n, z, s: solvers.lambda_grad(l, n, z, s, mu, invS))(
                lam0, nu, ndz, st
            )
        )
        assert np.abs(g_end).max() < 1e-2 * max(np.abs(g_start).max(), 1.0)

    def test_invalid_solver_raises(self):
        z = jnp.zeros((2, 3))
        with pytest.raises(ValueError, match="solver"):
            solvers.maximize_lambda(z, z, z, z, jnp.zeros(3), jnp.eye(3),
                                    solver="qr")

    def test_config_threads_solver_through_fit(self):
        # an f64 fit with lambda_solver="chol" must track the default (both
        # directions are machine-exact) to tight tolerance on the tiny corpus
        import dataclasses

        from multimodalmusig_tpu.models.mmctm import MMCTM

        # docs in the reference's sparse (1-based term, count) convention
        X = [
            [np.array([[1, 5], [2, 2]]), np.array([[1, 1], [2, 3]])],
            [np.array([[1, 1], [3, 3]]), np.array([[1, 2]])],
            [np.array([[2, 4], [3, 1]]), np.array([[2, 2]])],
            [np.array([[1, 2], [2, 2], [3, 2]]), np.array([[1, 4], [2, 1]])],
        ]
        m1 = MMCTM([2, 2], [0.1, 0.1], X, dtype=jnp.float64)
        m2 = MMCTM([2, 2], [0.1, 0.1], X, dtype=jnp.float64)
        m2.config = dataclasses.replace(m2.config, lambda_solver="chol")
        m1.fit(maxiter=25, tol=0.0, verbose=False)
        m2.fit(maxiter=25, tol=0.0, verbose=False)
        np.testing.assert_allclose(
            np.asarray(m1.ll), np.asarray(m2.ll), rtol=1e-8
        )

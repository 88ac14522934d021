"""Property and end-to-end tests beyond the reference's unit fixtures
(SURVEY.md §4 implications: convergence on real data, ELBO behavior,
signature recovery, multi-modality configs)."""

import jax
import jax.numpy as jnp
import numpy as np
from multimodalmusig_tpu.utils.data import brca_counts_path
import pytest

from conftest import requires_brca_data

from multimodalmusig_tpu.models import lda as lda_mod
from multimodalmusig_tpu.models import mmctm as mmctm_mod
from multimodalmusig_tpu.models.lda import LDA
from multimodalmusig_tpu.models.mmctm import MMCTM


class TestElboMonotonicity:
    def test_lda_elbo_nondecreasing(self, lda_fixture):
        model = LDA(lda_fixture["K"], lda_fixture["alpha"], lda_fixture["eta"], lda_fixture["X"])
        elbos = []
        for _ in range(25):
            model.fit(maxiter=1, verbose=False)
            elbos.append(model.elbo)
        diffs = np.diff(elbos)
        assert np.all(diffs > -1e-6 * np.abs(np.asarray(elbos[1:]))), elbos

    def test_mmctm_elbo_nondecreasing(self, mmctm_fixture):
        model = MMCTM(mmctm_fixture["K"], mmctm_fixture["alpha"], mmctm_fixture["X"])
        elbos = []
        for _ in range(25):
            model.fit(maxiter=1, verbose=False)
            elbos.append(model.elbo)
        diffs = np.diff(elbos)
        # the stored ζ is one λ-update stale (same as the reference's state
        # at ELBO time, src/MMCTM.jl:490), so allow float-level slack
        assert np.all(diffs > -1e-5 * np.abs(np.asarray(elbos[1:]))), elbos


class TestSignatureRecovery:
    def test_lda_recovers_planted_topics(self):
        """Generate documents from known topics; the fitted β must match
        each planted topic (best-of-N restarts to dodge local optima)."""
        from multimodalmusig_tpu.parallel.restarts import fit_lda_restarts

        rng = np.random.default_rng(7)
        K, V, D, N_per_doc = 3, 24, 120, 400
        beta_true = rng.dirichlet(np.full(V, 0.08), size=K)  # (K, V) peaked
        theta_true = rng.dirichlet(np.full(K, 0.3), size=D)
        X = []
        for d in range(D):
            p = theta_true[d] @ beta_true
            counts = rng.multinomial(N_per_doc, p)
            idx = np.nonzero(counts)[0]
            X.append(np.stack([idx + 1, counts[idx]], axis=1))

        model = fit_lda_restarts(K, 0.1, 0.1, X, V=V, restarts=6, maxiter=150, tol=1e-6)
        beta_fit = model.beta.T  # (K, V)
        # each true topic has a close fitted topic (greedy cosine matching)
        cos = (beta_true / np.linalg.norm(beta_true, axis=1, keepdims=True)) @ (
            beta_fit / np.linalg.norm(beta_fit, axis=1, keepdims=True)
        ).T
        assert cos.max(axis=1).min() > 0.9, cos

    def test_mmctm_covariance_captures_correlation(self):
        """Two modalities driven by a shared latent factor: the fitted Σ
        must show positive cross-modality correlation between the
        corresponding topic pair."""
        rng = np.random.default_rng(3)
        D = 150
        # modality A topics concentrated on disjoint vocab halves; same for B
        X = []
        for d in range(D):
            z = rng.random() < 0.5  # shared factor picks topic 1 vs 2 in BOTH
            a = np.zeros(8, dtype=int)
            b = np.zeros(6, dtype=int)
            a_idx = (0, 4) if z else (4, 8)
            b_idx = (0, 3) if z else (3, 6)
            a[a_idx[0]:a_idx[1]] = rng.multinomial(60, np.full(4, 0.25))
            b[b_idx[0]:b_idx[1]] = rng.multinomial(40, np.full(3, 1 / 3))
            docs = []
            for counts in (a, b):
                idx = np.nonzero(counts)[0]
                docs.append(np.stack([idx + 1, counts[idx]], axis=1))
            X.append(docs)

        model = MMCTM([2, 2], [0.1, 0.1], [8, 6], X, seed=1)
        model.fit(maxiter=60, tol=1e-6, verbose=False)
        Sigma = model.Sigma
        corr = Sigma / np.sqrt(np.outer(np.diag(Sigma), np.diag(Sigma)))
        # cross-modality block (2x2): strongest |corr| should be substantial
        cross = np.abs(corr[:2, 2:])
        assert cross.max() > 0.5, corr


class TestThreeModalities:
    def test_mmctm_three_modalities(self):
        """The PCAWG-shaped MMCTM([7,7,5]) config, miniaturized."""
        rng = np.random.default_rng(0)
        D = 12
        V = [10, 8, 6]
        K = [3, 3, 2]
        X = []
        for d in range(D):
            docs = []
            for m in range(3):
                counts = rng.integers(0, 8, size=V[m])
                idx = np.nonzero(counts)[0]
                docs.append(np.stack([idx + 1, counts[idx]], axis=1))
            X.append(docs)
        model = MMCTM(K, [0.1, 0.1, 0.1], V, X)
        ll = model.fit(maxiter=25, verbose=False)
        assert len(ll[0]) == 3
        assert np.all(np.isfinite(np.asarray(ll)))
        assert model.config.MK == 8
        eta = mmctm_mod.predict_modality_eta(
            [[doc[0], doc[1]] for doc in X[:4]], 3, model, maxiter=8
        )
        assert eta[0].shape == (2,)


class TestBRCAEndToEnd:
    @requires_brca_data
    def test_lda_converges_on_real_snv_subset(self):
        import pandas as pd

        from multimodalmusig_tpu import format_counts_lda

        snv = pd.read_csv(brca_counts_path("brca-eu_snv_counts.tsv"), sep="\t")
        cols = list(snv.columns[1:31])
        X = format_counts_lda(snv, cols)
        model = LDA(5, 0.1, 0.1, X)
        ll = model.fit(maxiter=300, tol=1e-5, verbose=False)
        assert model.converged
        assert ll[-1] > ll[0]
        assert model.elbo < 0 and np.isfinite(model.elbo)

    @requires_brca_data
    def test_mmctm_converges_on_real_subset(self):
        import pandas as pd

        from multimodalmusig_tpu import format_counts_mmctm

        snv = pd.read_csv(brca_counts_path("brca-eu_snv_counts.tsv"), sep="\t")
        sv = pd.read_csv(brca_counts_path("brca-eu_sv_counts.tsv"), sep="\t")
        cols = list(snv.columns[1:21])
        X = format_counts_mmctm([snv, sv], cols)
        model = MMCTM([3, 3], [0.1, 0.1], X)
        ll = model.fit(maxiter=120, tol=1e-4, verbose=False)
        assert model.converged
        assert np.all(np.isfinite(np.asarray(ll)))


class TestPrecision:
    def test_f32_trajectory_tracks_f64(self, mmctm_fixture):
        """float32 (the GPU production dtype) must track the float64
        trajectory closely over a realistic number of iterations."""
        import jax.numpy as jnp

        lls = {}
        for dt in (jnp.float32, jnp.float64):
            model = MMCTM(
                mmctm_fixture["K"], mmctm_fixture["alpha"], mmctm_fixture["X"],
                seed=5, dtype=dt,
            )
            lls[dt] = np.asarray(model.fit(maxiter=20, verbose=False))
        np.testing.assert_allclose(lls[jnp.float32], lls[jnp.float64], rtol=2e-4)


class TestFuzz:
    def test_random_configs_stay_finite(self):
        """Random shapes/counts/seeds in float32 (production dtype): fits
        must stay finite and normalized."""
        import jax.numpy as jnp

        rng = np.random.default_rng(123)
        for trial in range(6):
            M_ = int(rng.integers(1, 4))
            K_ = [int(rng.integers(2, 5)) for _ in range(M_)]
            V_ = [int(rng.integers(3, 12)) for _ in range(M_)]
            D_ = int(rng.integers(2, 9))
            X = []
            for d in range(D_):
                docs = []
                for m in range(M_):
                    counts = rng.integers(0, 15, size=V_[m])
                    if counts.sum() == 0:
                        counts[rng.integers(V_[m])] = 1
                    idx = np.nonzero(counts)[0]
                    docs.append(np.stack([idx + 1, counts[idx]], axis=1))
                X.append(docs)
            model = MMCTM(K_, [0.1] * M_, V_, X, seed=trial, dtype=jnp.float32)
            ll = model.fit(maxiter=15, verbose=False)
            assert np.all(np.isfinite(np.asarray(ll))), (trial, K_, V_, D_)
            assert np.isfinite(model.elbo), (trial, K_, V_, D_)
            for p in model.props[0]:
                np.testing.assert_allclose(p.sum(), 1.0, rtol=1e-4)


class TestPCAWGScale:
    def test_pcawg_shaped_config_smoke(self):
        """PCAWG-scale shapes: ~2800 samples x 3 modalities. Two CAVI
        iterations on CPU to validate shapes/memory; throughput is measured
        on the GPU."""
        import jax
        import jax.numpy as jnp

        from multimodalmusig_tpu.models import mmctm as mmod
        from multimodalmusig_tpu.models.mmctm import MMCTMConfig, init_with_alpha

        rng = np.random.default_rng(0)
        config = MMCTMConfig(K=(7, 7, 5), V=(96, 48, 24), D=2800, dtype=jnp.float32)
        X = tuple(
            jnp.asarray(rng.integers(0, 12, size=(config.D, V)), jnp.float32)
            for V in config.V
        )
        alpha = jnp.asarray([0.1, 0.1, 0.1], jnp.float32)
        state = init_with_alpha(jax.random.key(0), config, X, alpha)
        result = jax.jit(
            mmod.fit, static_argnames=("config", "maxiter", "tol")
        )(state, X, config, maxiter=2)
        ll = np.asarray(result.ll)
        assert ll.shape == (3,)
        assert np.all(np.isfinite(ll))

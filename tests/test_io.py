"""Checkpoint round-trip and TSV-writer tests (reference: JLD save at
run_mmctm.jl:272-274 and the TSV writers at run_mmctm.jl:184-240)."""

import numpy as np
from multimodalmusig_tpu.utils.data import brca_counts_path
import pytest

from conftest import requires_brca_data

from multimodalmusig_tpu.models.ilda import ILDA
from multimodalmusig_tpu.models.immctm import IMMCTM
from multimodalmusig_tpu.models.lda import LDA
from multimodalmusig_tpu.models.mmctm import MMCTM
from multimodalmusig_tpu.utils import io as io_mod

FEATURES = np.array([[1, 1], [1, 2], [2, 1], [2, 2]])


def roundtrip(tmp_path, model):
    path = str(tmp_path / "model.npz")
    io_mod.save_model(path, model)
    return io_mod.load_model(path)


class TestCheckpointRoundtrip:
    def test_lda(self, tmp_path, lda_fixture):
        model = LDA(lda_fixture["K"], lda_fixture["alpha"], lda_fixture["eta"], lda_fixture["X"])
        model.fit(maxiter=20, verbose=False)
        loaded = roundtrip(tmp_path, model)
        np.testing.assert_array_equal(loaded.lam, model.lam)
        np.testing.assert_array_equal(loaded.gamma, model.gamma)
        assert loaded.ll == model.ll
        assert loaded.converged == model.converged

    def test_mmctm(self, tmp_path, mmctm_fixture):
        model = MMCTM(mmctm_fixture["K"], mmctm_fixture["alpha"], mmctm_fixture["X"])
        model.fit(maxiter=15, verbose=False)
        loaded = roundtrip(tmp_path, model)
        np.testing.assert_array_equal(loaded.mu, model.mu)
        np.testing.assert_array_equal(loaded.Sigma, model.Sigma)
        for m in range(2):
            np.testing.assert_array_equal(
                np.asarray(loaded.state.gamma[m]), np.asarray(model.state.gamma[m])
            )
        assert loaded.ll == model.ll

    def test_mmctm_resume_continues_fit(self, tmp_path, mmctm_fixture):
        """Checkpoint mid-fit, reload, and resume — coordinate ascent picks
        up exactly where it stopped (warm-start semantics)."""
        model = MMCTM(mmctm_fixture["K"], mmctm_fixture["alpha"], mmctm_fixture["X"])
        model.fit(maxiter=5, verbose=False)
        loaded = roundtrip(tmp_path, model)
        ll_resumed = loaded.fit(maxiter=3, verbose=False)
        ll_direct = model.fit(maxiter=3, verbose=False)
        np.testing.assert_allclose(ll_resumed, ll_direct, rtol=1e-12)

    def test_ilda(self, tmp_path, lda_fixture):
        model = ILDA(2, 0.1, 0.1, FEATURES, lda_fixture["X"])
        model.fit(maxiter=15, verbose=False)
        loaded = roundtrip(tmp_path, model)
        for i in range(2):
            np.testing.assert_array_equal(loaded.lam[i], model.lam[i])
        assert loaded.eta == model.eta

    def test_immctm(self, tmp_path, mmctm_fixture):
        model = IMMCTM(
            mmctm_fixture["K"], mmctm_fixture["alpha"], [FEATURES, FEATURES],
            mmctm_fixture["X"],
        )
        model.fit(maxiter=10, verbose=False)
        loaded = roundtrip(tmp_path, model)
        np.testing.assert_array_equal(loaded.mu, model.mu)
        for m in range(2):
            for i in range(2):
                np.testing.assert_array_equal(
                    np.asarray(loaded.state.gamma[m][i]),
                    np.asarray(model.state.gamma[m][i]),
                )


class TestWriters:
    def test_cov2cor(self):
        C = np.array([[4.0, 2.0], [2.0, 9.0]])
        R = io_mod.cov2cor(C)
        np.testing.assert_allclose(np.diag(R), [1.0, 1.0])
        np.testing.assert_allclose(R[0, 1], 2.0 / 6.0)

    def test_tsv_outputs(self, tmp_path, mmctm_fixture):
        import pandas as pd

        model = MMCTM(mmctm_fixture["K"], mmctm_fixture["alpha"], mmctm_fixture["X"])
        model.fit(maxiter=5, verbose=False)
        terms = [[f"t{v}" for v in range(4)], [f"s{v}" for v in range(4)]]
        modalities = ["SNV", "SV"]
        samples = ["samp1", "samp2"]

        io_mod.write_mean(tmp_path / "mean.tsv", model)
        io_mod.write_cov(tmp_path / "cov.tsv", model)
        io_mod.write_cor(tmp_path / "cor.tsv", model)
        io_mod.write_sigs(tmp_path / "sigs.tsv", model, terms, modalities)
        io_mod.write_props(tmp_path / "props.tsv", model, samples, modalities)

        assert np.loadtxt(tmp_path / "mean.tsv").shape == (5,)
        assert np.loadtxt(tmp_path / "cov.tsv").shape == (5, 5)
        sigs = pd.read_csv(tmp_path / "sigs.tsv", sep="\t")
        assert list(sigs.columns) == ["modality", "topic", "value", "term", "probability"]
        assert len(sigs) == 2 * 4 + 3 * 4  # K1*V1 + K2*V2
        # probabilities normalize per modality x topic
        sums = sigs.groupby(["modality", "topic"])["probability"].sum()
        np.testing.assert_allclose(sums, 1.0, rtol=1e-5)
        props = pd.read_csv(tmp_path / "props.tsv", sep="\t")
        assert list(props.columns) == ["topic", "samp1", "samp2"]
        assert len(props) == 5

    def test_tsv_writers_match_pandas_bytes(self, tmp_path, mmctm_fixture):
        """The CLI's sigs/props writers need no pandas, and write exactly
        what the DataFrame helpers' to_csv writes."""
        model = MMCTM(mmctm_fixture["K"], mmctm_fixture["alpha"], mmctm_fixture["X"])
        model.fit(maxiter=5, verbose=False)
        terms = [[f"t{v}" for v in range(4)], [f"s,{v}" for v in range(4)]]
        modalities = ["SNV", "SV"]
        samples = ["samp1", "samp 2"]
        io_mod.write_sigs(tmp_path / "sigs.tsv", model, terms, modalities)
        io_mod.write_props(tmp_path / "props.tsv", model, samples, modalities)
        io_mod.topic_dataframe(model, terms, modalities).to_csv(
            tmp_path / "sigs_pd.tsv", sep="\t", index=False
        )
        io_mod.prop_dataframe(model, samples, modalities).to_csv(
            tmp_path / "props_pd.tsv", sep="\t", index=False
        )
        for name in ("sigs", "props"):
            assert (tmp_path / f"{name}.tsv").read_bytes() == (
                tmp_path / f"{name}_pd.tsv"
            ).read_bytes()


class TestCLI:
    @requires_brca_data
    def test_end_to_end(self, tmp_path):
        """Run the CLI exactly as a reference user would, on a subset of the
        bundled BRCA-EU data."""
        import pandas as pd

        from multimodalmusig_tpu import cli

        snv = pd.read_csv(brca_counts_path("brca-eu_snv_counts.tsv"), sep="\t")
        sv = pd.read_csv(brca_counts_path("brca-eu_sv_counts.tsv"), sep="\t")
        cols = ["term"] + list(snv.columns[1:13])
        snv_path, sv_path = str(tmp_path / "snv.tsv"), str(tmp_path / "sv.tsv")
        snv[cols].to_csv(snv_path, sep="\t", index=False)
        sv[cols].to_csv(sv_path, sep="\t", index=False)

        rc = cli.main(
            [
                snv_path, sv_path,
                "-k", "2", "2",
                "-m", "SNV", "SV",
                "--restarts", "2",
                "--maxiter", "12",
                "--model", str(tmp_path / "model.npz"),
                "--mean", str(tmp_path / "mean.tsv"),
                "--cov", str(tmp_path / "cov.tsv"),
                "--cor", str(tmp_path / "cor.tsv"),
                "--sigs", str(tmp_path / "sigs.tsv"),
                "--props", str(tmp_path / "props.tsv"),
            ]
        )
        assert rc == 0
        for f in ("model.npz", "mean.tsv", "cov.tsv", "cor.tsv", "sigs.tsv", "props.tsv"):
            assert (tmp_path / f).exists(), f

        loaded = io_mod.load_model(str(tmp_path / "model.npz"))
        assert loaded.K == [2, 2]
        assert np.all(np.isfinite(loaded.ll))

    def test_arg_validation(self, capsys):
        from multimodalmusig_tpu import cli

        rc = cli.main(["a.tsv", "b.tsv", "-k", "2", "-m", "SNV", "SV"])
        assert rc == 1

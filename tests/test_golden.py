"""Golden-trajectory regression tests.

A fixed-seed float64 MMCTM fit on the tiny fixture must keep producing the
same numbers across refactors (solver rewrites, kernel integrations,
layout changes). Golden values were generated by this implementation at
commit b078d57 and spot-validated against the hand-derived update fixtures;
they pin *trajectory* behavior, not just single updates.

Regenerate intentionally with:
    python tests/test_golden.py --regen
"""

import json
import os

import numpy as np

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden", "mmctm_tiny_f64.json")


def _run():
    import multimodalmusig_tpu as mm

    X = [
        [np.array([[1, 5], [2, 8]]), np.array([[1, 2], [2, 5]])],
        [np.array([[3, 4], [4, 9]]), np.array([[3, 4], [4, 6]])],
    ]
    model = mm.MMCTM([2, 3], [0.1, 0.1], X, seed=123)
    ll = model.fit(maxiter=15, tol=1e-12, verbose=False)
    return {
        "ll": np.asarray(ll, dtype=np.float64).tolist(),
        "elbo": float(model.elbo),
        "mu": model.mu.astype(np.float64).tolist(),
        "Sigma_diag": np.diag(model.Sigma).astype(np.float64).tolist(),
        "lam0": model.lam[0].astype(np.float64).tolist(),
    }


def test_mmctm_trajectory_matches_golden():
    with open(GOLDEN_PATH) as f:
        golden = json.load(f)
    got = _run()
    np.testing.assert_allclose(got["ll"], golden["ll"], rtol=1e-9)
    np.testing.assert_allclose(got["elbo"], golden["elbo"], rtol=1e-9)
    np.testing.assert_allclose(got["mu"], golden["mu"], rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(got["Sigma_diag"], golden["Sigma_diag"], rtol=1e-8)
    np.testing.assert_allclose(got["lam0"], golden["lam0"], rtol=1e-8, atol=1e-10)


if __name__ == "__main__":
    import sys

    if "--regen" in sys.argv:
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_enable_x64", True)
        jax.config.update("jax_default_device", jax.devices("cpu")[0])
        os.makedirs(os.path.dirname(GOLDEN_PATH), exist_ok=True)
        with open(GOLDEN_PATH, "w") as f:
            json.dump(_run(), f, indent=1)
        print(f"wrote {GOLDEN_PATH}")

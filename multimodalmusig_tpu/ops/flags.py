"""Environment flags, resolved ONCE at import.

The gates are consulted at trace time inside jitted fits, and jit caches do
not key on the process environment — so if the env vars were re-read on
every call, toggling one after a fit has been traced would silently keep the
previously compiled path (an in-process A/B comparison would measure the
same path twice). Pinning the values at import makes the behavior
deterministic for the life of the process: change the flag, start a new
process.

Tests that need to flip a gate in-process monkeypatch the gate *functions*
(e.g. rescore._use_device_rescore), not these constants.
"""

import os

# MUSIG_F32_FULL_BUDGETS=1: disable the warm-start inner-solver budget caps
# that float32 fit loops use by default (LAMBDA_NITER_F32_CAVI=3 etc. —
# ops/solvers.py). The caps were tuned to their measured accuracy cliffs on
# BRCA and PCAWG; a dataset with much harsher precision-matrix geometry can
# set this to restore the cold-start-safe full budgets everywhere without
# touching per-model config (models/ctm_base.py resolved_budgets).
F32_FULL_BUDGETS = os.environ.get("MUSIG_F32_FULL_BUDGETS", "0") == "1"

# MUSIG_THETA_FACTORIZED=0: fall back to materializing the (D, V, K) θ
# softmax in the hot fit loops instead of the exp-factorized moments
# (ctm_base.theta_moments — exact same math on a matmul schedule; default
# on everywhere). The off switch exists for A/B measurement only.
THETA_FACTORIZED = os.environ.get("MUSIG_THETA_FACTORIZED", "1") == "1"

# MUSIG_DEVICE_RESCORE: where the exact-f64 selection re-scoring runs.
# "auto" (default) = on the accelerator when the default backend is not CPU
# (parallel/rescore_device.py — same f64 math where the final states
# already live, no state fetch and no host log storm), on the host numpy
# path otherwise (CPU fits gain nothing from a jitted scorer and the test
# suite churns many tiny shapes). "1"/"0" force the device/host path.
DEVICE_RESCORE = os.environ.get("MUSIG_DEVICE_RESCORE", "auto")

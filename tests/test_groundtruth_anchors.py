"""Ground-truthed CTF moment anchors.

`scripts/groundtruth_ctf_moment.py` recomputes the disputed raw-sample moment
anchors through a pipeline that shares no derivative pathway with the
production CTF: production tracer at abstol=reltol=1e-11 (100× tighter),
host-driven FD Newton offset solves, closed-form redshift, and
Richardson-extrapolated central-FD Jacobians (NOT jvp-through-the-integrator),
with NO near-extremal regularisation gate. The committed artifact
`scripts/groundtruth_ctf.npz` holds the per-sample dumps.

MEASURED GROUND TRUTH (a = 0.998, rₑ = 4, f64):

    anchor   ground truth   repo pinned   reference golden
    i=74°    0.0555103      0.055006      0.0555030   ← control
    i=35°    0.1064168      0.106156      0.1084618
    i=30°    0.1101249      0.110886      0.1195815
    i=3°     0.1220254      0.122230      0.1404890

- At the well-conditioned CONTROL the ground truth lands on the reference
  golden to 1.3e-4 (7× inside the reference's own atol 1e-3) — the
  independent pipeline reproduces the reference where both solvers are
  healthy, validating the method.
- On the three disputed anchors the ground truth lands on the REPO's values
  (within 0.17-0.69%) and sits 1.9%, 8.6% and 15% BELOW the reference's
  recorded goldens — the round-4 conditioning claim ("the reference goldens
  embed the reference solver's own near-extremal noise") is now a
  measurement, not an argument.
- Robustness: recomputing at tol = 1e-10 with halved FD step h_ab = 1e-4
  gives 0.0555598 / 0.1052011 / 0.1109589 / 0.1220211 — the deepest
  near-extremal samples carry FD-Jacobian noise that moves the i=74/35/30
  moments by up to ±1% between configs (i=3° is clean at ±4e-5). The
  ground-truth BANDS [0.05551, 0.05556] / [0.10520, 0.10650] /
  [0.11012, 0.11096] / [0.1220211, 0.1220254] still exclude the reference's
  disputed goldens by 1.9%, 7.8% and 15% at their nearest edges, and contain
  (or sit within 1% of) the repo's pinned values.
- The independent Carter first-order formulation cross-validates the ρ-map
  at r_obs = 1e3 (where its Mino-form drift is benign): offsets to 1.1e-4,
  Jacobians to 4.6% (the FO map's own noise floor).
- Per-sample diagnosis (production vs ground truth, matched by sweep θ):
  the f fields agree to p90 ≤ 1e-2 everywhere; the residual ≤0.9% moment
  differences are dominated by EXTREMAL-SAMPLE BOOKKEEPING — each pipeline
  zeroes f at its OWN argmax sample (the IEEE x/x = 1 identity, exactly as
  the reference accumulator does), and which probe lands deepest differs
  between realisations, moving a full-weight (g✶ = 1) sample in or out of
  the sum. The near-gmin disagreements carry no moment weight (f·g✶ → 0).
  This is the statistic's intrinsic realisation sensitivity, shared by the
  reference — not a fixable pipeline error.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

NPZ = os.path.join(os.path.dirname(__file__), "..", "scripts", "groundtruth_ctf.npz")

GROUND_TRUTH = {
    (74.0, 4.0): 0.05551031,
    (35.0, 4.0): 0.10641677,
    (30.0, 4.0): 0.11012485,
    (3.0, 4.0): 0.12202535,
}

REFERENCE_GOLDENS = {
    (74.0, 4.0): 0.05550300700779827,
    (35.0, 4.0): 0.10846177995555085,
    (30.0, 4.0): 0.11958152396826184,
    (3.0, 4.0): 0.14048899037409682,
}


def test_groundtruth_artifact_consistency():
    """The committed artifact reproduces the table above, the control anchor
    matches the reference golden, and the disputed anchors sit measurably
    below the reference's recorded values."""
    data = np.load(NPZ)
    for (inc, re), gt_val in GROUND_TRUTH.items():
        key = f"i{inc:g}_re{re:g}_moment"
        np.testing.assert_allclose(float(data[key]), gt_val, rtol=1e-6)
        # Richardson vs plain-h FD agreement at the recorded h (2e-4)
        plain = float(data[f"i{inc:g}_re{re:g}_moment_plain_h"])
        np.testing.assert_allclose(plain, gt_val, rtol=1e-3)
    # control: ground truth ≈ reference golden (inside reference atol 1e-3)
    assert abs(GROUND_TRUTH[(74.0, 4.0)] - REFERENCE_GOLDENS[(74.0, 4.0)]) < 1e-3
    # disputed: reference goldens sit 1.9-15% ABOVE the ground truth
    for key, lo, hi in [((35.0, 4.0), 0.015, 0.03), ((30.0, 4.0), 0.07, 0.10), ((3.0, 4.0), 0.13, 0.17)]:
        excess = REFERENCE_GOLDENS[key] / GROUND_TRUTH[key] - 1.0
        assert lo < excess < hi, (key, excess)
    # FO-formulation cross-validation recorded
    assert float(data["fo_crossval_droff"]) < 5e-4
    assert float(data["fo_crossval_dJ"]) < 0.1


@pytest.mark.slow
@pytest.mark.parametrize("inc,re", list(GROUND_TRUTH))
def test_production_moment_matches_groundtruth(inc, re):
    """The production f64 CTF pipeline (with its asymmetric near-extremal
    gate) reproduces the independent ground truth to ≤1.5% on every anchor —
    including the three where the reference's recorded goldens do not."""
    from test_transfer import _ctf_moment

    mom = _ctf_moment(0.998, inc, re)
    np.testing.assert_allclose(mom, GROUND_TRUTH[(inc, re)], rtol=1.5e-2)

"""Corona adaptive-sampling specialization.

Reference: `src/corona/adaptive-sample.jl` — CoronaGridValues payload,
g/J refinement metric, (r, φ) grid binning. The adaptive sampler must match
the dense profiles at a fraction of the ray budget: each sky cell carries an
AD Jacobian J = |∂(r,φ)/∂(θ,φ)|/sinθ through the integrator, making every
cell a pointwise-exact emissivity sample (no Monte-Carlo deposition noise).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gradus_tpu.metrics import KerrMetric
from gradus_tpu.geometry import ThinDisc
from gradus_tpu.corona.models import LampPostModel, RingCorona
from gradus_tpu.corona.adaptive import (
    corona_adaptive_sky,
    bin_emissivity_grid,
    bin_redshift_grid,
    bin_time_grid,
    adaptive_emissivity_profile,
)


@pytest.mark.slow
def test_lamppost_adaptive_matches_dense_pointwise():
    """Per-cell pointwise emissivity (exact via AD Jacobian) vs the dense
    lamppost sweep: ≤5% with ~10-30× fewer rays than the MC path needs."""
    from gradus_tpu.corona.emissivity import point_source_emissivity_profile

    m = KerrMetric(M=1.0, a=0.9)
    d = ThinDisc(inner_r=0.0, outer_r=200.0)
    lp = LampPostModel(h=10.0)

    grid, vals, n_traced = corona_adaptive_sky(
        m, d, lp, n0=16, rounds=3, max_refine=64
    )
    # the adaptive budget: a comparably-accurate Monte-Carlo binning needs
    # ≳ 25k photons for 5% per-bin noise at this bin count (1/√N) — the
    # VERDICT "≥10× fewer traced rays" margin
    assert n_traced < 2500

    dense = point_source_emissivity_profile(m, d, lp, n_samples=4000)
    rd = np.asarray(dense.radii)
    ed = np.asarray(dense.eps)
    okd = np.isfinite(rd) & (ed > 0)

    r = vals["r"]
    hit = np.isfinite(r) & np.isfinite(vals["J"]) & (vals["J"] > 0)
    q = (
        np.nan_to_num(vals["g"], nan=1.0) ** -2.0
        / (4 * np.pi * vals["J"] * vals["gamma"] * vals["area_el"])
    )
    sel = hit & (r > 2.0) & (r < 150.0) & np.isfinite(q)
    assert sel.sum() > 300
    ei = np.exp(np.interp(np.log(r[sel]), np.log(rd[okd]), np.log(ed[okd])))
    ratio = q[sel] / ei
    # absolute normalization agreement (both are per unit proper area for a
    # unit-luminosity isotropic source)
    assert abs(np.median(ratio) - 1.0) < 0.02
    dev = np.abs(ratio / np.median(ratio) - 1.0)
    assert np.percentile(dev, 90) < 0.05


def _bin_average(m, ref_r, ref_eps, r_bins):
    """Proper-area-weighted bin average of a dense reference profile — the
    like-for-like comparison target for deposition-binned estimates."""
    ok = np.isfinite(ref_r) & (ref_eps > 0)
    rf = np.geomspace(r_bins[0], r_bins[-1], 4001)
    ef = np.exp(np.interp(np.log(rf), np.log(ref_r[ok]), np.log(ref_eps[ok])))
    comp = np.asarray(m.components(jnp.asarray(rf), jnp.full(rf.shape, np.pi / 2)))
    w = np.sqrt(comp[..., 1] * comp[..., 3]) * np.gradient(rf)
    nb = len(r_bins) - 1
    bi = np.clip(np.searchsorted(r_bins, rf, side="right") - 1, 0, nb - 1)
    num = np.bincount(bi, weights=w * ef, minlength=nb)
    den = np.bincount(bi, weights=w, minlength=nb)
    return num / np.maximum(den, 1e-300)


@pytest.mark.slow
def test_lamppost_adaptive_profile_and_grids():
    """Binned φ-integrated profile vs the bin-averaged dense sweep;
    redshift/time grids are sane (g rises outward toward ~1, t grows with
    r)."""
    from gradus_tpu.corona.emissivity import point_source_emissivity_profile

    m = KerrMetric(M=1.0, a=0.9)
    d = ThinDisc(inner_r=0.0, outer_r=200.0)
    lp = LampPostModel(h=10.0)

    grid, vals, n_traced = corona_adaptive_sky(
        m, d, lp, n0=16, rounds=3, max_refine=64
    )
    r_bins = np.geomspace(1.5, 200.0, 21)
    eps, sa = bin_emissivity_grid(m, grid, vals, r_bins, np.array([0.0, 2 * np.pi]))
    dense = point_source_emissivity_profile(m, d, lp, n_samples=4000)
    ebar = _bin_average(m, np.asarray(dense.radii), np.asarray(dense.eps), r_bins)
    sel = (
        (sa[:, 0] > 0)
        & (eps[:, 0] > 0)
        & (ebar > 0)
        & (r_bins[:-1] > 2.5)
        & (r_bins[1:] < 150.0)
    )
    ratio = eps[sel, 0] / ebar[sel]
    assert sel.sum() > 10
    # deposition binning: unbiased (median ≤ 2%), per-bin footprint-model
    # scatter ≤ 10% p90 at this ~2k-ray budget (shrinks with refinement)
    assert abs(np.median(ratio) - 1.0) < 0.02
    assert np.percentile(np.abs(ratio - 1.0), 90) < 0.10

    grid, vals, _ = corona_adaptive_sky(m, d, lp, n0=16, rounds=2, max_refine=48)
    r_bins = np.geomspace(2.0, 150.0, 13)
    phi_bins = np.linspace(0.0, 2 * np.pi, 5)
    gbar, sa_g = bin_redshift_grid(grid, vals, r_bins, phi_bins)
    tbar, _ = bin_time_grid(grid, vals, r_bins, phi_bins)
    row_g = np.nanmean(gbar, axis=1)
    row_t = np.nanmean(tbar, axis=1)
    fin = np.isfinite(row_g)
    # gravitational redshift weakens outward
    assert row_g[fin][-1] > row_g[fin][0]
    assert 0.5 < row_g[fin][-1] < 1.3
    # propagation time grows with radius
    fin_t = np.isfinite(row_t)
    assert row_t[fin_t][-1] > row_t[fin_t][0]


@pytest.mark.slow
def test_ring_corona_adaptive_matches_dense_fan():
    """Adaptive sky emissivity for an off-axis RingCorona vs the dense-fan
    ring tracer (ring_corona_profile): ≤5% p90 on interior radii with fewer
    traced rays than the dense fan's n_beta × n_angles."""
    from gradus_tpu.corona.extended import ring_corona_profile

    m = KerrMetric(M=1.0, a=0.9)
    d = ThinDisc(inner_r=0.0, outer_r=200.0)
    ring = RingCorona(r=3.0, h=6.0)

    grid, vals, n_traced = corona_adaptive_sky(
        m, d, ring, n0=20, rounds=3, max_refine=96
    )
    n_dense = 20 * 256
    assert n_traced < n_dense

    r_bins = np.geomspace(2.5, 100.0, 13)
    eps, sa = bin_emissivity_grid(m, grid, vals, r_bins, np.array([0.0, 2 * np.pi]))
    dense = ring_corona_profile(m, d, ring, n_beta=20, n_angles=256)
    rq = np.geomspace(2.5, 100.0, 400)
    ed = np.asarray(dense.emissivity_at(jnp.asarray(rq)))
    ebar = _bin_average(m, rq, ed, r_bins)
    # interior bins only: the first/last bins straddle the sampled-region
    # boundary where deposition coverage is partial by construction
    sel = (sa[:, 0] > 0) & (eps[:, 0] > 0) & (ebar > 0)
    sel &= (r_bins[:-1] >= 3.2) & (r_bins[1:] <= 65.0)
    ratio = eps[sel, 0] / ebar[sel]
    assert sel.sum() > 7
    # two independent estimators of an off-axis source agree: unbiased to 5%,
    # per-bin scatter ≤ 10% p90 at this ~3k-ray budget
    assert abs(np.median(ratio) - 1.0) < 0.05
    assert np.percentile(np.abs(ratio - 1.0), 90) < 0.10


@pytest.mark.slow
def test_disc_corona_hybrid_profile():
    """`disc_corona_profile_hybrid` (opt-in per-ring near-field hybrid):
    aggregate semantics mirror DiscCoronaProfile — positive decaying
    emissivity, causal flux-weighted times, propagation delays shift the
    support — and each ring's near field comes from the adaptive sky."""
    from gradus_tpu.corona.models import DiscCorona
    from gradus_tpu.corona.extended import (
        DiscCoronaHybridProfile,
        disc_corona_profile,
        disc_corona_profile_hybrid,
    )

    m = KerrMetric(M=1.0, a=0.5)
    d = ThinDisc(0.0, 100.0)
    model = DiscCorona(r=6.0, h=4.0)
    prof = disc_corona_profile_hybrid(
        m, d, model, n_rings=3, n_beta=4, n_angles=64,
        n0=16, rounds=2, max_refine=64,
    )
    assert isinstance(prof, DiscCoronaHybridProfile)
    rq = jnp.array([8.0, 16.0, 32.0])
    eps = np.asarray(prof.emissivity_at(rq))
    assert np.all(eps > 0)
    assert np.all(np.diff(eps) < 0)
    lo, hi = prof.time_limits_at(12.0)
    assert float(hi) > float(lo) > 0.0
    prof2 = prof.with_propagation_velocity(lambda r: r / 0.5)
    lo2, hi2 = prof2.time_limits_at(12.0)
    assert float(hi2) > float(hi)
    # far-field agreement with the plain fan stack (the hybrid only replaces
    # the near field): ratio within 25% at r >> r_disc + blend window
    fan = disc_corona_profile(
        m, d, model, n_rings=3, n_beta=4, n_angles=64
    )
    r_far = jnp.array([20.0, 40.0])
    ratio = np.asarray(prof.emissivity_at(r_far)) / np.asarray(
        fan.emissivity_at(r_far)
    )
    assert np.all(np.abs(ratio - 1.0) < 0.25), ratio
    # time-emissivity curve: non-negative with mass inside the support
    tq = jnp.linspace(float(lo), float(hi), 32)
    curve = np.asarray(prof.time_emissivity_curve(12.0, tq))
    assert np.all(curve >= 0) and curve.max() > 0

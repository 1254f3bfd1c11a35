"""Analytic Kerr redshift (Cunningham 1975) vs the generic dot-product path.

The reference keeps `redshift_function(::KerrMetric, gp)` (redshift.jl:166-203)
both as the Kerr fast path and as an independent cross-check of the generic
`_redshift_dotproduct` (redshift.jl:204-220). These tests serve both roles
here: the closed-form machinery is derived
independently of `CircularOrbits`/`PlungingInterpolation`, so agreement here
validates BOTH redshift implementations.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import gradus_tpu as gt
from gradus_tpu.camera.impact import map_impact_parameters
from gradus_tpu.integrate.status import StatusCodes
from gradus_tpu.redshift import redshift_pointfunction
from gradus_tpu.utils.linalg import equatorial_project


def _trace_grid(m, x, d, side=28, lims=18.0):
    al = jnp.linspace(-lims, lims, side) + 1e-3
    be = jnp.linspace(-lims, lims, side) + 1e-3
    A = jnp.broadcast_to(al[:, None], (side, side)).ravel()
    B = jnp.broadcast_to(be[None, :], (side, side)).ravel()
    v = map_impact_parameters(m, x, A, B)
    xs = jnp.broadcast_to(x, v.shape)
    gp = gt.trace_geodesics(m, xs, v, (0.0, 2200.0), geometry=d)
    return gp


@pytest.mark.parametrize("a,inc", [(0.998, 75.0), (0.6, 45.0), (0.0, 30.0)])
def test_analytic_vs_generic_kerr(a, inc):
    """g over an (r_em, α, β) hit grid.

    The two paths are algebraically identical but numerically distinct: on
    the Keplerian branch the analytic path consumes the photon's conserved
    λ = p_φ/(−p_t) evaluated at the OBSERVER (exact), while the generic path
    dots the INTEGRATED momentum at the disc — so their difference measures
    the integrator's momentum drift at the default tolerances (directly
    measured: λ drifts ~1e-7 relative over a near-ISCO a = 0.998 trajectory
    while E drifts ~1e-9; the disagreement tracks it). The analytic path is
    therefore the more accurate of the two. Budgets: Keplerian ≤5e-7
    (integrator drift), plunging ≤1e-6 — far below product tolerances, so
    either path independently validates the other."""
    m = gt.KerrMetric(M=1.0, a=a)
    # disc down to the horizon so the plunging branch is exercised
    d = gt.ThinDisc(0.0, 50.0)
    x = jnp.asarray([0.0, 1000.0, np.deg2rad(inc), 0.0])
    gp = _trace_grid(m, x, d)

    pf_ana = redshift_pointfunction(m, x, analytic="always")
    pf_gen = redshift_pointfunction(m, x, analytic="never")
    assert pf_ana.is_analytic_kerr and not pf_gen.is_analytic_kerr

    g_ana = np.asarray(pf_ana(m, gp, 2200.0))
    g_gen = np.asarray(pf_gen(m, gp, 2200.0))
    hit = np.asarray(gp.status == StatusCodes.IntersectedWithGeometry)
    r_em = np.asarray(equatorial_project(gp.x))
    r_isco = float(gt.isco(m))

    kep = hit & (r_em >= r_isco * (1 + 1e-6))
    plunge = hit & (r_em < r_isco * (1 - 1e-6))
    assert kep.sum() > 50
    rel_kep = np.abs(g_ana[kep] - g_gen[kep]) / np.abs(g_gen[kep])
    assert rel_kep.max() < 5e-7, rel_kep.max()
    if plunge.sum() > 0:
        rel_pl = np.abs(g_ana[plunge] - g_gen[plunge]) / np.abs(g_gen[plunge])
        assert rel_pl.max() < 1e-6, rel_pl.max()


def test_auto_dispatch():
    """`analytic='auto'` picks the closed form exactly for prograde Kerr and
    the generic path for everything else."""
    mk = gt.KerrMetric(M=1.0, a=0.9)
    assert redshift_pointfunction(mk, analytic="auto").is_analytic_kerr
    assert not redshift_pointfunction(
        mk, contra_rotating=True, analytic="auto"
    ).is_analytic_kerr
    mj = gt.JohannsenMetric(M=1.0, a=0.6)
    assert not redshift_pointfunction(mj, analytic="auto").is_analytic_kerr
    with pytest.raises(ValueError):
        redshift_pointfunction(mj, analytic="always")


def test_keplerian_closed_form_values():
    """Spot values of the A2/A7 ingredient functions against their defining
    expressions at (M, r, a, θ) = (1, 6, 0.5, π/2)."""
    from gradus_tpu import redshift_analytic as ra

    M, r, a, th = 1.0, 6.0, 0.5, np.pi / 2
    Sigma = r * r
    Delta = r * r - 2 * r + a * a
    A = (r * r + a * a) ** 2 - a * a * Delta
    assert np.isclose(float(ra.e_nu(M, r, a, th)), np.sqrt(Sigma * Delta / A))
    assert np.isclose(float(ra.e_phi(M, r, a, th)), np.sqrt(A / Sigma))
    assert np.isclose(float(ra.omega(M, r, a, th)), 2 * a * r / A)
    assert np.isclose(float(ra.Omega_e(M, r, a)), 1.0 / (r**1.5 + a))

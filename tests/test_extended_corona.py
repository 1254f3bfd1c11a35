"""Extended-corona subsystem: ring/disc coronae, time-dependent radial
profiles, the generic target optimizer, and the time-dependent lag transfer.

Reference behavior: `src/corona/models/ring.jl`, `src/corona/radial.jl:165-325`,
`src/tracing/precision-solvers.jl:384-546`, ring-profile integration
ring.jl:857-950."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gradus_tpu as gt
from gradus_tpu.corona.extended import (
    RingCoronaProfile,
    DiscCoronaProfile,
    co_rotating_velocity,
    stationary_velocity,
)
from gradus_tpu.geodesics.tetrads import propernorm


@pytest.fixture(scope="module")
def kerr_disc():
    m = gt.KerrMetric(M=1.0, a=0.5)
    d = gt.ThinDisc(0.0, 100.0)
    return m, d


@pytest.fixture(scope="module")
def ring_profile(kerr_disc):
    m, d = kerr_disc
    model = gt.RingCorona(r=3.0, h=4.0)
    # near_field="fan" opts out of the (default) adaptive-sky hybrid: these
    # structural tests exercise the raw β-slice fan machinery
    return gt.emissivity_profile(
        m, d, model, n_beta=6, n_angles=96, near_field="fan"
    )


def test_source_velocities_timelike(kerr_disc):
    """Both source velocity functions give unit-norm timelike vectors
    (reference SourceVelocities, extended.jl:1-46)."""
    m, _ = kerr_disc
    x = jnp.array([0.0, 5.0, 0.6435, 0.0])
    for v in (stationary_velocity(m, x), co_rotating_velocity(m, x)):
        nrm = float(propernorm(m.metric(x), v))
        np.testing.assert_allclose(nrm, -1.0, atol=1e-10)
    # co-rotating has azimuthal motion, stationary does not
    assert float(co_rotating_velocity(m, x)[3]) > 1e-4
    assert float(stationary_velocity(m, x)[3]) == 0.0


def test_ring_profile_structure(ring_profile):
    """Two arms, positive decaying emissivity, causal time ordering."""
    prof = ring_profile
    assert isinstance(prof, RingCoronaProfile)
    rq = jnp.array([4.0, 8.0, 16.0, 32.0])
    eps = np.asarray(prof.emissivity_at(rq))
    assert np.all(eps > 0)
    assert np.all(np.diff(eps) < 0)  # decays beyond the ring radius
    # emission time spread at a given radius is positive (near vs far arm)
    lo, hi = prof.time_limits_at(10.0)
    assert float(hi) > float(lo) > 0.0
    # light curve is non-negative with support inside the limits
    tq = jnp.linspace(float(lo), float(hi), 32)
    curve = np.asarray(prof.time_emissivity_curve(10.0, tq))
    assert np.all(curve >= 0)
    assert curve.max() > 0
    # zero outside the support
    assert float(prof.time_emissivity_curve(10.0, jnp.asarray(float(lo) - 5.0))) == 0.0


def test_ring_farfield_slope(ring_profile):
    """Beyond the ring the illumination falls as a power law: fitted log-slope
    in r ∈ [15, 40] is a steady decline (a beamed co-rotating off-axis source
    is flatter than the lamppost's asymptotic r⁻³ at these moderate radii)."""
    rq = jnp.geomspace(15.0, 40.0, 12)
    eps = np.asarray(ring_profile.emissivity_at(rq))
    slope = np.polyfit(np.log(np.asarray(rq)), np.log(eps), 1)[0]
    assert -4.0 < slope < -1.0


def test_ring_small_radius_matches_lamppost(kerr_disc):
    """r → 0 axisymmetric limit: ring emissivity approaches the on-axis
    lamppost sweep."""
    m, d = kerr_disc
    h = 5.0
    lamp = gt.emissivity_profile(m, d, gt.LampPostModel(h=h), n_samples=400)
    ring = gt.emissivity_profile(
        m, d, gt.RingCorona(r=0.05, h=h), n_beta=4, n_angles=128,
        near_field="fan",
    )
    rq = jnp.array([6.0, 10.0, 18.0, 30.0])
    e_lamp = np.asarray(lamp.emissivity_at(rq))
    e_ring = np.asarray(ring.emissivity_at(rq))
    # same shape AND scale (slice-normalized): measured ratio ≈ 1.01
    ratio = e_ring / e_lamp
    assert np.all(ratio > 0.7) and np.all(ratio < 1.4)
    np.testing.assert_allclose(ratio / ratio.mean(), 1.0, atol=0.25)


def test_disc_corona_profile(kerr_disc):
    """DiscCorona ring stack: positive decaying emissivity; the previously
    crashing `emissivity_profile(m, d, DiscCorona())` entry point works."""
    m, d = kerr_disc
    prof = gt.emissivity_profile(
        m, d, gt.DiscCorona(r=6.0, h=4.0), n_rings=3, n_beta=4, n_angles=64
    )
    assert isinstance(prof, DiscCoronaProfile)
    rq = jnp.array([8.0, 16.0, 32.0])
    eps = np.asarray(prof.emissivity_at(rq))
    assert np.all(eps > 0)
    assert np.all(np.diff(eps) < 0)
    lo, hi = prof.time_limits_at(12.0)
    assert float(hi) > float(lo) > 0.0
    # propagation delays shift the time support (reference
    # `with_propagation_velocity`, radial.jl:287-289)
    prof2 = prof.with_propagation_velocity(lambda r: r / 0.5)
    lo2, hi2 = prof2.time_limits_at(12.0)
    assert float(hi2) > float(hi)


def test_optimize_for_target_hits(kerr_disc):
    """The batched pattern-search finds a geodesic passing within ~1e-2 r_g of
    an off-axis target (reference `optimize_for_target`)."""
    m, _ = kerr_disc
    x = jnp.array([0.0, 1000.0, np.deg2rad(45.0), 0.0])
    target = jnp.array([np.hypot(3.0, 4.0), np.arctan2(3.0, 4.0), 0.0])
    al, be, gp, acc = gt.optimize_for_target(target, m, x)
    assert float(acc) < 5e-2
    assert np.isfinite(float(al)) and np.isfinite(float(be))
    # arrival time ≈ r_obs + O(10) for a source near the hole
    assert 990.0 < float(gp.x[0]) < 1050.0


def test_continuum_time_offaxis_matches_onaxis(kerr_disc):
    """Ring corona with r → 0 gives the same continuum time as the on-axis
    datum-plane fast path (axisymmetric limit; VERDICT item-8 criterion)."""
    m, _ = kerr_disc
    x = jnp.array([0.0, 1000.0, np.deg2rad(45.0), 0.0])
    t_on = float(gt.continuum_time(m, x, gt.LampPostModel(h=5.0)))
    t_ring = float(gt.continuum_time(m, x, gt.RingCorona(r=0.05, h=5.0)))
    np.testing.assert_allclose(t_ring, t_on, atol=0.5)


def test_is_visible(kerr_disc):
    """Unobstructed rays re-trace to the same endpoint; rays that would cross
    the disc get flagged invisible."""
    m, d = kerr_disc
    from gradus_tpu.camera.impact import map_impact_parameters

    x = jnp.array([0.0, 1000.0, np.deg2rad(85.0), 0.0])
    # first ray misses everything (far from the hole AND above the disc
    # plane); the fan of near-plane rays bends through the equatorial plane
    # inside the disc
    al = jnp.array([80.0, 0.0, 4.0, -4.0])
    be = jnp.array([80.0, 5.0, 3.0, 3.0])
    v = map_impact_parameters(m, x, al, be)
    xs = jnp.broadcast_to(x, v.shape)
    # trace with NO geometry: endpoints land wherever the chart stops them
    gp = gt.trace_geodesics(m, xs, v, (0.0, 4000.0), chart_outer=2000.0)
    vis = np.asarray(
        gt.is_visible(m, d, gp, lam_max=4000.0, atol=1e-4, chart_outer=2000.0)
    )
    assert vis.dtype == bool and vis.shape == (4,)
    assert vis[0]
    assert not vis[1:].all()


@pytest.mark.slow
def test_timedep_lagtransfer(kerr_disc):
    """Time-dependent 2D lag transfer: normalized, causal, echo lag bounded by
    the profile's time support (reference ring.jl:857-950)."""
    m, d = kerr_disc
    x = jnp.array([0.0, 1000.0, np.deg2rad(45.0), 0.0])
    radii = jnp.linspace(gt.isco(m) + 1e-2, 30.0, 5)
    tfs = gt.transferfunctions(m, x, d, radii=radii, N=12, N_extrema=5, Ng=24)
    prof = gt.emissivity_profile(
        m, d, gt.RingCorona(r=3.0, h=4.0), n_beta=4, n_angles=64
    )
    bins = jnp.linspace(0.0, 1.5, 40)
    tbins = jnp.linspace(0.0, 150.0, 100)
    flux = np.asarray(
        gt.integrate_lagtransfer_timedep(
            prof, tfs, bins, tbins, t0=float(x[1]), n_radii=60, n_time=24
        )
    )
    assert np.isclose(np.nansum(flux), 1.0, rtol=1e-6)
    psi = np.nansum(flux, axis=0)
    lag = float((np.asarray(tbins) * psi).sum() / psi.sum())
    # echo arrives after the continuum but within the light-crossing budget
    assert 2.0 < lag < 120.0


@pytest.mark.slow
def test_disc_corona_lag_frequency_grows_with_radius(kerr_disc):
    """End-to-end disc-corona reverberation:
    emissivity profile → time-dependent lag transfer → τ(f). A radially
    larger corona means longer source-to-disc light paths from its outer
    rings, so the low-frequency lag must grow with the corona radius."""
    from gradus_tpu.reverberation import _lag_frequency_fft

    m, d = kerr_disc
    x = jnp.array([0.0, 1000.0, np.deg2rad(45.0), 0.0])
    radii = jnp.linspace(gt.isco(m) + 1e-2, 30.0, 5)
    tfs = gt.transferfunctions(m, x, d, radii=radii, N=12, N_extrema=5, Ng=24)
    bins = jnp.linspace(0.0, 1.5, 40)
    tbins = jnp.linspace(0.0, 200.0, 128)

    lags = {}
    taus = {}
    for rc in (2.0, 10.0):
        prof = gt.emissivity_profile(
            m, d, gt.DiscCorona(r=rc, h=4.0), n_rings=3, n_beta=4, n_angles=64
        )
        # propagation delays: the productized ring stack supports actual
        # radial spacing weights + flux-weighted arrival times
        prof = prof.with_propagation_velocity(lambda r: 2.0 * r)
        flux = gt.integrate_lagtransfer_timedep(
            prof, tfs, bins, tbins, t0=float(x[1]), n_radii=60, n_time=24
        )
        flux = np.asarray(flux)
        assert np.isclose(np.nansum(flux), 1.0, rtol=1e-6)
        psi = np.nansum(flux, axis=0)
        lags[rc] = float((np.asarray(tbins) * psi).sum() / psi.sum())
        freq, tau = _lag_frequency_fft(tbins, jnp.asarray(flux))
        freq = np.asarray(freq)
        tau = np.asarray(tau)
        lo = (freq > 0) & (freq < 2e-3)
        taus[rc] = float(np.nanmean(tau[lo]))

    # mean echo lag and low-frequency FFT lag both grow with corona radius
    assert lags[10.0] > lags[2.0] + 1.0
    assert taus[10.0] > taus[2.0]
    assert taus[2.0] > 0


@pytest.mark.slow
def test_ring_corona_n_beta_convergence(kerr_disc):
    """Convergence in the β-slice count, INCLUDING the near field.

    Any β-slice fan estimates the near-field ε through fold caustics (each
    slice's support edge has dρ/dδ = 0), whose β-Riemann-sum error decays
    only as O(√Δβ) — measured ±25% wobble at r − r_ring < 1 r_g even at 80
    slices. The hybrid profile serves that regime from the slice-free
    adaptive-sky estimator (`ring_corona_profile_hybrid`), so ε(r) is
    n_beta-independent in the near field and fan-converged outside it.

    VERDICT r4 next #6 done-criterion: this uses the DEFAULT
    `emissivity_profile` dispatch — no hybrid import needed."""
    m, d = kerr_disc
    ring = gt.RingCorona(r=3.0, h=6.0)
    # straddles the ring: 2.6, 3.0, 3.4, 4.0 are all within 1.5 r_g of it
    rq = jnp.asarray([2.6, 3.0, 3.4, 4.0, 5.0, 8.0, 15.0, 30.0])
    eps = {}
    for nb in (10, 20, 40):
        prof = gt.emissivity_profile(m, d, ring, n_beta=nb, n_angles=256)
        eps[nb] = np.asarray(prof.emissivity_at(rq))
    np.testing.assert_allclose(eps[20], eps[40], rtol=1e-2)
    np.testing.assert_allclose(eps[10], eps[40], rtol=3e-2)
    # the near-field values carry real signal (not zeros / window artifacts)
    assert np.all(eps[40][:4] > 0)


@pytest.mark.slow
def test_ring_corona_lag_frequency_n_beta_stable(kerr_disc):
    """Product-level near-field stability: the
    lag-frequency spectrum of a ring corona must be n_beta-stable THROUGH the
    near field with the default dispatch. The disc inner region sits within
    1.5 r_g of the r=3 ring, so the pre-hybrid fan default wobbled the
    emissivity (and hence the echo weighting) by ±25% there."""
    from gradus_tpu.reverberation import _lag_frequency_fft

    m, d = kerr_disc
    x = jnp.array([0.0, 1000.0, np.deg2rad(45.0), 0.0])
    ring = gt.RingCorona(r=3.0, h=4.0)
    radii = jnp.linspace(gt.isco(m) + 1e-2, 30.0, 5)
    bins = jnp.linspace(0.0, 1.5, 40)
    tbins = jnp.linspace(0.0, 150.0, 100)

    taus = {}
    for nb in (10, 20):
        tb, eb, flux = gt.lag_frequency(
            m,
            x,
            d,
            ring,
            bins=bins,
            tbins=tbins,
            radii=radii,
            N=12,
            N_extrema=5,
            Ng=24,
            n_radii=60,
            profile_kwargs=dict(n_beta=nb, n_angles=128),
        )
        freq, tau = _lag_frequency_fft(tbins, jnp.nan_to_num(jnp.asarray(flux)))
        freq, tau = np.asarray(freq), np.asarray(tau)
        lo = (freq > 0) & (freq < 2e-3)
        taus[nb] = float(np.nanmean(tau[lo]))
    # doubling the slice count moves the low-frequency lag by < 2%
    np.testing.assert_allclose(taus[10], taus[20], rtol=2e-2)


@pytest.mark.slow
def test_refine_for_target_differentiable(kerr_disc):
    """Differentiable target polish: forward-mode
    gradient of the off-axis continuum arrival time w.r.t. the corona
    position (r, h) matches central finite differences."""
    from gradus_tpu.transfer.targets import optimize_for_target, refine_for_target

    m, _ = kerr_disc
    x0 = jnp.array([0.0, 1000.0, np.deg2rad(45.0), 0.0])

    def src_position(rh):
        r_c, h = rh
        R = jnp.sqrt(r_c**2 + h**2)
        theta = jnp.arctan2(r_c, h)
        return jnp.stack([R, theta, jnp.asarray(0.0, rh.dtype)])

    rh0 = jnp.asarray([3.0, 6.0])
    # concrete pattern-search seed (host loop, run once off the traced path)
    al, be, _, acc = optimize_for_target(src_position(rh0), m, x0)
    ab0 = jnp.asarray([float(al), float(be)])

    def arrival_time(rh):
        _, t_star, _ = refine_for_target(src_position(rh), m, x0, ab0, iters=3)
        return t_star

    t0 = float(arrival_time(rh0))
    assert 950.0 < t0 < 1100.0

    # the polish lands within the softmin model's bias floor (~sample spacing)
    _, _, d_fin = refine_for_target(src_position(rh0), m, x0, ab0, iters=3)
    assert float(d_fin) < 0.05

    g = np.asarray(jax.jacfwd(arrival_time)(rh0))
    assert np.isfinite(g).all()
    # FD needs a step well above the saved-trajectory quantization noise of
    # the primal (~0.01 t_g); the analytic eikonal derivative is exact
    eps = 5e-2
    for k in range(2):
        u = np.zeros(2)
        u[k] = eps
        fd = (
            float(arrival_time(rh0 + jnp.asarray(u)))
            - float(arrival_time(rh0 - jnp.asarray(u)))
        ) / (2 * eps)
        np.testing.assert_allclose(g[k], fd, rtol=8e-2, atol=5e-3)

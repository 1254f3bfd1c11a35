"""Reverberation: lag-frequency spectra from the 2D (g, t) lag transfer.

Reference: `src/reverberation.jl`. The impulse response ψ(t) = Σ_g flux(g, t)
is zero-padded to 1/flo, FFT'd, and the lag is τ(f) = -atan(Im𝔉ψ/(1+Re𝔉ψ))/(2πf)
(reverberation.jl:17-45).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from gradus_tpu.corona.emissivity import emissivity_profile
from gradus_tpu.corona.profiles import AnalyticRadialDiscProfile
from gradus_tpu.corona.spectra import PowerLawSpectrum
from gradus_tpu.metrics.base import AbstractMetric
from gradus_tpu.transfer.cunningham import transferfunctions
from gradus_tpu.transfer.integration import integrate_lagtransfer
from gradus_tpu.transfer.solvers import find_offset_for_radius

__all__ = ["lag_frequency", "continuum_time", "lagtransfer", "binflux"]


def continuum_time(m: AbstractMetric, x, model, rho_factor: float = 1e-3):
    """Coordinate arrival time of the direct corona → observer ray.

    The reference Nelder-Meads (α, β) to minimise the closest approach to the
    source (`optimize_for_target`, precision-solvers.jl:453-546). For an
    on-axis source this is equivalent to root-finding the ray that crosses the
    source's height plane at the source's cylindrical radius — which reuses
    the batched offset solver. Off-axis sources (ring / disc coronae) go
    through the generic batched `optimize_for_target`."""
    from gradus_tpu.corona.models import RingCorona, DiscCorona
    from gradus_tpu.geometry.discs import DatumPlane

    x_src, _ = model.sample_position_velocity(m)
    if isinstance(model, (RingCorona, DiscCorona)):
        from gradus_tpu.transfer.targets import optimize_for_target, refine_for_target

        al, be, gp, _ = optimize_for_target(x_src[1:4], m, x)
        # differentiable Gauss-Newton polish: tightens the pattern-search
        # quantization and lets gradients flow to the corona parameters
        # through the target position
        _, t_star, _ = refine_for_target(
            x_src[1:4], m, x, jnp.stack([al, be]), iters=2
        )
        return t_star
    z_src = x_src[1] * jnp.cos(x_src[2])
    rho_src = jnp.maximum(x_src[1] * jnp.sin(x_src[2]), rho_factor * x_src[1])
    plane = DatumPlane(z_src)
    r_off, gp, resid = find_offset_for_radius(
        m,
        x,
        plane,
        jnp.atleast_1d(rho_src),
        jnp.atleast_1d(jnp.asarray(np.pi / 2, x.dtype)),
    )
    return gp.x[0, 0]


def lag_frequency(*args, **kwargs):
    """Two dispatches (reference parity):

    - lag_frequency(t, flux2d, flo=5e-5) → (freq, τ)
    - lag_frequency(m, x, d, model; ...) → (tbins, bins, flux2d)
    """
    if isinstance(args[0], AbstractMetric):
        return _lag_frequency_model(*args, **kwargs)
    return _lag_frequency_fft(*args, **kwargs)


def _lag_frequency_fft(t, f, flo: float = 5e-5, R: float = 1.0, n_ext: int | None = None):
    """FFT lag spectrum of the impulse response (reverberation.jl:17-45).

    Device-resident and differentiable: only the padded length (a shape) is
    computed on host. Pass `n_ext` explicitly when `t` is a traced value."""
    t = jnp.asarray(t)
    f = jnp.asarray(f)
    if f.ndim == 2:
        # impulse response: NaN-tolerant sum over the energy axis
        psi = jnp.nansum(f, axis=0)
    else:
        psi = f
    if n_ext is None:
        # padded-grid length: len(arange(t₀, 1/flo + dt, dt)) — shape only, host-side
        t_host = np.asarray(t)
        dt_host = float(t_host[1] - t_host[0])
        n_ext = len(np.arange(float(t_host.min()), 1.0 / flo + dt_host, dt_host))
    dt = t[1] - t[0]
    psi_ext = jnp.zeros(n_ext, psi.dtype).at[: psi.shape[0]].set(psi)

    freq = jnp.fft.fftfreq(n_ext, dt)
    F = R * jnp.fft.fft(psi_ext)
    half = n_ext // 2
    phase = jnp.arctan(jnp.imag(F[:half]) / (1.0 + jnp.real(F[:half])))
    tau = phase / (2 * jnp.pi * freq[:half])
    return freq[:half], -tau


def _lag_frequency_model(
    m: AbstractMetric,
    x,
    d,
    model,
    *,
    n_radii: int = 6000,
    bins=None,
    tbins=None,
    spectrum=PowerLawSpectrum(2.0),
    radii=None,
    n_samples: int = 1000,
    profile_kwargs: dict | None = None,
    **kwargs,
):
    from gradus_tpu.orbits.special_radii import isco as _isco

    x = jnp.asarray(x)
    if bins is None:
        bins = jnp.linspace(0.0, 1.5, 500, dtype=x.dtype)
    if tbins is None:
        tbins = jnp.linspace(0.0, 1000.0, 2000, dtype=x.dtype)
    if radii is None:
        radii = jnp.linspace(_isco(m) + 1e-2, 300.0, 100, dtype=x.dtype)

    prof = emissivity_profile(
        m, d, model, spectrum, n_samples=n_samples, **(profile_kwargs or {})
    )
    t0 = continuum_time(m, x, model)
    tfs = transferfunctions(m, x, d, radii=radii, **kwargs)
    if hasattr(prof, "time_emissivity_curve"):
        # ring / disc corona: spread flux over the ε(t | rₑ) light curve.
        # The time-dependent integrator materialises an
        # (n_radii × n_tbins × n_bins) tensor, so very large n_radii requests
        # are clamped — loudly, not silently.
        from gradus_tpu.transfer.integration import integrate_lagtransfer_timedep

        if n_radii > 400:
            import warnings

            warnings.warn(
                f"integrate_lagtransfer_timedep: clamping n_radii {n_radii} → 400 "
                "(the time-dependent path materialises an n_radii × n_tbins × "
                "n_bins tensor); pass n_radii <= 400 to silence",
                stacklevel=2,
            )
        flux = integrate_lagtransfer_timedep(
            prof, tfs, bins, tbins, t0=t0, n_radii=min(n_radii, 400)
        )
    else:
        flux = integrate_lagtransfer(
            prof, tfs, bins, tbins, t0=t0, n_radii=n_radii
        )
    flux = jnp.where(flux == 0, jnp.nan, flux)
    return tbins, bins, flux


def lagtransfer(m, x, d, model, **kwargs):
    """Observer-to-disc + corona-to-disc combination; binning-method analogue
    of the lag transfer (reference transfer-functions-2d.jl:160-216).
    Returns a dict with the traced components for `binflux`."""
    from gradus_tpu.camera.planes import PolarPlane
    from gradus_tpu.camera.grids import GeometricGrid
    from gradus_tpu.camera.impact import map_impact_parameters
    from gradus_tpu.integrate.tracing import trace_geodesics, domain_upper_hemisphere
    from gradus_tpu.integrate.status import StatusCodes

    from gradus_tpu.corona.samplers import (
        BothHemispheres,
        EvenSampler,
        sky_angles_to_velocity,
    )
    from gradus_tpu.utils.linalg import equatorial_project

    x = jnp.asarray(x)
    plane = kwargs.pop(
        "plane", PolarPlane(GeometricGrid(), Nr=800, Ntheta=800, r_max=50.0)
    )
    max_t = kwargs.pop("max_t", 2.0 * x[1])
    n_samples = kwargs.pop("n_samples", 10000)
    # reference default sampler: EvenSampler(BothHemispheres, Random)
    # (transfer-functions-2d.jl:171); pass sampler=None for the fast 1D
    # δ-sweep point-source emissivity profile
    sampler = kwargs.pop("sampler", None)
    prof = emissivity_profile(m, d, model, n_samples=n_samples, sampler=sampler)

    # raw coronal (r, t) hit samples: the reference's `binflux` interpolates
    # arrival times over the traced coronal geodesic points directly
    # (AnalyticRadialDiscProfile(cg), corona/analytic.jl:11-16), NOT over a
    # binned profile — keep the same semantics here
    corona_sampler = sampler or EvenSampler(domain=BothHemispheres())
    x_src, v_src = model.sample_position_velocity(m)
    idx = jnp.arange(1, n_samples + 1, dtype=x.dtype)
    elev, az = corona_sampler.sample_angles(idx, n_samples)
    v_c = sky_angles_to_velocity(m, x_src, v_src, elev, az)
    gps_c = trace_geodesics(
        m,
        jnp.broadcast_to(x_src, v_c.shape),
        v_c,
        (0.0, max_t),
        geometry=d,
        terminate_fns=(domain_upper_hemisphere(),),
        constrain=False,
    )
    hit_c = gps_c.status == StatusCodes.IntersectedWithGeometry
    r_c = jnp.where(hit_c, equatorial_project(gps_c.x), jnp.inf)
    order = jnp.argsort(r_c)
    corona_r = r_c[order]
    corona_t = gps_c.x[..., 0][order]
    corona_n = jnp.sum(hit_c)

    alpha, beta = plane.impact_parameters()
    areas = plane.unnormalized_areas()
    v = map_impact_parameters(m, x, alpha, beta)
    xs = jnp.broadcast_to(x, v.shape)
    gps = trace_geodesics(
        m,
        xs,
        v,
        (0.0, max_t),
        geometry=d,
        chart_outer=1.1 * float(x[1]),
        terminate_fns=(domain_upper_hemisphere(),),
    )
    hit = gps.status == StatusCodes.IntersectedWithGeometry
    return dict(
        max_t=max_t,
        x=x,
        areas=areas,
        profile=prof,
        points=gps,
        hit=hit,
        metric=m,
        corona_r=corona_r,
        corona_t=corona_t,
        corona_n=corona_n,
    )


def binflux(
    tf: dict,
    profile=None,
    E0: float = 6.4,
    N_E: int = 300,
    N_t: int = 300,
    e_bins=None,
    t_bins=None,
    axis_name=None,
):
    """Bin the lag transfer into (t, E) flux (reference `binflux`,
    transfer-functions-2d.jl:218-241): f = g³·ε·area.

    Device-resident scatter-add 2D histogram: jittable,
    differentiable w.r.t. the flux weights, and shardable — pass ``axis_name``
    inside `shard_map` to psum the histogram (and the flux normalisation)
    across devices. Bin edges are computed from the data when not supplied;
    pass explicit ``e_bins``/``t_bins`` under jit to keep edges static."""
    from gradus_tpu.redshift import redshift_pointfunction
    from gradus_tpu.utils.linalg import equatorial_project
    import jax

    m = tf["metric"]
    gps = tf["points"]
    hit = tf["hit"]
    if profile is None:
        # reference default (transfer-functions-2d.jl:217-220): ε(r) = r⁻³
        # with coordinate times interpolated over the RAW traced coronal
        # geodesic points, clamped outside their radial range
        # (AnalyticRadialDiscProfile(cg), corona/analytic.jl:11-33) — NOT the
        # traced emissivity (pass `profile=tf["profile"]` for that)
        from gradus_tpu.utils.interp import masked_sorted_interp

        t_fn = lambda r: masked_sorted_interp(
            jnp.asarray(r), tf["corona_r"], tf["corona_t"], tf["corona_n"]
        )
        prof = AnalyticRadialDiscProfile(lambda r: r**-3.0, t_fn)
    else:
        prof = profile
    r = equatorial_project(gps.x)
    t = prof.coordtime_at(r) + gps.x[..., 0]
    eps = prof.emissivity_at(r)
    pf = redshift_pointfunction(m, tf["x"])
    g = pf(m, gps, tf["max_t"])
    f = jnp.where(hit, g**3 * eps * tf["areas"], 0.0)
    total = jnp.sum(f)
    if axis_name is not None:
        total = jax.lax.psum(total, axis_name)
    F = f / total

    E = g * E0
    msk = hit & jnp.isfinite(t) & jnp.isfinite(E)

    def _minmax(v):
        lo = jnp.min(jnp.where(msk, v, jnp.inf))
        hi = jnp.max(jnp.where(msk, v, -jnp.inf))
        if axis_name is not None:
            lo = jax.lax.pmin(lo, axis_name)
            hi = jax.lax.pmax(hi, axis_name)
        return lo, hi

    if e_bins is None:
        e_lo, e_hi = _minmax(E)
        e_bins = jnp.linspace(e_lo, e_hi, N_E)
    else:
        e_bins = jnp.asarray(e_bins)
        N_E = e_bins.shape[0]
    if t_bins is None:
        t_lo, t_hi = _minmax(t)
        t_bins = jnp.linspace(t_lo, t_hi, N_t)
    else:
        t_bins = jnp.asarray(t_bins)
        N_t = t_bins.shape[0]

    ie = jnp.clip(jnp.searchsorted(e_bins, E, side="right") - 1, 0, N_E - 2)
    it = jnp.clip(jnp.searchsorted(t_bins, t, side="right") - 1, 0, N_t - 2)
    flat = (ie * (N_t - 1) + it).ravel()
    w = jnp.where(msk, F, 0.0).ravel()
    H = jax.ops.segment_sum(w, flat, num_segments=(N_E - 1) * (N_t - 1))
    H = H.reshape(N_E - 1, N_t - 1)
    if axis_name is not None:
        H = jax.lax.psum(H, axis_name)
    de = e_bins[1] - e_bins[0]
    dt = t_bins[1] - t_bins[0]
    H = H / (de * dt)
    H = jnp.where(H == 0, jnp.nan, H)
    return t_bins - tf["x"][1], e_bins, H

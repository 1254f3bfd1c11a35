"""Corona → disc illumination: emissivity profiles.

Reference: `src/corona/emissivity.jl`, `src/corona/models/lamp-post.jl:77-154`
(point-source sweep, Dauser et al. 2013 emissivity) and `src/corona/radial.jl`
(Monte-Carlo photon-count binning). Both paths are single batched traces here;
the radial binning is a fixed-size `segment_sum`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from gradus_tpu.corona.models import LampPostModel, BeamedPointSource
from gradus_tpu.corona.profiles import RadialDiscProfile
from gradus_tpu.corona.samplers import EvenSampler, BothHemispheres, sky_angles_to_velocity
from gradus_tpu.corona.spectra import PowerLawSpectrum
from gradus_tpu.geodesics.tetrads import dotproduct, lnrbasis
from gradus_tpu.integrate.status import StatusCodes
from gradus_tpu.integrate.tracing import trace_geodesics, domain_upper_hemisphere
from gradus_tpu.metrics.base import AbstractMetric
from gradus_tpu.redshift import keplerian_velocity_projector
from gradus_tpu.utils.linalg import equatorial_project

__all__ = [
    "proper_area",
    "energy_ratio",
    "lorentz_factor",
    "local_velocity",
    "emissivity_profile",
    "tracecorona",
    "point_source_emissivity_profile",
    "bin_corona_hits",
]


def proper_area(m: AbstractMetric, x):
    """2π√(g_rr g_φφ) — proper area element of an annulus
    (reference `_proper_area`, emissivity.jl:170-175)."""
    g = m.components(x[..., 1], x[..., 2])
    return 2 * jnp.pi * jnp.sqrt(g[..., 1] * g[..., 3])


def local_velocity(m: AbstractMetric, x, v, component: int):
    """LNRF velocity component (Bardeen+73 eq. 3.9; reference
    flux-calculations.jl:13-29)."""
    basis = lnrbasis(m, x)
    vt = jnp.einsum(
        "...i,...i->...", basis[0], v, precision=jax.lax.Precision.HIGHEST
    )
    vi = jnp.einsum(
        "...i,...i->...", basis[component], v, precision=jax.lax.Precision.HIGHEST
    )
    return vi / vt


def lorentz_factor(m: AbstractMetric, x, v):
    """γ = (1 − (𝒱^φ)²)^(-1/2) (reference flux-calculations.jl:39-44)."""
    vphi = local_velocity(m, x, v, 3)
    return 1.0 / jnp.sqrt(1.0 - vphi**2)


def energy_ratio(m: AbstractMetric, gp, v_src, v_disc):
    """g = E_src / E_disc (reference `energy_ratio`,
    flux-calculations.jl:100-112 — note the reference's inverted convention)."""
    g_src = m.metric(gp.x_init)
    e_src = dotproduct(g_src, gp.v_init, v_src)
    g_disc = m.metric(gp.x)
    e_disc = dotproduct(g_disc, gp.v, v_disc)
    return e_src / e_disc


@functools.partial(
    jax.jit,
    static_argnames=("n_samples", "delta_min", "delta_max", "lam_max", "chart_outer"),
)
def point_source_emissivity_profile(
    m: AbstractMetric,
    d,
    model,
    spectrum=PowerLawSpectrum(2.0),
    *,
    n_samples: int = 1000,
    delta_min: float = 0.01,
    delta_max: float = 179.99,
    lam_max: float = 10000.0,
    chart_outer: float = 12000.0,
) -> RadialDiscProfile:
    """1D polar-angle sweep from an on-axis point source; Dauser et al. (2013)
    emissivity ε = weight·sin(δ)·g^(−Γ)/(A·γ) per annulus
    (reference `_point_source_symmetric_emissivity_profile`,
    lamp-post.jl:77-154)."""
    x, v_src = model.sample_position_velocity(m)
    deltas = jnp.deg2rad(jnp.linspace(delta_min, delta_max, n_samples)).astype(x.dtype)
    v = sky_angles_to_velocity(m, x, v_src, deltas, 0.0)
    xs = jnp.broadcast_to(x, v.shape)
    gps = trace_geodesics(
        m,
        xs,
        v,
        (0.0, lam_max),
        geometry=d,
        chart_outer=chart_outer,
        terminate_fns=(domain_upper_hemisphere(),),
        constrain=False,
    )
    hit = gps.status == StatusCodes.IntersectedWithGeometry
    r = equatorial_project(gps.x)
    t = gps.x[..., 0]

    disc_velocity = keplerian_velocity_projector(m)
    v_disc = disc_velocity(gps.x)
    g = energy_ratio(m, gps, v_src, v_disc)
    gam = lorentz_factor(m, gps.x, v_disc)

    # sort hits by radius (invalid → +inf tail)
    key = jnp.where(hit, r, jnp.inf)
    order = jnp.argsort(key)
    r_s = key[order]
    t_s = t[order]
    d_s = deltas[order]
    g_s = g[order]
    gam_s = gam[order]
    n = jnp.sum(hit)

    # neighbour differences with reference edge handling
    # (lamp-post.jl:128-141): interior uses centred |Δ|, edges one-sided
    N = n_samples
    i = jnp.arange(N)
    ip = jnp.clip(i + 1, 0, n - 1)
    im = jnp.clip(i - 1, 0, None)
    first = i == 0
    last = i == n - 1

    def diffs(a):
        d_int = (jnp.abs(a[i] - a[ip]) + jnp.abs(a[i] - a[im])) / 2.0
        d_first = jnp.abs(a[jnp.minimum(0, N - 1)] - a[jnp.minimum(1, N - 1)])
        d_last = jnp.abs(a[i] - a[im])
        return jnp.where(first, d_first, jnp.where(last, d_last, d_int))

    dr = diffs(r_s)
    dd = diffs(d_s) / 2.0  # reference divides angle weight by 4 (two sums of 2)

    x_hit = jax.tree_util.tree_map(lambda a: a[order], gps.x)
    A = proper_area(m, x_hit) * dr
    A = jnp.where(A <= 0, 1.0, A)
    eps = dd * jnp.abs(jnp.sin(d_s)) * spectrum(g_s) / (A * gam_s)
    eps = jnp.where(jnp.arange(N) < n, eps, 0.0)

    return RadialDiscProfile(radii=r_s, eps=eps, t=t_s, n=n)


@functools.partial(
    jax.jit, static_argnames=("sampler", "n_samples", "lam_max", "n_bins")
)
def tracecorona_profile(
    m: AbstractMetric,
    d,
    model,
    spectrum=PowerLawSpectrum(2.0),
    *,
    sampler=None,
    n_samples: int = 1024,
    lam_max: float = 10000.0,
    n_bins: int = 100,
) -> RadialDiscProfile:
    """Monte-Carlo sky sampling + radial photon-count binning
    (reference `tracecorona` corona-models.jl:164-190 + `RadialDiscProfile`
    binning radial.jl:39-125): ε = N·I(g)/(A·γ) per radial bin."""
    if sampler is None:
        sampler = EvenSampler(domain=BothHemispheres())
    x, v_src = model.sample_position_velocity(m)
    idx = jnp.arange(1, n_samples + 1, dtype=x.dtype)
    elev, az = sampler.sample_angles(idx, n_samples)
    v = sky_angles_to_velocity(m, x, v_src, elev, az)
    xs = jnp.broadcast_to(x, v.shape)
    gps = trace_geodesics(
        m,
        xs,
        v,
        (0.0, lam_max),
        geometry=d,
        terminate_fns=(domain_upper_hemisphere(),),
        constrain=False,
    )
    hit = gps.status == StatusCodes.IntersectedWithGeometry
    return bin_corona_hits(m, spectrum, gps, v_src, hit, n_bins=n_bins)


def bin_corona_hits(
    m: AbstractMetric,
    spectrum,
    gps,
    v_src,
    hit,
    *,
    n_bins: int,
    axis_name: str | None = None,
) -> RadialDiscProfile:
    """Radial photon-count binning of corona-trace hits into a
    `RadialDiscProfile` (reference `_build_radial_profile`, radial.jl:39-93).

    With `axis_name` (inside `shard_map` over a sharded sample axis) the bin
    range is `pmin`/`pmax`-agreed and the (count, g, t) bin sums are
    `psum`-reduced over the mesh, so every device returns the identical global
    profile."""
    from jax import lax

    r = equatorial_project(gps.x)
    t = gps.x[..., 0]

    disc_velocity = keplerian_velocity_projector(m)
    v_disc_pt = disc_velocity(gps.x)
    g_pt = energy_ratio(m, gps, v_src, v_disc_pt)

    # geometric radial bins over the (global) hit range
    r_lo = jnp.min(jnp.where(hit, r, jnp.inf))
    r_hi = jnp.max(jnp.where(hit, r, -jnp.inf))
    if axis_name is not None:
        r_lo = lax.pmin(r_lo, axis_name)
        r_hi = lax.pmax(r_hi, axis_name)
    K = (r_hi / r_lo) ** (1.0 / (n_bins - 1))
    bins = r_lo * K ** jnp.arange(n_bins)

    bi = jnp.clip(jnp.searchsorted(bins, r), 0, n_bins - 1)
    w = hit.astype(r.dtype)
    counts = jnp.zeros(n_bins, r.dtype).at[bi].add(w)
    g_sum = jnp.zeros(n_bins, r.dtype).at[bi].add(jnp.where(hit, g_pt, 0.0))
    t_sum = jnp.zeros(n_bins, r.dtype).at[bi].add(jnp.where(hit, t, 0.0))
    if axis_name is not None:
        counts = lax.psum(counts, axis_name)
        g_sum = lax.psum(g_sum, axis_name)
        t_sum = lax.psum(t_sum, axis_name)
    cnt_safe = jnp.maximum(counts, 1.0)
    g_mean = g_sum / cnt_safe
    t_mean = t_sum / cnt_safe

    R = bins
    r_prev = jnp.concatenate([jnp.zeros(1, bins.dtype), bins[:-1]])
    dr = R - r_prev
    x_eq = jnp.stack(
        [jnp.zeros_like(R), R, jnp.full_like(R, jnp.pi / 2), jnp.zeros_like(R)],
        axis=-1,
    )
    v_disc = disc_velocity(x_eq)
    gam = lorentz_factor(m, x_eq, v_disc)
    A = dr * proper_area(m, x_eq)
    eps = counts * spectrum(g_mean) / (A * gam)
    valid = counts > 0
    key = jnp.where(valid, bins, jnp.inf)
    order = jnp.argsort(key)
    return RadialDiscProfile(
        radii=key[order],
        eps=jnp.where(valid, eps, 0.0)[order],
        t=t_mean[order],
        n=jnp.sum(valid),
    )


tracecorona = tracecorona_profile


def emissivity_profile(
    m: AbstractMetric,
    d,
    model,
    spectrum=PowerLawSpectrum(2.0),
    *,
    sampler=None,
    n_samples: int = 1000,
    **kwargs,
) -> RadialDiscProfile:
    """Dispatch: fast 1D sweep for on-axis point sources when no sampler is
    given; β-slice arm tracing for ring/disc coronae; else Monte-Carlo
    (reference `emissivity_profile`, emissivity.jl:133-168 +
    extended.jl:133-143,186-200)."""
    from gradus_tpu.corona.models import RingCorona, DiscCorona

    if sampler is None and isinstance(model, (LampPostModel, BeamedPointSource)):
        return point_source_emissivity_profile(
            m, d, model, spectrum, n_samples=n_samples, **kwargs
        )
    if sampler is None and isinstance(model, RingCorona):
        from gradus_tpu.corona.extended import (
            ring_corona_profile,
            ring_corona_profile_hybrid,
        )

        # DEFAULT: the near-field hybrid. The plain
        # β-slice fan estimates ε through fold caustics with an O(√Δβ) error
        # that wobbles ±25% at |r − r_ring| ≲ 1 r_g; the hybrid serves that
        # band from the slice-free adaptive-sky estimator and the fan
        # everywhere else. `near_field="fan"` opts out (cheaper; fine when
        # only the far field matters).
        if kwargs.pop("near_field", "hybrid") == "hybrid":
            return ring_corona_profile_hybrid(m, d, model, spectrum, **kwargs)
        return ring_corona_profile(m, d, model, spectrum, **kwargs)
    if sampler is None and isinstance(model, DiscCorona):
        from gradus_tpu.corona.extended import disc_corona_profile

        # the ring-stack fan: each ring's near-field wobble is diluted by the
        # flux-weighted stack average; a per-ring hybrid would run n_rings
        # host-driven adaptive skies (pass near_field="hybrid" to force it)
        if kwargs.pop("near_field", "fan") == "hybrid":
            from gradus_tpu.corona.extended import disc_corona_profile_hybrid

            return disc_corona_profile_hybrid(m, d, model, spectrum, **kwargs)
        return disc_corona_profile(m, d, model, spectrum, **kwargs)
    return tracecorona_profile(
        m, d, model, spectrum, sampler=sampler, n_samples=n_samples, **kwargs
    )

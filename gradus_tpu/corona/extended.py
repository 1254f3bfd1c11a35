"""Extended corona machinery: ring and disc coronae with time-dependent
emissivity profiles.

Reference: `src/corona/models/ring.jl` (β-slice "beachball" arm tracing:
`corona_arms` :456, `_ring_arm!` :388, `_split_arms_indices` :346,
`split_into_branches` :566) and `src/corona/radial.jl:165-325`
(`TimeDependentRadialDiscProfile`, `RingCoronaProfile`, `DiscCoronaProfile`).

Batched redesign. The reference traces each β slice sequentially per CPU
thread with a reusable integrator, then refines the slice's extremal radii
with a host-driven golden-section optimiser (ring.jl:169-236, 2×80 extra
solves per slice). Here every (ring, β slice, local angle) triple is ONE
batched trace — a dense fan of angles per slice resolves the extrema to the
fan spacing without any host round-trips — and the arm splitting, per-arm
radial sorting, and Dauser emissivity all run as fixed-shape vmapped array
programs. A disc corona's full ring stack traces in a single launch.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from gradus_tpu.corona.spectra import PowerLawSpectrum
from gradus_tpu.geodesics.equation import constrain_all
from gradus_tpu.geodesics.tetrads import propernorm
from gradus_tpu.integrate.status import StatusCodes
from gradus_tpu.integrate.tracing import trace_geodesics, domain_upper_hemisphere
from gradus_tpu.metrics.base import AbstractMetric
from gradus_tpu.utils.interp import masked_sorted_interp
from gradus_tpu.utils.linalg import equatorial_project

__all__ = [
    "stationary_velocity",
    "co_rotating_velocity",
    "default_beta_angles",
    "rodrigues_rotate",
    "rotated_sky_angles",
    "TimeDependentRadialDiscProfile",
    "RingCoronaProfile",
    "DiscCoronaProfile",
    "NearFieldBlendedProfile",
    "ring_corona_profile",
    "ring_corona_profile_hybrid",
    "disc_corona_profile",
    "disc_corona_profile_hybrid",
    "DiscCoronaHybridProfile",
]


# ---------------------------------------------------------------------------
# Source velocities (reference `SourceVelocities`, extended.jl:1-46)
# ---------------------------------------------------------------------------


def stationary_velocity(m: AbstractMetric, x):
    """v = (1,0,0,0)/√(-g_tt) (reference `SourceVelocities.stationary`)."""
    g = m.components(x[1], x[2])
    v = jnp.zeros(4, x.dtype).at[0].set(1.0)
    return v / jnp.sqrt(-g[0])


def co_rotating_velocity(m: AbstractMetric, x, isco_r=None):
    """Keplerian co-rotation of the cylinder through x (reference
    `SourceVelocities.co_rotating`, extended.jl:20-25): the circular-orbit
    four-velocity at max(isco, r sinθ) scaled by sinθ, unit-normalized, then
    re-constrained to g_μν v^μ v^ν = −1."""
    from gradus_tpu.orbits.circular import CircularOrbits
    from gradus_tpu.orbits.special_radii import isco as _isco

    if isco_r is None:
        isco_r = _isco(m)
    sin_t = jnp.sin(x[2])
    r_kep = jnp.maximum(isco_r, x[1] * sin_t)
    v = CircularOrbits.fourvelocity(m, r_kep) * sin_t
    v = v / jnp.sqrt(jnp.abs(propernorm(m.metric(x), v)))
    return constrain_all(m, x, v, mu=1.0)


def source_velocity(m: AbstractMetric, x, vf: str):
    if vf == "co_rotating":
        return co_rotating_velocity(m, x)
    if vf == "stationary":
        return stationary_velocity(m, x)
    raise ValueError(f"unknown source velocity function {vf!r}")


def default_beta_angles(n: int = 100, dtype=jnp.float64):
    """Default β slice angles (reference `DEFAULT_β_ANGLES`, extended.jl:49-53):
    n angles evenly in [0, π)."""
    return jnp.linspace(0.0, jnp.pi - jnp.pi / n, n, dtype=dtype)


# ---------------------------------------------------------------------------
# Slice geometry: rotate the poloidal fan around the local radial axis
# ---------------------------------------------------------------------------


def rodrigues_rotate(k, v, theta):
    """Rodrigues rotation of v by theta about unit axis k
    (reference emissivity.jl:220)."""
    c = jnp.cos(theta)[..., None]
    s = jnp.sin(theta)[..., None]
    kxv = jnp.cross(jnp.broadcast_to(k, v.shape), v)
    kdv = jnp.sum(k * v, axis=-1, keepdims=True)
    return v * c + kxv * s + k * kdv * (1.0 - c)


def _cart_local_direction(theta, phi):
    return jnp.stack(
        [
            jnp.sin(theta) * jnp.cos(phi),
            jnp.sin(theta) * jnp.sin(phi),
            jnp.cos(theta),
        ],
        axis=-1,
    )


def rotated_sky_angles(theta0, deltas, betas):
    """Local-sky (θ, φ) of the fan directions: poloidal angles `deltas` offset
    from the axis direction θ₀, rotated by each slice angle β about the axis
    (reference `rotatorfunctor`, ring.jl:104-119). Returns (th, ph) arrays of
    shape (n_beta, n_delta)."""
    k = _cart_local_direction(theta0, 0.0)
    q = _cart_local_direction(deltas + theta0, 0.0)  # (n_delta, 3)
    b = rodrigues_rotate(
        k, q[None, :, :], jnp.asarray(betas)[:, None]
    )  # (n_beta, n_delta, 3)
    ph = jnp.arctan2(b[..., 1], b[..., 0])
    th = jnp.arctan2(jnp.sqrt(b[..., 0] ** 2 + b[..., 1] ** 2), b[..., 2])
    return th, ph


# ---------------------------------------------------------------------------
# Time-dependent radial disc profile
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TimeDependentRadialDiscProfile:
    """Stack of (radii, t, ε) branches — one branch per β slice and arm —
    each sorted by radius with a valid prefix count (+inf tail), replacing the
    reference's ragged Vector{Vector} (radial.jl:165-230).

    `emissivity_at` is the time-integrated ε(ρ) (sum of branch interpolants);
    `time_points_at` yields the branch-wise (t, ε) samples at ρ from which the
    ε(t | ρ) light curve is interpolated (reference `emissivity_interp`)."""

    radii: Any  # (S, P)
    t: Any  # (S, P)
    eps: Any  # (S, P)
    n: Any  # (S,) int32 valid counts

    def _branch_at(self, values, r):
        def one(radii, vals, n):
            val = masked_sorted_interp(r, radii, vals, n)
            r_hi = radii[jnp.clip(n - 1, 0, radii.shape[0] - 1)]
            ok = (n >= 2) & (r >= radii[0]) & (r <= r_hi)
            return val, ok

        return jax.vmap(one)(self.radii, values, self.n)

    def emissivity_at(self, r):
        """Σ over branches of the in-range ε(ρ) interpolant
        (reference radial.jl:180-189)."""
        r = jnp.asarray(r)
        vals, ok = self._branch_at(self.eps, r)
        return jnp.sum(jnp.where(ok, vals, 0.0), axis=0)

    def coordtime_at(self, r):
        """Branch-averaged arrival time (earliest-to-latest mean) — used when a
        time-dependent profile is consumed by the time-averaged integrators."""
        r = jnp.asarray(r)
        vals, ok = self._branch_at(self.t, r)
        w = ok.astype(vals.dtype)
        return jnp.sum(vals * w, axis=0) / jnp.maximum(jnp.sum(w, axis=0), 1.0)

    def time_points_at(self, r):
        """(t_s, ε_s, valid_s) per branch at scalar radius r
        (reference `emissivity_interp` body, radial.jl:191-209)."""
        ts, ok_t = self._branch_at(self.t, r)
        es, _ = self._branch_at(self.eps, r)
        return ts, es, ok_t

    def time_limits_at(self, r):
        ts, _, ok = self.time_points_at(r)
        tmin = jnp.min(jnp.where(ok, ts, jnp.inf))
        tmax = jnp.max(jnp.where(ok, ts, -jnp.inf))
        has = jnp.any(ok)
        zero = jnp.zeros((), ts.dtype)
        return jnp.where(has, tmin, zero), jnp.where(has, tmax, zero)

    def time_emissivity_curve(self, r, tq):
        """ε(tq | ρ=r): interpolate the branch (t, ε) samples sorted by t;
        zero outside the sampled time support (reference radial.jl:191-209)."""
        ts, es, ok = self.time_points_at(r)
        key = jnp.where(ok, ts, jnp.inf)
        order = jnp.argsort(key)
        ts_s = key[order]
        es_s = jnp.where(ok, es, 0.0)[order]
        nv = jnp.sum(ok)
        val = masked_sorted_interp(tq, ts_s, es_s, nv)
        t_hi = ts_s[jnp.clip(nv - 1, 0, ts_s.shape[0] - 1)]
        in_t = (nv >= 2) & (tq >= ts_s[0]) & (tq <= t_hi)
        return jnp.where(in_t, val, 0.0)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RingCoronaProfile:
    """Left + right longitudinal arms (reference radial.jl:232-279)."""

    left: TimeDependentRadialDiscProfile
    right: TimeDependentRadialDiscProfile

    def emissivity_at(self, r):
        return self.left.emissivity_at(r) + self.right.emissivity_at(r)

    def coordtime_at(self, r):
        tl = self.left.coordtime_at(r)
        tr = self.right.coordtime_at(r)
        return 0.5 * (tl + tr)

    def time_limits_at(self, r):
        l0, l1 = self.left.time_limits_at(r)
        r0, r1 = self.right.time_limits_at(r)
        return jnp.minimum(l0, r0), jnp.maximum(l1, r1)

    def time_emissivity_curve(self, r, tq):
        """Sum of the two arm light-curves (reference `_add_arms`,
        radial.jl:253-271)."""
        return self.left.time_emissivity_curve(r, tq) + self.right.time_emissivity_curve(
            r, tq
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class NearFieldBlendedProfile:
    """RingCoronaProfile with the near-field emissivity served by the
    adaptive-sky estimator.

    Any β-slice fan estimates ε near the source ring through fold caustics
    (each slice's hit-radius support edge has dρ/dδ = 0, so its contribution
    to the β-sum is an integrable 1/√(r − ρ_min(β)) singularity whose
    Riemann-sum error decays only as O(√Δβ) — measured: ±25% wobble at
    r − r_ring < 1 r_g even at 80 slices, vs <1e-3 convergence at
    |r − r_ring| > 1.5). The adaptive sky (corona/adaptive.py) has no slice
    structure at all: it refines 2D sky cells at exactly those caustics and
    deposits footprint-smeared flux into radial bins, so its near-field
    estimate is slice-count independent. This wrapper blends the two with a
    smooth window: adaptive inside the near field, fan outside. The
    time-dependent machinery (lag products) stays fan-based throughout —
    the blend affects `emissivity_at` only.
    """

    fan: RingCoronaProfile
    r_nodes: Any  # (K,) radial nodes of the adaptive near-field ε
    eps_nodes: Any  # (K,)
    lo0: Any  # window: fan below lo0, adaptive within [lo1, hi0], fan above hi1
    lo1: Any
    hi0: Any
    hi1: Any

    def _window(self, r):
        def sstep(u):
            u = jnp.clip(u, 0.0, 1.0)
            return u * u * (3.0 - 2.0 * u)

        up = sstep((r - self.lo0) / jnp.maximum(self.lo1 - self.lo0, 1e-12))
        dn = sstep((self.hi1 - r) / jnp.maximum(self.hi1 - self.hi0, 1e-12))
        return up * dn

    def emissivity_at(self, r):
        r = jnp.asarray(r)
        e_fan = self.fan.emissivity_at(r)
        e_near = jnp.interp(r, self.r_nodes, self.eps_nodes)
        w = self._window(r)
        return w * e_near + (1.0 - w) * e_fan

    def coordtime_at(self, r):
        return self.fan.coordtime_at(r)

    def time_limits_at(self, r):
        return self.fan.time_limits_at(r)

    def time_emissivity_curve(self, r, tq):
        return self.fan.time_emissivity_curve(r, tq)


def ring_corona_profile_hybrid(
    m: AbstractMetric,
    d,
    model,
    spectrum=PowerLawSpectrum(2.0),
    *,
    near_inner: float = 1.2,
    near_outer: float = 1.8,
    n0: int = 24,
    rounds: int = 5,
    max_refine: int = 256,
    n_r_nodes: int = 24,
    **fan_kwargs,
):
    """Ring-corona emissivity profile with adaptive-sky near field.

    Host-driven builder (the adaptive quadtree loop breaks the trace): runs
    the jitted dense-fan profile AND `corona_adaptive_sky`, bins the
    adaptive flux into radial nodes spanning [isco-ish, r_ring + near_outer],
    and returns a `NearFieldBlendedProfile`. Reference swap-point: the
    reference covers this regime with 2×80 extra golden-section solves per
    slice (ring.jl:169-236) and 100 slices; the adaptive sky reaches the
    same rays-budget with slice-free caustic refinement."""
    import numpy as _np

    from gradus_tpu.corona.adaptive import (
        corona_adaptive_sky,
        bin_emissivity_grid,
    )

    fan = ring_corona_profile(m, d, model, spectrum, **fan_kwargs)
    grid, vals, _ = corona_adaptive_sky(
        m, d, model, n0=n0, rounds=rounds, max_refine=max_refine
    )
    rr = float(model.r)
    hi1 = rr + near_outer
    # nodes span from just outside the horizon to the blend top
    r_lo = max(1.05 * float(m.inner_radius()), 1.0)
    r_bins = _np.geomspace(r_lo, hi1 + 0.5, n_r_nodes + 1)
    eps, sa = bin_emissivity_grid(
        m, grid, vals, r_bins, _np.array([0.0, 2 * _np.pi]), spectrum
    )
    centers = _np.sqrt(r_bins[:-1] * r_bins[1:])
    eps_nodes = _np.asarray(eps[:, 0])
    covered = _np.asarray(sa[:, 0]) > 0
    # bins the adaptive sampling never reached fall back to the fan estimate
    fan_vals = _np.asarray(fan.emissivity_at(jnp.asarray(centers)))
    eps_nodes = _np.where(covered, eps_nodes, fan_vals)
    lo0 = centers[0]
    lo1 = min(lo0 + 0.5, rr)
    return NearFieldBlendedProfile(
        fan=fan,
        r_nodes=jnp.asarray(centers),
        eps_nodes=jnp.asarray(eps_nodes),
        lo0=jnp.asarray(lo0),
        lo1=jnp.asarray(lo1),
        hi0=jnp.asarray(rr + near_inner),
        hi1=jnp.asarray(hi1),
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DiscCoronaProfile:
    """Ring stack with r·δr area weights and per-ring propagation delays
    (reference radial.jl:281-325). `rings` is a RingCoronaProfile whose leaves
    carry a leading ring axis."""

    radii: Any  # (R,)
    rings: RingCoronaProfile  # stacked: leaves (R, S, P)
    delays: Any  # (R,) propagation-time offsets

    def _weights(self):
        # trapezoidal ACTUAL ring spacing (the reference's `_ring_weighting`,
        # radial.jl:289-292, assumes uniform radii[2]-radii[1]; identical for
        # linspace stacks up to half-weighted end rings, correct for any
        # spacing)
        r = self.radii
        if r.shape[0] == 1:
            # single-ring stack: no spacing information — unit area weight
            return r
        dr = 0.5 * (
            jnp.concatenate([r[1:2] - r[0:1], r[2:] - r[:-2], r[-1:] - r[-2:-1]])
        )
        return r * dr

    def emissivity_at(self, r):
        vals = jax.vmap(lambda ring: ring.emissivity_at(r))(self.rings)
        w = self._weights()
        return jnp.tensordot(w, vals, axes=(0, 0))

    def coordtime_at(self, r):
        """Flux-weighted mean arrival time over the ring stack (reference
        flux-weights via `emissivity_interp` products, radial.jl:298-305):
        rings that barely illuminate ρ must not drag the mean."""
        t_vals = jax.vmap(lambda ring: ring.coordtime_at(r))(self.rings)
        e_vals = jax.vmap(lambda ring: ring.emissivity_at(r))(self.rings)
        w = self._weights()
        fw = w.reshape((-1,) + (1,) * (e_vals.ndim - 1)) * e_vals
        t_shift = t_vals + self.delays.reshape((-1,) + (1,) * (t_vals.ndim - 1))
        num = jnp.sum(fw * t_shift, axis=0)
        den = jnp.sum(fw, axis=0)
        return jnp.where(den > 0, num / jnp.where(den > 0, den, 1.0),
                         jnp.mean(t_shift, axis=0))

    def time_limits_at(self, r):
        lo, hi = jax.vmap(lambda ring: ring.time_limits_at(r))(self.rings)
        return jnp.min(lo + self.delays), jnp.max(hi + self.delays)

    def time_emissivity_curve(self, r, tq):
        w = self._weights()
        curves = jax.vmap(
            lambda ring, dt: ring.time_emissivity_curve(r, tq - dt)
        )(self.rings, self.delays)
        return jnp.tensordot(w, curves, axes=(0, 0))

    def with_propagation_velocity(self, func):
        """Reference `with_propagation_velocity` (radial.jl:287-289): delays
        dt_i = func(r_i)."""
        return dataclasses.replace(
            self, delays=jnp.asarray(jax.vmap(func)(self.radii), self.radii.dtype)
        )


# ---------------------------------------------------------------------------
# Ring-arm tracing and emissivity
# ---------------------------------------------------------------------------


def _sorted_point_emissivity(m, spectrum, r_s, d_s, g_s, gam_s, n):
    """Dauser emissivity on radius-sorted samples: ε = Δδ·|sinδ|·I(g)/(A·γ)
    with centred interior / one-sided edge differences (reference
    `_point_source_emissivity`, lamp-post.jl:118-154)."""
    N = r_s.shape[0]
    i = jnp.arange(N)
    ip = jnp.clip(i + 1, 0, jnp.maximum(n - 1, 0))
    im = jnp.clip(i - 1, 0, None)
    first = i == 0
    last = i == n - 1

    def diffs(a):
        d_int = (jnp.abs(a[i] - a[ip]) + jnp.abs(a[i] - a[im])) / 2.0
        d_first = jnp.abs(a[0] - a[jnp.minimum(1, N - 1)])
        d_last = jnp.abs(a[i] - a[im])
        return jnp.where(first, d_first, jnp.where(last, d_last, d_int))

    dr = diffs(r_s)
    dd = diffs(d_s) / 2.0
    g = m.components(r_s, jnp.full_like(r_s, jnp.pi / 2))
    area = 2 * jnp.pi * jnp.sqrt(jnp.abs(g[..., 1] * g[..., 3])) * dr
    area = jnp.where(area <= 0, 1.0, area)
    eps = dd * jnp.abs(jnp.sin(d_s)) * spectrum(g_s) / (area * gam_s)
    return jnp.where((i < n) & (n >= 2), eps, 0.0)


def _arm_branch(m, spectrum, rho, t, delta, g, gam, arm_mask):
    """One (slice, arm) → a sorted (radii, t, ε, n) branch row."""
    key = jnp.where(arm_mask, rho, jnp.inf)
    order = jnp.argsort(key)
    r_s = key[order]
    t_s = t[order]
    d_s = delta[order]
    g_s = g[order]
    gam_s = gam[order]
    n = jnp.sum(arm_mask)
    eps = _sorted_point_emissivity(m, spectrum, r_s, d_s, g_s, gam_s, n)
    return r_s, t_s, eps, n


def _split_arms(hit, rho, n_angles):
    """Two-arm split of a slice: samples between the (angle-ordered) minimum-
    and maximum-radius hits form one monotonic arm, the cyclic remainder the
    other (reference `_split_arms_indices`, ring.jl:346-386)."""
    idx = jnp.arange(n_angles)
    imin = jnp.argmin(jnp.where(hit, rho, jnp.inf))
    imax = jnp.argmax(jnp.where(hit, rho, -jnp.inf))
    lo = jnp.minimum(imin, imax)
    hi = jnp.maximum(imin, imax)
    arm_a = hit & (idx > lo) & (idx <= hi)
    arm_b = hit & ~arm_a
    return arm_a, arm_b


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_beta",
        "n_angles",
        "lam_max",
        "chart_outer",
        "vf",
        "n_refine",
    ),
)
def ring_corona_profile(
    m: AbstractMetric,
    d,
    model,
    spectrum=PowerLawSpectrum(2.0),
    *,
    betas=None,
    n_beta: int = 20,
    n_angles: int = 256,
    lam_max: float = 10000.0,
    chart_outer: float = 12000.0,
    vf: str | None = None,
    n_refine: int = 16,
) -> RingCoronaProfile:
    """Emissivity profile of a `RingCorona` (reference `emissivity_profile`
    for RingCorona, extended.jl:133-143 + `corona_arms` ring.jl:456-484).

    All (β slice, local angle) pairs trace in one batch; per slice the hits
    split into two monotonic arms and each arm becomes a time-dependent
    emissivity branch. ``vf`` (jit-static) overrides the model's source
    velocity function ('co_rotating' / 'stationary').

    ``n_refine`` > 0 runs a batched golden-section refinement of each slice's
    extremal-ρ fan directions (reference `_golden_bracket!` toward :minima
    and :maxima, ring.jl:140-236 — the reference spends 2·extrema_iter extra
    solves per slice on exactly this): each slice's hit-radius support edges
    are fold caustics (dρ/dδ = 0) where the fan under-resolves, which is the
    dominant error for the near-field emissivity |r − r_ring| ≲ 1.5 r_g. The
    refinement probes all slices (both targets) in lockstep — `n_refine`
    iterations × one (2·n_beta,)-ray launch — and merges the probe samples
    into the fan before the arm split."""
    if vf is not None:
        model = dataclasses.replace(model, vf=vf)
    x, v_src = model.sample_position_velocity(m)
    if betas is None:
        betas = default_beta_angles(n_beta, x.dtype)
    else:
        betas = jnp.asarray(betas, x.dtype)
    n_beta = betas.shape[0]

    h = 1e-4
    deltas = jnp.linspace(h, 2 * jnp.pi - h, n_angles, dtype=x.dtype)

    from gradus_tpu.corona.samplers import sky_angles_to_velocity
    from gradus_tpu.corona.emissivity import energy_ratio, lorentz_factor
    from gradus_tpu.redshift import keplerian_velocity_projector

    disc_velocity = keplerian_velocity_projector(m)

    def eval_directions(th_flat, ph_flat):
        """(hit, ρ, t, g, γ) for a flat batch of local-sky directions."""
        v = sky_angles_to_velocity(m, x, v_src, th_flat, ph_flat)
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
        rho = equatorial_project(gps.x)
        t = gps.x[..., 0]
        v_disc = disc_velocity(gps.x)
        g = energy_ratio(m, gps, v_src, v_disc)
        gam = lorentz_factor(m, gps.x, v_disc)
        return hit, rho, t, g, gam

    th, ph = rotated_sky_angles(x[2], deltas, betas)  # (n_beta, n_angles)
    hit, rho, t, g, gam = (
        a.reshape(n_beta, n_angles)
        for a in eval_directions(th.ravel(), ph.ravel())
    )
    delta_grid = jnp.broadcast_to(deltas, (n_beta, n_angles))

    if n_refine > 0:
        # ---- per-slice extremal refinement (fold caustics at the support
        # edges; reference `_golden_bracket!`, ring.jl:140-236) -------------
        # Python float (weak) so f32 slices under x64 mode don't promote the
        # golden-section scan carry to f64 (see transfer/cunningham.py _GR)
        gr = 0.6180339887498949
        big = jnp.asarray(jnp.inf, x.dtype)
        sign = jnp.asarray([1.0, -1.0], x.dtype)[:, None]  # (min, max) targets

        def masked_rho(h_, r_):
            return jnp.where(h_, r_, big)  # non-hits are "worse" for min

        # extremal hit indices per slice, both targets: (2, n_beta)
        i_min = jnp.argmin(masked_rho(hit, rho), axis=1)
        i_max = jnp.argmax(jnp.where(hit, rho, -big), axis=1)
        d_ext = jnp.stack(
            [
                jnp.take_along_axis(delta_grid, i_min[:, None], 1)[:, 0],
                jnp.take_along_axis(delta_grid, i_max[:, None], 1)[:, 0],
            ]
        )  # (2, n_beta)
        spacing = deltas[1] - deltas[0]
        a = d_ext - 2.0 * spacing
        b = d_ext + 2.0 * spacing
        c = b - gr * (b - a)
        e = a + gr * (b - a)
        beta2 = jnp.broadcast_to(betas[None, :], (2, n_beta))

        def probe_eval(delta_probe):
            """delta (2, n_beta) → fan-sample tuple at those directions."""
            q = _cart_local_direction(delta_probe + x[2], 0.0)  # (2, nb, 3)
            k = _cart_local_direction(x[2], 0.0)
            bvec = rodrigues_rotate(k, q, beta2)
            php = jnp.arctan2(bvec[..., 1], bvec[..., 0])
            thp = jnp.arctan2(
                jnp.sqrt(bvec[..., 0] ** 2 + bvec[..., 1] ** 2), bvec[..., 2]
            )
            out = eval_directions(thp.ravel(), php.ravel())
            return tuple(o.reshape(2, n_beta) for o in out)

        hc, rc, tc, gc, gmc = probe_eval(c)
        he, re_, te, ge, gme = probe_eval(e)
        fc = sign * masked_rho(hc, rc) * jnp.where(hc, 1.0, sign)
        fe = sign * masked_rho(he, re_) * jnp.where(he, 1.0, sign)

        def step(carry, _):
            a, b, c, e, fc, fe = carry
            left = fc < fe
            a2 = jnp.where(left, a, c)
            b2 = jnp.where(left, e, b)
            c2 = jnp.where(left, b2 - gr * (b2 - a2), e)
            e2 = jnp.where(left, c, a2 + gr * (b2 - a2))
            probe = jnp.where(left, c2, e2)
            hp, rp, tp, gp_, gmp = probe_eval(probe)
            fp = sign * masked_rho(hp, rp) * jnp.where(hp, 1.0, sign)
            fc2 = jnp.where(left, fp, fe)
            fe2 = jnp.where(left, fc, fp)
            return (a2, b2, c2, e2, fc2, fe2), (probe, hp, rp, tp, gp_, gmp)

        _, scanned = jax.lax.scan(
            step, (a, b, c, e, fc, fe), None, length=n_refine
        )

        def merge(fan, first2, rest):
            # (n_beta, n_angles) ++ prologue (2,2,nb) ++ scan (K,2,nb)
            extra = jnp.concatenate(
                [jnp.stack(first2), rest], axis=0
            )  # (K+2, 2, nb)
            extra = jnp.moveaxis(extra, -1, 0).reshape(n_beta, -1)
            return jnp.concatenate([fan, extra], axis=1)

        # probe deltas can step outside [0, 2π) (bracket d_ext ± 2·spacing at
        # the fan seam); wrap them so the cyclic argsort below keeps δ
        # ordering consistent and _split_arms sees correctly-ordered arms
        wrap2pi = lambda dd: jnp.mod(dd, 2.0 * np.pi)
        delta_grid = merge(delta_grid, (wrap2pi(c), wrap2pi(e)), wrap2pi(scanned[0]))
        hit = merge(hit, (hc, he), scanned[1])
        rho = merge(rho, (rc, re_), scanned[2])
        t = merge(t, (tc, te), scanned[3])
        g = merge(g, (gc, ge), scanned[4])
        gam = merge(gam, (gmc, gme), scanned[5])
        # re-establish cyclic δ ordering for the arm split
        order = jnp.argsort(delta_grid, axis=1)
        take = lambda arr: jnp.take_along_axis(arr, order, axis=1)
        delta_grid, hit, rho, t, g, gam = (
            take(delta_grid),
            take(hit),
            take(rho),
            take(t),
            take(g),
            take(gam),
        )

    n_samples = delta_grid.shape[1]
    arm_a, arm_b = jax.vmap(lambda h_, r_: _split_arms(h_, r_, n_samples))(hit, rho)

    # Slice normalization: the reference's `emissivity_at` sums arm branches
    # over β slices without weighting (radial.jl:180-189), so its raw ε scales
    # with length(βs); each slice's 2π fan also covers the sky twice relative
    # to the lamppost's (0,π)+axisymmetry convention. Dividing by 2·n_beta
    # makes ε slice-count independent and equal to the lamppost profile in
    # the r → 0 limit; normalized products (line profiles, lag spectra) are
    # unaffected.
    scale = 1.0 / (2.0 * n_beta)

    def branches(mask):
        r_s, t_s, e_s, n = jax.vmap(
            lambda *args: _arm_branch(m, spectrum, *args)
        )(rho, t, delta_grid, g, gam, mask)
        return TimeDependentRadialDiscProfile(radii=r_s, t=t_s, eps=scale * e_s, n=n)

    return RingCoronaProfile(left=branches(arm_b), right=branches(arm_a))


class DiscCoronaHybridProfile:
    """Disc-corona ring stack whose per-ring near fields come from the
    adaptive-sky hybrid (a host-level aggregate of `NearFieldBlendedProfile`s
    — the hybrid builder is host-driven, so the stack cannot vmap).

    Mirrors `DiscCoronaProfile` semantics: trapezoidal r·δr ring weights,
    flux-weighted mean arrival times, summed time-emissivity curves, and
    `with_propagation_velocity` delays (reference radial.jl:281-325)."""

    def __init__(self, radii, profiles, delays=None):
        self.radii = jnp.asarray(radii)
        self.profiles = list(profiles)
        self.delays = (
            jnp.zeros_like(self.radii) if delays is None else jnp.asarray(delays)
        )

    def _weights(self):
        r = self.radii
        if r.shape[0] == 1:
            return r
        dr = 0.5 * (
            jnp.concatenate([r[1:2] - r[0:1], r[2:] - r[:-2], r[-1:] - r[-2:-1]])
        )
        return r * dr

    def emissivity_at(self, r):
        w = self._weights()
        vals = [wi * p.emissivity_at(r) for wi, p in zip(w, self.profiles)]
        return sum(vals[1:], vals[0])

    def coordtime_at(self, r):
        w = self._weights()
        num = None
        den = None
        t_mean = None
        for wi, p, dt in zip(w, self.profiles, self.delays):
            e = wi * p.emissivity_at(r)
            t = p.coordtime_at(r) + dt
            num = e * t if num is None else num + e * t
            den = e if den is None else den + e
            t_mean = t if t_mean is None else t_mean + t
        t_mean = t_mean / len(self.profiles)
        return jnp.where(den > 0, num / jnp.where(den > 0, den, 1.0), t_mean)

    def time_limits_at(self, r):
        los, his = zip(
            *[p.time_limits_at(r) for p in self.profiles]
        )
        lo = jnp.min(jnp.stack(los) + self.delays)
        hi = jnp.max(jnp.stack(his) + self.delays)
        return lo, hi

    def time_emissivity_curve(self, r, tq):
        w = self._weights()
        vals = [
            wi * p.time_emissivity_curve(r, tq - dt)
            for wi, p, dt in zip(w, self.profiles, self.delays)
        ]
        return sum(vals[1:], vals[0])

    def with_propagation_velocity(self, func):
        delays = jnp.asarray(jax.vmap(func)(self.radii), self.radii.dtype)
        return DiscCoronaHybridProfile(self.radii, self.profiles, delays)


def disc_corona_profile_hybrid(
    m: AbstractMetric,
    d,
    model,
    spectrum=PowerLawSpectrum(2.0),
    *,
    n_rings: int = 10,
    vf: str | None = None,
    **hybrid_kwargs,
):
    """`disc_corona_profile` with each constituent ring served by the
    near-field hybrid (`ring_corona_profile_hybrid`). Host-driven: n_rings
    adaptive-sky passes — use for final production profiles; the plain
    vmapped fan stack (`disc_corona_profile`) is the cheap default."""
    from gradus_tpu.corona.models import RingCorona

    dtype = jnp.result_type(model.r, float)
    radii = jnp.linspace(1e-2, model.r, n_rings, dtype=dtype)
    profiles = [
        ring_corona_profile_hybrid(
            m,
            d,
            RingCorona(
                r=float(rc), h=model.h, vf=vf if vf is not None else model.vf
            ),
            spectrum,
            **hybrid_kwargs,
        )
        for rc in np.asarray(radii)
    ]
    return DiscCoronaHybridProfile(radii, profiles)


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_rings",
        "n_beta",
        "n_angles",
        "lam_max",
        "chart_outer",
        "vf",
    ),
)
def disc_corona_profile(
    m: AbstractMetric,
    d,
    model,
    spectrum=PowerLawSpectrum(2.0),
    *,
    n_rings: int = 10,
    n_beta: int = 20,
    n_angles: int = 256,
    lam_max: float = 10000.0,
    chart_outer: float = 12000.0,
    vf: str | None = None,
    n_refine: int = 16,
) -> DiscCoronaProfile:
    """Emissivity profile of a `DiscCorona` as a stack of concentric rings
    (reference extended.jl:186-200): radii = range(1e-2, r, n_rings), delays
    initially zero (the reference's `_ -> 0` propagation velocity)."""
    from gradus_tpu.corona.models import RingCorona

    dtype = jnp.result_type(model.r, float)
    radii = jnp.linspace(1e-2, model.r, n_rings, dtype=dtype)

    def one_ring(rc):
        ring = RingCorona(r=rc, h=model.h, vf=vf if vf is not None else model.vf)
        return ring_corona_profile(
            m,
            d,
            ring,
            spectrum,
            n_beta=n_beta,
            n_angles=n_angles,
            lam_max=lam_max,
            chart_outer=chart_outer,
            n_refine=n_refine,
        )

    rings = jax.vmap(one_ring)(radii)
    return DiscCoronaProfile(
        radii=radii, rings=rings, delays=jnp.zeros_like(radii)
    )

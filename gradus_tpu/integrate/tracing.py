"""Front-door tracing API — the analogue of the reference's `tracegeodesics`
(`src/tracing/tracing.jl:66-110`) + problem assembly
(`src/tracing/geodesic-problem.jl`).

The 8-component state is u = (x, v); the RHS is
``du/dλ = (v, geodesic_equation(m, x, v))`` — reference `_second_order_ode_f`
(geodesic-problem.jl:87). Charged traces add the Lorentz force
``(q/μ)·F·v`` (reference `src/metrics/kerr-newman-ad.jl:74-102`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from gradus_tpu import config as _config
from gradus_tpu.geodesics.equation import geodesic_equation, constrain_all
from gradus_tpu.integrate.points import GeodesicPoint, unpack_solution
from gradus_tpu.integrate.solver import integrate_rays, IntegrationResult
from gradus_tpu.metrics.base import AbstractMetric

__all__ = [
    "TraceGeodesic",
    "TraceRadiativeTransfer",
    "trace_geodesics",
    "tracegeodesics",
    "make_geodesic_rhs",
    "domain_upper_hemisphere",
]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TraceGeodesic:
    """Null (μ=0) / timelike (μ=1) / charged (q≠0) trace
    (reference `src/tracing/tracing.jl:1-8`)."""

    mu: float = 0.0
    q: float = 0.0


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TraceRadiativeTransfer:
    """Covariant radiative-transfer trace: 9th state component integrates the
    invariant intensity (reference `src/tracing/radiative-transfer-problem.jl`)."""

    mu: float = 0.0
    q: float = 0.0
    nu: float = 1.0
    I0: float = 1.0


def make_geodesic_rhs(m: AbstractMetric, trace: TraceGeodesic | None = None):
    """RHS over (..., 8) states."""
    charged = trace is not None and _is_nonzero(trace.q)
    if charged:
        from gradus_tpu.metrics.kerr_newman import faraday_tensor

        q_over_mu = trace.q / (trace.mu if _is_nonzero(trace.mu) else 1.0)

        def f(y):
            x, v = y[..., 0:4], y[..., 4:8]
            acc = geodesic_equation(m, x, v)
            F = faraday_tensor(m, x) if x.ndim == 1 else jax.vmap(
                lambda xx: faraday_tensor(m, xx)
            )(x)
            lorentz = q_over_mu * jnp.einsum(
                "...ij,...j->...i", F, v, precision=jax.lax.Precision.HIGHEST
            )
            return jnp.concatenate([v, acc + lorentz], axis=-1)

        return f

    def f(y):
        x, v = y[..., 0:4], y[..., 4:8]
        acc = geodesic_equation(m, x, v)
        return jnp.concatenate([v, acc], axis=-1)

    return f


def _is_nonzero(val) -> bool:
    try:
        return float(val) != 0.0
    except (TypeError, jax.errors.TracerArrayConversionError):
        return True  # traced → assume may be nonzero


@functools.lru_cache(maxsize=None)
def domain_upper_hemisphere(delta: float = 1e-4):
    """Terminate (OutOfDomain) once the ray crosses below the equatorial plane
    (reference `src/tracing/callbacks.jl:31-41`). Cached so the returned
    callback tuple is a stable jit-static."""
    from gradus_tpu.integrate.status import StatusCodes

    def pred(y, lam):
        r, th = y[..., 1], y[..., 2]
        return r * jnp.cos(th) < delta

    return (pred, StatusCodes.OutOfDomain)


@functools.partial(
    jax.jit,
    static_argnames=(
        "mu",
        "q",
        "trace",
        "gtol",
        "closest_approach",
        "abstol",
        "reltol",
        "max_steps",
        "terminate_fns",
        "constrain",
        "n_interp",
        "checkpointed",
        "n_segments",
        "seg_steps",
    ),
)
def trace_geodesics(
    m: AbstractMetric,
    x,
    v,
    lam_span=(0.0, 2000.0),
    *,
    mu: float = 0.0,
    q: float = 0.0,
    trace=None,
    geometry=None,
    gtol: float = 1e-2,
    chart_inner=None,
    chart_outer: float = 12000.0,
    closest_approach: float = 1.01,
    abstol: float | None = None,
    reltol: float | None = None,
    max_steps: int = 40000,
    terminate_fns: tuple = (),
    constrain: bool = True,
    n_interp: int = 8,
    checkpointed: bool = False,
    n_segments: int = 64,
    seg_steps: int = 32,
) -> GeodesicPoint:
    """Trace a batch (or a single) geodesic; returns endpoint `GeodesicPoint`s.

    ``x``, ``v``: (..., 4) position / unconstrained velocity. The time
    component of ``v`` is solved from the norm constraint unless
    ``constrain=False`` (reference `constrain_all`,
    `src/tracing/constraints.jl`).

    ``checkpointed=True`` runs the reverse-differentiable segment ladder
    (`integrate_rays_checkpointed`) bounded by ``n_segments × seg_steps``
    total steps — use for `jax.grad` with many parameters in the dynamics.
    """
    if trace is None:
        trace = TraceGeodesic(mu=mu, q=q)
    single = jnp.ndim(x) == 1 and jnp.ndim(v) == 1
    x = jnp.atleast_2d(jnp.asarray(x))
    v = jnp.atleast_2d(jnp.asarray(v))
    x, v = jnp.broadcast_arrays(x, v)

    if constrain:
        v = constrain_all(m, x, v, mu=trace.mu)

    a_tol, r_tol = _config.default_tols(x.dtype)
    abstol = a_tol if abstol is None else abstol
    reltol = r_tol if reltol is None else reltol

    if chart_inner is None:
        chart_inner = m.inner_radius() * closest_approach

    crossing_fn = None
    hit_fn = None
    segment_fn = None
    if geometry is not None:
        if getattr(geometry, "segment_based", False):

            def segment_fn(xa, xb):
                return geometry.segment_hit(xa, xb)

        else:

            def crossing_fn(y):
                return geometry.crossing_indicator(y[..., 0:4])

            def hit_fn(y):
                return geometry.is_hit(y[..., 0:4], gtol=gtol)

    f = make_geodesic_rhs(m, trace)
    y0 = jnp.concatenate([x, v], axis=-1)
    if checkpointed:
        from gradus_tpu.integrate.solver import integrate_rays_checkpointed

        if segment_fn is not None:
            raise NotImplementedError(
                "checkpointed=True does not support segment-based geometry "
                "(MeshAccretionGeometry): the segment ladder has no per-step "
                "segment test. Use checkpointed=False."
            )
        result = integrate_rays_checkpointed(
            f,
            y0,
            lam_span,
            abstol=abstol,
            reltol=reltol,
            r_inner=chart_inner,
            r_outer=chart_outer,
            crossing_fn=crossing_fn,
            hit_fn=hit_fn,
            terminate_fns=terminate_fns,
            n_segments=n_segments,
            seg_steps=seg_steps,
            n_interp=n_interp,
        )
        gp = unpack_solution(result)
        return gp[0] if single else gp
    result = integrate_rays(
        f,
        y0,
        lam_span,
        abstol=abstol,
        reltol=reltol,
        r_inner=chart_inner,
        r_outer=chart_outer,
        crossing_fn=crossing_fn,
        hit_fn=hit_fn,
        segment_fn=segment_fn,
        terminate_fns=terminate_fns,
        max_steps=max_steps,
        n_interp=n_interp,
    )
    gp = unpack_solution(result)
    if single:
        gp = gp[0]
    return gp


# reference-parity alias
def tracegeodesics(m, x, v=None, lam_span=(0.0, 2000.0), **kwargs):
    """Reference-parity front door. Two dispatches:

    - ``tracegeodesics(m, x, v, lam_span, ...)`` — positions/velocities,
      exactly `trace_geodesics`;
    - ``tracegeodesics(m, model, lam_max_or_span; n_samples=64,
      sampler=None, ...)`` — sample a corona model's local sky and trace the
      emitted rays (reference corona-models.jl:143-153).
    """
    if hasattr(x, "sample_position_velocity"):
        from gradus_tpu.corona.samplers import (
            BothHemispheres,
            EvenSampler,
            sky_angles_to_velocity,
        )

        model = x
        span = v if v is not None else lam_span
        if jnp.ndim(span) == 0:
            span = (0.0, float(span))
        n_samples = kwargs.pop("n_samples", 64)
        sampler = kwargs.pop("sampler", None) or EvenSampler(
            domain=BothHemispheres()
        )
        x_src, v_src = model.sample_position_velocity(m)
        idx = jnp.arange(1, n_samples + 1, dtype=x_src.dtype)
        elev, az = sampler.sample_angles(idx, n_samples)
        vs = sky_angles_to_velocity(m, x_src, v_src, elev, az)
        xs = jnp.broadcast_to(x_src, vs.shape)
        kwargs.setdefault("constrain", False)
        return trace_geodesics(m, xs, vs, span, **kwargs)
    return trace_geodesics(m, x, v, lam_span, **kwargs)


class Tracer:
    """Reusable high-throughput tracer over a fixed (metric, geometry) pair.

    Wraps `CompactedIntegrator` (segmented integration with alive-ray
    compaction — the batched analogue of the reference's dynamically-scheduled
    `EnsembleEndpointThreads` pool, `src/tracing/tracing.jl:151-196`).
    Construct once, call many times: jitted programs are cached per
    working-set shape. Host-driven, so NOT usable inside jit/jvp — use
    `trace_geodesics` there.
    """

    def __init__(
        self,
        m: AbstractMetric,
        *,
        mu: float = 0.0,
        q: float = 0.0,
        trace=None,
        geometry=None,
        gtol: float = 1e-2,
        chart_inner=None,
        chart_outer: float = 12000.0,
        closest_approach: float = 1.01,
        abstol: float | None = None,
        reltol: float | None = None,
        max_steps: int = 40000,
        terminate_fns: tuple = (),
        n_interp: int = 8,
        segment_iters: int = 96,
        min_bucket: int = 8192,
        segment_schedule: tuple | None = None,
        dtype=None,
        progress=None,
    ):
        from gradus_tpu.integrate.solver import CompactedIntegrator

        if trace is None:
            trace = TraceGeodesic(mu=mu, q=q)
        self.m = m
        self.trace = trace
        self.geometry = geometry

        a_tol, r_tol = _config.default_tols(dtype)
        abstol = a_tol if abstol is None else abstol
        reltol = r_tol if reltol is None else reltol
        if chart_inner is None:
            chart_inner = m.inner_radius() * closest_approach

        crossing_fn = hit_fn = segment_fn = None
        if geometry is not None:
            if getattr(geometry, "segment_based", False):

                def segment_fn(xa, xb):
                    return geometry.segment_hit(xa, xb)

            else:

                def crossing_fn(y):
                    return geometry.crossing_indicator(y[..., 0:4])

                def hit_fn(y):
                    return geometry.is_hit(y[..., 0:4], gtol=gtol)

        self._integ = CompactedIntegrator(
            make_geodesic_rhs(m, trace),
            abstol=abstol,
            reltol=reltol,
            r_inner=chart_inner,
            r_outer=chart_outer,
            crossing_fn=crossing_fn,
            hit_fn=hit_fn,
            segment_fn=segment_fn,
            terminate_fns=terminate_fns,
            max_steps=max_steps,
            n_interp=n_interp,
            segment_iters=segment_iters,
            min_bucket=min_bucket,
            segment_schedule=segment_schedule,
            progress=progress,
        )
        self._constrain = jax.jit(
            lambda x, v: jnp.concatenate(
                [x, constrain_all(self.m, x, v, mu=self.trace.mu)], axis=-1
            )
        )

    def __call__(self, x, v, lam_span, constrain: bool = True) -> GeodesicPoint:
        x = jnp.atleast_2d(jnp.asarray(x))
        v = jnp.atleast_2d(jnp.asarray(v))
        x, v = jnp.broadcast_arrays(x, v)
        if constrain:
            y0 = self._constrain(x, v)
        else:
            y0 = jnp.concatenate([x, v], axis=-1)
        result = self._integ(y0, lam_span)
        return unpack_solution(result)


def make_radiative_transfer_rhs(m: AbstractMetric, trace, geometry, r_isco):
    """RHS over (..., 10) states u = (x, k, I, n_crossings): covariant
    radiative transfer dI/dλ = ds/dλ·(−a_ν I + j_ν/ν³) integrated only while
    inside the (optically thick) geometry volume.

    Reference: `radiative_transfer` + `radiative_transfer_ode_problem`,
    `src/tracing/radiative-transfer-problem.jl:1-34, 147-189`. The fluid
    velocity is Keplerian outside the ISCO and the exact frozen-(E,L) plunge
    inside (the reference uses the ISCO-only `plunging_fourvelocity`)."""
    from gradus_tpu.redshift import keplerian_velocity_projector

    project = keplerian_velocity_projector(m)

    def f(y):
        x, k, I = y[..., 0:4], y[..., 4:8], y[..., 8]
        acc = geodesic_equation(m, x, k)
        u = project(x)
        dsdlam = -jnp.einsum(
            "...ij,...i,...j->...", m.metric(x), k, u
        )
        nu = trace.nu * dsdlam
        a_nu = geometry.absorption_coefficient(x, nu)
        j_nu = geometry.emission_coefficient(x, nu)
        within = jnp.mod(y[..., 9], 2.0) >= 1.0
        dI = jnp.where(
            within, dsdlam * (-a_nu * I + j_nu / jnp.maximum(nu, 1e-30) ** 3), 0.0
        )
        zeros = jnp.zeros_like(dI)
        return jnp.concatenate(
            [k, acc, dI[..., None], zeros[..., None]], axis=-1
        )

    return f


def trace_radiative_transfer(
    m: AbstractMetric,
    x,
    v,
    lam_span=(0.0, 2000.0),
    *,
    trace: TraceRadiativeTransfer | None = None,
    geometry=None,
    gtol: float = 1e-2,
    chart_outer: float = 12000.0,
    abstol=None,
    reltol=None,
    max_steps: int = 40000,
    constrain: bool = True,
) -> GeodesicPoint:
    """Radiative-transfer trace: integrates the invariant intensity along the
    ray. Optically thin geometry terminates the ray at the surface; optically
    thick geometry toggles an inside/outside flag at each boundary crossing
    and integrates the transfer equation through the volume.

    The endpoint's ``aux`` carries (I, n_crossings)."""
    from gradus_tpu.integrate.solver import integrate_rays
    from gradus_tpu.orbits.special_radii import isco as _isco

    if geometry is None:
        raise ValueError("radiative transfer requires geometry")
    if trace is None:
        trace = TraceRadiativeTransfer()

    single = jnp.ndim(x) == 1 and jnp.ndim(v) == 1
    x = jnp.atleast_2d(jnp.asarray(x))
    v = jnp.atleast_2d(jnp.asarray(v))
    x, v = jnp.broadcast_arrays(x, v)
    if constrain:
        v = constrain_all(m, x, v, mu=trace.mu)

    a_tol, r_tol = _config.default_tols(x.dtype)
    abstol = a_tol if abstol is None else abstol
    reltol = r_tol if reltol is None else reltol

    r_isco = _isco(m)
    f = make_radiative_transfer_rhs(m, trace, geometry, r_isco)

    def crossing_fn(y):
        return geometry.crossing_indicator(y[..., 0:4])

    def hit_fn(y):
        return geometry.is_hit(y[..., 0:4], gtol=gtol)

    N = x.shape[:-1]
    extra = jnp.concatenate(
        [
            jnp.full(N + (1,), trace.I0, x.dtype),
            jnp.zeros(N + (1,), x.dtype),
        ],
        axis=-1,
    )
    y0 = jnp.concatenate([x, v, extra], axis=-1)
    result = integrate_rays(
        f,
        y0,
        lam_span,
        abstol=abstol,
        reltol=reltol,
        r_inner=m.inner_radius() * 1.01,
        r_outer=chart_outer,
        crossing_fn=crossing_fn,
        hit_fn=hit_fn,
        max_steps=max_steps,
        terminate_on_hit=geometry.optically_thin,
    )
    gp = unpack_solution(result)
    if single:
        gp = gp[0]
    return gp


@functools.partial(
    jax.jit,
    static_argnames=(
        "mu",
        "q",
        "gtol",
        "abstol",
        "reltol",
        "max_steps",
        "constrain",
        "n_save",
    ),
)
def trace_geodesics_dense(
    m: AbstractMetric,
    x,
    v,
    lam_span=(0.0, 2000.0),
    *,
    mu: float = 0.0,
    q: float = 0.0,
    geometry=None,
    gtol: float = 1e-2,
    chart_outer: float = 12000.0,
    abstol=None,
    reltol=None,
    max_steps: int = 40000,
    constrain: bool = True,
    n_save: int = 512,
):
    """Like `trace_geodesics` but additionally records the full trajectory at
    accepted steps (fixed-size buffers; reference `save_on=true` solutions /
    `unpack_solution_full`). Returns (GeodesicPoint, traj (N, n_save, 8),
    traj_lam (N, n_save), n_steps)."""
    from gradus_tpu.integrate.solver import integrate_rays

    single = jnp.ndim(x) == 1 and jnp.ndim(v) == 1
    x = jnp.atleast_2d(jnp.asarray(x))
    v = jnp.atleast_2d(jnp.asarray(v))
    x, v = jnp.broadcast_arrays(x, v)
    trace = TraceGeodesic(mu=mu, q=q)
    if constrain:
        v = constrain_all(m, x, v, mu=mu)

    a_tol, r_tol = _config.default_tols(x.dtype)
    abstol = a_tol if abstol is None else abstol
    reltol = r_tol if reltol is None else reltol

    crossing_fn = hit_fn = None
    if geometry is not None:

        def crossing_fn(y):
            return geometry.crossing_indicator(y[..., 0:4])

        def hit_fn(y):
            return geometry.is_hit(y[..., 0:4], gtol=gtol)

    f = make_geodesic_rhs(m, trace)
    y0 = jnp.concatenate([x, v], axis=-1)
    result = integrate_rays(
        f,
        y0,
        lam_span,
        abstol=abstol,
        reltol=reltol,
        r_inner=m.inner_radius() * 1.01,
        r_outer=chart_outer,
        crossing_fn=crossing_fn,
        hit_fn=hit_fn,
        max_steps=max_steps,
        n_save=n_save,
    )
    gp = unpack_solution(result)
    traj = result.traj
    traj_lam = result.traj_lam
    nsteps = jnp.minimum(result.steps + 1, n_save)
    if single:
        gp = gp[0]
        traj = traj[0]
        traj_lam = traj_lam[0]
        nsteps = nsteps[0]
    return gp, traj, traj_lam, nsteps


class _WindingPlane:
    """Plane of constant θ used for winding counts."""

    optically_thin = False

    def __init__(self, inc):
        self.inc = inc

    def crossing_indicator(self, x4):
        return x4[..., 2] - self.inc

    def is_hit(self, x4, gtol=1e-2):
        return jnp.ones(x4.shape[:-1], dtype=bool)


def trace_windings(
    m: AbstractMetric,
    x,
    v,
    lam_span=(0.0, 2000.0),
    *,
    plane_inc: float = jnp.pi / 2,
    mu: float = 0.0,
    **kwargs,
):
    """Count crossings of the θ = plane_inc plane along each geodesic
    (photon rings / higher-order images; reference `TraceWindings`,
    `src/tracing/photon-rings.jl`). Returns (GeodesicPoint, windings)."""
    from gradus_tpu.integrate.solver import integrate_rays

    single = jnp.ndim(x) == 1 and jnp.ndim(v) == 1
    x = jnp.atleast_2d(jnp.asarray(x))
    v = jnp.atleast_2d(jnp.asarray(v))
    x, v = jnp.broadcast_arrays(x, v)
    v = constrain_all(m, x, v, mu=mu)

    a_tol, r_tol = _config.default_tols(x.dtype)
    plane = _WindingPlane(plane_inc)
    f8 = make_geodesic_rhs(m, TraceGeodesic(mu=mu))

    def f(y):
        dy = f8(y[..., :8])
        return jnp.concatenate([dy, jnp.zeros_like(y[..., 8:9])], axis=-1)

    y0 = jnp.concatenate([x, v, jnp.zeros(x.shape[:-1] + (1,), x.dtype)], axis=-1)
    result = integrate_rays(
        f,
        y0,
        lam_span,
        abstol=a_tol,
        reltol=r_tol,
        r_inner=m.inner_radius() * 1.01,
        r_outer=kwargs.get("chart_outer", 12000.0),
        crossing_fn=lambda y: plane.crossing_indicator(y[..., 0:4]),
        hit_fn=lambda y: plane.is_hit(y[..., 0:4]),
        terminate_on_hit=False,
        max_steps=kwargs.get("max_steps", 40000),
    )
    gp = unpack_solution(result)
    windings = result.y[..., 8].astype(jnp.int32)
    if single:
        gp = gp[0]
        windings = windings[0]
    return gp, windings


class PoloidalShape(NamedTuple):
    """θ-dependent inner chart boundary r_min(θ) (reference
    `PoloidalShapeChart`, `src/tracing/charts.jl:26-48`). Pass as
    `chart_inner=` to `trace_geodesics` / `Tracer`; the solver interpolates
    r_min at each ray's current θ."""

    rs: Any
    thetas: Any


def event_horizon_chart(
    m: AbstractMetric, closest_approach: float = 1.01, resolution: int = 128
) -> PoloidalShape:
    """Shaped inner boundary from the θ-dependent event horizon (reference
    `event_horizon_chart`, charts.jl:60-69) — matters for near-extremal spins
    and deformed metrics where the horizon is not a coordinate sphere."""
    from gradus_tpu.orbits.special_radii import event_horizon

    rs, thetas = event_horizon(m, resolution=resolution)
    rs = jnp.nan_to_num(rs, nan=float(m.inner_radius()))
    return PoloidalShape(rs=rs * closest_approach, thetas=thetas)

"""Precision solvers: differentiable inverse ray tracing.

Reference: `src/tracing/precision-solvers.jl`. `find_offset_for_radius` finds
the image-plane offset r₀ along direction θₒ such that the traced geodesic
hits the disc at emission radius rₑ. The reference runs a scalar
Newton-Raphson whose derivative comes from pushing a ForwardDiff dual through
a reusable ODE integrator (precision-solvers.jl:73-131), with event-horizon
contrapoint bisection rescue (:133-236).

Here the same algorithm is batched: every (rₑ, θ) pair iterates in lockstep,
the Newton derivative dρ/dr₀ comes from one `jax.jvp` through the batched
trace, and the bisection safeguard is a per-ray bracket maintained with
masks. All fixed iteration counts — jit-compiled once, reused across calls.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from gradus_tpu.camera.impact import map_impact_parameters
from gradus_tpu.geodesics.equation import constrain_all
from gradus_tpu.integrate.status import StatusCodes
from gradus_tpu.integrate.tracing import trace_geodesics
from gradus_tpu.metrics.base import AbstractMetric
from gradus_tpu.utils.linalg import equatorial_project

__all__ = [
    "rtheta_to_alphabeta",
    "find_offset_for_radius",
    "impact_parameters_for_radius",
    "offset_workhorse",
    "offset_probe",
    "offset_jacobian_at",
]


def rtheta_to_alphabeta(r, theta, alpha0=0.0, beta0=0.0):
    """(r, θ) polar image-plane coordinates → (α, β)
    (reference `_rθ_to_αβ`, transfer-functions/utils.jl:114-118)."""
    return r * jnp.cos(theta) + alpha0, r * jnp.sin(theta) + beta0


def _make_trace_to_disc(m, x, d, lam_max, thetas, alpha0, beta0, gtol, trace_kwargs):
    """Returns offsets → GeodesicPoint batch (traced against geometry d)."""

    def trace(r_off):
        al, be = rtheta_to_alphabeta(r_off, thetas, alpha0, beta0)
        v = map_impact_parameters(m, x, al, be)
        xs = jnp.broadcast_to(x, v.shape)
        # reference CTF chart: outer boundary at 2·r_obs
        # (cunningham-transfer-functions.jl:352 `chart_for_metric(m, 2x[2])`)
        return trace_geodesics(
            m,
            xs,
            v,
            (0.0, lam_max),
            geometry=d,
            gtol=gtol,
            chart_outer=2.0 * x[1],
            **trace_kwargs,
        )

    return trace


@partial(
    jax.jit,
    static_argnames=(
        "zero_atol",
        "worst_accuracy_factor",
        "max_iter",
        "alpha0",
        "beta0",
        "gtol",
        "offset_max",
    ),
)
def find_offset_for_radius(
    m: AbstractMetric,
    x,
    d,
    r_targets,
    thetas,
    *,
    lam_max=None,
    zero_atol: float = 1e-7,
    worst_accuracy_factor: float = 1e-4,
    max_iter: int = 30,
    alpha0: float = 0.0,
    beta0: float = 0.0,
    gtol: float = 1e-2,
    offset_max: float = 4.0,
    r_init=None,
):
    """Batched safeguarded Newton for the image-plane offset.

    r_targets, thetas: broadcastable arrays. Returns (r_offset, GeodesicPoint,
    residual); non-converged entries have r_offset = NaN (reference returns
    NaN likewise, precision-solvers.jl:223-236).

    ``r_init``: optional warm-start offsets (e.g. the solution at a nearby θ —
    the golden-section extremal search moves θ geometrically, so the previous
    probe's offset converges in 1-3 Newton steps instead of ~10 from the cold
    ``max(20, rₑ)`` start). Non-finite entries fall back to the cold start.
    """
    x = jnp.asarray(x)
    r_targets, thetas = jnp.broadcast_arrays(
        jnp.asarray(r_targets, x.dtype), jnp.asarray(thetas, x.dtype)
    )
    if lam_max is None:
        lam_max = 2.0 * x[1]

    # dtype-aware tolerances: the f64 default
    # zero_atol = 1e-7 sits below float32 resolution of ρ ~ r_target, so in
    # f32 the loop would never flag convergence and the acceptance test would
    # reject legitimately-converged solves. Scale both to the dtype.
    eps = float(jnp.finfo(x.dtype).eps)
    zero_atol_eff = jnp.maximum(zero_atol, 32.0 * eps * jnp.maximum(1.0, r_targets))
    accept_tol = jnp.maximum(
        worst_accuracy_factor * r_targets, 10 * zero_atol_eff
    )

    trace = _make_trace_to_disc(m, x, d, lam_max, thetas, alpha0, beta0, gtol, {})

    def rho_of(r_off):
        gp = trace(r_off)
        return equatorial_project(gp.x)

    # initial guess (reference: initial_r = max(20, r_target))
    r0 = jnp.maximum(20.0, r_targets)
    if r_init is not None:
        r_init = jnp.broadcast_to(jnp.asarray(r_init, x.dtype), r0.shape)
        r0 = jnp.where(jnp.isfinite(r_init) & (r_init > 0.0), r_init, r0)
    lo = jnp.zeros_like(r0)  # maps inside the event horizon: y(lo) < 0
    hi = jnp.full_like(r0, jnp.inf)
    have_hi = jnp.zeros(r0.shape, bool)
    upper_limit = offset_max * (r_targets + 20.0)
    # best-seen iterate (reference `best` tracking,
    # precision-solvers.jl:1-10): in f32 the Newton step bounces at the noise
    # floor, so the final iterate is not necessarily the best one
    best_r0 = r0
    best_y0 = jnp.full_like(r0, jnp.inf)
    # Stall detection (lockstep cost lever): the while_loop exits only when
    # EVERY lane is finished, and in f32 a handful of near-fold lanes bounce
    # at the residual noise floor without ever crossing zero_atol — without a
    # stall exit they force the full max_iter on the whole batch every call
    # (the 8000-ray CTF sweep always ran 30 iterations; typical lanes
    # converge in ~6). A lane that hasn't improved its best |y| by 2× in
    # `stall_iters` consecutive iterations is finished — it already reports
    # its best-seen iterate. f32 ONLY: in f64 every lane genuinely converges
    # (the loop exits on all-converged well before max_iter), and cutting
    # slow bisection lanes there measurably wobbles the CTF moment goldens
    # (re7 2.4e-4 → 1.2e-3 vs the reference's atol 1e-3).
    if jnp.dtype(x.dtype) == jnp.float32:
        stall_iters = jnp.int32(6)
    else:
        stall_iters = jnp.int32(max_iter)

    def cond(state):
        r, lo, hi, have_hi, done, best_r, best_y, since, it = state
        return (~jnp.all(done)) & (it < max_iter)

    def body(state):
        r, lo, hi, have_hi, _, best_r, best_y, since, it = state
        rho, drho = jax.jvp(rho_of, (r,), (jnp.ones_like(r),))
        y = rho - r_targets
        improved = jnp.abs(y) < best_y
        progressed = jnp.abs(y) < 0.5 * best_y
        best_r = jnp.where(improved, r, best_r)
        best_y = jnp.where(improved, jnp.abs(y), best_y)
        since = jnp.where(progressed, 0, since + 1)
        # ρ(r₀) is monotone increasing along the primary image direction:
        # update the bracket
        lo = jnp.where(y < 0, jnp.maximum(lo, r), lo)
        hi = jnp.where(y > 0, jnp.minimum(hi, r), hi)
        have_hi = have_hi | (y > 0)

        drho_safe = jnp.where(jnp.abs(drho) < 1e-30, 1.0, drho)
        newton = r - y / drho_safe
        bad = (
            ~jnp.isfinite(newton)
            | (newton <= lo)
            | (have_hi & (newton >= hi))
            | (newton > upper_limit)
        )
        grow = jnp.minimum(2.0 * r, upper_limit)
        fallback = jnp.where(have_hi, 0.5 * (lo + hi), grow)
        converged = jnp.abs(y) < zero_atol_eff
        finished = converged | (since >= stall_iters)
        r_new = jnp.where(converged, r, jnp.where(bad, fallback, newton))
        return r_new, lo, hi, have_hi, finished, best_r, best_y, since, it + 1

    done0 = jnp.zeros(r0.shape, bool)
    since0 = jnp.zeros(r0.shape, jnp.int32)
    r_off, lo, hi, have_hi, conv, best_r, best_y, _, _ = lax.while_loop(
        cond,
        body,
        (r0, lo, hi, have_hi, done0, best_r0, best_y0, since0, jnp.int32(0)),
    )
    # f32: every lane reports its best-seen iterate (stalled lanes must not
    # report the last Newton bounce — the step jitters at the noise floor).
    # f64: converged lanes report the frozen converged iterate and only
    # non-converged lanes fall back to best — matching the recorded golden
    # trajectories (the two differ within zero_atol, which is exactly the
    # scale the CTF moment anchors are sensitive to).
    if jnp.dtype(x.dtype) == jnp.float32:
        r_off = best_r
    else:
        r_off = jnp.where(conv, r_off, best_r)
    gp = trace(r_off)
    resid = equatorial_project(gp.x) - r_targets
    ok = jnp.abs(resid) < accept_tol
    r_out = jnp.where(ok, r_off, jnp.nan)
    return r_out, gp, resid


def _conserved_g_helpers(m: AbstractMetric):
    """Closed-form redshift from conserved photon quantities.

    λ = p_φ/(−p_t) is exact in any static axis-symmetric metric; the disc
    four-velocity is Keplerian at exactly rₑ. See `offset_workhorse` docstring
    for why this (and not the endpoint dot product) feeds the transfer
    function."""
    from gradus_tpu.orbits.circular import CircularOrbits
    from gradus_tpu.orbits.special_radii import isco as _isco

    r_kep_min = _isco(m) + 1e-6

    def _lam_of(gp_):
        """λ = p_φ/(−p_t) from the (constrained) initial conditions."""
        p0 = jnp.einsum(
            "...ij,...j->...i",
            m.metric(gp_.x_init),
            gp_.v_init,
            precision=jax.lax.Precision.HIGHEST,
        )
        return p0[..., 3] / (-p0[..., 0])

    def _g_conserved(lam, r_disc):
        u = CircularOrbits.fourvelocity(
            m,
            (
                jnp.maximum(r_disc, r_kep_min),
                jnp.full_like(r_disc, jnp.pi / 2),
            ),
        )
        return 1.0 / (u[..., 0] - lam * u[..., 3])

    return _lam_of, _g_conserved


def _post_solve(
    m,
    x,
    d,
    r_targets,
    thetas,
    r_off,
    gp,
    ok,
    *,
    redshift_pf,
    jacobian_disc,
    verify_disc,
    lam_max,
    alpha0,
    beta0,
    gtol,
):
    """(g, J, t, ok) at already-solved offsets: redshift, thick-disc
    visibility re-trace, and the |∂(α,β)/∂(ρ,g)| Jacobian via two forward
    passes through the trace."""
    conserved_g = redshift_pf is None
    if conserved_g:
        _lam_of, _g_conserved = _conserved_g_helpers(m)
    if jacobian_disc is None:
        jacobian_disc = d

    r_safe = jnp.where(ok, r_off, jnp.maximum(20.0, r_targets))
    if conserved_g:
        # evaluate at EXACTLY rₑ (not the achieved ρ): the Newton residual
        # (≤ zero_atol) would otherwise re-introduce θ-jitter in g
        g = _g_conserved(_lam_of(gp), r_targets)
    else:
        g = redshift_pf(m, gp, lam_max)
    t = gp.x[..., 0]

    # Jacobian |∂(α,β)/∂(ρ,g)| via two forward passes through the trace
    alpha, beta = rtheta_to_alphabeta(r_safe, thetas, alpha0, beta0)

    thick = verify_disc is not None
    if thick:
        # thick-disc visibility: re-trace the solved ray against the REAL
        # disc; if the hit moved (occluded by the disc's own bulge) the
        # sample is invisible (reference `_thick_workhorse`,
        # cunningham-transfer-functions.jl:251-300)
        from gradus_tpu.integrate.tracing import domain_upper_hemisphere

        gp2 = trace_geodesics(
            m,
            gp.x_init,
            gp.v_init,
            (0.0, lam_max),
            geometry=verify_disc,
            gtol=gtol,
            chart_outer=2.0 * x[1],
            constrain=False,
        )
        dx = gp2.x - gp.x
        rel = jnp.sqrt(jnp.sum(dx * dx, axis=-1)) / jnp.sqrt(
            jnp.sum(gp.x * gp.x, axis=-1)
        )
        visible = (gp2.status == gp.status) & (rel < 1e-3)
        ok = ok & visible
        jac_terminators = (domain_upper_hemisphere(),)
    else:
        jac_terminators = ()

    def rho_g(ab):
        al, be = ab[..., 0], ab[..., 1]
        v = map_impact_parameters(m, x, al, be)
        xs = jnp.broadcast_to(x, v.shape)
        gp_ = trace_geodesics(
            m,
            xs,
            v,
            (0.0, lam_max),
            geometry=jacobian_disc,
            chart_outer=2.0 * x[1],
            terminate_fns=jac_terminators,
        )
        rho_ = equatorial_project(gp_.x)
        if conserved_g:
            # the redshift FIELD over the image plane: λ(α,β) analytic,
            # ρ(α,β) through the trace
            g_ = _g_conserved(_lam_of(gp_), rho_)
        else:
            g_ = redshift_pf(m, gp_, lam_max)
        if thick:
            # inside the disc inner edge the redshift is ill-defined: zero it
            # so the Jacobian diverges and the sample filters out (reference
            # jacobian_∂αβ_∂gr, precision-solvers.jl:419-434)
            g_ = jnp.where(rho_ < verify_disc.inner_radius(), 0.0, g_)
        return jnp.stack([rho_, g_], axis=-1)

    ab = jnp.stack([alpha, beta], axis=-1)
    e_a = jnp.zeros_like(ab).at[..., 0].set(1.0)
    e_b = jnp.zeros_like(ab).at[..., 1].set(1.0)
    _, d_da = jax.jvp(rho_g, (ab,), (e_a,))
    _, d_db = jax.jvp(rho_g, (ab,), (e_b,))
    det = d_da[..., 0] * d_db[..., 1] - d_da[..., 1] * d_db[..., 0]
    J = jnp.abs(1.0 / det)
    # conditioning of the determinant: |det| relative to the magnitude of the
    # cancelling terms. det → 0 exactly at the transfer-function extrema, so
    # near-extremal J = 1/|det| is trustworthy only while cond ≫ the jvp
    # field accuracy (~integrator tolerance). Exposed for diagnostics — it is
    # surfaced through `return_samples` (cunningham.py) so conditioning
    # studies can read it; the CTF regulariser itself gates on the g✶
    # ill-zone plus the κ = 1.5 upward-spike test, not on cond.
    cond = jnp.abs(det) / (
        jnp.abs(d_da[..., 0] * d_db[..., 1])
        + jnp.abs(d_da[..., 1] * d_db[..., 0])
        + 1e-300
    )
    return g, J, t, ok & jnp.isfinite(J), cond


@partial(
    jax.jit,
    static_argnames=(
        "redshift_pf",
        "alpha0",
        "beta0",
        "zero_atol",
        "max_iter",
        "gtol",
        "return_r_off",
    ),
)
def offset_workhorse(
    m: AbstractMetric,
    x,
    d,
    r_targets,
    thetas,
    *,
    redshift_pf=None,
    jacobian_disc=None,
    verify_disc=None,
    lam_max=None,
    alpha0: float = 0.0,
    beta0: float = 0.0,
    zero_atol: float = 1e-7,
    max_iter: int = 30,
    gtol: float = 1e-2,
    r_init=None,
    return_r_off: bool = False,
):
    """(g, J, t, ok) for each (rₑ, θ) pair: redshift, Jacobian
    |∂(α,β)/∂(g,rₑ)| and coordinate arrival time at the solved offset.

    Reference `_rear_workhorse` (cunningham-transfer-functions.jl:226-249) +
    `jacobian_∂αβ_∂gr` (precision-solvers.jl:401-451).

    Redshift evaluation (default ``redshift_pf=None``): g is computed from the
    CONSERVED photon quantities E = −p_t, L = p_φ (exact functions of the
    initial conditions — a static axis-symmetric metric conserves both) and
    the Keplerian disc four-velocity at exactly rₑ:

        g = 1 / (uᵗ(rₑ) − λ uᶲ(rₑ)),    λ = L/E.

    This matches the reference's endpoint dot product to ~1e-7 (v_obs =
    (1,0,0,0), redshift.jl:208) but carries ZERO integration noise, which is
    essential for the near-extremal samples: the transfer function is the
    0·∞-regularised product √(g✶(1−g✶))·J, and any jitter ε in g turns
    samples with (1−g✶) < ε/(gmax−gmin) into unbounded garbage (observed:
    f 30× the smooth limit from ~1e-9 endpoint noise). Pass an explicit
    ``redshift_pf`` to reproduce the endpoint-dot-product behavior.

    ``r_init`` warm-starts the Newton solve; ``return_r_off=True`` appends the
    solved offsets to the output (for callers chaining warm starts).
    """
    x = jnp.asarray(x)
    if lam_max is None:
        lam_max = 2.0 * x[1]

    r_off, gp, resid = find_offset_for_radius(
        m,
        x,
        d,
        r_targets,
        thetas,
        lam_max=lam_max,
        alpha0=alpha0,
        beta0=beta0,
        zero_atol=zero_atol,
        max_iter=max_iter,
        gtol=gtol,
        r_init=r_init,
    )
    ok = jnp.isfinite(r_off)
    g, J, t, ok, cond = _post_solve(
        m,
        x,
        d,
        r_targets,
        thetas,
        r_off,
        gp,
        ok,
        redshift_pf=redshift_pf,
        jacobian_disc=jacobian_disc,
        verify_disc=verify_disc,
        lam_max=lam_max,
        alpha0=alpha0,
        beta0=beta0,
        gtol=gtol,
    )
    if return_r_off:
        return g, J, t, ok, r_off, cond
    return g, J, t, ok


@partial(
    jax.jit,
    static_argnames=(
        "redshift_pf",
        "alpha0",
        "beta0",
        "zero_atol",
        "max_iter",
        "gtol",
    ),
)
def offset_probe(
    m: AbstractMetric,
    x,
    d,
    r_targets,
    thetas,
    *,
    redshift_pf=None,
    lam_max=None,
    alpha0: float = 0.0,
    beta0: float = 0.0,
    zero_atol: float = 1e-7,
    max_iter: int = 30,
    gtol: float = 1e-2,
    r_init=None,
):
    """g-only workhorse for the extremal search: offset solve + redshift +
    arrival time, NO Jacobian (≈3× cheaper per probe than the full
    workhorse). Returns (r_off, g, t, ok). The golden-section driver collects
    probe offsets and evaluates `offset_jacobian_at` once, batched, at the
    end."""
    x = jnp.asarray(x)
    if lam_max is None:
        lam_max = 2.0 * x[1]
    r_off, gp, _ = find_offset_for_radius(
        m,
        x,
        d,
        r_targets,
        thetas,
        lam_max=lam_max,
        alpha0=alpha0,
        beta0=beta0,
        zero_atol=zero_atol,
        max_iter=max_iter,
        gtol=gtol,
        r_init=r_init,
    )
    ok = jnp.isfinite(r_off)
    if redshift_pf is None:
        _lam_of, _g_conserved = _conserved_g_helpers(m)
        g = _g_conserved(_lam_of(gp), r_targets)
    else:
        g = redshift_pf(m, gp, lam_max)
    return r_off, g, gp.x[..., 0], ok


@partial(
    jax.jit,
    static_argnames=("redshift_pf", "alpha0", "beta0", "gtol"),
)
def offset_jacobian_at(
    m: AbstractMetric,
    x,
    d,
    r_targets,
    thetas,
    r_off,
    *,
    redshift_pf=None,
    jacobian_disc=None,
    verify_disc=None,
    lam_max=None,
    alpha0: float = 0.0,
    beta0: float = 0.0,
    gtol: float = 1e-2,
):
    """Full workhorse output (g, J, t, ok, cond) at ALREADY-SOLVED
    offsets: one re-trace for the endpoint + two jvp traces for the Jacobian,
    no Newton loop. Batched over every golden-section probe at once. ``cond``
    is the determinant-cancellation conditioning measure (see _post_solve)."""
    x = jnp.asarray(x)
    r_targets, thetas, r_off = jnp.broadcast_arrays(
        jnp.asarray(r_targets, x.dtype),
        jnp.asarray(thetas, x.dtype),
        jnp.asarray(r_off, x.dtype),
    )
    if lam_max is None:
        lam_max = 2.0 * x[1]
    ok = jnp.isfinite(r_off)
    r_safe = jnp.where(ok, r_off, jnp.maximum(20.0, r_targets))
    trace = _make_trace_to_disc(
        m, x, d, lam_max, thetas, alpha0, beta0, gtol, {}
    )
    gp = trace(r_safe)
    return _post_solve(
        m,
        x,
        d,
        r_targets,
        thetas,
        r_off,
        gp,
        ok,
        redshift_pf=redshift_pf,
        jacobian_disc=jacobian_disc,
        verify_disc=verify_disc,
        lam_max=lam_max,
        alpha0=alpha0,
        beta0=beta0,
        gtol=gtol,
    )


def impact_parameters_for_radius(m: AbstractMetric, x, d, r_e, N: int = 500, **kwargs):
    """(α, β) ring tracing to emission radius rₑ
    (reference precision-solvers.jl:298-344)."""
    thetas = jnp.linspace(0.0, 2 * jnp.pi, N)
    r_off, _, _ = find_offset_for_radius(m, x, d, jnp.full((N,), r_e), thetas, **kwargs)
    al, be = rtheta_to_alphabeta(r_off, thetas)
    return al, be

"""Batched adaptive geodesic integration with event detection.

This is the batched replacement for the reference's OrdinaryDiffEq solve +
SciML callback stack (`src/tracing/tracing.jl`, `charts.jl`,
`src/geometry/bootstrap.jl`): the whole ray batch advances in lockstep inside
one fixed-shape `lax.while_loop`; each ray carries its own (dt, error, status,
alive) state. Events:

- chart bounds (discrete, step-end): r ≤ r_inner → WithinInnerBoundary,
  r > r_outer → OutOfDomain  (reference `PolarChart`, charts.jl:8-24);
- geometry intersection (continuous): a *signed* crossing indicator is sampled
  on the cubic-Hermite step interpolant (reference: ContinuousCallback with
  interp_points = 8 on the unsigned distance); a sign change is bisected to the
  crossing in-loop, validated against the geometry (annulus bounds), and — for
  valid hits — polished AFTER the main loop by vectorized Newton iterations on
  the exact trajectory, so the hit time λ* and state are 5th-order accurate and
  differentiable (forward-mode) w.r.t. initial conditions and metric params.

Forward-mode differentiation (`jax.jvp` / `jax.jacfwd`) flows through the whole
loop — the analogue of the reference pushing ForwardDiff duals through the
integrator (`src/tracing/precision-solvers.jl:73-131`).

Two execution strategies:

- `integrate_rays` — one global `lax.while_loop`, fully jittable/differentiable
  (used inside jit/jvp contexts). Every loop iteration advances the WHOLE
  batch, so the wall-clock is set by the slowest ray (the lockstep tail).
- `CompactedIntegrator` — the high-throughput path for large batches
  (rendering, transfer tables): runs the same loop in fixed-size segments and,
  between segments, compacts the still-alive rays into progressively smaller
  power-of-4 buckets (argsort + gather), scattering finished rays into the
  full-size output. Total work drops from N × max(steps) to ≈ N × mean(steps),
  a ~10-30× win on renders where the step-count distribution is heavy-tailed
  (the reference gets the same effect for free from dynamic per-thread
  scheduling in `EnsembleEndpointThreads`, tracing.jl:151-196).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp
from jax import lax

from gradus_tpu.integrate.status import StatusCodes
from gradus_tpu.integrate.tsit5 import tsit5_step, hermite_interp, initial_dt

__all__ = [
    "integrate_rays",
    "integrate_rays_checkpointed",
    "IntegrationResult",
    "CompactedIntegrator",
]

# PI step-size controller constants (standard Gustafsson / OrdinaryDiffEq-style)
_GAMMA = 0.9
_BETA1 = 7.0 / 50.0
_BETA2 = 2.0 / 25.0
_QMAX_FACTOR = 10.0
_QMIN_FACTOR = 0.2
_QOLD_INIT = 1e-4


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class IntegrationResult:
    """Struct-of-arrays solver output over the ray batch."""

    y: Any  # (N, S) final state
    lam: Any  # (N,) final affine parameter
    y0: Any  # (N, S) initial state
    lam0: Any  # (N,) initial affine parameter
    status: Any  # (N,) int32 StatusCodes
    steps: Any  # (N,) int32 accepted step count
    failed: Any  # (N,) bool — dt underflow (should never fire)
    traj: Any = None  # (N, n_save, S) accepted-step states (save_path mode)
    traj_lam: Any = None  # (N, n_save) affine parameters of saved states


def _error_norm(err_vec, y, y_new, abstol, reltol):
    sc = abstol + jnp.maximum(jnp.abs(y), jnp.abs(y_new)) * reltol
    return jnp.sqrt(jnp.mean((err_vec / sc) ** 2, axis=-1))


@dataclasses.dataclass(frozen=True)
class _Problem:
    """Static description of one integration problem (everything that shapes
    the loop body; the per-ray state lives in the carry dict)."""

    f: Callable
    abstol: float
    reltol: float
    r_inner: Any
    r_outer: Any
    crossing_fn: Callable | None = None
    hit_fn: Callable | None = None
    segment_fn: Callable | None = None
    terminate_fns: tuple = ()
    max_steps: int = 40000
    n_interp: int = 8
    dt_min: float = 1e-10
    bisect_iters: int = 10
    newton_iters: int = 3
    terminate_on_hit: bool = True
    n_save: int = 0
    # "cubic": analytic first-crossing of the Hermite cubic of the signed
    # indicator (events.py; ~10x cheaper per step). "sampled": reference-style
    # interpolant sampling at n_interp points + in-loop bisection.
    event_method: str = "cubic"


def _vma_like(x, ref):
    """Give x the varying-manual-axes (shard_map VMA) of ref.

    Inside `shard_map` the loop body makes every per-ray carry leaf
    device-varying; leaves initialized from replicated scalars (λ-span, status
    fills) must be pcast to match or the while_loop carry typecheck fails.
    No-op outside shard_map."""
    vma = getattr(jax.typeof(ref), "vma", frozenset()) - getattr(
        jax.typeof(x), "vma", frozenset()
    )
    if vma:
        return jax.lax.pcast(x, tuple(vma), to="varying")
    return x


def _init_carry(p: _Problem, y0, lam_span):
    y0 = jnp.asarray(y0)
    N = y0.shape[:-1]
    dtype = y0.dtype
    lam0 = _vma_like(jnp.broadcast_to(jnp.asarray(lam_span[0], dtype), N), y0)
    lam1 = _vma_like(jnp.broadcast_to(jnp.asarray(lam_span[1], dtype), N), y0)

    dt0 = jnp.minimum(initial_dt(p.f, y0, p.abstol, p.reltol), lam1 - lam0)
    k1_0 = p.f(y0)

    status0 = _vma_like(jnp.full(N, StatusCodes.NoStatus, dtype=jnp.int32), y0)
    # rays whose initial state/RHS is non-finite (e.g. physically impossible
    # initial velocities) are dead on arrival — flagged failed, not integrated
    bad0 = ~(
        jnp.all(jnp.isfinite(y0), axis=-1)
        & jnp.isfinite(dt0)
        & jnp.all(jnp.isfinite(k1_0), axis=-1)
    )
    alive0 = ~bad0

    use_cubic = p.crossing_fn is not None and p.event_method == "cubic"
    if p.crossing_fn is not None:
        if use_cubic:
            c_prev0, dc_prev0 = jax.jvp(p.crossing_fn, (y0,), (k1_0,))
        else:
            c_prev0 = p.crossing_fn(y0)
            dc_prev0 = _vma_like(jnp.zeros(N, dtype), y0)
    else:
        c_prev0 = _vma_like(jnp.zeros(N, dtype), y0)
        dc_prev0 = _vma_like(jnp.zeros(N, dtype), y0)

    carry0 = dict(
        y=y0,
        lam=lam0,
        lam1=lam1,
        dt=dt0,
        k1=k1_0,
        qold=_vma_like(jnp.full(N, _QOLD_INIT, dtype), y0),
        status=status0,
        alive=alive0,
        steps=_vma_like(jnp.zeros(N, jnp.int32), y0),
        failed=bad0,
        c_prev=c_prev0,
        dc_prev=dc_prev0,
        hit_y=y0,
        hit_k=k1_0,
        hit_dt=_vma_like(jnp.zeros(N, dtype), y0),
        hit_lam=lam0,
        hit_theta=_vma_like(jnp.zeros(N, dtype), y0),
        iters=jnp.int32(0),
    )
    if p.n_save > 0:
        # trajectory buffers: slot 0 holds the initial state
        traj0 = (
            jnp.zeros(N + (p.n_save,) + y0.shape[-1:], dtype).at[..., 0, :].set(y0)
        )
        carry0["traj"] = traj0
        carry0["traj_lam"] = jnp.zeros(N + (p.n_save,), dtype).at[..., 0].set(lam0)
    return carry0, lam0


def _make_body(p: _Problem, dtype):
    """The loop body: one adaptive Tsit5 step + event handling for every ray."""
    f = p.f
    have_geometry = p.crossing_fn is not None
    thetas = jnp.linspace(0.0, 1.0, p.n_interp + 1)[1:].astype(dtype)

    def body(c):
        y, lam, dt = c["y"], c["lam"], c["dt"]
        lam1 = c["lam1"]
        alive = c["alive"]
        dt_eff = jnp.clip(lam1 - lam, p.dt_min, dt)
        y_new, err_vec, _, k7 = tsit5_step(f, y, dt_eff, c["k1"])
        err = _error_norm(err_vec, y, y_new, p.abstol, p.reltol)
        err = jnp.maximum(err, 1e-12)
        step_ok = jnp.isfinite(err) & jnp.all(jnp.isfinite(y_new), axis=-1)
        err = jnp.where(step_ok, err, 2.0)  # treat NaN steps as rejected
        accept = (err <= 1.0) & alive

        # --- PI controller ---------------------------------------------------
        q = (err**_BETA1) / (c["qold"] ** _BETA2) / _GAMMA
        fac_acc = 1.0 / jnp.clip(q, 1.0 / _QMAX_FACTOR, 1.0 / _QMIN_FACTOR)
        fac_rej = 1.0 / jnp.clip((err**0.2) / _GAMMA, 1.0, 1.0 / _QMIN_FACTOR)
        dt_next = jnp.where(accept, dt_eff * fac_acc, dt_eff * fac_rej)
        failed = c["failed"] | (
            alive & ~step_ok & ((dt_next < p.dt_min) | ~jnp.isfinite(dt_next))
        )
        qold_new = jnp.where(accept, jnp.maximum(err, _QOLD_INIT), c["qold"])

        lam_new = lam + dt_eff

        # --- geometry event (continuous) --------------------------------------
        dc_prev_new = c["dc_prev"]
        if have_geometry and p.event_method == "cubic":
            from gradus_tpu.integrate.events import cubic_first_crossing

            f0 = c["k1"]
            c1v, dc1v = jax.jvp(p.crossing_fn, (y_new,), (k7,))
            found, th_c = cubic_first_crossing(
                c["c_prev"],
                dt_eff * c["dc_prev"],
                c1v,
                dt_eff * dc1v,
            )
            candidate = found & accept
            y_c = hermite_interp(th_c, y, y_new, f0, k7, dt_eff)
            valid = (
                p.hit_fn(y_c)
                if p.hit_fn is not None
                else jnp.ones(lam.shape, dtype=bool)
            )
            hit_now = candidate & valid
            c_prev_new = jnp.where(accept, c1v, c["c_prev"])
            dc_prev_new = jnp.where(accept, dc1v, c["dc_prev"])
        elif have_geometry:
            f0 = c["k1"]

            def interp_at(theta):
                return hermite_interp(
                    jnp.broadcast_to(theta, lam.shape), y, y_new, f0, k7, dt_eff
                )

            cs = jax.vmap(lambda t: p.crossing_fn(interp_at(t)))(thetas)  # (K, N)
            c_all = jnp.concatenate([c["c_prev"][None], cs], axis=0)
            sign_change = (
                jnp.signbit(c_all[:-1]) != jnp.signbit(c_all[1:])
            ) & accept[None]
            candidate = jnp.any(sign_change, axis=0)
            first = jnp.argmax(sign_change, axis=0)
            theta_grid = jnp.concatenate([jnp.zeros(1, dtype), thetas])
            th_lo = theta_grid[first]
            th_hi = theta_grid[first + 1]
            c_lo = jnp.take_along_axis(c_all, first[None], axis=0)[0]

            # in-loop bisection on the interpolant: the left-end sign is
            # tracked so each iteration costs ONE crossing evaluation (the
            # post-loop Newton polish restores full 5th-order accuracy)
            def bis(_, st):
                a, b, ca = st
                mid = 0.5 * (a + b)
                cm = p.crossing_fn(interp_at(mid))
                same = jnp.signbit(cm) == jnp.signbit(ca)
                a_n = jnp.where(same, mid, a)
                ca_n = jnp.where(same, cm, ca)
                b_n = jnp.where(same, b, mid)
                return a_n, b_n, ca_n

            th_a, th_b, _ = lax.fori_loop(
                0, p.bisect_iters, bis, (th_lo, th_hi, c_lo)
            )
            th_c = 0.5 * (th_a + th_b)
            y_c = interp_at(th_c)
            N_shape = lam.shape
            valid = (
                p.hit_fn(y_c)
                if p.hit_fn is not None
                else jnp.ones(N_shape, dtype=bool)
            )
            hit_now = candidate & valid
            c_prev_new = jnp.where(accept, c_all[-1], c["c_prev"])
        elif p.segment_fn is not None:
            # segment-based geometry (meshes): test each interpolant chord;
            # terminate at step end like the reference's DiscreteCallback
            f0 = c["k1"]

            def pos_at(theta):
                ys = hermite_interp(
                    jnp.broadcast_to(theta, lam.shape), y, y_new, f0, k7, dt_eff
                )
                return ys[..., 0:4]

            pts = jax.vmap(pos_at)(jnp.concatenate([jnp.zeros(1, dtype), thetas]))
            seg_hits = jax.vmap(p.segment_fn)(pts[:-1], pts[1:])  # (K, N)
            hit_now = jnp.any(seg_hits, axis=0) & accept
            th_c = jnp.ones(lam.shape, dtype)
            c_prev_new = c["c_prev"]
        else:
            hit_now = jnp.zeros_like(alive)
            th_c = jnp.zeros(lam.shape, dtype)
            c_prev_new = c["c_prev"]

        # --- chart + user discrete events (step end), masked by no-hit -------
        # r_inner may be a θ-dependent PoloidalShape (reference
        # `PoloidalShapeChart`, charts.jl:26-48) — interpolate r_min(θ)
        r_new = y_new[..., 1]
        shape = getattr(p.r_inner, "rs", None)
        if shape is not None:
            rmin = jnp.interp(y_new[..., 2], p.r_inner.thetas, p.r_inner.rs)
        else:
            rmin = p.r_inner
        inner = accept & ~hit_now & (r_new <= rmin)
        outer = accept & ~hit_now & (r_new > p.r_outer)
        user_masks = []
        for pred, _code in p.terminate_fns:
            user_masks.append(
                accept & ~hit_now & ~inner & ~outer & pred(y_new, lam_new)
            )
        finished = accept & (lam_new >= lam1 - 1e-12)

        # --- commit ----------------------------------------------------------
        sel = accept[..., None]
        y_out = jnp.where(sel, y_new, y)
        lam_out = jnp.where(accept, lam_new, lam)
        k1_out = jnp.where(sel, k7, c["k1"])

        status = c["status"]
        status = jnp.where(inner, StatusCodes.WithinInnerBoundary, status)
        status = jnp.where(outer, StatusCodes.OutOfDomain, status)
        for (pred, code), mask in zip(p.terminate_fns, user_masks):
            status = jnp.where(mask, code, status)

        if p.terminate_on_hit:
            status = jnp.where(hit_now, StatusCodes.IntersectedWithGeometry, status)
            dead = hit_now | inner | outer | finished | failed
        else:
            # bump the crossing counter (last state component) and continue
            y_out = jnp.where(
                hit_now[..., None],
                y_out.at[..., -1].add(1.0),
                y_out,
            )
            dead = inner | outer | finished | failed
        for mask in user_masks:
            dead = dead | mask
        alive_out = alive & ~dead

        hsel = hit_now[..., None]
        out = dict(
            y=y_out,
            lam=lam_out,
            lam1=lam1,
            dt=dt_next,
            k1=k1_out,
            qold=qold_new,
            status=status,
            alive=alive_out,
            steps=c["steps"] + accept.astype(jnp.int32),
            failed=failed,
            c_prev=c_prev_new,
            dc_prev=dc_prev_new,
            hit_y=jnp.where(hsel, y, c["hit_y"]),
            hit_k=jnp.where(hsel, c["k1"], c["hit_k"]),
            hit_dt=jnp.where(hit_now, dt_eff, c["hit_dt"]),
            hit_lam=jnp.where(hit_now, lam, c["hit_lam"]),
            hit_theta=jnp.where(hit_now, th_c, c["hit_theta"]),
            iters=c["iters"] + 1,
        )
        if p.n_save > 0:
            steps_new = c["steps"] + accept.astype(jnp.int32)
            idx = jnp.clip(steps_new, 0, p.n_save - 1)
            rows = jnp.arange(idx.shape[0])
            cur = c["traj"][rows, idx]
            out["traj"] = c["traj"].at[rows, idx].set(
                jnp.where(accept[..., None], y_new, cur)
            )
            cur_l = c["traj_lam"][rows, idx]
            out["traj_lam"] = c["traj_lam"].at[rows, idx].set(
                jnp.where(accept, lam_new, cur_l)
            )
        return out

    return body


def _polish_hits(p: _Problem, cf: dict, y_f, lam_f):
    """Newton polish on the exact trajectory: one 5th-order RK substep from
    the hit step's start to λ*, then λ* ← λ* − c(y*)/(∇c·f)(y*)."""
    hit = cf["status"] == StatusCodes.IntersectedWithGeometry
    y_s, k_s, dt_s = cf["hit_y"], cf["hit_k"], cf["hit_dt"]
    dt_safe = jnp.where(hit, dt_s, 1.0)

    def newton_body(_, th):
        dtt = th * dt_safe
        ystar, _, _, _ = tsit5_step(p.f, y_s, dtt, k_s)
        cval, cdot = jax.jvp(p.crossing_fn, (ystar,), (p.f(ystar),))
        cdot = jnp.where(jnp.abs(cdot) < 1e-30, 1.0, cdot)
        th_new = th - cval / (cdot * dt_safe)
        return jnp.clip(th_new, 0.0, 1.0)

    theta_star = lax.fori_loop(0, p.newton_iters, newton_body, cf["hit_theta"])
    dt_star = theta_star * dt_safe
    y_star, _, _, _ = tsit5_step(p.f, y_s, dt_star, k_s)
    hsel = hit[..., None]
    y_f = jnp.where(hsel, y_star, y_f)
    lam_f = jnp.where(hit, cf["hit_lam"] + dt_star, lam_f)
    return y_f, lam_f


def integrate_rays(
    f: Callable,
    y0,
    lam_span,
    *,
    abstol: float,
    reltol: float,
    r_inner,
    r_outer,
    crossing_fn: Callable | None = None,
    hit_fn: Callable | None = None,
    segment_fn: Callable | None = None,
    terminate_fns: tuple = (),
    max_steps: int = 40000,
    n_interp: int = 8,
    dt_min: float = 1e-10,
    bisect_iters: int = 10,
    newton_iters: int = 3,
    terminate_on_hit: bool = True,
    n_save: int = 0,
    event_method: str = "cubic",
) -> IntegrationResult:
    """Integrate a batch of rays dy/dλ = f(y) from λ0 to λ1 with events.

    Parameters
    ----------
    f : RHS ``f(y) -> dy`` over ``(..., S)`` states (first 4 components must be
        the position 4-vector for the chart checks).
    y0 : (N, S) initial states.
    lam_span : (λ0, λ1) scalars, or per-ray arrays broadcastable to (N,).
    r_inner, r_outer : chart bounds (scalars).
    crossing_fn : optional signed surface indicator ``c(y) -> (...,)``; a zero
        crossing that passes ``hit_fn`` terminates with
        IntersectedWithGeometry.
    hit_fn : validity predicate at a located crossing (annulus test).
    terminate_fns : tuple of ``(pred(y, lam) -> bool mask, status_code)``
        discrete step-end callbacks (e.g. domain_upper_hemisphere).
    terminate_on_hit : when False, a validated crossing does NOT kill the ray;
        instead the LAST state component is incremented by 1 (crossing
        counter — used for winding counts and optically-thick radiative
        transfer 'within geometry' flags; reference
        `src/tracing/photon-rings.jl` and
        `radiative-transfer-problem.jl:101-117`).
    """
    y0 = jnp.asarray(y0)
    p = _Problem(
        f=f,
        abstol=abstol,
        reltol=reltol,
        r_inner=r_inner,
        r_outer=r_outer,
        crossing_fn=crossing_fn,
        hit_fn=hit_fn,
        segment_fn=segment_fn,
        terminate_fns=terminate_fns,
        max_steps=max_steps,
        n_interp=n_interp,
        dt_min=dt_min,
        bisect_iters=bisect_iters,
        newton_iters=newton_iters,
        terminate_on_hit=terminate_on_hit,
        n_save=n_save,
        event_method=event_method,
    )
    carry0, lam0 = _init_carry(p, y0, lam_span)
    body = _make_body(p, y0.dtype)

    def cond(c):
        return jnp.any(c["alive"]) & (c["iters"] < p.max_steps)

    cf = lax.while_loop(cond, body, carry0)

    y_f, lam_f, status = cf["y"], cf["lam"], cf["status"]
    if crossing_fn is not None and terminate_on_hit:
        y_f, lam_f = _polish_hits(p, cf, y_f, lam_f)

    return IntegrationResult(
        y=y_f,
        lam=lam_f,
        y0=y0,
        lam0=lam0,
        status=status,
        steps=cf["steps"],
        failed=cf["failed"],
        traj=cf.get("traj"),
        traj_lam=cf.get("traj_lam"),
    )


def integrate_rays_checkpointed(
    f: Callable,
    y0,
    lam_span,
    *,
    abstol: float,
    reltol: float,
    r_inner,
    r_outer,
    crossing_fn: Callable | None = None,
    hit_fn: Callable | None = None,
    terminate_fns: tuple = (),
    n_segments: int = 64,
    seg_steps: int = 32,
    n_interp: int = 8,
    dt_min: float = 1e-10,
    bisect_iters: int = 10,
    newton_iters: int = 3,
    terminate_on_hit: bool = True,
    event_method: str = "cubic",
) -> IntegrationResult:
    """Reverse-differentiable variant of `integrate_rays`.

    The adaptive `lax.while_loop` is replaced by a bounded
    ``scan(n_segments) ∘ checkpoint ∘ fori_loop(seg_steps)`` ladder: reverse
    mode stores one carry per segment and rematerializes the steps inside a
    segment during the backward sweep (one-level treeverse). Loop bodies,
    event localization and the Newton hit-polish are identical to the
    forward-mode path (same `_make_body`/`_polish_hits`), so primals match
    `integrate_rays` exactly whenever ``n_segments·seg_steps`` covers the
    trajectory; segments whose rays are all finished are skipped via
    `lax.cond`, recovering the early exit.

    This is the many-parameter adjoint path: `jax.grad` flows
    through in O(1) integrations regardless of parameter count — use it when
    ≳ 10 parameters enter the traced dynamics (neural/spline disc surfaces,
    many-coefficient deformed metrics). For ≲ 10 parameters the forward
    Jacobian wrapper (`gradus_tpu.diff.fwd_adjoint`) is cheaper.

    Reference analogue: none — Gradus is forward-mode only
    (`precision-solvers.jl:73-131`); this extends the BASELINE gradient
    north-star to many-parameter fitting heads.
    """
    y0 = jnp.asarray(y0)

    # Reverse-mode NaN guard: trial steps can probe inside the horizon where
    # the metric is singular (Δ → 0); the forward path just rejects those
    # steps, but their non-finite linearization residuals poison cotangents
    # (0 × NaN) in the backward sweep. Clamping r a hair above the chart's
    # inner bound only alters states the integrator terminates anyway. The θ
    # clamp (needed for the sin θ pole of the metric) DOES perturb primal
    # dynamics for rays passing within 1e-6 rad of the pole: for those the
    # primal deviates from `integrate_rays` at the clamp scale. Legitimate
    # polar crossings stay well clear in practice (the RHS unwraps θ past the
    # pole rather than grazing it); exact-pole shots are measure-zero camera
    # configurations.
    r_floor = jnp.asarray(r_inner) * 0.995
    th_eps = 1e-6

    def f_safe(y):
        r_s = jnp.maximum(y[..., 1], r_floor)
        th_s = jnp.clip(y[..., 2], th_eps, jnp.pi - th_eps)
        y_s = y.at[..., 1].set(r_s).at[..., 2].set(th_s)
        return f(y_s)

    p = _Problem(
        f=f_safe,
        abstol=abstol,
        reltol=reltol,
        r_inner=r_inner,
        r_outer=r_outer,
        crossing_fn=crossing_fn,
        hit_fn=hit_fn,
        terminate_fns=terminate_fns,
        max_steps=n_segments * seg_steps,
        n_interp=n_interp,
        dt_min=dt_min,
        bisect_iters=bisect_iters,
        newton_iters=newton_iters,
        terminate_on_hit=terminate_on_hit,
        n_save=0,
        event_method=event_method,
    )
    carry0, lam0 = _init_carry(p, y0, lam_span)
    body = _make_body(p, y0.dtype)

    @jax.checkpoint
    def segment(c):
        return lax.fori_loop(0, seg_steps, lambda _, cc: body(cc), c)

    def scan_step(c, _):
        c = lax.cond(jnp.any(c["alive"]), segment, lambda cc: cc, c)
        return c, None

    cf, _ = lax.scan(scan_step, carry0, None, length=n_segments)

    y_f, lam_f, status = cf["y"], cf["lam"], cf["status"]
    if crossing_fn is not None and terminate_on_hit:
        y_f, lam_f = _polish_hits(p, cf, y_f, lam_f)

    return IntegrationResult(
        y=y_f,
        lam=lam_f,
        y0=y0,
        lam0=lam0,
        status=status,
        steps=cf["steps"],
        failed=cf["failed"],
    )


# --- compacted execution ------------------------------------------------------

# final per-ray fields scattered into the full-size output between compactions
_OUT_KEYS = (
    "y",
    "lam",
    "status",
    "steps",
    "failed",
    "hit_y",
    "hit_k",
    "hit_dt",
    "hit_lam",
    "hit_theta",
)


def _next_bucket(n: int, min_bucket: int) -> int:
    """Smallest power-of-4 multiple of `min_bucket` that is ≥ n."""
    b = min_bucket
    while b < n:
        b *= 4
    return b


class CompactedIntegrator:
    """Host-driven segmented integration with alive-ray compaction.

    Builds its jitted segment/gather/scatter programs once; reuse the instance
    across calls (each new working-set size compiles once and is cached by
    shape). Not differentiable end-to-end (the host loop breaks the trace) —
    use `integrate_rays` inside jit/jvp contexts.
    """

    def __init__(
        self,
        f: Callable,
        *,
        abstol: float,
        reltol: float,
        r_inner,
        r_outer,
        crossing_fn: Callable | None = None,
        hit_fn: Callable | None = None,
        segment_fn: Callable | None = None,
        terminate_fns: tuple = (),
        max_steps: int = 40000,
        n_interp: int = 8,
        dt_min: float = 1e-10,
        bisect_iters: int = 10,
        newton_iters: int = 3,
        terminate_on_hit: bool = True,
        segment_iters: int = 96,
        min_bucket: int = 8192,
        event_method: str = "cubic",
        segment_schedule: tuple | None = None,
        progress=None,
    ):
        self.p = _Problem(
            f=f,
            abstol=abstol,
            reltol=reltol,
            r_inner=r_inner,
            r_outer=r_outer,
            crossing_fn=crossing_fn,
            hit_fn=hit_fn,
            segment_fn=segment_fn,
            terminate_fns=terminate_fns,
            max_steps=max_steps,
            n_interp=n_interp,
            dt_min=dt_min,
            bisect_iters=bisect_iters,
            newton_iters=newton_iters,
            terminate_on_hit=terminate_on_hit,
            n_save=0,
            event_method=event_method,
        )
        self.segment_iters = segment_iters
        self.min_bucket = min_bucket
        # per-segment progress hook (reference ProgressMeter parity,
        # rendering/utility.jl:30-41): called with a dict after every
        # compaction segment — width, executed iters, rays still alive
        self.progress = progress
        # growing segment schedule: short early segments let compaction trim
        # the fast-dying bulk (disc hits cluster at ~60 steps on the flagship
        # render) before wasting full-width lanes; long late segments
        # amortize host round trips over the long-lived tail. The cap is a
        # traced operand, so the schedule adds NO extra compilations.
        if segment_schedule is None:
            s, seq = max(segment_iters // 4, 8), []
            while s < segment_iters:
                seq.extend([s, s])
                s *= 2
            segment_schedule = tuple(seq) or (segment_iters,)
        self.segment_schedule = tuple(segment_schedule)

        p = self.p

        def _segment(carry, iter_cap):
            body = _make_body(p, carry["y"].dtype)

            def cond(c):
                return jnp.any(c["alive"]) & (c["iters"] < iter_cap)

            out = lax.while_loop(cond, body, carry)
            return out, jnp.sum(out["alive"])

        def _compact(carry, bucket: int):
            # alive rays first (stable), then gather the leading `bucket`
            order = jnp.argsort(~carry["alive"], stable=True)
            idx = order[:bucket]
            gathered = {
                k: (v if k == "iters" else v[idx]) for k, v in carry.items()
            }
            return gathered, idx

        def _scatter(out, carry, glob_idx):
            return {
                k: out[k].at[glob_idx].set(carry[k]) for k in _OUT_KEYS
            }

        def _finalize(out, y0, lam0):
            y_f, lam_f, status = out["y"], out["lam"], out["status"]
            if p.crossing_fn is not None and p.terminate_on_hit:
                y_f, lam_f = _polish_hits(p, out, y_f, lam_f)
            return IntegrationResult(
                y=y_f,
                lam=lam_f,
                y0=y0,
                lam0=lam0,
                status=status,
                steps=out["steps"],
                failed=out["failed"],
            )

        def _init(y0, lam_span):
            return _init_carry(p, y0, lam_span)

        self._segment = jax.jit(_segment)
        self._compact = jax.jit(_compact, static_argnums=1)
        self._scatter = jax.jit(_scatter)
        self._finalize = jax.jit(_finalize)
        self._init = jax.jit(_init)

    def __call__(self, y0, lam_span) -> IntegrationResult:
        y0 = jnp.asarray(y0)
        if y0.ndim != 2:
            raise ValueError("CompactedIntegrator expects a (N, S) batch")
        N = y0.shape[0]
        carry, lam0 = self._init(y0, lam_span)

        out = {k: carry[k] for k in _OUT_KEYS}
        # identity mapping: working-set row -> global ray index
        glob_idx = jnp.arange(N)

        iters = 0
        iters_prev = 0
        seg_no = 0
        stats = []  # per segment: (working-set width, executed iters, alive after)
        while iters < self.p.max_steps:
            width = carry["lam"].shape[0]
            seg_len = (
                self.segment_schedule[seg_no]
                if seg_no < len(self.segment_schedule)
                else self.segment_iters
            )
            seg_no += 1
            carry, n_alive = self._segment(
                carry, jnp.int32(min(iters + seg_len, self.p.max_steps))
            )
            iters += seg_len
            # one host round trip for both scalars
            n_alive, iters_exec = jax.device_get((n_alive, carry["iters"]))
            n_alive = int(n_alive)
            iters_exec = int(iters_exec)
            stats.append((width, iters_exec - iters_prev, n_alive))
            iters_prev = iters_exec
            if self.progress is not None:
                self.progress(
                    dict(
                        segment=seg_no,
                        width=width,
                        executed_iters=iters_exec,
                        alive=n_alive,
                        total=N,
                    )
                )
            if n_alive == 0:
                break
            cur = carry["lam"].shape[0]
            bucket = _next_bucket(n_alive, self.min_bucket)
            if bucket < cur:
                # flush the whole working set, then shrink to the bucket
                out = self._scatter(out, {k: carry[k] for k in _OUT_KEYS}, glob_idx)
                carry, idx = self._compact(carry, bucket)
                glob_idx = glob_idx[idx]

        out = self._scatter(out, {k: carry[k] for k in _OUT_KEYS}, glob_idx)
        # observability: lane-steps actually executed vs the useful per-ray
        # steps lets callers compute the wasted-work fraction (BASELINE /
        # SURVEY §5 profiling parity)
        self.last_stats = stats
        result = self._finalize(out, y0, lam0)
        self.last_steps = result.steps
        return result

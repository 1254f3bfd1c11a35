"""Pallas kernel (Triton route) for the geodesic integrator hot loop.

The XLA `lax.while_loop` path (`solver.integrate_rays`) streams the whole
~30-array carry through device memory on every adaptive step and advances all
rays in lockstep. This kernel removes both costs:

- **Register residency**: one GPU thread owns one ray. A program (thread
  block) owns ``block_rays = 32·num_warps`` rays, and the whole carry (state,
  FSAL cache, controller state, event bookkeeping) stays in that thread's
  registers for the whole integration. Device-memory traffic is one read of
  the initial conditions and one write of the results per ray.
- **Per-block early exit**: the in-kernel `while_loop` ends when *this
  block's* rays are done. Blocks run in parallel on the SMs and a finished
  block frees its SM for the next one, so with cost-coherent ray blocks
  (pilot ordering in `bench.py`) total work is close to Σ_rays steps(ray).

Layout is state-major: a ray block is a tuple of S ``(block_rays,)`` vectors,
one per state component, so every arithmetic op is elementwise across the
block's threads. The RHS and the event functions are consumed in component
form (`geodesic_acceleration`, `crossing_indicator_c` — see
`gradus_tpu/geodesics/equation.py` and `geometry/discs.py`).

Semantics match `solver.integrate_rays` (same Tsit5 tableau, PI controller,
chart bounds, interpolant-sampled sign-change events with in-loop bisection
and post-loop Newton polish — reference behavior per
`src/tracing/configuration.jl`, `charts.jl`, `geometry/bootstrap.jl`).
Differences: no dense output, no mesh segment events; float32 or float64
follows the input dtype.

The kernel names its route (``backend="triton"``). It compiles only for a
GPU; elsewhere pass ``interpret=True`` (the CPU tests do).
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from gradus_tpu.integrate.status import StatusCodes
from gradus_tpu.integrate.solver import (
    IntegrationResult,
    _GAMMA,
    _BETA1,
    _BETA2,
    _QMAX_FACTOR,
    _QMIN_FACTOR,
    _QOLD_INIT,
)
from gradus_tpu.integrate.tsit5 import TSIT5_C  # noqa: F401  (tableau shared)
from gradus_tpu.integrate import tsit5 as _tsit5

__all__ = ["pallas_integrate_rays", "PallasTracer", "num_warps_for"]

_WARP = 32


def num_warps_for(block_rays: int) -> int:
    """Warps per program for a ray block: one ray per thread, so a block of
    ``block_rays`` rays is ``block_rays / 32`` warps. Triton wants a power of
    two, and a program holds at most 32 warps."""
    block_rays = int(block_rays)
    if block_rays < _WARP or block_rays > 32 * _WARP or block_rays & (block_rays - 1):
        raise ValueError(
            f"block_rays must be a power of two in [32, 1024], got {block_rays}"
        )
    return block_rays // _WARP


# --- component-form Tsit5 ------------------------------------------------------


def _lc(dt, coeffs, ks):
    """dt * Σ_j coeffs[j]·ks[j], componentwise over tuples of blocks."""
    S = len(ks[0])
    return tuple(
        dt * functools.reduce(lambda a, b: a + b, (c * k[i] for c, k in zip(coeffs, ks)))
        for i in range(S)
    )


def _add(y, d):
    return tuple(yi + di for yi, di in zip(y, d))


def _tsit5_step_cm(f_cm, y, dt, k1):
    """One Tsit5 step in component form. Returns (y_new, err_vec, k7)."""
    A = _tsit5._A
    BT = _tsit5._BTILDE
    k2 = f_cm(_add(y, _lc(dt, A[0], (k1,))))
    k3 = f_cm(_add(y, _lc(dt, A[1], (k1, k2))))
    k4 = f_cm(_add(y, _lc(dt, A[2], (k1, k2, k3))))
    k5 = f_cm(_add(y, _lc(dt, A[3], (k1, k2, k3, k4))))
    k6 = f_cm(_add(y, _lc(dt, A[4], (k1, k2, k3, k4, k5))))
    y_new = _add(y, _lc(dt, A[5], (k1, k2, k3, k4, k5, k6)))
    k7 = f_cm(y_new)
    err = _lc(dt, BT, (k1, k2, k3, k4, k5, k6, k7))
    return y_new, err, k7


def _error_norm_cm(err, y, y_new, abstol, reltol):
    S = len(y)
    acc = None
    for i in range(S):
        sc = abstol + jnp.maximum(jnp.abs(y[i]), jnp.abs(y_new[i])) * reltol
        e = err[i] / sc
        acc = e * e if acc is None else acc + e * e
    return jnp.sqrt(acc / S)


def _initial_dt_cm(f_cm, y, abstol, reltol, order: int = 5):
    """Hairer-Nørsett-Wanner automatic initial step (II.4), component form."""
    S = len(y)
    f0 = f_cm(y)
    d0sq = d1sq = None
    for i in range(S):
        sc = abstol + jnp.abs(y[i]) * reltol
        a = y[i] / sc
        b = f0[i] / sc
        d0sq = a * a if d0sq is None else d0sq + a * a
        d1sq = b * b if d1sq is None else d1sq + b * b
    d0 = jnp.sqrt(d0sq / S)
    d1 = jnp.sqrt(d1sq / S)
    h0 = jnp.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / jnp.maximum(d1, 1e-30))
    y1 = tuple(y[i] + h0 * f0[i] for i in range(S))
    f1 = f_cm(y1)
    d2sq = None
    for i in range(S):
        sc = abstol + jnp.abs(y[i]) * reltol
        c = (f1[i] - f0[i]) / sc
        d2sq = c * c if d2sq is None else d2sq + c * c
    d2 = jnp.sqrt(d2sq / S) / h0
    dmax = jnp.maximum(d1, d2)
    h1 = jnp.where(
        dmax <= 1e-15,
        jnp.maximum(1e-6, h0 * 1e-3),
        (0.01 / dmax) ** (1.0 / order),
    )
    return jnp.minimum(100.0 * h0, h1), f0


def _hermite_pos(theta, y, y_new, f0, f1, dt):
    """Cubic-Hermite interpolation of the 4 position components only (events
    read positions; velocities are not needed to localize a crossing)."""
    th = theta
    h00 = (1 + 2 * th) * (1 - th) ** 2
    h10 = th * (1 - th) ** 2
    h01 = th * th * (3 - 2 * th)
    h11 = th * th * (th - 1)
    return tuple(
        h00 * y[i] + h10 * dt * f0[i] + h01 * y_new[i] + h11 * dt * f1[i]
        for i in range(4)
    )


# --- the kernel ----------------------------------------------------------------


def _make_kernel(
    S: int,
    f_cm: Callable,
    crossing_cm: Callable | None,
    hit_cm: Callable | None,
    *,
    abstol: float,
    reltol: float,
    r_inner: float,
    r_outer: float,
    lam0: float,
    lam1: float,
    max_steps: int,
    n_interp: int,
    dt_min: float,
    bisect_iters: int,
    terminate_on_hit: bool,
    steps_per_check: int = 8,
    event_method: str = "cubic",
    resume: bool = False,
):
    have_geometry = crossing_cm is not None
    use_cubic = have_geometry and event_method == "cubic"
    theta_grid = np.linspace(0.0, 1.0, n_interp + 1)  # python floats, unrolled

    def crossing_jvp(pos4, vel4):
        return jax.jvp(lambda p: crossing_cm(*p), (pos4,), (vel4,))

    def kernel(*refs):
        if resume:
            # segmented restart: the full integrator carry arrives as inputs
            (
                y0_ref,
                k1_in_ref,
                lam_in_ref,
                dt_in_ref,
                lnq_in_ref,
                status_in_ref,
                steps_in_ref,
                failed_in_ref,
                cprev_in_ref,
                dcprev_in_ref,
                hth_in_ref,
            ) = refs[:11]
            out_refs = refs[11:]
        else:
            y0_ref = refs[0]
            out_refs = refs[1:]
        (
            y_ref,
            k1_ref,
            lam_ref,
            dt_ref,
            lnq_ref,
            status_ref,
            steps_ref,
            failed_ref,
            cprev_ref,
            dcprev_ref,
            hth_ref,
            iters_ref,
            attempts_ref,
        ) = out_refs

        dtype = y0_ref.dtype
        y = tuple(y0_ref[i] for i in range(S))
        shape = y[0].shape
        zero = jnp.zeros(shape, dtype)

        if resume:
            k1 = tuple(k1_in_ref[i] for i in range(S))
            lam = lam_in_ref[...]
            dt0 = dt_in_ref[...]
            ln_qold = lnq_in_ref[...]
            status = status_in_ref[...]
            steps = steps_in_ref[...]
            failed = failed_in_ref[...]
            c_prev = cprev_in_ref[...]
            dc_prev = dcprev_in_ref[...]
            hit_th = hth_in_ref[...]
            attempts = jnp.zeros(shape, jnp.int32)
            # only rays still mid-flight continue (finished / terminated /
            # failed / padding rows all stay inert)
            alive = (
                (status == StatusCodes.NoStatus)
                & (failed == 0)
                & (lam < lam1 - 1e-12)
            ).astype(jnp.int32)
        else:
            lam = jnp.full(shape, lam0, dtype)
            dt0, k1 = _initial_dt_cm(f_cm, y, abstol, reltol)
            dt0 = jnp.minimum(dt0, lam1 - lam)

            finite0 = jnp.isfinite(dt0)
            for i in range(S):
                finite0 &= jnp.isfinite(y[i]) & jnp.isfinite(k1[i])
            # masks ride the loop carry as int32 0/1
            alive = finite0.astype(jnp.int32)
            failed = (~finite0).astype(jnp.int32)

            status = jnp.full(shape, StatusCodes.NoStatus, jnp.int32)
            steps = jnp.zeros(shape, jnp.int32)
            # the PI controller carries ln(qold): turns the 3 pow() per step
            # (= 3 log + 3 exp) into 1 log + 2 exp
            ln_qold = jnp.full(shape, float(np.log(_QOLD_INIT)), dtype)
            if use_cubic:
                c_prev, dc_prev = crossing_jvp(y[0:4], k1[0:4])
            elif have_geometry:
                c_prev = crossing_cm(y[0], y[1], y[2], y[3])
                dc_prev = zero
            else:
                c_prev = zero
                dc_prev = zero
            hit_th = zero
            attempts = jnp.zeros(shape, jnp.int32)

        # NOTE the slim carry: there are no hit_y/hit_k/hit_dt/hit_lam slots.
        # A validated hit does NOT commit its step, so at loop exit the hit
        # ray's (y, k1, lam, dt) are exactly the step-start quantities the
        # post-loop Newton polish needs — 18 fewer carried blocks and their
        # per-step masked selects than the naive bookkeeping.
        carry0 = (
            y,
            k1,
            lam,
            dt0,
            ln_qold,
            status,
            alive,
            steps,
            failed,
            c_prev,
            dc_prev,
            hit_th,
            attempts,
            jnp.int32(0),
        )

        def cond(c):
            # max, not any: Triton has no lowering for reduce_or
            return (jnp.max(c[6]) > 0) & (c[-1] < max_steps)

        def body(c):
            (
                y,
                k1,
                lam,
                dt,
                ln_qold,
                status,
                alive_i,
                steps,
                failed_i,
                c_prev,
                dc_prev,
                hit_th,
                attempts,
                iters,
            ) = c
            alive = alive_i > 0
            failed = failed_i > 0

            dt_eff = jnp.clip(lam1 - lam, dt_min, dt)
            y_new, err_vec, k7 = _tsit5_step_cm(f_cm, y, dt_eff, k1)
            err = _error_norm_cm(err_vec, y, y_new, abstol, reltol)
            err = jnp.maximum(err, 1e-12)
            step_ok = jnp.isfinite(err)
            for i in range(S):
                step_ok &= jnp.isfinite(y_new[i])
            err = jnp.where(step_ok, err, 2.0)
            accept = (err <= 1.0) & alive

            # PI controller (same constants as solver.py, log-space powers)
            ln_err = jnp.log(err)
            q = jnp.exp(_BETA1 * ln_err - _BETA2 * ln_qold) / _GAMMA
            fac_acc = 1.0 / jnp.clip(q, 1.0 / _QMAX_FACTOR, 1.0 / _QMIN_FACTOR)
            fac_rej = 1.0 / jnp.clip(
                jnp.exp(0.2 * ln_err) / _GAMMA, 1.0, 1.0 / _QMIN_FACTOR
            )
            dt_next = jnp.where(accept, dt_eff * fac_acc, dt_eff * fac_rej)
            failed = failed | (
                alive & ~step_ok & ((dt_next < dt_min) | ~jnp.isfinite(dt_next))
            )
            ln_qold_new = jnp.where(
                accept, jnp.maximum(ln_err, float(np.log(_QOLD_INIT))), ln_qold
            )
            lam_new = lam + dt_eff

            # --- geometry event: sign change on the position interpolant ----
            dc_prev_new = dc_prev
            if use_cubic:
                from gradus_tpu.integrate.events import cubic_first_crossing

                c1v, dc1v = crossing_jvp(y_new[0:4], k7[0:4])
                found, th_c = cubic_first_crossing(
                    c_prev, dt_eff * dc_prev, c1v, dt_eff * dc1v
                )
                candidate = found & accept
                pos_c = _hermite_pos(th_c, y, y_new, k1, k7, dt_eff)
                valid = (
                    hit_cm(*pos_c) if hit_cm is not None else jnp.ones(shape, bool)
                )
                hit_now = candidate & valid
                c_prev_new = jnp.where(accept, c1v, c_prev)
                dc_prev_new = jnp.where(accept, dc1v, dc_prev)
            elif have_geometry:

                def interp_pos(theta):
                    return _hermite_pos(theta, y, y_new, k1, k7, dt_eff)

                found = jnp.zeros(shape, bool)
                th_lo = zero
                th_hi = jnp.ones(shape, dtype)
                c_lo = c_prev
                c_left = c_prev
                for k in range(n_interp):
                    th_r = jnp.asarray(theta_grid[k + 1], dtype)
                    c_right = crossing_cm(*interp_pos(th_r))
                    sc = ((c_left < 0) != (c_right < 0)) & ~found
                    th_lo = jnp.where(sc, jnp.asarray(theta_grid[k], dtype), th_lo)
                    th_hi = jnp.where(sc, th_r, th_hi)
                    c_lo = jnp.where(sc, c_left, c_lo)
                    found = found | sc
                    c_left = c_right
                candidate = found & accept

                def bis(_, st):
                    a, b, ca = st
                    mid = 0.5 * (a + b)
                    cm = crossing_cm(*interp_pos(mid))
                    same = (cm < 0) == (ca < 0)
                    return (
                        jnp.where(same, mid, a),
                        jnp.where(same, b, mid),
                        jnp.where(same, cm, ca),
                    )

                th_a, th_b, _ = lax.fori_loop(
                    0, bisect_iters, bis, (th_lo, th_hi, c_lo)
                )
                th_c = 0.5 * (th_a + th_b)
                pos_c = interp_pos(th_c)
                valid = (
                    hit_cm(*pos_c) if hit_cm is not None else jnp.ones(shape, bool)
                )
                hit_now = candidate & valid
                c_prev_new = jnp.where(accept, c_left, c_prev)
            else:
                hit_now = jnp.zeros(shape, bool)
                th_c = zero
                c_prev_new = c_prev

            # --- chart bounds (discrete, step end) ---------------------------
            r_new = y_new[1]
            inner = accept & ~hit_now & (r_new <= r_inner)
            outer = accept & ~hit_now & (r_new > r_outer)
            finished = accept & (lam_new >= lam1 - 1e-12)

            status = jnp.where(inner, StatusCodes.WithinInnerBoundary, status)
            status = jnp.where(outer, StatusCodes.OutOfDomain, status)
            if terminate_on_hit:
                # hit rays do NOT commit: (y, k1, lam) stay at step start and
                # dt records the step span, feeding the post-loop polish
                sel = accept & ~hit_now
                status = jnp.where(
                    hit_now, StatusCodes.IntersectedWithGeometry, status
                )
                dead = hit_now | inner | outer | finished | failed
                dt_out = jnp.where(hit_now, dt_eff, dt_next)
            else:
                sel = accept
                dead = inner | outer | finished | failed
                dt_out = dt_next
            y_out = tuple(jnp.where(sel, y_new[i], y[i]) for i in range(S))
            if not terminate_on_hit:
                y_out = y_out[:-1] + (
                    jnp.where(hit_now, y_out[-1] + 1.0, y_out[-1]),
                )
            lam_out = jnp.where(sel, lam_new, lam)
            k1_out = tuple(jnp.where(sel, k7[i], k1[i]) for i in range(S))
            alive_out = alive & ~dead

            hit_th = jnp.where(hit_now, th_c, hit_th)

            return (
                y_out,
                k1_out,
                lam_out,
                dt_out,
                ln_qold_new,
                status,
                alive_out.astype(jnp.int32),
                steps + accept.astype(jnp.int32),
                failed.astype(jnp.int32),
                c_prev_new,
                dc_prev_new,
                hit_th,
                attempts + alive.astype(jnp.int32),
                iters + 1,
            )

        # The loop condition is a block-wide reduction behind a barrier; run
        # steps_per_check steps per check — dead rays do masked no-op work
        # for at most steps_per_check-1 iterations.
        cf = lax.while_loop(
            cond, lambda c: lax.fori_loop(0, steps_per_check, lambda _, cc: body(cc), c), carry0
        )

        for i in range(S):
            y_ref[i] = cf[0][i]
            k1_ref[i] = cf[1][i]
        lam_ref[...] = cf[2]
        dt_ref[...] = cf[3]
        lnq_ref[...] = cf[4]
        status_ref[...] = cf[5]
        steps_ref[...] = cf[7]
        failed_ref[...] = cf[8]
        cprev_ref[...] = cf[9]
        dcprev_ref[...] = cf[10]
        hth_ref[...] = cf[11]
        # observability: loop iterations this block actually executed (every
        # ray in the block occupies a thread for all of them) vs the iterations
        # each ray was still alive for ("attempts" = accepted + rejected
        # steps) — callers decompose executed thread-steps into scheduling
        # waste (dead threads) and adaptive-control rejects
        attempts_ref[...] = cf[12]
        iters_ref[...] = jnp.full(cf[7].shape, cf[13], jnp.int32)

    return kernel


# raw integrator state fields, in kernel input/output order after y
_STATE_KEYS = (
    "k1",
    "lam",
    "dt",
    "ln_qold",
    "status",
    "steps",
    "failed",
    "c_prev",
    "dc_prev",
    "hit_theta",
)


def pallas_integrate_rays(
    f_cm: Callable,
    y0,
    lam_span: tuple[float, float],
    *,
    abstol: float,
    reltol: float,
    r_inner: float,
    r_outer: float,
    crossing_cm: Callable | None = None,
    hit_cm: Callable | None = None,
    max_steps: int = 40000,
    n_interp: int = 8,
    dt_min: float = 1e-10,
    bisect_iters: int = 10,
    terminate_on_hit: bool = True,
    block_rays: int = 128,
    steps_per_check: int = 8,
    event_method: str = "cubic",
    interpret: bool = False,
    iter_cap: int | None = None,
    state: dict | None = None,
):
    """Integrate a (N, S) ray batch with the register-resident Pallas kernel.

    ``f_cm``/``crossing_cm``/``hit_cm`` take component tuples (S blocks /
    4 position blocks). ``lam_span``, chart bounds and tolerances are static
    python floats (one compile per configuration). Returns the raw per-ray
    outputs; hit polishing is done by the caller (`PallasTracer`).

    ``block_rays`` rays (a power of two, one per thread) make one program.
    The kernel compiles for a GPU only; ``interpret=True`` runs it through
    the Pallas interpreter on any backend.

    Segmented execution: pass ``iter_cap`` to stop each block after that many
    loop iterations, and feed the returned dict back via ``state`` (gathered /
    re-ordered however the caller likes) to resume exactly where the capped
    pass stopped — the tail-compaction scheme in `PallasTracer.trace`.
    """
    y0 = jnp.asarray(y0)
    N, S = y0.shape
    dtype = y0.dtype
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "pallas_integrate_rays compiles for a GPU (Pallas Triton route); "
            f"the default backend is {jax.default_backend()!r}. "
            "Pass interpret=True to run the kernel in the Pallas interpreter."
        )

    T = int(block_rays)
    num_warps = num_warps_for(T)
    n_blocks = max(1, -(-N // T))
    Npad = n_blocks * T

    lam0, lam1 = float(lam_span[0]), float(lam_span[1])
    resume = state is not None

    kernel = _make_kernel(
        S,
        f_cm,
        crossing_cm,
        hit_cm,
        abstol=float(abstol),
        reltol=float(reltol),
        r_inner=float(r_inner),
        r_outer=float(r_outer),
        lam0=lam0,
        lam1=lam1,
        max_steps=max_steps if iter_cap is None else int(iter_cap),
        n_interp=n_interp,
        dt_min=dt_min,
        bisect_iters=bisect_iters,
        terminate_on_hit=terminate_on_hit,
        steps_per_check=steps_per_check,
        event_method=event_method,
        resume=resume,
    )

    blk_s = pl.BlockSpec((S, T), lambda i: (0, i))
    blk_1 = pl.BlockSpec((T,), lambda i: (i,))

    def shaped(s_axis: bool, dt=dtype):
        return jax.ShapeDtypeStruct((S, Npad) if s_axis else (Npad,), dt)

    state_specs = [blk_s] + [blk_1] * 9  # k1 then the 9 per-ray scalars
    in_specs = [blk_s] + (state_specs if resume else [])

    call = pl.pallas_call(
        kernel,
        grid=(n_blocks,),
        in_specs=in_specs,
        out_specs=(
            blk_s,  # y   (for hit rays: hit-step START state — see kernel note)
            blk_s,  # k1  (for hit rays: RHS at the hit-step start)
            blk_1,  # lam (for hit rays: λ at the hit-step start)
            blk_1,  # dt  (for hit rays: the hit step's span dt_eff)
            blk_1,  # ln_qold
            blk_1,  # status
            blk_1,  # steps
            blk_1,  # failed
            blk_1,  # c_prev
            blk_1,  # dc_prev
            blk_1,  # hit_theta
            blk_1,  # block iters
            blk_1,  # attempts
        ),
        out_shape=(
            shaped(True),
            shaped(True),
            shaped(False),
            shaped(False),
            shaped(False),
            shaped(False, jnp.int32),
            shaped(False, jnp.int32),
            shaped(False, jnp.int32),
            shaped(False),
            shaped(False),
            shaped(False),
            shaped(False, jnp.int32),
            shaped(False, jnp.int32),
        ),
        backend="triton",
        # the carry lives in registers; there is no tile stream to pipeline
        compiler_params=plt.CompilerParams(num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name="geodesic_tsit5",
    )

    # (N, S) -> (S, Npad); pad rays with NaN (flagged failed/dead in the
    # kernel's finiteness screen, so they never cost loop iterations)
    def block_s(a, fill):
        return jnp.full((Npad, S), fill, a.dtype).at[:N].set(a).T

    def block_1(a, fill):
        return jnp.full((Npad,), fill, a.dtype).at[:N].set(a)

    ins = [block_s(y0, jnp.nan)]
    if resume:
        ins.append(block_s(state["k1"], jnp.nan))
        # padding rows resume as already-finished (λ ≥ λ1) so they stay inert
        fills = dict(
            lam=lam1,
            dt=1.0,
            ln_qold=0.0,
            status=StatusCodes.NoStatus,
            steps=0,
            failed=0,
            c_prev=0.0,
            dc_prev=0.0,
            hit_theta=0.0,
        )
        for k in _STATE_KEYS[1:]:
            ins.append(block_1(state[k], fills[k]))

    outs = call(*ins)

    def unblock(a):
        return a.T[:N] if a.ndim == 2 else a[:N]

    (
        y_f, k1_f, lam_f, dt_f, lnq, status, steps, failed, cprev, dcprev,
        hth, biters, attempts,
    ) = map(unblock, outs)
    # hit rays exit the kernel UNcommitted (y/k1/lam at the hit-step start, dt
    # = the step span), so the polish inputs alias the main outputs — the slim
    # carry eliminated the dedicated hit_* bookkeeping
    return dict(
        y=y_f,
        k1=k1_f,
        lam=lam_f,
        dt=dt_f,
        ln_qold=lnq,
        status=status,
        steps=steps,
        failed=failed,
        c_prev=cprev,
        dc_prev=dcprev,
        hit_theta=hth,
        block_iters=biters,
        attempts=attempts,
        hit_y=y_f,
        hit_k=k1_f,
        hit_dt=dt_f,
        hit_lam=lam_f,
    )


class PallasTracer:
    """High-throughput tracer over a fixed (metric, geometry) pair, running the
    register-resident Pallas integrator. Drop-in alternative to `tracing.Tracer`
    for rendering/table workloads (host-driven; not differentiable end-to-end
    — use `trace_geodesics` inside jit/jvp contexts).

    Metric parameters are baked into the kernel as compile-time constants
    (`float(leaf)`), matching the reference's one-solve-per-configuration
    usage (`EnsembleEndpointThreads` reuse, src/tracing/tracing.jl:151-196).
    """

    def __init__(
        self,
        m,
        *,
        mu: float = 0.0,
        geometry=None,
        gtol: float = 1e-2,
        chart_inner: float | None = None,
        chart_outer: float = 12000.0,
        closest_approach: float = 1.01,
        abstol: float | None = None,
        reltol: float | None = None,
        max_steps: int = 40000,
        n_interp: int = 8,
        bisect_iters: int = 10,
        newton_iters: int = 3,
        block_rays: int = 128,
        steps_per_check: int = 8,
        event_method: str = "cubic",
        segment_iters: int | None = None,
        tail_bucket: int = 16384,
        dtype=None,
        interpret: bool = False,
    ):
        from gradus_tpu import config as _config
        from gradus_tpu.geodesics.equation import (
            geodesic_acceleration,
            constrain_all,
        )
        from gradus_tpu.integrate.solver import _Problem, _polish_hits
        from gradus_tpu.integrate.points import unpack_solution
        from gradus_tpu.integrate.tracing import make_geodesic_rhs, TraceGeodesic

        def _concretize(tree):
            """Pallas kernels cannot capture traced/device constants — bake
            parameters to python floats (one compile per configuration)."""

            def leaf(v):
                try:
                    return float(v)
                except (TypeError, ValueError):
                    return v

            return jax.tree_util.tree_map(leaf, tree)

        m = _concretize(m)
        geometry = _concretize(geometry)
        self.m = m
        self.geometry = geometry
        self.mu = mu
        a_tol, r_tol = _config.default_tols(dtype)
        self.abstol = a_tol if abstol is None else abstol
        self.reltol = r_tol if reltol is None else reltol
        if chart_inner is None:
            chart_inner = float(m.inner_radius()) * closest_approach
        self.r_inner = float(chart_inner)
        self.r_outer = float(chart_outer)
        self.max_steps = max_steps
        self.n_interp = n_interp
        self.bisect_iters = bisect_iters
        num_warps_for(block_rays)  # validate early
        self.block_rays = int(block_rays)
        self.steps_per_check = steps_per_check
        self.event_method = event_method
        self.segment_iters = segment_iters
        self.tail_bucket = tail_bucket
        self.interpret = interpret

        def f_cm(ys):
            t, r, th, ph, vt, vr, vth, vph = ys
            acc = geodesic_acceleration(m, r, th, vt, vr, vth, vph)
            return (vt, vr, vth, vph) + acc

        self._f_cm = f_cm
        self._crossing_cm = None
        self._hit_cm = None
        if geometry is not None:
            self._crossing_cm = geometry.crossing_indicator_c
            self._hit_cm = functools.partial(geometry.is_hit_c, gtol=gtol)

        # array-form problem for the post-loop Newton polish (shared with the
        # XLA solver so hit states are identically 5th-order accurate)
        f_arr = make_geodesic_rhs(m, TraceGeodesic(mu=mu))
        crossing_arr = (
            None
            if geometry is None
            else (lambda y: geometry.crossing_indicator(y[..., 0:4]))
        )
        self._polish_problem = _Problem(
            f=f_arr,
            abstol=self.abstol,
            reltol=self.reltol,
            r_inner=self.r_inner,
            r_outer=self.r_outer,
            crossing_fn=crossing_arr,
            newton_iters=newton_iters,
        )

        self._constrain = jax.jit(
            lambda x, v: jnp.concatenate(
                [x, constrain_all(m, x, v, mu=mu)], axis=-1
            )
        )

        @jax.jit
        def _finish(out, y0, lam0):
            y_f, lam_f = out["y"], out["lam"]
            if crossing_arr is not None:
                y_f, lam_f = _polish_hits(self._polish_problem, out, y_f, lam_f)
            res = IntegrationResult(
                y=y_f,
                lam=lam_f,
                y0=y0,
                lam0=jnp.broadcast_to(jnp.asarray(lam0, y0.dtype), y0.shape[:-1]),
                status=out["status"],
                steps=out["steps"],
                failed=out["failed"].astype(bool),
            )
            return unpack_solution(res)

        self._finish = _finish

        # jitted end-to-end programs cached per (N, S, λ-span): without this,
        # every call re-traces and re-lowers the whole kernel on the host
        self._compiled = {}
        self.last_block_iters = None

    def _integrate_kwargs(self):
        return dict(
            abstol=self.abstol,
            reltol=self.reltol,
            r_inner=self.r_inner,
            r_outer=self.r_outer,
            crossing_cm=self._crossing_cm,
            hit_cm=self._hit_cm,
            max_steps=self.max_steps,
            n_interp=self.n_interp,
            bisect_iters=self.bisect_iters,
            steps_per_check=self.steps_per_check,
            event_method=self.event_method,
            interpret=self.interpret,
        )

    def trace(self, y0, lam_span):
        """Traceable (jit-composable) trace of a constrained (N, S) batch.

        Returns ``(GeodesicPoint, aux)`` where aux carries per-ray
        observability arrays (``block_iters``: the kernel-loop iterations the
        ray's block executed; ``steps``: the ray's accepted step count;
        ``unfinished``: rays still mid-flight at exit — 0 unless a pathological
        workload overflows ``tail_bucket`` or ``max_steps``). Compose this
        under one outer `jax.jit` with camera permutations / shading to avoid
        per-call dispatch latency.

        When ``segment_iters`` is set and the batch is larger than
        ``tail_bucket``, integration is two kernel passes: a full-width pass
        capped at ``segment_iters`` loop iterations, then the surviving tail —
        typically < 1% of rays, the photon-ring cluster — is gathered into a
        ``tail_bucket``-wide resume pass, ordered by the estimated remaining
        step count (λ1−λ)/dt so each tail block is cost-coherent. This removes the
        lockstep waste the reference avoids with dynamic thread scheduling
        (tracing.jl:151-196) at the cost of one gather/scatter, with no host
        round trips."""
        lam0, lam1 = float(lam_span[0]), float(lam_span[1])
        kw = self._integrate_kwargs()
        N = y0.shape[0]

        if self.segment_iters is None or N <= self.tail_bucket:
            out = pallas_integrate_rays(
                self._f_cm, y0, (lam0, lam1), block_rays=self.block_rays, **kw
            )
        else:
            st1 = pallas_integrate_rays(
                self._f_cm,
                y0,
                (lam0, lam1),
                block_rays=self.block_rays,
                iter_cap=self.segment_iters,
                **kw,
            )
            alive = (
                (st1["status"] == StatusCodes.NoStatus)
                & (st1["failed"] == 0)
                & (st1["lam"] < lam1 - 1e-12)
            )
            # O(N) survivor compaction instead of a full argsort: scatter each
            # survivor's ray index to its cumsum slot. Unfilled/overflow slots point at ray N:
            # gathers clip to ray N-1 (a duplicate — integrated twice, written
            # back once) and scatters drop out-of-range updates.
            K = self.tail_bucket
            dest = jnp.cumsum(alive.astype(jnp.int32)) - 1
            dest = jnp.where(alive & (dest < K), dest, K)
            idx = (
                jnp.full((K + 1,), N, jnp.int32)
                .at[dest]
                .set(jnp.arange(N, dtype=jnp.int32), mode="drop")[:K]
            )
            # order the K-sized tail by estimated remaining steps (λ1−λ)/dt,
            # descending, so pass-2 blocks have coherent costs — a K-sized sort
            est = (lam1 - st1["lam"]) / jnp.maximum(st1["dt"], 1e-30)
            key = jnp.where(alive, -est, jnp.inf)
            idx = idx[jnp.argsort(key[jnp.minimum(idx, N - 1)])]
            sub_state = {k: st1[k][idx] for k in _STATE_KEYS}
            st2 = pallas_integrate_rays(
                self._f_cm,
                st1["y"][idx],
                (lam0, lam1),
                block_rays=self.block_rays,
                state=sub_state,
                **kw,
            )
            out = {
                k: st1[k].at[idx].set(st2[k]) for k in ("y",) + _STATE_KEYS
            }
            out["block_iters"] = st1["block_iters"].at[idx].add(st2["block_iters"])
            out["attempts"] = st1["attempts"].at[idx].add(st2["attempts"])
            out.update(
                hit_y=out["y"], hit_k=out["k1"], hit_dt=out["dt"], hit_lam=out["lam"]
            )

        unfinished = jnp.sum(
            (out["status"] == StatusCodes.NoStatus)
            & (out["failed"] == 0)
            & (out["lam"] < lam1 - 1e-12)
        )
        gp = self._finish(out, y0, lam0)
        aux = {
            "block_iters": out["block_iters"],
            "steps": out["steps"],
            "attempts": out["attempts"],
            "unfinished": unfinished,
        }
        return gp, aux

    def _program(self, shape, lam_span):
        key = (shape, lam_span)
        prog = self._compiled.get(key)
        if prog is None:
            prog = jax.jit(lambda y0: self.trace(y0, lam_span))
            self._compiled[key] = prog
        return prog

    def __call__(self, x, v, lam_span, constrain: bool = True):
        x = jnp.atleast_2d(jnp.asarray(x))
        v = jnp.atleast_2d(jnp.asarray(v))
        x, v = jnp.broadcast_arrays(x, v)
        if constrain:
            y0 = self._constrain(x, v)
        else:
            y0 = jnp.concatenate([x, v], axis=-1)
        lam_span = (float(lam_span[0]), float(lam_span[1]))
        gp, aux = self._program(y0.shape, lam_span)(y0)
        self.last_block_iters = aux["block_iters"]
        self.last_steps = aux["steps"]
        return gp

"""Pallas-kernel-backed Cunningham-transfer-function solver (the fast
``lineprofile(..., backend="pallas")`` path).

The CTF pipeline's cost is ~10⁴ Newton offset solves per profile, each
iteration a derivative of the image-plane→disc map through a full geodesic
integration (reference: ForwardDiff duals through OrdinaryDiffEq,
`src/tracing/precision-solvers.jl:73-131`; XLA path here: `jax.jvp` through
`integrate_rays`, `transfer/solvers.py`). The jvp doubles every RHS and
streams the ~25-array carry through device memory each step.

This module replaces the derivative with a FINITE-DIFFERENCE pair traced
through the register-resident Pallas kernel (`integrate/pallas_solver.py`):
one (2N,) kernel launch per Newton iteration gives ρ(r₀) and ρ(r₀+h)
simultaneously. The redshift field needs no tracing at all — with the
conserved-quantity formulation g(α, β) = 1/(uᵗ(ρ) − λ(α,β)·uᶲ(ρ)),
λ = p_φ/(−p_t) is a closed form of the initial conditions and u is the
Keplerian four-velocity, so ∂g/∂(α,β) splits into analytic λ/u derivatives
plus the FD ρ derivatives. The Jacobian |∂(α,β)/∂(ρ,g)| therefore costs ONE
central-difference 4N-ray launch instead of two jvp integrations.

Accuracy: the safeguarded Newton tolerates the FD slope noise (bracketing +
best-iterate fallback, identical to the XLA path); the J field uses central
differences at h ∝ √ε_ρ. Built for float32; golden-parity float64 runs stay
on the XLA jvp path. Parity vs the XLA f32 path is asserted in
tests/test_pallas_ctf.py (interpret mode); the first-moment drift on the
card is in PERF.md.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from gradus_tpu.camera.impact import map_impact_parameters
from gradus_tpu.integrate.status import StatusCodes
from gradus_tpu.metrics.base import AbstractMetric
from gradus_tpu.transfer.solvers import rtheta_to_alphabeta, _conserved_g_helpers
from gradus_tpu.utils.linalg import equatorial_project

__all__ = ["PallasCTFSolver", "get_pallas_ctf_solver"]


class PallasCTFSolver:
    """Reusable offset solver over a fixed (metric, observer, disc) triple.

    Provides the same three operations the CTF assembly consumes
    (`transfer/cunningham.py`): ``workhorse`` (solve + g + J + t),
    ``probe`` (solve + g + t, no J) and ``jacobian_at`` (J at given
    offsets), each shape-cached under one jit program.
    """

    def __init__(
        self,
        m: AbstractMetric,
        x,
        d,
        *,
        lam_max=None,
        alpha0: float = 0.0,
        beta0: float = 0.0,
        gtol: float = 1e-2,
        block_rays: int = 128,
        fd_h: float = 4e-4,
        # h = 2.5e-3·(1+|r|) balances FD truncation against float32 slope
        # noise: smaller steps destabilize the Newton, larger ones straddle
        # image branches (first-moment drift on the card: PERF.md)
        fd_h_ab: float = 2.5e-3,
        max_iter: int = 20,
        stall_iters: int = 5,
        zero_atol: float = 1e-7,
        worst_accuracy_factor: float = 1e-4,
        interpret: bool = False,
        dtype=jnp.float32,
    ):
        from gradus_tpu.integrate.pallas_solver import PallasTracer

        self.x = jnp.asarray(x, dtype)
        self.m = m
        self.alpha0 = float(alpha0)
        self.beta0 = float(beta0)
        self.lam_max = float(2.0 * self.x[1]) if lam_max is None else float(lam_max)
        self.fd_h = float(fd_h)
        self.fd_h_ab = float(fd_h_ab)
        self.max_iter = int(max_iter)
        self.stall_iters = int(stall_iters)
        self.zero_atol = float(zero_atol)
        self.worst_accuracy_factor = float(worst_accuracy_factor)
        self.tracer = PallasTracer(
            m,
            geometry=d,
            gtol=gtol,
            chart_outer=2.0 * float(self.x[1]),
            block_rays=block_rays,
            interpret=interpret,
            dtype=dtype,
        )
        self._lam_of_helpers = _conserved_g_helpers(self.tracer.m)
        self._programs = {}
        # stable identity for jit-static use (`_golden_scan(probe_fn=...)`)
        self.probe_fn = lambda rt, th, warm: self._probe_impl(rt, th, warm)

    # -- primitives -------------------------------------------------------

    def _trace_ab(self, al, be):
        """(ρ, t_hit, hit) for image-plane coordinates via the kernel."""
        v = map_impact_parameters(self.tracer.m, self.x, al, be)
        xs = jnp.broadcast_to(self.x, v.shape)
        y0 = self.tracer._constrain(xs, v)
        gp, _aux = self.tracer.trace(y0, (0.0, self.lam_max))
        rho = equatorial_project(gp.x)
        hit = gp.status == StatusCodes.IntersectedWithGeometry
        return rho, gp.x[..., 0], hit

    def _trace_rho_t(self, r_off, thetas):
        al, be = rtheta_to_alphabeta(r_off, thetas, self.alpha0, self.beta0)
        return self._trace_ab(al, be)

    def _lam_of_ab(self, al, be):
        """Conserved λ = p_φ/(−p_t) from the image-plane coordinates —
        closed form, no integration. The null constraint must be applied
        first: it solves for v^t, and λ is a ratio involving p_t."""
        from gradus_tpu.geodesics.equation import constrain_all

        m = self.tracer.m
        v = map_impact_parameters(m, self.x, al, be)
        xs = jnp.broadcast_to(self.x, v.shape)
        v = constrain_all(m, xs, v, mu=0.0)
        p0 = jnp.einsum(
            "...ij,...j->...i",
            m.metric(xs),
            v,
            precision=jax.lax.Precision.HIGHEST,
        )
        return p0[..., 3] / (-p0[..., 0])

    def _g_of(self, lam, rho):
        _lam_of, _g_conserved = self._lam_of_helpers
        return _g_conserved(lam, rho)

    # -- the FD Newton ----------------------------------------------------

    def _solve_impl(self, r_targets, thetas, r_init):
        x = self.x
        dtype = x.dtype
        eps = float(jnp.finfo(dtype).eps)
        zero_atol_eff = jnp.maximum(
            self.zero_atol, 32.0 * eps * jnp.maximum(1.0, r_targets)
        )
        accept_tol = jnp.maximum(
            self.worst_accuracy_factor * r_targets, 10 * zero_atol_eff
        )

        r0 = jnp.maximum(20.0, r_targets)
        r0 = jnp.where(jnp.isfinite(r_init) & (r_init > 0.0), r_init, r0)
        lo = jnp.zeros_like(r0)
        hi = jnp.full_like(r0, jnp.inf)
        have_hi = jnp.zeros(r0.shape, bool)
        upper_limit = 4.0 * (r_targets + 20.0)
        best_r0 = r0
        best_y0 = jnp.full_like(r0, jnp.inf)
        n = r0.shape[0]
        th2 = jnp.concatenate([thetas, thetas])

        def cond(state):
            r, lo, hi, have_hi, done, best_r, best_y, since, it = state
            return (~jnp.all(done)) & (it < self.max_iter)

        def body(state):
            r, lo, hi, have_hi, _, best_r, best_y, since, it = state
            h = self.fd_h * (1.0 + r)
            rho2, _, _ = self._trace_rho_t(jnp.concatenate([r, r + h]), th2)
            rho = rho2[:n]
            drho = (rho2[n:] - rho) / h
            y = rho - r_targets
            improved = jnp.abs(y) < best_y
            progressed = jnp.abs(y) < 0.5 * best_y
            best_r = jnp.where(improved, r, best_r)
            best_y = jnp.where(improved, jnp.abs(y), best_y)
            since = jnp.where(progressed, 0, since + 1)
            lo = jnp.where(y < 0, jnp.maximum(lo, r), lo)
            hi = jnp.where(y > 0, jnp.minimum(hi, r), hi)
            have_hi = have_hi | (y > 0)
            drho_safe = jnp.where(jnp.abs(drho) < 1e-20, 1.0, drho)
            newton = r - y / drho_safe
            # a branch-straddling FD pair (the + h ray crossed the photon-
            # ring critical curve into another image order — impossible for
            # the jvp path, whose derivative is one-sided in the limit)
            # shows up as an enormous or negative slope: treat as a bad step
            # so the bracketed bisection keeps the solve on the primary image
            branch_jump = (jnp.abs(drho) > 1e3) | (drho < 0.0)
            bad = (
                branch_jump
                | ~jnp.isfinite(newton)
                | (newton <= lo)
                | (have_hi & (newton >= hi))
                | (newton > upper_limit)
            )
            grow = jnp.minimum(2.0 * r, upper_limit)
            fallback = jnp.where(have_hi, 0.5 * (lo + hi), grow)
            converged = jnp.abs(y) < zero_atol_eff
            finished = converged | (since >= self.stall_iters)
            r_new = jnp.where(converged, r, jnp.where(bad, fallback, newton))
            return r_new, lo, hi, have_hi, finished, best_r, best_y, since, it + 1

        done0 = jnp.zeros(r0.shape, bool)
        since0 = jnp.zeros(r0.shape, jnp.int32)
        state = (r0, lo, hi, have_hi, done0, best_r0, best_y0, since0, jnp.int32(0))
        _, _, _, _, _, best_r, _, _, _ = lax.while_loop(cond, body, state)
        r_off = best_r
        rho, t_hit, hit = self._trace_rho_t(r_off, thetas)
        resid = rho - r_targets
        ok = (jnp.abs(resid) < accept_tol) & hit
        return jnp.where(ok, r_off, jnp.nan), rho, t_hit, ok

    def _probe_impl(self, r_targets, thetas, r_init):
        r_off, rho, t_hit, ok = self._solve_impl(r_targets, thetas, r_init)
        r_safe = jnp.where(ok, r_off, jnp.maximum(20.0, r_targets))
        al, be = rtheta_to_alphabeta(r_safe, thetas, self.alpha0, self.beta0)
        g = self._g_of(self._lam_of_ab(al, be), r_targets)
        return r_off, g, t_hit, ok

    def _jacobian_impl(self, r_targets, thetas, r_off):
        """(g, J, t, ok, cond) at solved offsets: one (5N,) launch gives the
        center + central α/β differences of ρ; the g field's λ-part is
        closed-form."""
        ok0 = jnp.isfinite(r_off)
        r_safe = jnp.where(ok0, r_off, jnp.maximum(20.0, r_targets))
        al, be = rtheta_to_alphabeta(r_safe, thetas, self.alpha0, self.beta0)
        h = self.fd_h_ab * (1.0 + jnp.abs(r_safe))
        n = r_targets.shape[0]

        als = jnp.concatenate([al, al + h, al - h, al, al])
        bes = jnp.concatenate([be, be, be, be + h, be - h])
        rho5, t5, hit5 = self._trace_ab(als, bes)
        rho_c = rho5[:n]
        t_hit = t5[:n]
        drho_da = (rho5[n : 2 * n] - rho5[2 * n : 3 * n]) / (2.0 * h)
        drho_db = (rho5[3 * n : 4 * n] - rho5[4 * n : 5 * n]) / (2.0 * h)

        # g(α, β) = g_c(λ(α, β), ρ(α, β)): λ and the Keplerian u are closed
        # forms, so their derivatives are exact jvps (λ and g are elementwise
        # in the sample index — an all-ones tangent reads off the diagonal);
        # only the FD ρ derivatives involve the integrator.
        ones = jnp.ones_like(al)
        lam_c, dlam_da = jax.jvp(
            lambda a_: self._lam_of_ab(a_, be), (al,), (ones,)
        )
        _, dlam_db = jax.jvp(lambda b_: self._lam_of_ab(al, b_), (be,), (ones,))
        _, dg_dlam = jax.jvp(
            lambda l_: self._g_of(l_, rho_c), (lam_c,), (jnp.ones_like(lam_c),)
        )
        _, dg_drho = jax.jvp(
            lambda r_: self._g_of(lam_c, r_), (rho_c,), (jnp.ones_like(rho_c),)
        )
        dg_da = dg_dlam * dlam_da + dg_drho * drho_da
        dg_db = dg_dlam * dlam_db + dg_drho * drho_db
        det = drho_da * dg_db - drho_db * dg_da
        J = jnp.abs(1.0 / det)
        cond = jnp.abs(det) / (
            jnp.abs(drho_da * dg_db) + jnp.abs(drho_db * dg_da) + 1e-300
        )
        # g evaluated at EXACTLY rₑ for the dataset (matching the XLA path)
        g = self._g_of(self._lam_of_ab(al, be), r_targets)
        ok = ok0 & hit5[:n] & jnp.isfinite(J)
        return g, J, t_hit, ok, cond

    # -- public jit-cached entry points ------------------------------------

    def _program(self, name, impl, n_args):
        key = name
        if key not in self._programs:
            self._programs[key] = jax.jit(impl)
        return self._programs[key]

    def workhorse(self, r_targets, thetas, r_init=None):
        """(g, J, t, ok, r_off, cond) — the sweep operation."""
        r_targets = jnp.asarray(r_targets, self.x.dtype)
        thetas = jnp.asarray(thetas, self.x.dtype)
        if r_init is None:
            r_init = jnp.full_like(r_targets, jnp.nan)

        def impl(r_targets, thetas, r_init):
            r_off, rho, t_hit, ok = self._solve_impl(r_targets, thetas, r_init)
            g, J, _t2, okJ, cond = self._jacobian_impl(r_targets, thetas, r_off)
            return g, J, t_hit, ok & okJ, r_off, cond

        return self._program("workhorse", impl, 3)(r_targets, thetas, r_init)

    def probe(self, r_targets, thetas, r_init=None):
        """(r_off, g, t, ok) — golden-section probe (no J)."""
        r_targets = jnp.asarray(r_targets, self.x.dtype)
        thetas = jnp.asarray(thetas, self.x.dtype)
        if r_init is None:
            r_init = jnp.full_like(r_targets, jnp.nan)
        return self._program("probe", self._probe_impl, 3)(
            r_targets, thetas, r_init
        )

    def jacobian_at(self, r_targets, thetas, r_off):
        """(g, J, t, ok, cond) at precomputed offsets."""
        r_targets = jnp.asarray(r_targets, self.x.dtype)
        thetas = jnp.asarray(thetas, self.x.dtype)
        r_off = jnp.asarray(r_off, self.x.dtype)
        return self._program("jacobian", self._jacobian_impl, 3)(
            r_targets, thetas, r_off
        )


_SOLVER_CACHE: dict = {}


def get_pallas_ctf_solver(m, x, d, **kwargs) -> PallasCTFSolver:
    """Config-keyed solver cache: the kernel + jit programs compile once per
    (metric params, observer, disc, hyperparameters) and are reused across
    `cunningham_transfer_function` calls (the product benchmark calls the
    stateless `lineprofile` repeatedly)."""

    def leafkey(tree):
        return tuple(
            float(v) for v in jax.tree_util.tree_leaves(tree) if jnp.ndim(v) == 0
        )

    key = (
        type(m).__name__,
        leafkey(m),
        tuple(np.asarray(x, np.float64).tolist()),
        type(d).__name__,
        leafkey(d),
        # dtype and interpret are NOT numeric kwargs — key them explicitly so
        # an f64/interpret run never reuses an f32/compiled solver
        str(jnp.dtype(kwargs.get("dtype", jnp.float32))),
        kwargs.get("interpret", False),
        tuple(sorted((k, float(v)) for k, v in kwargs.items() if isinstance(v, (int, float)))),
    )
    if key not in _SOLVER_CACHE:
        _SOLVER_CACHE[key] = PallasCTFSolver(m, x, d, **kwargs)
    return _SOLVER_CACHE[key]

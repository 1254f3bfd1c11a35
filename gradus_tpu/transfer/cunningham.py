"""Cunningham transfer functions, batched over (emission radius, angle).

Reference: `src/transfer-functions/cunningham-transfer-functions.jl`. For each
emission radius rₑ the reference loops an edge-clustered θ iterator, root-finds
the image-plane offset per θ, golden-sections for the extremal redshifts
gmin/gmax, rescales the Jacobian to ∂g✶ and forms

    f = (1/π rₑ) · g · √(g✶(1−g✶)) · J            (:62)

then splits the samples into upper/lower branches and interpolates over g✶.

Batched redesign: all radii process all angles simultaneously through the batched
offset solver; the golden-section extremal search advances every radius in
lockstep (probe samples are collected into the dataset exactly like the
reference's accumulator); branches are resampled onto a fixed g✶ grid so the
result is a dense `TransferBranchGrid` — the reference's
`CunninghamTransferGrid` (types.jl:14-40) as the primary representation.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from gradus_tpu.metrics.base import AbstractMetric
from gradus_tpu.geometry.discs import DatumPlane, ThinDisc, AbstractThickAccretionDisc, datumplane
from gradus_tpu.transfer.solvers import (
    offset_workhorse,
    offset_probe,
    offset_jacobian_at,
)
from gradus_tpu.utils.interp import linear_interp

__all__ = [
    "TransferBranchGrid",
    "cunningham_transfer_function",
    "transferfunctions",
    "interpolated_transfer_branches",
    "g_to_gstar",
    "gstar_to_g",
]

# Python float (weakly typed) so the golden-section updates never promote an
# f32 `lax.scan` carry to f64 under x64 mode (a non-weak np.float64 here broke
# the f32 CTF pipeline in the golden-parity environment).
_GR = 0.6180339887498949


def g_to_gstar(g, gmin, gmax):
    return (g - gmin) / (gmax - gmin)


def gstar_to_g(gstar, gmin, gmax):
    return (gmax - gmin) * gstar + gmin


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TransferBranchGrid:
    """Dense transfer-function table over (rₑ, g✶)."""

    radii: Any  # (nr,)
    gmin: Any  # (nr,)
    gmax: Any  # (nr,)
    gstar: Any  # (Ng,)
    lower_f: Any  # (nr, Ng)
    upper_f: Any  # (nr, Ng)
    lower_t: Any  # (nr, Ng)
    upper_t: Any  # (nr, Ng)

    def inner_radius(self):
        return self.radii[0]

    def outer_radius(self):
        return self.radii[-1]

    def at_radius(self, r):
        """Linear interpolation of every row quantity at radii ``r`` (any
        shape). Returns dict of arrays with leading shape of ``r``."""
        r = jnp.asarray(r)
        xs = self.radii
        idx = jnp.clip(jnp.searchsorted(xs, r, side="right") - 1, 0, xs.shape[0] - 2)
        x0, x1 = xs[idx], xs[idx + 1]
        w = jnp.clip((r - x0) / jnp.where(x1 == x0, 1.0, x1 - x0), 0.0, 1.0)

        def lerp(row):
            return row[idx] * (1 - w[..., None] if row.ndim > 1 else 1 - w) + row[
                idx + 1
            ] * (w[..., None] if row.ndim > 1 else w)

        return dict(
            gmin=self.gmin[idx] * (1 - w) + self.gmin[idx + 1] * w,
            gmax=self.gmax[idx] * (1 - w) + self.gmax[idx + 1] * w,
            lower_f=lerp(self.lower_f),
            upper_f=lerp(self.upper_f),
            lower_t=lerp(self.lower_t),
            upper_t=lerp(self.upper_t),
        )

    def __repr__(self):
        try:
            import numpy as _np

            nr = self.radii.shape[0]
            return (
                f"TransferBranchGrid\n"
                f"  . radii (N, min, max) : {nr}, "
                f"{float(_np.min(_np.asarray(self.radii))):.4g}, "
                f"{float(_np.max(_np.asarray(self.radii))):.4g}\n"
                f"  . g✶ grid            : {self.gstar.shape[0]} nodes\n"
                f"  . g (min, max)        : "
                f"{float(_np.min(_np.asarray(self.gmin))):.4g}, "
                f"{float(_np.max(_np.asarray(self.gmax))):.4g}"
            )
        except Exception:
            return object.__repr__(self)


def _theta_samples(N: int, theta_offset: float, dtype):
    """Edge-clustered θ iterator (reference
    cunningham-transfer-functions.jl:359-367)."""
    K = N // 5
    a = np.linspace(-2 * theta_offset, 2 * theta_offset, K)
    b = np.linspace(-np.pi / 2, 3 * np.pi / 2, N - 2 * K)
    c = np.linspace(np.pi - 2 * theta_offset, np.pi + 2 * theta_offset, K)
    return jnp.asarray(np.concatenate([a, b, c]), dtype)


def _avoid_poles(theta):
    """Nudge θ off the exact image-plane axes (reference `_gmin_finder`,
    cunningham-transfer-functions.jl:437-447)."""
    near0 = jnp.abs(theta) < 1e-4
    nearpi = jnp.abs(jnp.abs(theta) - jnp.pi) < 1e-4
    return jnp.where(near0 | nearpi, theta + 1e-4, theta)


def _masked_resample(gq, gs, vals, mask):
    """Linear interpolation of (gs, vals) restricted to mask, sampled at gq.

    Invalid entries sort to +inf; queries clamp to the valid range.
    gs: (M,), vals: (M,), mask: (M,), gq: (Ng,) → (Ng,)"""
    big = jnp.where(mask, gs, jnp.inf)
    order = jnp.argsort(big)
    xs = big[order]
    ys = vals[order]
    n = jnp.sum(mask)
    idx = jnp.clip(jnp.searchsorted(xs, gq, side="right") - 1, 0, n - 2)
    x0, x1 = xs[idx], xs[idx + 1]
    w = jnp.clip((gq - x0) / jnp.where(x1 <= x0, 1.0, x1 - x0), 0.0, 1.0)
    return ys[idx] * (1 - w) + ys[idx + 1] * w


@partial(
    jax.jit,
    static_argnames=(
        "N_extrema",
        "newton_iters",
        "zero_atol",
        "alpha0",
        "beta0",
        "warm_start",
        "probe_fn",
    ),
)
def _golden_scan(
    m,
    x,
    disc2,
    radii,
    theta_offset,
    lam_max,
    warm0,
    *,
    N_extrema,
    newton_iters,
    zero_atol,
    alpha0,
    beta0,
    warm_start=True,
    probe_fn=None,
):
    """Both extremal golden-section searches (gmin around θ=0, gmax around
    θ=π) advanced in lockstep inside ONE compiled scan of g-only probes
    (`offset_probe`), each warm-started from the previous probe's offset.

    Returns (θ, r_off, g, t, ok) stacked (N_extrema+2, 2, nr) — the same
    probe trajectory the reference's sequential Optim.jl GoldenSection visits
    (`_search_extremal!`, cunningham-transfer-functions.jl:391-430), with
    ~5× fewer traced geodesics (no per-probe Jacobian, warm Newton) and two
    device launches instead of 2·(N_extrema+2)."""
    nr = radii.shape[0]
    sign = jnp.asarray([1.0, -1.0], x.dtype)[:, None]  # min side, max side
    center = jnp.asarray([0.0, np.pi], x.dtype)[:, None]
    a = jnp.broadcast_to(center - theta_offset, (2, nr))
    b = jnp.broadcast_to(center + theta_offset, (2, nr))
    c = b - _GR * (b - a)
    e = a + _GR * (b - a)
    RE2 = jnp.broadcast_to(radii[None, :], (2, nr))

    def probe_eval(theta_2nr, warm_2nr):
        if probe_fn is not None:
            # backend-supplied probe (e.g. the Pallas FD solver): same
            # (r_targets, θ, warm) → (r_off, g, t, ok) contract
            warm = (
                warm_2nr.ravel()
                if warm_start
                else jnp.full((2 * nr,), jnp.nan, x.dtype)
            )
            r_off, g, t, ok = probe_fn(
                RE2.ravel(), _avoid_poles(theta_2nr.ravel()), warm
            )
        else:
            r_off, g, t, ok = offset_probe(
                m,
                x,
                disc2,
                RE2.ravel(),
                _avoid_poles(theta_2nr.ravel()),
                lam_max=lam_max,
                zero_atol=zero_atol,
                max_iter=newton_iters,
                alpha0=alpha0,
                beta0=beta0,
                r_init=warm_2nr.ravel() if warm_start else None,
            )
        rs = (2, nr)
        return r_off.reshape(rs), g.reshape(rs), t.reshape(rs), ok.reshape(rs)

    # prologue: evaluate both interior points of both brackets
    rc, gc, tc, okc = probe_eval(c, warm0)
    warm = jnp.where(jnp.isfinite(rc), rc, warm0)
    re_, ge, te, oke = probe_eval(e, warm)
    warm = jnp.where(jnp.isfinite(re_), re_, warm)
    fc = sign * gc
    fe = sign * ge

    def step(carry, _):
        a, b, c, e, fc, fe, warm = carry
        left = fc < fe
        a2 = jnp.where(left, a, c)
        b2 = jnp.where(left, e, b)
        c2 = jnp.where(left, b2 - _GR * (b2 - a2), e)
        e2 = jnp.where(left, c, a2 + _GR * (b2 - a2))
        probe = jnp.where(left, c2, e2)
        rp, gp_, tp_, okp_ = probe_eval(probe, warm)
        warm2 = jnp.where(jnp.isfinite(rp), rp, warm)
        fp = sign * gp_
        fc2 = jnp.where(left, fp, fe)
        fe2 = jnp.where(left, fc, fp)
        return (a2, b2, c2, e2, fc2, fe2, warm2), (probe, rp, gp_, tp_, okp_)

    _, (thp, rp, gp_, tp_, okp_) = jax.lax.scan(
        step, (a, b, c, e, fc, fe, warm), None, length=N_extrema
    )
    # stack prologue + scanned probes: (P, 2, nr) with P = N_extrema + 2
    th_all = jnp.concatenate([jnp.stack([c, e]), thp], axis=0)
    r_all = jnp.concatenate([jnp.stack([rc, re_]), rp], axis=0)
    g_all = jnp.concatenate([jnp.stack([gc, ge]), gp_], axis=0)
    t_all = jnp.concatenate([jnp.stack([tc, te]), tp_], axis=0)
    ok_all = jnp.concatenate([jnp.stack([okc, oke]), okp_], axis=0)
    return th_all, r_all, g_all, t_all, ok_all


def cunningham_transfer_function(
    m: AbstractMetric,
    x,
    d,
    radii,
    *,
    N: int = 80,
    N_extrema: int = 15,  # + 2 init evals = 17 probes/side (reference M = N + 2·17)
    Ng: int = 64,
    theta_offset: float = 0.3,
    h: float = 1e-6,
    h_reg: float = 1e-4,
    h_resample: float = 1e-3,
    zero_atol: float = 1e-7,
    newton_iters: int = 30,
    lam_max=None,
    alpha0: float = 0.0,
    beta0: float = 0.0,
    return_samples: bool = False,
    probe_warm_start: bool = True,
    backend: str = "xla",
    pallas_opts: dict | None = None,
) -> TransferBranchGrid:
    """Compute transfer functions for an array of emission radii at once.

    Thin discs are promoted to an equatorial DatumPlane for the offset solve
    (reference `_promote_disc_for_transfer_functions`, :1-5).
    """
    x = jnp.asarray(x)
    radii = jnp.atleast_1d(jnp.asarray(radii, x.dtype))
    nr = radii.shape[0]
    if lam_max is None:
        lam_max = 2.0 * x[1]

    if isinstance(d, ThinDisc):
        disc = DatumPlane(jnp.asarray(0.0, x.dtype))
        jacobian_disc = disc
        verify_disc = None
    elif isinstance(d, AbstractThickAccretionDisc):
        disc = None  # per-radius datum plane below
        jacobian_disc = d
        verify_disc = d
    else:
        disc = d
        jacobian_disc = d
        verify_disc = None

    thetas0 = _theta_samples(N, theta_offset, x.dtype)

    if isinstance(d, AbstractThickAccretionDisc):
        disc_for = datumplane(d, radii)  # batched heights
        # DatumPlane with (nr,) height works elementwise against (nr,) rays
        disc_solver = disc_for
    else:
        disc_solver = disc

    def _tiled_disc(k):
        """disc whose per-ray height matches a (k·nr,) flat [k, nr] batch."""
        if isinstance(disc_solver, DatumPlane) and jnp.ndim(disc_solver.height) == 1:
            return DatumPlane(jnp.tile(disc_solver.height, k))
        return disc_solver

    # --- main angular sweep ---------------------------------------------
    TH = jnp.broadcast_to(thetas0[None, :], (nr, N))
    RE = jnp.broadcast_to(radii[:, None], (nr, N))
    # Warm-start the lockstep Newton with the flat-space image of the
    # emission ring: a disc ring of radius rₑ seen at inclination i images
    # onto the ellipse r(θ) = rₑ·cos i / √(cos²i·cos²θ + sin²θ) (semi-axes
    # rₑ and rₑ·cos i), plus an O(M) light-bending lift that peaks on the
    # far side (θ ≈ π/2). The guess lands within a few % of the root for
    # rₑ ≳ 3, so the batch converges in ~5 iterations instead of the cold
    # max(20, rₑ) start's ~15-30 — and in lockstep the WORST ray sets the
    # cost of all 8000 (the reference's per-ray scalar Newton never pays
    # this, precision-solvers.jl:151; our batch does, so init quality is a
    # first-order cost lever).
    inc = x[2]
    cos_i = jnp.cos(inc)
    sin2 = jnp.sin(TH) ** 2
    ellipse = RE * jnp.abs(cos_i) / jnp.sqrt(cos_i**2 * (1.0 - sin2) + sin2)
    bend = 1.0 + jnp.sin(inc) * jnp.maximum(jnp.sin(TH), 0.0)
    # f32 only: the init composes with the float32 Newton stall exit for
    # product speed. In f64 the cold reference start is kept — the init
    # perturbs which iterate first crosses zero_atol, which wobbles the
    # CTF moment anchors at exactly their 1e-3 tolerance scale.
    if jnp.dtype(x.dtype) == jnp.float32:
        r_init_sweep = (ellipse + bend).ravel()
    else:
        r_init_sweep = None

    pallas_solver = None
    if backend == "pallas":
        # fast path (transfer/pallas_ctf.py): FD Newton through the Pallas
        # kernel. Thin discs only — the kernel bakes
        # geometry parameters as compile-time scalars, so per-radius datum
        # planes (thick discs) stay on the XLA jvp path.
        from gradus_tpu.transfer.pallas_ctf import get_pallas_ctf_solver

        if not (
            isinstance(disc_solver, DatumPlane)
            and jnp.ndim(disc_solver.height) == 0
        ):
            raise NotImplementedError(
                "backend='pallas' supports thin discs (scalar DatumPlane) "
                "only; thick discs use the default XLA path"
            )
        pallas_solver = get_pallas_ctf_solver(
            m,
            np.asarray(x, np.float64),
            disc_solver,
            lam_max=float(lam_max),
            alpha0=float(alpha0),
            beta0=float(beta0),
            zero_atol=float(zero_atol),
            dtype=x.dtype,
            **(pallas_opts or {}),
        )
        r_init_p = (
            r_init_sweep
            if r_init_sweep is not None
            else (ellipse + bend).ravel()
        )
        g_s, J_s, t_s, ok_s, roff_s, cond_s = pallas_solver.workhorse(
            RE.ravel(), _avoid_poles(TH.ravel()), r_init=r_init_p
        )
    else:
        g_s, J_s, t_s, ok_s, roff_s, cond_s = offset_workhorse(
            m,
            x,
            disc_solver_tile(disc_solver, N),
            RE.ravel(),
            _avoid_poles(TH.ravel()),
            jacobian_disc=jacobian_disc,
            verify_disc=verify_disc,
            lam_max=lam_max,
            zero_atol=zero_atol,
            max_iter=newton_iters,
            alpha0=alpha0,
            beta0=beta0,
            r_init=r_init_sweep,
            return_r_off=True,
        )
    g_s = g_s.reshape(nr, N)
    J_s = J_s.reshape(nr, N)
    t_s = t_s.reshape(nr, N)
    ok_s = ok_s.reshape(nr, N)
    roff_s = roff_s.reshape(nr, N)
    cond_s = cond_s.reshape(nr, N)

    # --- golden-section extremal search (batched over radii) -------------
    # Restructure: the whole search — both
    # extremal sides at once — runs as ONE jitted scan of g-only probes
    # (`offset_probe`, no Jacobian), each warm-started from the previous
    # probe's solved offset (the probe θ moves geometrically, so Newton
    # lands in 1-3 steps instead of ~10 cold). The Jacobians for every
    # collected probe are then evaluated in ONE batched `offset_jacobian_at`
    # launch. Same probe trajectory and same math as the reference's
    # sequential GoldenSection (Optim.jl semantics), ~5× fewer traced
    # geodesics and 2 launches instead of 2·(N_extrema+2).
    # warm starts from the sweep samples nearest each bracket center (the
    # θ iterator clusters samples around 0 and π exactly for this)
    th_np = np.asarray(thetas0)
    i0 = int(np.argmin(np.abs(th_np)))
    ipi = int(np.argmin(np.abs(th_np - np.pi)))
    warm0 = jnp.stack([roff_s[:, i0], roff_s[:, ipi]], axis=0)  # (2, nr)

    th_p, r_p, g_p, t_p, ok_p = _golden_scan(
        m,
        x,
        _tiled_disc(2),
        radii,
        jnp.asarray(theta_offset, x.dtype),
        jnp.asarray(lam_max, x.dtype),
        warm0,
        N_extrema=N_extrema,
        newton_iters=newton_iters,
        zero_atol=zero_atol,
        alpha0=alpha0,
        beta0=beta0,
        warm_start=probe_warm_start,
        probe_fn=None if pallas_solver is None else pallas_solver.probe_fn,
    )
    P = N_extrema + 2

    # Jacobians for ALL probes in one batched launch, at the solved offsets
    # (no Newton re-solve): probes flatten (P, 2, nr) → (nr, 2P) per radius
    def to_rows(arr):
        return jnp.moveaxis(arr, -1, 0).reshape(nr, 2 * P)

    th_rows = to_rows(th_p)
    r_rows = to_rows(r_p)
    if pallas_solver is not None:
        gJ, J_pr, tJ, okJ, condJ = pallas_solver.jacobian_at(
            jnp.broadcast_to(radii[:, None], (nr, 2 * P)).ravel(),
            _avoid_poles(th_rows.ravel()),
            r_rows.ravel(),
        )
    else:
        gJ, J_pr, tJ, okJ, condJ = offset_jacobian_at(
            m,
            x,
            disc_solver_tile(disc_solver, 2 * P),
            jnp.broadcast_to(radii[:, None], (nr, 2 * P)).ravel(),
            _avoid_poles(th_rows.ravel()),
            r_rows.ravel(),
            jacobian_disc=jacobian_disc,
            verify_disc=verify_disc,
            lam_max=lam_max,
            alpha0=alpha0,
            beta0=beta0,
        )
    J_rows = J_pr.reshape(nr, 2 * P)
    ok_rows = to_rows(ok_p) & okJ.reshape(nr, 2 * P)

    # assemble all samples: static sweep + probe evaluations
    th_all = jnp.concatenate([TH, th_rows], axis=1)
    g_all = jnp.concatenate([g_s, to_rows(g_p)], axis=1)
    J_all = jnp.concatenate([J_s, J_rows], axis=1)
    t_all = jnp.concatenate([t_s, to_rows(t_p)], axis=1)
    ok_all = jnp.concatenate([ok_s, ok_rows], axis=1)
    cond_all = jnp.concatenate([cond_s, condJ.reshape(nr, 2 * P)], axis=1)

    # extrema from the collected samples ONLY (the golden-section candidates
    # are themselves samples): the argmin/argmax samples then get g✶ = 0 / 1
    # EXACTLY (IEEE x/x = 1), so √(g✶(1−g✶)) = 0 kills the divergent-J
    # endpoint instead of producing a 0·∞ garbage f — matching the reference
    # accumulator, where the extremal sample is stored bit-identically to
    # gmin/gmax (`_cunningham_transfer_function!`, :314-332).
    g_valid = jnp.where(ok_all, g_all, jnp.inf)
    gmin = jnp.min(g_valid, axis=1)
    g_valid_neg = jnp.where(ok_all, g_all, -jnp.inf)
    gmax = jnp.max(g_valid_neg, axis=1)

    # --- transfer function values ----------------------------------------
    span = (gmax - gmin)[:, None]
    gstar_all = (g_all - gmin[:, None]) / span
    Jstar = span * J_all
    root = jnp.sqrt(jnp.clip(gstar_all * (1.0 - gstar_all), 0.0, None))
    # at the exact extrema root = 0 while J may overflow: f ≡ 0 there
    f_all = jnp.where(
        root == 0.0,
        0.0,
        (1.0 / (jnp.pi * radii[:, None])) * g_all * root * Jstar,
    )

    # --- near-extremal regularisation (gated outlier filter) ---------------
    # f is a 0·∞-regularised product: within h_reg of either extremum the two
    # factors can be SEPARATELY noise-dominated — |det ∂(ρ,g)/∂(α,β)| crosses
    # zero exactly at the extremum, so J = 1/|det| sits below its jvp noise
    # floor while (1−g✶) sits below the g-field resolution — and their
    # product is unbounded garbage (observed up to 1700× the smooth limit at
    # rₑ = 4), even though the TRUE curve limits smoothly to the branch-merge
    # value f*. BUT the ill zone is config-dependent: at rₑ = 1000 the edge
    # samples are perfectly conditioned and genuinely sit ~13% below the
    # interior f — a blanket replacement biased the CTF moment by +1.2%
    # (round-4 A/B, scripts/debug notes: unregularised moment matches the
    # reference golden to 0.016%). The two failure directions are NOT
    # symmetric (round-4 per-sample dumps, i = 30/74 rₑ = 4 vs rₑ = 1000):
    # UPWARD spikes (measured J ≫ true J, up to ~12× the neighbouring
    # plateau) are pure 0·∞ garbage, while DOWNWARD dips at the deepest
    # probes are J saturating against the jvp field resolution — behavior the
    # reference's dual-through-ODE Jacobian shares at the same tolerances
    # (keeping the dips is what reproduces its rₑ = 1000 golden to 0.016%).
    # So the gate is ASYMMETRIC: an ill-zone sample is replaced by its
    # nearest well-conditioned neighbour's f only when it spikes UPWARD by
    # more than κ = 1.5× (or is non-finite). The
    # exact-extremal samples keep f ≡ 0, matching the reference accumulator
    # where √(g✶(1−g✶)) evaluates to exactly zero
    # (`_cunningham_transfer_function!`, :326-331).
    if h_reg > 0.0:
        kappa = 1.5

        def _regularise(f_cur, ill, safe, toward):
            have = jnp.any(safe, axis=1)[:, None]
            cand = jnp.where(safe, gstar_all, -toward * jnp.inf)
            pick = (
                jnp.argmax(cand, axis=1)
                if toward > 0
                else jnp.argmin(cand, axis=1)
            )
            f_ref = jnp.take_along_axis(f_cur, pick[:, None], axis=1)
            noise = ~jnp.isfinite(f_cur) | (f_cur > kappa * f_ref)
            return jnp.where(ill & have & noise, f_ref, f_cur)

        safe_hi = ok_all & (gstar_all <= 1.0 - h_reg)
        ill_hi = ok_all & (gstar_all > 1.0 - h_reg) & (gstar_all < 1.0)
        f_all = _regularise(f_all, ill_hi, safe_hi, +1.0)
        safe_lo = ok_all & (gstar_all >= h_reg)
        ill_lo = ok_all & (gstar_all < h_reg) & (gstar_all > 0.0)
        f_all = _regularise(f_all, ill_lo, safe_lo, -1.0)

    # --- sort by θ, split branches at the g✶ extrema ----------------------
    order = jnp.argsort(th_all, axis=1)
    gstar_o = jnp.take_along_axis(gstar_all, order, axis=1)
    f_o = jnp.take_along_axis(f_all, order, axis=1)
    t_o = jnp.take_along_axis(t_all, order, axis=1)
    ok_o = jnp.take_along_axis(ok_all, order, axis=1)

    M = gstar_o.shape[1]
    k = jnp.arange(M)[None, :]
    gstar_masked = jnp.where(ok_o, gstar_o, jnp.inf)
    imin = jnp.argmin(gstar_masked, axis=1)
    gstar_masked_neg = jnp.where(ok_o, gstar_o, -jnp.inf)
    imax = jnp.argmax(gstar_masked_neg, axis=1)
    i1 = jnp.minimum(imin, imax)[:, None]
    i2 = jnp.maximum(imin, imax)[:, None]
    # exclude samples hard against the extrema: there f is a numerically
    # broken 0·∞ product (√(g✶(1−g✶)) → 0 while J → ∞). The reference drops
    # g✶ ∉ (h, 1−h) the same way (`_make_sorted_with_adjustments!`, :81-89).
    interior = ok_o & (gstar_o > h) & (gstar_o < 1.0 - h)
    b1 = (k >= i1) & (k <= i2) & interior
    b2 = ((k <= i1) | (k >= i2)) & interior

    gq = jnp.linspace(h_resample, 1.0 - h_resample, Ng)

    res = jax.vmap(
        lambda gs, fs, ts, m1, m2: (
            _masked_resample(gq, gs, fs, m1),
            _masked_resample(gq, gs, ts, m1),
            _masked_resample(gq, gs, fs, m2),
            _masked_resample(gq, gs, ts, m2),
        )
    )(gstar_o, f_o, t_o, b1, b2)
    f1, t1, f2, t2 = res

    # upper branch = larger mean f (reference uses adjacent-sample ordering)
    b1_upper = jnp.mean(f1, axis=1) > jnp.mean(f2, axis=1)
    sel = b1_upper[:, None]
    upper_f = jnp.where(sel, f1, f2)
    lower_f = jnp.where(sel, f2, f1)
    upper_t = jnp.where(sel, t1, t2)
    lower_t = jnp.where(sel, t2, t1)

    grid = TransferBranchGrid(
        radii=radii,
        gmin=gmin,
        gmax=gmax,
        gstar=gq,
        lower_f=lower_f,
        upper_f=upper_f,
        lower_t=lower_t,
        upper_t=upper_t,
    )
    if return_samples:
        f_sorted = jnp.take_along_axis(f_all, order, axis=1)
        samples = dict(
            theta=jnp.take_along_axis(th_all, order, axis=1),
            gstar=gstar_o,
            f=f_sorted,
            t=t_o,
            ok=ok_o,
            cond=jnp.take_along_axis(cond_all, order, axis=1),
            J=jnp.take_along_axis(J_all, order, axis=1),
        )
        return grid, samples
    return grid


def disc_solver_tile(disc, N):
    """Tile per-radius datum planes across the angle axis if needed."""
    if isinstance(disc, DatumPlane) and jnp.ndim(disc.height) == 1:
        return DatumPlane(jnp.repeat(disc.height, N))
    return disc


def transferfunctions(
    m: AbstractMetric,
    x,
    d,
    *,
    min_re=None,
    max_re: float = 50.0,
    num_re: int = 100,
    radii=None,
    **kwargs,
) -> TransferBranchGrid:
    """Pre-compute transfer functions over an inverse-spaced radial grid
    (reference `transferfunctions`, cunningham-transfer-functions.jl:547-569;
    defaults minrₑ = isco + 1e-2, maxrₑ = 50, numrₑ = 100)."""
    from gradus_tpu.orbits.special_radii import isco as _isco
    from gradus_tpu.camera.grids import InverseGrid

    if radii is None:
        if min_re is None:
            min_re = _isco(m) + 1e-2
        radii = InverseGrid()(min_re, max_re, num_re)
    return cunningham_transfer_function(m, x, d, radii, **kwargs)


# reference-parity alias
interpolated_transfer_branches = transferfunctions

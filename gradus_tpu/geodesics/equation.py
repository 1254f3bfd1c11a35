"""The core numeric kernel: geodesic acceleration from AD of the metric.

The reference (`src/tracing/method-implementations/auto-diff.jl`) computes the
metric Jacobian with ForwardDiff duals and expands the Christoffel contraction
symbolically at compile time. Here the same mathematics is two `jax.jvp` passes
through the metric components plus a closed-form contraction — XLA fuses the
whole thing into one elementwise kernel across the ray batch.

For a static axis-symmetric metric (∂_t g = ∂_φ g = 0) the geodesic equation

    a^μ = -Γ^μ_{νσ} v^ν v^σ,
    Γ^μ_{νσ} = ½ g^{μρ} (∂_ν g_{ρσ} + ∂_σ g_{ρν} − ∂_ρ g_{νσ})

reduces (using the v↔v symmetry) to

    a^μ = -g^{μρ} [ (v^r ∂_r g_{ρσ} + v^θ ∂_θ g_{ρσ}) v^σ
                    − ½ δ_ρ∈{r,θ} (v ∂_ρ g v) ].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gradus_tpu.metrics.base import AbstractMetric
from gradus_tpu.utils.linalg import sym4x4, sym4x4_inverse_components

__all__ = [
    "metric_jacobian",
    "metric_jacobian5",
    "geodesic_equation",
    "geodesic_acceleration",
    "constrain_time",
    "constrain",
    "constrain_all",
]


def metric_jacobian(m: AbstractMetric, r, theta):
    """Value + (∂_r, ∂_θ) of the 5 metric components in two forward-mode passes
    (reference `metric_jacobian`, auto-diff.jl:206-211)."""
    dtype = jnp.result_type(r, theta, float)
    rt = jnp.stack(
        jnp.broadcast_arrays(jnp.asarray(r, dtype), jnp.asarray(theta, dtype))
    )

    def f(rt):
        return m.components(rt[0], rt[1])

    ones = jnp.ones_like(rt[0])
    zeros = jnp.zeros_like(rt[0])
    g, dg_dr = jax.jvp(f, (rt,), (jnp.stack([ones, zeros]),))
    _, dg_dtheta = jax.jvp(f, (rt,), (jnp.stack([zeros, ones]),))
    return g, dg_dr, dg_dtheta


def metric_jacobian5(m: AbstractMetric, r, theta):
    """Component-tuple form of `metric_jacobian`: three 5-tuples of arrays
    (values, ∂_r, ∂_θ). Pallas-kernel friendly — no stacked minor axis.
    Dispatches to the metric's (possibly hand-derived) `components5_jac`."""
    dtype = jnp.result_type(r, theta, float)
    r = jnp.asarray(r, dtype)
    theta = jnp.asarray(theta, dtype)
    r, theta = jnp.broadcast_arrays(r, theta)
    return m.components5_jac(r, theta)


def geodesic_equation(m: AbstractMetric, x, v):
    """Four-acceleration a^μ = -Γ^μ_{νσ} v^ν v^σ at position ``x`` with
    velocity ``v`` (both 4-vectors).

    Reference: `geodesic_equation` + `compute_geodesic_equation`,
    auto-diff.jl:115-141, 213-224.

    The Christoffel contraction is fully scalar-expanded over the 5-component
    symmetric structure (the reference does the same expansion symbolically at
    compile time with Symbolics+Tullio). The expanded form is pure (N,)-wide
    elementwise arithmetic that XLA fuses into the integrator loop body and
    that the Pallas kernel evaluates per thread, instead of batches of tiny
    (4, 4) matrix products.
    """
    a_t, a_r, a_th, a_ph = geodesic_acceleration(
        m,
        x[..., 1],
        x[..., 2],
        v[..., 0],
        v[..., 1],
        v[..., 2],
        v[..., 3],
    )
    return jnp.stack([a_t, a_r, a_th, a_ph], axis=-1)


def geodesic_acceleration(m: AbstractMetric, r, th, vt, vr, vth, vph):
    """Component-form four-acceleration: 4-tuple of arrays from 6 coordinate /
    velocity arrays. Shared by the array API above and the Pallas integrator
    (state-major layout, `gradus_tpu/integrate/pallas_solver.py`)."""
    g, dgr, dgth = metric_jacobian5(m, r, th)

    # inverse of the 5-component symmetric form (auto-diff.jl:59-78)
    g_tt, g_rr, g_thth, g_phph, g_tph = g
    det = g_tt * g_phph - g_tph * g_tph
    inv_det = 1.0 / det
    gi_tt = g_phph * inv_det
    gi_phph = g_tt * inv_det
    gi_tph = -g_tph * inv_det
    gi_rr = 1.0 / g_rr
    gi_thth = 1.0 / g_thth

    def Av(J):
        """(J v)_ρ for a 5-component symmetric matrix J."""
        J_tt, J_rr, J_thth, J_phph, J_tph = J
        Jv_t = J_tt * vt + J_tph * vph
        Jv_r = J_rr * vr
        Jv_th = J_thth * vth
        Jv_ph = J_tph * vt + J_phph * vph
        q = vt * Jv_t + vr * Jv_r + vth * Jv_th + vph * Jv_ph
        return Jv_t, Jv_r, Jv_th, Jv_ph, q

    J1v_t, J1v_r, J1v_th, J1v_ph, q1 = Av(dgr)
    J2v_t, J2v_r, J2v_th, J2v_ph, q2 = Av(dgth)

    # A_ρ = ∂_ν g_{ρσ} v^ν v^σ (only ν ∈ {r, θ} contribute);
    # B_ρ = ∂_ρ g_{νσ} v^ν v^σ (nonzero only for ρ ∈ {r, θ})
    A_t = vr * J1v_t + vth * J2v_t
    A_r = vr * J1v_r + vth * J2v_r - 0.5 * q1
    A_th = vr * J1v_th + vth * J2v_th - 0.5 * q2
    A_ph = vr * J1v_ph + vth * J2v_ph

    a_t = -(gi_tt * A_t + gi_tph * A_ph)
    a_r = -gi_rr * A_r
    a_th = -gi_thth * A_th
    a_ph = -(gi_tph * A_t + gi_phph * A_ph)
    return a_t, a_r, a_th, a_ph


def constrain_time(g_comps, v, mu=0.0, positive: bool = True):
    """Solve g_{σν} v^σ v^ν = -μ² for v^t (quadratic; reference
    `constrain_time`, auto-diff.jl:161-179)."""
    g1, g2, g3, g4, g5 = (
        g_comps[..., 0],
        g_comps[..., 1],
        g_comps[..., 2],
        g_comps[..., 3],
        g_comps[..., 4],
    )
    disc = (
        -g1 * g2 * v[..., 1] ** 2
        - g1 * g3 * v[..., 2] ** 2
        - g1 * mu**2
        - (g1 * g4 - g5 * g5) * v[..., 3] ** 2
    )
    root = jnp.sqrt(disc)
    if positive:
        return -(g5 * v[..., 3] + root) / g1
    return -(g5 * v[..., 3] - root) / g1


def constrain(m: AbstractMetric, x, v, mu=0.0):
    """v^t such that the velocity satisfies the norm constraint at ``x``."""
    g = m.components(x[..., 1], x[..., 2])
    return constrain_time(g, v, mu)


def constrain_all(m: AbstractMetric, x, v, mu=0.0):
    """Replace the time component of ``v`` with the constrained value
    (reference `constrain_all`, `src/tracing/constraints.jl:14-31`)."""
    vt = constrain(m, x, v, mu)
    return v.at[..., 0].set(vt)

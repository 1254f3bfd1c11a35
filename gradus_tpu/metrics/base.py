"""Metric interface: a pytree of parameters + a pure component function.

Every static, axis-symmetric spacetime is described by its 5 non-zero metric
components ``(g_tt, g_rr, g_θθ, g_φφ, g_tφ)`` as functions of ``(r, θ)`` — exactly
the surface the reference defines (`src/Gradus.jl:79-97`,
`metric_components(m, rθ)::SVector{5}`). Metrics are frozen dataclasses registered
as JAX pytrees, so spins/deformation parameters are traced leaves and everything
is differentiable w.r.t. them.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from gradus_tpu.utils.linalg import sym4x4, sym4x4_inverse_components

__all__ = [
    "metric_dataclass",
    "AbstractMetric",
    "metric_components",
    "metric_4x4",
    "inverse_metric_components",
    "inner_radius",
    "unpack_rtheta",
]


def metric_dataclass(cls):
    """Decorator: freeze + register as a JAX pytree (all fields are leaves)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


class AbstractMetric:
    """Shared behaviour for static axis-symmetric metrics.

    Subclasses implement ``components(r, θ) -> (5,) array`` and ``inner_radius()``.
    """

    coords = "boyer_lindquist"

    def components(self, r, theta):  # pragma: no cover - interface
        raise NotImplementedError

    def components5(self, r, theta):
        """The 5 components as a TUPLE of arrays (no trailing stack axis).

        This is the kernel-friendly form: inside the Pallas kernel each
        component is its own per-ray vector, with no stacked ``(..., 5)``
        axis to build and index. The default unstacks ``components``; hot
        metrics (Kerr) override this natively and derive ``components``."""
        g = self.components(r, theta)
        return tuple(g[..., i] for i in range(5))

    def components5_jac(self, r, theta):
        """Value + (∂_r, ∂_θ) of the 5 components: three 5-tuples of arrays.

        This is the hot call of the geodesic RHS (7 evaluations per adaptive
        step). The default is two forward-mode passes through ``components5``
        (the reference's ForwardDiff dual evaluation, auto-diff.jl:206-211);
        hot metrics (Kerr) override with hand-derived closed forms, which cuts
        the Pallas integrator's per-step op count by ~20%. Overrides are
        parity-tested against this AD fallback in tests/test_metrics.py."""
        return _ad_components5_jac(self, r, theta)

    def inner_radius(self):  # pragma: no cover - interface
        raise NotImplementedError

    # --- derived quantities -------------------------------------------------
    def metric(self, x):
        """Full 4x4 covariant metric at position ``x`` ((r,θ) pair or 4-vector)."""
        r, theta = unpack_rtheta(x)
        return sym4x4(self.components(r, theta))

    def inverse_components(self, r, theta):
        return sym4x4_inverse_components(self.components(r, theta))

    def inverse_metric(self, x):
        r, theta = unpack_rtheta(x)
        return sym4x4(self.inverse_components(r, theta))

    def isco(self):
        # generic fall-back implemented in gradus_tpu.orbits (import cycle avoided)
        from gradus_tpu.orbits.special_radii import isco as _isco

        return _isco(self)

    def electromagnetic_potential(self, r, theta):
        """A_μ(r, θ); zero unless the metric is charged (Kerr-Newman)."""
        z = jnp.zeros(4, dtype=jnp.result_type(r, theta, float))
        return z


def _ad_components5_jac(m, r, theta):
    """Generic value + (∂_r, ∂_θ) of ``components5`` via two jvp passes."""
    dtype = jnp.result_type(r, theta, float)
    r = jnp.asarray(r, dtype)
    theta = jnp.asarray(theta, dtype)
    r, theta = jnp.broadcast_arrays(r, theta)

    def f(rth):
        return m.components5(rth[0], rth[1])

    ones = jnp.ones_like(r)
    zeros = jnp.zeros_like(r)
    g, dg_dr = jax.jvp(f, ((r, theta),), ((ones, zeros),))
    _, dg_dtheta = jax.jvp(f, ((r, theta),), ((zeros, ones),))
    return g, dg_dr, dg_dtheta


def unpack_rtheta(x):
    """Accept a 4-position ``(t, r, θ, φ)``, an ``(r, θ)`` pair or tuple."""
    if isinstance(x, (tuple, list)):
        if len(x) == 2:
            return x[0], x[1]
        return x[1], x[2]
    x = jnp.asarray(x)
    if x.shape[-1] == 2:
        return x[..., 0], x[..., 1]
    return x[..., 1], x[..., 2]


# --- functional API (reference naming parity) --------------------------------


def metric_components(m: AbstractMetric, rtheta):
    r, theta = unpack_rtheta(rtheta)
    return m.components(r, theta)


def metric_4x4(m: AbstractMetric, x):
    return m.metric(x)


def inverse_metric_components(m_or_comps, rtheta=None):
    if rtheta is None:
        return sym4x4_inverse_components(m_or_comps)
    r, theta = unpack_rtheta(rtheta)
    return m_or_comps.inverse_components(r, theta)


def inner_radius(m: AbstractMetric):
    return m.inner_radius()

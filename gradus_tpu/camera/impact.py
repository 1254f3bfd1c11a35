"""Impact-parameter pinhole camera: (α, β) ↦ initial velocity.

Reference: `src/tracing/utility.jl:13-87` (`local_momentum`,
`lnr_momentum_to_global_velocity_transform`, `map_impact_parameters`).
The observer is stationary in the LNRF; the local momentum for impact
parameters (α, β) at observer radius r_obs is

    p̄_(ν) = (1, p_r, p_θ, p_φ),  p_r = -1/√(1 + a² + b²),
    p_θ = (β/r)·p_r,  p_φ = (α/r)·p_r,

mapped to the global frame via v^μ = g^{μσ} e^{(ν)}_σ p̄_(ν).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gradus_tpu.geodesics.tetrads import lnrbasis_matrix
from gradus_tpu.metrics.base import AbstractMetric

__all__ = ["local_momentum", "map_impact_parameters", "lnr_momentum_transform"]


def local_momentum(r_obs, alpha, beta):
    a = alpha / r_obs
    b = beta / r_obs
    pr = -1.0 / jnp.sqrt(1.0 + a * a + b * b)
    return jnp.stack([jnp.ones_like(pr), pr, b * pr, a * pr], axis=-1)


def lnr_momentum_transform(m: AbstractMetric, x):
    """Matrix T with v = T @ p̄: ginv · lnrbasis."""
    ginv = m.inverse_metric(x)
    Tx = lnrbasis_matrix(m, x)
    # full-f32 contraction: a TF32 product (the GPU's default for float32
    # matmuls) keeps ~3 decimal digits and breaks the ray initial conditions
    return jnp.matmul(ginv, Tx, precision=jax.lax.Precision.HIGHEST)


def map_impact_parameters(m: AbstractMetric, x, alpha, beta):
    """Velocity (unconstrained v^t scale; normalized so v^t-slot from p̄_(t)=1)
    for impact parameters (α, β). Supports scalar or array α/β (broadcast)."""
    T = lnr_momentum_transform(m, x)
    alpha = jnp.asarray(alpha)
    beta = jnp.asarray(beta)
    alpha, beta = jnp.broadcast_arrays(alpha, beta)
    p = local_momentum(x[..., 1], alpha, beta)
    return jnp.einsum("ij,...j->...i", T, p, precision=jax.lax.Precision.HIGHEST)

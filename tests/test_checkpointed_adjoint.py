"""True reverse-mode adjoint through the integrator.

A 128-parameter spline disc surface enters the traced dynamics (the crossing
indicator); `jax.grad` of a render-like loss flows through the checkpointed
segment ladder in ONE backward sweep — O(1) integrations in n_params, vs the
O(n_params) forward-Jacobian wrapper (`diff.fwd_adjoint`) kept for few-param
fits. Gradients are verified against central finite differences on random
projections (BASELINE gradient config; the reference is forward-mode only,
precision-solvers.jl:73-131).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gradus_tpu.metrics import KerrMetric
from gradus_tpu.integrate import trace_geodesics, StatusCodes
from gradus_tpu.camera.impact import map_impact_parameters


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SplineSurface:
    """Warped disc surface z = h(ρ) with h a 128-knot linear spline — a
    many-parameter 'neural-style' geometry head inside the event function."""

    knots: jnp.ndarray
    heights: jnp.ndarray

    def height(self, rho):
        return jnp.interp(rho, self.knots, self.heights)

    def crossing_indicator(self, x):
        r, th = x[..., 1], x[..., 2]
        rho = r * jnp.sin(th)
        z = r * jnp.cos(th)
        return z - self.height(rho)

    def is_hit(self, x, gtol=1e-2):
        rho = x[..., 1] * jnp.sin(x[..., 2])
        return (rho > 5.0) & (rho < 35.0)


def _setup():
    m = KerrMetric(M=1.0, a=0.6)
    x_obs = jnp.asarray([0.0, 100.0, np.deg2rad(70.0), 0.0])
    # rays aimed well inside the annulus so FD perturbations don't flip hits
    al = jnp.linspace(-16.0, -8.0, 4)
    be = jnp.linspace(-3.0, 3.0, 4)
    A = jnp.broadcast_to(al[:, None], (4, 4)).ravel()
    B = jnp.broadcast_to(be[None, :], (4, 4)).ravel()
    v = map_impact_parameters(m, x_obs, A, B)
    xs = jnp.broadcast_to(x_obs, v.shape)
    knots = jnp.linspace(3.0, 40.0, 128)
    return m, xs, v, knots


def _loss_fn(m, xs, v, knots):
    def loss(heights):
        d = SplineSurface(knots=knots, heights=heights)
        gp = trace_geodesics(
            m,
            xs,
            v,
            (0.0, 300.0),
            geometry=d,
            checkpointed=True,
            n_segments=16,
            seg_steps=16,
        )
        hit = gp.status == StatusCodes.IntersectedWithGeometry
        rho = gp.x[..., 1] * jnp.sin(gp.x[..., 2])
        # loss mixes trace-dependent quantities (hit radius, arrival time)
        # with a head re-evaluation, so gradients must flow THROUGH the
        # integrator and the Newton hit-polish
        val = jnp.where(hit, rho**2 + 0.1 * gp.x[..., 0], 0.0)
        return jnp.sum(val) / xs.shape[0]

    return loss


@pytest.mark.slow
def test_checkpointed_primal_matches_while_loop():
    m, xs, v, knots = _setup()
    heights = 0.5 + 0.3 * jnp.sin(knots / 5.0)
    d = SplineSurface(knots=knots, heights=heights)
    gp_w = trace_geodesics(m, xs, v, (0.0, 300.0), geometry=d)
    gp_c = trace_geodesics(
        m, xs, v, (0.0, 300.0), geometry=d, checkpointed=True,
        n_segments=16, seg_steps=16,
    )
    assert (np.asarray(gp_w.status) == np.asarray(gp_c.status)).all()
    np.testing.assert_allclose(
        np.asarray(gp_w.x), np.asarray(gp_c.x), rtol=1e-10, atol=1e-10
    )


@pytest.mark.slow
def test_checkpointed_adjoint_128_param_head_matches_fd():
    m, xs, v, knots = _setup()
    heights0 = 0.5 + 0.3 * jnp.sin(knots / 5.0)
    loss = _loss_fn(m, xs, v, knots)

    val0 = loss(heights0)
    assert val0 > 0  # rays actually hit

    grad = jax.jit(jax.grad(loss))(heights0)
    assert grad.shape == (128,)
    assert np.isfinite(np.asarray(grad)).all()
    assert np.abs(np.asarray(grad)).max() > 0

    rng = np.random.default_rng(3)
    eps = 3e-5
    loss_j = jax.jit(loss)
    for _ in range(5):
        u = rng.standard_normal(128)
        u /= np.linalg.norm(u)
        u = jnp.asarray(u)
        fd = (loss_j(heights0 + eps * u) - loss_j(heights0 - eps * u)) / (2 * eps)
        an = jnp.vdot(grad, u)
        np.testing.assert_allclose(
            float(an), float(fd), rtol=1e-3, atol=1e-9
        )

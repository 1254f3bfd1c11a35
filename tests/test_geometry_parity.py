"""Small parity sweep: ThickDisc AD surface
normals/tangents (thick-disc.jl:31-82), shoelace/in-polygon utilities
(geometry.jl:55-123), Fuerst-Wu (r_k, n) PolishDoughnut
(polish-doughnut.jl:1-124)."""

import jax.numpy as jnp
import numpy as np
import pytest

from gradus_tpu.metrics import KerrMetric
from gradus_tpu.geometry import (
    ThickDisc,
    ShakuraSunyaev,
    polish_doughnut_fw,
    polygon_area,
    polygon_barycenter,
    in_polygon,
)


def test_thick_disc_tangent_and_normal():
    # paraboloid-ish surface h = 0.1 ρ²: analytic slope dh/dρ = 0.2 ρ
    d = ThickDisc(f=lambda rho: 0.1 * rho**2, inner_r=0.0, outer_r=50.0)
    rho = jnp.asarray([1.0, 3.0, 7.5])
    t = d.cartesian_tangent_vector(rho)
    slope = 0.2 * rho
    expect = jnp.stack(
        [jnp.ones_like(rho), jnp.zeros_like(rho), slope], axis=-1
    )
    expect = expect / jnp.linalg.norm(expect, axis=-1, keepdims=True)
    np.testing.assert_allclose(np.asarray(t), np.asarray(expect), atol=1e-12)

    n = d.cartesian_surface_normal(rho)
    # unit, orthogonal to the tangent, outward (positive z component)
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(n), axis=-1), 1.0, atol=1e-12
    )
    np.testing.assert_allclose(
        np.sum(np.asarray(n) * np.asarray(t), axis=-1), 0.0, atol=1e-12
    )
    assert (np.asarray(n)[:, 2] > 0).all()

    # rotation about the spin axis preserves z and the norm
    n_rot = d.cartesian_surface_normal(rho, phi=jnp.asarray(1.2))
    np.testing.assert_allclose(
        np.asarray(n_rot)[:, 2], np.asarray(n)[:, 2], atol=1e-12
    )
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(n_rot), axis=-1), 1.0, atol=1e-12
    )

    # ShakuraSunyaev inherits the machinery
    ss = ShakuraSunyaev.from_metric(KerrMetric(M=1.0, a=0.9))
    nv = ss.cartesian_surface_normal(jnp.asarray(8.0))
    assert np.isfinite(np.asarray(nv)).all()


def test_polygon_utils():
    # unit square
    sq = jnp.asarray([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    assert float(polygon_area(sq)) == pytest.approx(1.0)
    np.testing.assert_allclose(np.asarray(polygon_barycenter(sq)), [0.5, 0.5])

    # triangle, reversed orientation — area is unsigned
    tri = jnp.asarray([[0.0, 0.0], [0.0, 2.0], [3.0, 0.0]])
    assert float(polygon_area(tri)) == pytest.approx(3.0)

    pts = jnp.asarray([[0.5, 0.5], [1.5, 0.5], [0.99, 0.01], [-0.01, 0.5]])
    inside = np.asarray(in_polygon(sq, pts))
    assert inside.tolist() == [True, False, True, False]
    assert bool(in_polygon(tri, jnp.asarray([0.5, 0.5])))


@pytest.mark.slow
def test_fuerst_wu_doughnut():
    m = KerrMetric(M=1.0, a=0.998)
    d = polish_doughnut_fw(m, r_k=12.0, n=0.21)
    r_in = float(d.inner_radius())
    r_out = float(d.outer_radius())
    # reference defaults give a torus spanning from a few r_g to tens of r_g
    assert 1.0 < r_in < 12.0
    assert r_out > r_in + 5.0
    # cross-section: zero outside, positive with a single interior maximum
    rho = np.linspace(r_in + 1e-3, r_out - 1e-3, 200)
    h = np.asarray(d.cross_section(jnp.asarray(rho)))
    assert (h >= 0).all() and h.max() > 0.1
    imax = h.argmax()
    assert 5 < imax < 195
    assert float(d.cross_section(jnp.asarray(r_out + 1.0))) == 0.0
    # innermost radius is the dE/dr = 0 marginal-stability point
    from gradus_tpu.orbits import CircularOrbits
    import jax

    def energy(r):
        Om = CircularOrbits.Omega(m, (r, jnp.pi / 2)) * (12.0 / r) ** 0.21
        g = m.components(r, jnp.pi / 2)
        return -(g[..., 0] + g[..., 4] * Om) / jnp.sqrt(
            -g[..., 0] - 2 * g[..., 4] * Om - g[..., 3] * Om**2
        )

    dE = float(jax.grad(energy)(jnp.asarray(r_in)))
    assert abs(dE) < 1e-8

    # the torus is traceable: a ray through its volume intersects it
    from gradus_tpu.integrate import trace_geodesics, StatusCodes
    from gradus_tpu.camera.impact import map_impact_parameters

    x_obs = jnp.asarray([0.0, 1000.0, np.deg2rad(85.0), 0.0])
    rc = 0.5 * (r_in + r_out)
    A = jnp.asarray([-rc, rc])
    B = jnp.asarray([0.0, 0.0])
    v = map_impact_parameters(m, x_obs, A, B)
    gp = trace_geodesics(m, jnp.broadcast_to(x_obs, v.shape), v, (0.0, 2200.0), geometry=d)
    assert (np.asarray(gp.status) == StatusCodes.IntersectedWithGeometry).any()

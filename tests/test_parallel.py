"""Multi-device correctness: sharded == unsharded over the 8 virtual CPU
devices configured in conftest.py.

The trace shards over rays with no collectives (the while_loop is
device-local); the product pipelines reduce with real collectives —
`psum` histograms for the line profile, `pmin`/`pmax` bin-range agreement +
`psum` bin sums for the emissivity profile (reference swap point:
`ext/GradusDiffEqGPUExt/GradusDiffEqGPUExt.jl:10-31`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gradus_tpu as gt
from gradus_tpu.camera.grids import GeometricGrid
from gradus_tpu.camera.impact import map_impact_parameters
from gradus_tpu.camera.planes import PolarPlane
from gradus_tpu.corona.emissivity import tracecorona_profile
from gradus_tpu.lineprofile import BinningMethod
from gradus_tpu.parallel import (
    ray_mesh,
    sharded_trace,
    sharded_render,
    sharded_lineprofile,
    sharded_emissivity,
)


@pytest.fixture(scope="module")
def kerr_setup():
    m = gt.KerrMetric(M=1.0, a=0.9)
    x = jnp.array([0.0, 1000.0, np.deg2rad(60.0), 0.0])
    d = gt.ThinDisc(0.0, 50.0)
    return m, x, d


def test_mesh_has_devices():
    assert ray_mesh().devices.size == 8


def test_sharded_trace_matches(kerr_setup):
    """Per-ray results are independent of the sharding layout (incl. the
    ragged 10-over-8 padding path)."""
    m, x, d = kerr_setup
    alphas = jnp.linspace(-10.0, 10.0, 10) + 1e-4
    betas = jnp.zeros(10) + 1e-4
    v = map_impact_parameters(m, x, alphas, betas)
    xs = jnp.broadcast_to(x, v.shape)
    gp_sh = sharded_trace(m, xs, v, (0.0, 2200.0), geometry=d)
    gp = gt.trace_geodesics(m, xs, v, (0.0, 2200.0), geometry=d)
    np.testing.assert_array_equal(np.asarray(gp_sh.status), np.asarray(gp.status))
    np.testing.assert_allclose(
        np.asarray(gp_sh.x), np.asarray(gp.x), rtol=1e-8, atol=1e-8
    )


@pytest.mark.slow
def test_sharded_lineprofile_matches(kerr_setup):
    """psum-reduced flux histogram equals the single-program histogram."""
    m, x, d = kerr_setup
    plane = PolarPlane(GeometricGrid(), Nr=16, Ntheta=16, r_max=30.0)
    bins, flux_sh = sharded_lineprofile(m, x, d, plane=plane, max_re=50.0)
    _, flux = gt.lineprofile(
        m, x, d, method=BinningMethod(), plane=plane, max_re=50.0
    )
    np.testing.assert_allclose(
        np.asarray(flux_sh), np.asarray(flux), rtol=1e-10, atol=1e-12
    )
    assert np.isclose(np.asarray(flux_sh).sum(), 1.0, rtol=1e-8)


@pytest.mark.slow
def test_sharded_emissivity_matches(kerr_setup):
    """pmin/pmax bin agreement + psum photon counting equals single-program."""
    m, _, d = kerr_setup
    model = gt.LampPostModel()
    prof_sh = sharded_emissivity(m, d, model, n_samples=256, n_bins=20)
    prof = tracecorona_profile(m, d, model, n_samples=256, n_bins=20)
    assert int(prof_sh.n) == int(prof.n)
    np.testing.assert_allclose(
        np.asarray(prof_sh.eps), np.asarray(prof.eps), rtol=1e-9, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(prof_sh.radii), np.asarray(prof.radii), rtol=1e-12
    )


def test_sharded_render_matches(kerr_setup):
    """Sharded shadow render equals the single-device render pixel-for-pixel."""
    m, x, _ = kerr_setup
    kw = dict(
        image_width=12,
        image_height=12,
        alpha_lims=(-10.0, 10.0),
        beta_lims=(-10.0, 10.0),
        lam_max=2200.0,
    )
    _, _, img_sh = sharded_render(m, x, **kw)
    _, _, img = gt.rendergeodesics(m, x, **kw)
    np.testing.assert_allclose(
        np.asarray(img_sh), np.asarray(img), rtol=1e-8, atol=1e-8
    )


def test_sharded_gradient_psum():
    """Parameter gradient of a sharded loss: psum'd spin gradient is finite
    and matches the unsharded gradient (the dryrun_multichip contract, now
    asserted in-suite)."""
    from jax.sharding import PartitionSpec as P

    mesh = ray_mesh()
    d = gt.ThinDisc(0.0, 30.0)
    x = jnp.array([0.0, 100.0, np.deg2rad(70.0), 0.0])
    alphas = jnp.linspace(4.0, 9.0, 8)
    betas = jnp.zeros(8) + 1e-3

    def loss(a):
        m = gt.KerrMetric(M=1.0, a=a)
        v = map_impact_parameters(m, x, alphas, betas)
        xs = jnp.broadcast_to(x, v.shape)

        def local(x_loc, v_loc):
            gp = gt.trace_geodesics(m, x_loc, v_loc, (0.0, 300.0), geometry=d)
            contrib = jnp.where(
                gp.status == gt.StatusCodes.IntersectedWithGeometry,
                gp.x[..., 1],
                0.0,
            )
            return jax.lax.psum(jnp.sum(contrib), "rays")

        return jax.shard_map(
            local, mesh=mesh, in_specs=(P("rays"), P("rays")), out_specs=P()
        )(xs, v)

    def loss_unsharded(a):
        m = gt.KerrMetric(M=1.0, a=a)
        v = map_impact_parameters(m, x, alphas, betas)
        xs = jnp.broadcast_to(x, v.shape)
        gp = gt.trace_geodesics(m, xs, v, (0.0, 300.0), geometry=d)
        return jnp.sum(
            jnp.where(
                gp.status == gt.StatusCodes.IntersectedWithGeometry,
                gp.x[..., 1],
                0.0,
            )
        )

    a0 = jnp.asarray(0.5)
    val, dval = jax.jvp(loss, (a0,), (jnp.ones(()),))
    val_u, dval_u = jax.jvp(loss_unsharded, (a0,), (jnp.ones(()),))
    assert np.isfinite(float(dval))
    np.testing.assert_allclose(float(val), float(val_u), rtol=1e-10)
    np.testing.assert_allclose(float(dval), float(dval_u), rtol=1e-6)


def test_sharded_pallas_trace_matches(kerr_setup):
    """The flagship Pallas kernel composes with shard_map: pixel-exact equality between the 8-device mesh run and the
    single-device run of the same interpret-mode kernel, including the
    ragged 20-over-8 padding path."""
    from gradus_tpu.integrate.pallas_solver import PallasTracer
    from gradus_tpu.parallel import sharded_pallas_trace

    m, x, d = kerr_setup
    al = jnp.linspace(-10.0, 10.0, 20) + 1e-3
    v = map_impact_parameters(m, x, al, jnp.full_like(al, 2.0))
    xs = jnp.broadcast_to(x, v.shape)
    pt = PallasTracer(m, geometry=d, interpret=True)
    y0 = pt._constrain(xs, v)
    gp1, _ = pt.trace(y0, (0.0, 2200.0))
    gp8 = sharded_pallas_trace(pt, y0, (0.0, 2200.0), mesh=ray_mesh())
    np.testing.assert_array_equal(np.asarray(gp1.status), np.asarray(gp8.status))
    np.testing.assert_allclose(np.asarray(gp1.x), np.asarray(gp8.x), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(gp1.v), np.asarray(gp8.v), rtol=1e-12)

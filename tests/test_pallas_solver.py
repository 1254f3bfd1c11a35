"""Pallas register-resident integrator vs the XLA while_loop solver.

Runs in interpret mode on the CPU test backend. The same kernel compiles
through Pallas's Triton route for a GPU; the ``gpu``-marked tests check the
compiled kernel there and skip elsewhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gradus_tpu.metrics import KerrMetric
from gradus_tpu.geometry import ThinDisc
from gradus_tpu.integrate import trace_geodesics, StatusCodes
from gradus_tpu.integrate import pallas_solver
from gradus_tpu.integrate.pallas_solver import PallasTracer, num_warps_for
from gradus_tpu.camera.impact import map_impact_parameters


@pytest.fixture(scope="module")
def kerr_disc_setup():
    m = KerrMetric(M=1.0, a=0.998)
    d = ThinDisc(inner_r=0.0, outer_r=50.0)
    x_obs = jnp.asarray([0.0, 1000.0, np.deg2rad(75.0), 0.0])
    rng = np.random.default_rng(2)
    n = 96
    A = jnp.asarray(rng.uniform(-12, 12, n))
    B = jnp.asarray(rng.uniform(-12, 12, n))
    v = map_impact_parameters(m, x_obs, A, B)
    xs = jnp.broadcast_to(x_obs, v.shape)
    return m, d, xs, v


@pytest.mark.slow
def test_pallas_matches_xla_solver(kerr_disc_setup):
    m, d, xs, v = kerr_disc_setup
    gp_ref = trace_geodesics(m, xs, v, (0.0, 2200.0), geometry=d)
    pt = PallasTracer(m, geometry=d, interpret=True)
    gp_pal = pt(xs, v, (0.0, 2200.0))

    s_ref = np.asarray(gp_ref.status)
    s_pal = np.asarray(gp_pal.status)
    assert (s_ref == s_pal).all()
    # disc hits land on the same surface point to solver tolerance
    hit = s_ref == StatusCodes.IntersectedWithGeometry
    assert hit.sum() > 10
    assert np.allclose(
        np.asarray(gp_ref.x)[hit], np.asarray(gp_pal.x)[hit], atol=1e-5
    )
    assert np.allclose(
        np.asarray(gp_ref.lam_max)[hit], np.asarray(gp_pal.lam_max)[hit], atol=1e-5
    )
    # hits are on the equatorial plane within the annulus
    xh = np.asarray(gp_pal.x)[hit]
    assert np.allclose(xh[:, 2], np.pi / 2, atol=1e-5)


def test_pallas_no_geometry_chart_bounds(kerr_disc_setup):
    m, _, xs, v = kerr_disc_setup
    gp_ref = trace_geodesics(m, xs, v, (0.0, 2200.0))
    pt = PallasTracer(m, interpret=True)
    gp_pal = pt(xs, v, (0.0, 2200.0))
    assert (np.asarray(gp_ref.status) == np.asarray(gp_pal.status)).all()
    ok = np.asarray(gp_ref.status) != StatusCodes.WithinInnerBoundary
    assert np.allclose(
        np.asarray(gp_ref.x)[ok, 1], np.asarray(gp_pal.x)[ok, 1], rtol=1e-6
    )


@pytest.mark.slow
def test_pallas_segmented_matches_single_pass(kerr_disc_setup):
    """Tail-segmented execution (capped pass 1 + sorted resume pass 2) must be
    bit-compatible with the single-pass kernel: the resume path restores the
    exact integrator carry, so statuses and endpoints are identical."""
    m, d, xs, v = kerr_disc_setup
    pt1 = PallasTracer(m, geometry=d, interpret=True)
    gp1 = pt1(xs, v, (0.0, 2200.0))
    # tiny cap + small bucket forces several rays through the resume path
    pt2 = PallasTracer(
        m,
        geometry=d,
        interpret=True,
        segment_iters=48,
        tail_bucket=128,
    )
    gp2 = pt2(xs, v, (0.0, 2200.0))
    assert (np.asarray(gp1.status) == np.asarray(gp2.status)).all()
    np.testing.assert_allclose(
        np.asarray(gp1.x), np.asarray(gp2.x), rtol=0, atol=0
    )
    np.testing.assert_allclose(
        np.asarray(gp1.lam_max), np.asarray(gp2.lam_max), rtol=0, atol=0
    )


@pytest.mark.slow
def test_pallas_unfinished_counter(kerr_disc_setup):
    """An undersized tail bucket must be *detected*, not silent: rays that
    never resumed stay NoStatus and are counted in aux["unfinished"]."""
    import jax

    m, d, xs, v = kerr_disc_setup
    pt = PallasTracer(
        m, geometry=d, interpret=True, segment_iters=24, tail_bucket=8
    )
    y0 = pt._constrain(xs, v)
    _, aux = jax.jit(lambda y: pt.trace(y, (0.0, 2200.0)))(y0)
    assert int(aux["unfinished"]) > 0

    ok = PallasTracer(m, geometry=d, interpret=True)
    _, aux_ok = jax.jit(lambda y: ok.trace(y, (0.0, 2200.0)))(y0)
    assert int(aux_ok["unfinished"]) == 0


@pytest.mark.parametrize(
    "block_rays,warps", [(32, 1), (64, 2), (128, 4), (256, 8), (1024, 32)]
)
def test_block_rays_to_warps(block_rays, warps):
    """One ray per thread: a block of 32·w rays is w warps."""
    assert num_warps_for(block_rays) == warps


@pytest.mark.parametrize("block_rays", [0, 16, 48, 96, 2048])
def test_block_rays_rule_rejects(block_rays):
    """Block sizes are powers of two from one warp to Triton's 32 warps."""
    with pytest.raises(ValueError):
        num_warps_for(block_rays)
    with pytest.raises(ValueError):
        PallasTracer(KerrMetric(M=1.0, a=0.5), block_rays=block_rays)


def test_block_padding_is_invisible(kerr_disc_setup):
    """N = 45 is not a multiple of the block: padded rays are inert and the
    per-ray results do not depend on the block size."""
    m, d, xs, v = kerr_disc_setup
    xs, v = xs[:45], v[:45]
    gp32 = PallasTracer(m, geometry=d, interpret=True, block_rays=32)(
        xs, v, (0.0, 2200.0)
    )
    pt64 = PallasTracer(m, geometry=d, interpret=True, block_rays=64)
    gp64 = pt64(xs, v, (0.0, 2200.0))
    assert gp32.x.shape == (45, 4) and pt64.last_block_iters.shape == (45,)
    np.testing.assert_array_equal(np.asarray(gp32.status), np.asarray(gp64.status))
    np.testing.assert_array_equal(np.asarray(gp32.x), np.asarray(gp64.x))
    ref = trace_geodesics(m, xs, v, (0.0, 2200.0), geometry=d)
    np.testing.assert_array_equal(np.asarray(ref.status), np.asarray(gp32.status))


def _kernel_call(dtype, n=40, interpret=True):
    m = KerrMetric(M=1.0, a=0.9)
    pt = PallasTracer(m, geometry=ThinDisc(0.0, 50.0), dtype=dtype, interpret=interpret)
    y0 = jnp.full((n, 8), 1.0, dtype)
    return pt, (lambda y: pallas_solver.pallas_integrate_rays(
        pt._f_cm, y, (0.0, 100.0), **{**pt._integrate_kwargs(), "interpret": interpret}
    )), y0


def test_pallas_call_names_triton():
    """The kernel names its route and its warp count; nothing is left to
    JAX's default GPU route."""
    _, fn, y0 = _kernel_call(jnp.float32)
    jaxpr = jax.make_jaxpr(fn)(y0)
    calls = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "pallas_call"]
    assert len(calls) == 1
    params = calls[0].params
    assert params["backend"] == "triton"
    assert params["compiler_params"]["triton"].num_warps == num_warps_for(128)
    assert params["grid_mapping"].grid == (1,)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_kernel_lowers_for_cuda(monkeypatch, dtype):
    """Every primitive of the kernel body has a Triton lowering: lowering
    for CUDA emits one Triton custom call (compiling it needs the card)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    _, fn, y0 = _kernel_call(dtype, interpret=False)
    text = jax.jit(fn).trace(y0).lower(lowering_platforms=("cuda",)).as_text()
    assert text.count("__gpu$xla.gpu.triton") == 1
    assert "num_warps = 4" in text


def test_compiled_call_off_gpu_raises():
    """Without a GPU the compiled kernel refuses instead of interpreting."""
    assert jax.default_backend() != "gpu"
    _, fn, y0 = _kernel_call(jnp.float32, interpret=False)
    with pytest.raises(RuntimeError, match="interpret=True"):
        fn(y0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_compiled_kernel_matches_xla(gpu_device, kerr_disc_setup, dtype):
    """The kernel compiled for the card against the XLA solver."""
    m, d, xs, v = kerr_disc_setup
    xs, v = jnp.asarray(xs, dtype), jnp.asarray(v, dtype)
    gp_ref = trace_geodesics(m, xs, v, (0.0, 2200.0), geometry=d)
    gp = PallasTracer(m, geometry=d, dtype=dtype)(xs, v, (0.0, 2200.0))
    assert gp.x.dtype == dtype
    s_ref, s = np.asarray(gp_ref.status), np.asarray(gp.status)
    assert (s_ref == s).all()
    hit = s_ref == StatusCodes.IntersectedWithGeometry
    assert hit.sum() > 10
    # Triton and XLA round differently (FMA contraction, libdevice vs XLA
    # transcendentals); rays near the photon ring amplify that, so the bulk
    # is held to the dtype's solver tolerance and the tail only loosely
    r_ref, r = np.asarray(gp_ref.x)[hit, 1], np.asarray(gp.x)[hit, 1]
    rel = np.abs(r - r_ref) / r_ref
    assert np.median(rel) < (1e-5 if dtype == jnp.float32 else 1e-8), rel
    assert np.percentile(rel, 90) < 1e-3, rel

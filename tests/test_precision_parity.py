"""f32 ↔ f64 self-parity: the BASELINE.md precision story.

BASELINE north-star: "match Gradus within rtol = 1e-5 on the redshift image".
The production path is float32; this test quantifies the f32 error budget against the f64 CPU path on the flagship
Kerr a=0.998 thin-disc redshift render. Measured budget (48², i=75°):
hit-mask agreement 100%, redshift relative error median ~8e-7 /
p95 ~1.3e-5 / max ~2e-3 (disc-edge pixels where the intersection point
itself is ill-conditioned), hit-radius relative error median ~1.4e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gradus_tpu as gt
from gradus_tpu.camera.impact import map_impact_parameters
from gradus_tpu.integrate.status import StatusCodes
from gradus_tpu.redshift import redshift_pointfunction

SIDE = 48


def _render(dtype):
    m = gt.KerrMetric(M=jnp.asarray(1.0, dtype), a=jnp.asarray(0.998, dtype))
    d = gt.ThinDisc(0.0, 50.0)
    x = jnp.asarray([0.0, 1000.0, np.deg2rad(75.0), 0.0], dtype)
    al = jnp.linspace(-25, 25, SIDE, dtype=dtype) + 1e-3
    be = jnp.linspace(-15, 15, SIDE, dtype=dtype) + 1e-3
    A = jnp.broadcast_to(al[:, None], (SIDE, SIDE)).ravel()
    B = jnp.broadcast_to(be[None, :], (SIDE, SIDE)).ravel()
    v = map_impact_parameters(m, x, A, B)
    xs = jnp.broadcast_to(x, v.shape)
    gp = gt.trace_geodesics(m, xs, v, (0.0, 2200.0), geometry=d)
    pf = redshift_pointfunction(m, x)
    g = pf(m, gp, 2200.0)
    hit = gp.status == StatusCodes.IntersectedWithGeometry
    return np.asarray(g), np.asarray(gp.x), np.asarray(hit)


def test_f32_f64_redshift_image_parity():
    g64, x64, h64 = _render(jnp.float64)
    g32, x32, h32 = _render(jnp.float32)
    # every pixel classifies identically (hit / miss)
    assert (h64 == h32).all()
    both = h64 & h32
    assert both.sum() > 1500
    rel = np.abs(g32[both] - g64[both]) / np.abs(g64[both])
    # the BASELINE rtol=1e-5 target, met at the bulk of the image; the tail
    # is disc-edge pixels whose intersection is ill-conditioned in ANY dtype
    assert np.median(rel) < 5e-6
    assert np.percentile(rel, 95) < 1e-4
    assert rel.max() < 1e-2
    rrel = np.abs(x32[both, 1] - x64[both, 1]) / np.abs(x64[both, 1])
    assert np.median(rrel) < 1e-4


@pytest.mark.slow
def test_f32_f64_lineprofile_parity_production_scale():
    """f32 vs f64 at the HARDWARE BENCH config: 100
    radii, N=80, 180 bins — the exact TransferFunctionMethod product the
    benchmark runs. Measured budgets (full config, CPU): median 3.1e-4, p90 7.8e-4,
    p99 5.0e-3, max 8.2e-3 — the bulk-bins ≤1e-3 target is met; the tail is
    near-edge bins whose √-edge integrand is resolution-limited in f32."""
    from gradus_tpu.transfer import transferfunctions, integrate_lineprofile

    def profile(dtype):
        m = gt.KerrMetric(M=jnp.asarray(1.0, dtype), a=jnp.asarray(0.998, dtype))
        x = jnp.asarray([0.0, 1000.0, np.deg2rad(60.0), 0.0], dtype)
        d = gt.ThinDisc(0.0, jnp.inf)
        bins = jnp.linspace(0.1, 1.5, 180, dtype=dtype)
        tfs = transferfunctions(m, x, d, num_re=100, N=80)
        return np.asarray(
            integrate_lineprofile(lambda r: r**-3.0, tfs, bins, n_radii=1000)
        )

    f64 = profile(jnp.float64)
    f32 = profile(jnp.float32)
    nz = f64 > 1e-5 * f64.max()
    assert nz.sum() > 120
    rel = np.abs(f32[nz] - f64[nz]) / f64[nz]
    assert np.median(rel) < 1e-3
    assert np.percentile(rel, 90) < 2e-3
    assert rel.max() < 3e-2
    # first-moment checksum (the drift statistic bench_ctf reports on
    # hardware): mean line energy Σ(flux·g)/Σflux
    centers = np.linspace(0.1, 1.5, 180)
    m1_64 = (f64 * centers).sum() / f64.sum()
    m1_32 = (f32 * centers).sum() / f32.sum()
    np.testing.assert_allclose(m1_32, m1_64, rtol=1e-4)


@pytest.mark.slow
def test_f32_f64_lineprofile_parity():
    """Line-profile flux: f32 pipeline (CTF table + integration) against f64,
    quantified bin-wise."""
    from gradus_tpu.transfer import transferfunctions, integrate_lineprofile

    def profile(dtype):
        m = gt.KerrMetric(M=jnp.asarray(1.0, dtype), a=jnp.asarray(0.6, dtype))
        x = jnp.asarray([0.0, 1000.0, np.deg2rad(45.0), 0.0], dtype)
        d = gt.ThinDisc(0.0, jnp.inf)
        tfs = transferfunctions(
            m, x, d, num_re=8, max_re=30.0, N=20, N_extrema=8, Ng=32
        )
        bins = jnp.linspace(0.1, 1.5, 80, dtype=dtype)
        return np.asarray(
            integrate_lineprofile(lambda r: r**-3.0, tfs, bins, n_radii=200)
        )

    f64 = profile(jnp.float64)
    f32 = profile(jnp.float32)
    nz = f64 > 1e-5 * f64.max()
    rel = np.abs(f32[nz] - f64[nz]) / f64[nz]
    # bulk of the profile matches to <1%; the median bin to ~1e-3
    assert np.median(rel) < 2e-3
    assert np.percentile(rel, 90) < 2e-2

"""PoloidalShapeChart (θ-dependent inner boundary) and the metric-generic
PolishDoughnut isobars (reference charts.jl:26-69, polish-doughnut.jl)."""

import jax.numpy as jnp
import numpy as np

import gradus_tpu as gt
from gradus_tpu.camera.impact import map_impact_parameters
from gradus_tpu.integrate.status import StatusCodes


def test_event_horizon_chart_shape():
    """Near-extremal Kerr horizon: r_H = M + √(M²−a²) is θ-independent in BL
    coordinates, but the chart machinery must interpolate r(θ) correctly; use
    Johannsen-Psaltis where the capture surface genuinely deforms."""
    m = gt.KerrMetric(M=1.0, a=0.998)
    chart = gt.event_horizon_chart(m)
    r_h = 1.0 + np.sqrt(1.0 - 0.998**2)
    np.testing.assert_allclose(np.asarray(chart.rs), r_h * 1.01, rtol=1e-6)


def test_shaped_chart_capture_radius():
    """Rays captured with the shaped chart terminate at r ≈ r_min(θ) of the
    interpolated shape, and hit/escape classification matches the scalar
    chart for Kerr (where the true horizon IS a coordinate sphere)."""
    m = gt.KerrMetric(M=1.0, a=0.998)
    x = jnp.array([0.0, 100.0, np.deg2rad(85.0), 0.0])
    al = jnp.linspace(-7.0, 7.0, 16)
    be = jnp.zeros(16) + 0.5
    v = map_impact_parameters(m, x, al, be)
    xs = jnp.broadcast_to(x, v.shape)

    chart = gt.event_horizon_chart(m)
    gp_shaped = gt.trace_geodesics(
        m, xs, v, (0.0, 300.0), chart_inner=chart, chart_outer=200.0
    )
    gp_scalar = gt.trace_geodesics(m, xs, v, (0.0, 300.0), chart_outer=200.0)
    s1 = np.asarray(gp_shaped.status)
    s2 = np.asarray(gp_scalar.status)
    np.testing.assert_array_equal(s1, s2)
    captured = s1 == int(StatusCodes.WithinInnerBoundary)
    assert captured.any()
    r_end = np.asarray(gp_shaped.x)[captured, 1]
    th_end = np.asarray(gp_shaped.x)[captured, 2]
    r_min = np.interp(th_end, np.asarray(chart.thetas), np.asarray(chart.rs))
    assert (r_end <= r_min + 0.3).all()


def test_shaped_chart_deformed_metric():
    """Deformed-metric render near the horizon through the shaped chart: the
    JP capture surface from event_horizon feeds the chart and tracing
    terminates cleanly."""
    m = gt.JohannsenPsaltisMetric(M=1.0, a=0.6, eps3=2.0)
    chart = gt.event_horizon_chart(m)
    assert np.all(np.asarray(chart.rs) > 0)
    x = jnp.array([0.0, 100.0, np.deg2rad(80.0), 0.0])
    al = jnp.linspace(-6.0, 6.0, 12)
    v = map_impact_parameters(m, x, al, jnp.zeros(12) + 0.3)
    xs = jnp.broadcast_to(x, v.shape)
    gp = gt.trace_geodesics(
        m, xs, v, (0.0, 600.0), chart_inner=chart, chart_outer=200.0
    )
    s = np.asarray(gp.status)
    assert (s != int(StatusCodes.NoStatus)).all()
    assert (s == int(StatusCodes.WithinInnerBoundary)).any()


def test_polish_doughnut_generic_matches_schwarzschild():
    """Metric-generic isobar potential at a=0 reproduces the Schwarzschild
    closed form."""
    d_closed = gt.PolishDoughnut(M=1.0, ell=3.8, r_cusp=4.6)
    d_generic = gt.PolishDoughnut(
        M=1.0, ell=3.8, r_cusp=4.6, metric=gt.KerrMetric(M=1.0, a=0.0)
    )
    rho = jnp.linspace(4.8, 14.0, 40)
    h1 = np.asarray(d_closed.cross_section(rho))
    h2 = np.asarray(d_generic.cross_section(rho))
    inside = h1 > 0
    assert inside.any()
    np.testing.assert_allclose(h2[inside], h1[inside], rtol=1e-4, atol=1e-4)


def test_polish_doughnut_kerr_torus():
    """Kerr a=0.9 torus: bounded cross-section, thicker than the a=0 torus at
    the same ℓ near the centre (frame dragging deepens the potential well)."""
    rho = jnp.linspace(4.0, 16.0, 60)
    h0 = np.asarray(
        gt.PolishDoughnut(ell=3.8, r_cusp=4.6, metric=gt.KerrMetric(M=1.0, a=0.0)).cross_section(rho)
    )
    h9 = np.asarray(
        gt.PolishDoughnut(ell=3.8, r_cusp=4.6, metric=gt.KerrMetric(M=1.0, a=0.9)).cross_section(rho)
    )
    assert (h9 >= -1.0).all() and np.isfinite(h9).all()
    # the a=0.9 torus exists and differs measurably from Schwarzschild
    assert (h9 > 0).any()
    assert np.max(np.abs(np.where(h9 > 0, h9, 0) - np.where(h0 > 0, h0, 0))) > 0.05

"""Reverse-mode gradients through the integrator: jax.grad works through the while_loop trace via the
forward-Jacobian custom VJP, and agrees with jacfwd and finite differences
on (spin, disc inner radius) through a small render and through the fittable
LineProfileModel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gradus_tpu as gt
from gradus_tpu.camera.impact import map_impact_parameters
from gradus_tpu.integrate.status import StatusCodes


def _mean_redshift(params):
    """Scalar loss: masked mean redshift of an 8x8 Kerr disc render.

    Parameters: spin `a` and observer inclination `incl` — both act smoothly
    on the redshift (a disc-edge radius would only flip discrete hit
    classifications, so its a.e. gradient is zero)."""
    a, incl = params["a"], params["incl"]
    m = gt.KerrMetric(M=1.0, a=a)
    d = gt.ThinDisc(0.0, 50.0)
    x = jnp.stack([jnp.asarray(0.0, incl.dtype), jnp.asarray(1000.0, incl.dtype), incl, jnp.asarray(0.0, incl.dtype)])
    al = jnp.linspace(-12.0, 12.0, 8) + 1e-3
    be = jnp.linspace(-8.0, 8.0, 8) + 1e-3
    A = jnp.broadcast_to(al[:, None], (8, 8)).ravel()
    B = jnp.broadcast_to(be[None, :], (8, 8)).ravel()
    v = map_impact_parameters(m, x, A, B)
    xs = jnp.broadcast_to(x, v.shape)
    gp = gt.trace_geodesics(m, xs, v, (0.0, 2200.0), geometry=d)
    from gradus_tpu.redshift import redshift_pointfunction

    g = redshift_pointfunction(m, x)(m, gp, 2200.0)
    hit = (gp.status == StatusCodes.IntersectedWithGeometry).astype(g.dtype)
    return jnp.sum(jnp.where(hit > 0, g, 0.0)) / jnp.sum(hit)


@pytest.mark.slow
def test_grad_render_vjp_jvp_fd_agree():
    params = {"a": jnp.asarray(0.5), "incl": jnp.asarray(np.deg2rad(60.0))}

    # reverse mode through the custom VJP
    loss_rev = gt.fwd_adjoint(_mean_redshift)
    g_rev = jax.grad(loss_rev)(params)

    # forward mode directly
    g_fwd = jax.jacfwd(_mean_redshift)(params)

    # central finite differences
    def fd(key, eps=1e-4):
        up = dict(params); up[key] = params[key] + eps
        dn = dict(params); dn[key] = params[key] - eps
        return (float(_mean_redshift(up)) - float(_mean_redshift(dn))) / (2 * eps)

    for key in ("a", "incl"):
        np.testing.assert_allclose(float(g_rev[key]), float(g_fwd[key]), rtol=1e-6)
        np.testing.assert_allclose(float(g_rev[key]), fd(key), rtol=2e-2, atol=1e-7)
    # physics: the gradients actually carry signal
    assert abs(float(g_rev["incl"])) > 1e-5


def test_grad_composes_with_downstream_reverse_ad():
    """The wrapper sits at the trace boundary; plain reverse-mode AD handles
    arbitrary downstream computation on top of it."""
    params = {"a": jnp.asarray(0.3), "incl": jnp.asarray(np.deg2rad(45.0))}
    base = gt.fwd_adjoint(_mean_redshift)

    def downstream(p):
        v = base(p)
        return jnp.tanh(v) ** 2 + 3.0 * v

    def downstream_plain(p):
        v = _mean_redshift(p)
        return jnp.tanh(v) ** 2 + 3.0 * v

    g = jax.grad(downstream)(params)
    # custom_vjp functions cannot be jvp'd — forward-mode reference comes
    # from the unwrapped pipeline
    gf = jax.jacfwd(downstream_plain)(params)
    for key in ("a", "incl"):
        np.testing.assert_allclose(float(g[key]), float(gf[key]), rtol=1e-6)


@pytest.mark.slow
def test_lineprofile_model_gradient():
    """jax.grad through the fittable LineProfileModel (table interpolation +
    line integration) w.r.t. (a, inner_r, lineE, K)."""
    m0 = gt.KerrMetric(M=1.0, a=0.6)
    x = jnp.array([0.0, 1000.0, np.deg2rad(45.0), 0.0])
    d = gt.ThinDisc(0.0, jnp.inf)
    table = gt.make_transfer_function_table(
        gt.KerrMetric, d, [0.5, 0.7], [40.0, 50.0],
        n_radii=6, r_max=30.0, N=16, N_extrema=6, Ng=24,
    )
    model = gt.LineProfileModel(table=table)
    energies = jnp.linspace(2.0, 9.0, 40)

    def chi2(p):
        flux = model(energies, a=p["a"], inner_r=p["inner_r"], lineE=p["lineE"], K=p["K"])
        return jnp.sum((flux - 0.01) ** 2)

    p0 = {"a": jnp.asarray(0.6), "inner_r": jnp.asarray(4.0),
          "lineE": jnp.asarray(6.4), "K": jnp.asarray(1.0)}
    g = jax.grad(chi2)(p0)
    for k, v in g.items():
        assert np.isfinite(float(v)), k
    # finite-difference check on the normalization (smooth, well-conditioned)
    eps = 1e-4
    up = dict(p0); up["K"] = p0["K"] + eps
    dn = dict(p0); dn["K"] = p0["K"] - eps
    fd = (float(chi2(up)) - float(chi2(dn))) / (2 * eps)
    np.testing.assert_allclose(float(g["K"]), fd, rtol=1e-4)

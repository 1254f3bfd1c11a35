"""Pallas FD-Newton CTF solver vs the XLA jvp path.

`transfer/pallas_ctf.py` replaces the jvp-through-integration derivative with
finite differences traced through the Pallas kernel. These tests run the
kernel in interpret mode on the CPU backend (the same kernel compiles through
Pallas's Triton route for a GPU) and assert the three operations the CTF assembly consumes —
``workhorse``, ``probe``, ``jacobian_at`` — agree with the XLA f32 path, plus
an end-to-end `cunningham_transfer_function(backend="pallas")` comparison.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gradus_tpu.metrics import KerrMetric
from gradus_tpu.geometry import ThinDisc, DatumPlane
from gradus_tpu.transfer.cunningham import cunningham_transfer_function
from gradus_tpu.transfer.pallas_ctf import PallasCTFSolver, get_pallas_ctf_solver
from gradus_tpu.transfer.solvers import (
    offset_workhorse,
    offset_probe,
    offset_jacobian_at,
)

DT = jnp.float32


@pytest.fixture(scope="module")
def setup():
    m = KerrMetric(M=jnp.asarray(1.0, DT), a=jnp.asarray(0.998, DT))
    x = jnp.asarray([0.0, 1000.0, np.deg2rad(60.0), 0.0], DT)
    d = DatumPlane(jnp.asarray(0.0, DT))
    solver = PallasCTFSolver(m, np.asarray(x, np.float64), d, interpret=True)
    # a band of emission radii × angles covering near-ISCO to mid-disc
    radii = jnp.asarray([4.0, 7.0, 11.0, 20.0], DT)
    thetas = jnp.asarray([0.31, 1.2, 2.3, 3.43, 4.5, 5.9], DT)
    RE = jnp.broadcast_to(radii[:, None], (4, 6)).ravel()
    TH = jnp.broadcast_to(thetas[None, :], (4, 6)).ravel()
    return m, x, d, solver, RE, TH


@pytest.mark.slow
def test_workhorse_parity(setup):
    """g, J, t from the FD kernel path match the XLA jvp path."""
    m, x, d, solver, RE, TH = setup
    g_p, J_p, t_p, ok_p, roff_p, _ = solver.workhorse(RE, TH)
    g_x, J_x, t_x, ok_x, roff_x, cond_x = offset_workhorse(
        m, x, d, RE, TH, return_r_off=True
    )
    ok_p, ok_x = np.asarray(ok_p), np.asarray(ok_x)
    both = ok_p & ok_x
    # all these (rₑ, θ) pairs are solvable on the primary image
    assert both.sum() == RE.shape[0], (ok_p, ok_x)
    np.testing.assert_allclose(
        np.asarray(roff_p)[both], np.asarray(roff_x)[both], rtol=5e-4
    )
    # the redshift field is the same closed form in both paths
    np.testing.assert_allclose(
        np.asarray(g_p)[both], np.asarray(g_x)[both], rtol=1e-4
    )
    # J: central FD vs jvp. The FD truncation error has a tail at
    # strongly-lensed rays (behind-hole far-side images, where the
    # curvature of ρ(α, β) over the FD step h·(1+r_off) is large) and near
    # the det→0 extrema; the product-level consequence is the m1 drift in
    # PERF.md and the end-to-end grid test below. Here: bulk parity.
    relJ = np.abs(np.asarray(J_p)[both] - np.asarray(J_x)[both]) / np.abs(
        np.asarray(J_x)[both]
    )
    assert np.median(relJ) < 1e-3, relJ
    assert np.percentile(relJ, 90) < 2e-2, relJ
    np.testing.assert_allclose(
        np.asarray(t_p)[both], np.asarray(t_x)[both], rtol=1e-4
    )


@pytest.mark.slow
def test_probe_parity(setup):
    m, x, d, solver, RE, TH = setup
    roff_p, g_p, t_p, ok_p = solver.probe(RE, TH)
    roff_x, g_x, t_x, ok_x = offset_probe(m, x, d, RE, TH)
    both = np.asarray(ok_p) & np.asarray(ok_x)
    assert both.sum() == RE.shape[0]
    np.testing.assert_allclose(
        np.asarray(roff_p)[both], np.asarray(roff_x)[both], rtol=5e-4
    )
    np.testing.assert_allclose(
        np.asarray(g_p)[both], np.asarray(g_x)[both], rtol=1e-4
    )


@pytest.mark.slow
def test_jacobian_at_parity(setup):
    """J at fixed offsets (no Newton): isolates the FD-vs-jvp derivative."""
    m, x, d, solver, RE, TH = setup
    roff_x, _, _, ok0 = offset_probe(m, x, d, RE, TH)
    g_p, J_p, t_p, ok_p, _ = solver.jacobian_at(RE, TH, roff_x)
    g_x, J_x, t_x, ok_x, _ = offset_jacobian_at(m, x, d, RE, TH, roff_x)
    both = np.asarray(ok_p) & np.asarray(ok_x)
    assert both.sum() == RE.shape[0]
    np.testing.assert_allclose(
        np.asarray(J_p)[both], np.asarray(J_x)[both], rtol=2e-2
    )
    np.testing.assert_allclose(
        np.asarray(g_p)[both], np.asarray(g_x)[both], rtol=1e-4
    )


@pytest.mark.slow
def test_end_to_end_backend_pallas(setup):
    """Full CTF grid via backend='pallas' vs the XLA path: gmin/gmax to f32
    image precision, branch f to the FD-J noise floor over the bulk."""
    m, x, _, _, _, _ = setup
    d = ThinDisc(0.0, jnp.inf)
    radii = jnp.asarray([4.0, 8.0, 15.0], DT)
    kw = dict(N=20, N_extrema=8, Ng=32)
    tf_x = cunningham_transfer_function(m, x, d, radii, **kw)
    tf_p = cunningham_transfer_function(
        m, x, d, radii, backend="pallas", pallas_opts={"interpret": True}, **kw
    )
    np.testing.assert_allclose(
        np.asarray(tf_p.gmin), np.asarray(tf_x.gmin), rtol=2e-4
    )
    np.testing.assert_allclose(
        np.asarray(tf_p.gmax), np.asarray(tf_x.gmax), rtol=2e-4
    )
    # compare branch f away from the extremal endpoints where both paths are
    # noise-dominated (the asymmetric near-extremal gate is applied to both)
    interior = (np.asarray(tf_x.gstar) > 0.1) & (np.asarray(tf_x.gstar) < 0.9)
    for branch in ("lower_f", "upper_f"):
        fx = np.asarray(getattr(tf_x, branch))[:, interior]
        fp = np.asarray(getattr(tf_p, branch))[:, interior]
        rel = np.abs(fp - fx) / np.maximum(np.abs(fx), 1e-12)
        assert np.median(rel) < 5e-3, (branch, np.median(rel))
        assert np.percentile(rel, 90) < 3e-2, (branch, np.percentile(rel, 90))


def test_thick_disc_raises(setup):
    """backend='pallas' is documented thin-disc-only; thick discs must raise
    loudly, not silently fall back."""
    from gradus_tpu.geometry import ShakuraSunyaev

    m, x, _, _, _, _ = setup
    d = ShakuraSunyaev.from_metric(m)
    with pytest.raises(NotImplementedError):
        cunningham_transfer_function(
            m, x, d, jnp.asarray([5.0], DT), N=4, N_extrema=2, backend="pallas"
        )


def test_solver_cache_keys_dtype():
    """ADVICE r4: the solver cache must not hand an f32-configured solver to
    an f64 caller (or a compiled solver to an interpret caller)."""
    m = KerrMetric(M=1.0, a=0.9)
    x = np.asarray([0.0, 1000.0, np.deg2rad(40.0), 0.0])
    d = DatumPlane(jnp.asarray(0.0, DT))
    s32 = get_pallas_ctf_solver(m, x, d, interpret=True, dtype=jnp.float32)
    s64 = get_pallas_ctf_solver(m, x, d, interpret=True, dtype=jnp.float64)
    assert s32 is not s64
    assert s32 is get_pallas_ctf_solver(m, x, d, interpret=True, dtype=jnp.float32)

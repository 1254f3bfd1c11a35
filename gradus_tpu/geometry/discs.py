"""Accretion-disc geometry: signed distance functions consumed by the
integrator's event layer.

Reference semantics (`src/geometry/discs.jl`, `src/geometry/discs/*.jl`):
`distance_to_disc(d, x4; gtol)` is positive away from the disc, ≤ 0 on/inside
it; the heuristic surface thickening is ``gtol·|r|``
(`_gtol_error`, discs.jl:1-7). Out-of-annulus queries return 1.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from gradus_tpu.utils.linalg import equatorial_project, spinaxis_project

__all__ = [
    "AbstractAccretionGeometry",
    "ThinDisc",
    "WarpedThinDisc",
    "DatumPlane",
    "ThickDisc",
    "ShakuraSunyaev",
    "EllipticalDisc",
    "PrecessingDisc",
    "PolishDoughnut",
    "PolishDoughnutFW",
    "polish_doughnut_fw",
    "CompositeGeometry",
    "datumplane",
]


def _geometry_dataclass(cls=None, *, meta=()):
    def wrap(c):
        c = dataclasses.dataclass(frozen=True)(c)
        fields = [f.name for f in dataclasses.fields(c)]
        data = [f for f in fields if f not in meta]
        jax.tree_util.register_dataclass(c, data_fields=data, meta_fields=list(meta))
        return c

    return wrap(cls) if cls is not None else wrap


class AbstractAccretionGeometry:
    optically_thin = True

    def distance_to_disc(self, x4, gtol=1e-2):  # pragma: no cover - interface
        raise NotImplementedError

    def crossing_indicator(self, x4):
        """Smooth signed function whose zero crossings include every possible
        surface hit. Defaults to the distance function (right for volume
        discs); plane-like discs override with the *signed* height so that
        arbitrarily large integrator steps still see a sign change — the
        robust replacement for the reference's interp-sampled unsigned
        distance (ContinuousCallback interp_points=8)."""
        return self.distance_to_disc(x4, gtol=0.0)

    def is_hit(self, x4, gtol=1e-2):
        """Whether a located zero crossing is a real surface hit (e.g. within
        the annulus). Defaults to true."""
        return jnp.ones(x4.shape[:-1], dtype=bool)

    # --- component-form event interface (Pallas integrator) --------------
    # Inside the Pallas kernel the state is component-major (one vector per
    # component). Defaults stack a (..., 4) position and call the array
    # form; hot geometries override scalar-wise.
    def crossing_indicator_c(self, t, r, th, ph):
        return self.crossing_indicator(jnp.stack([t, r, th, ph], axis=-1))

    def is_hit_c(self, t, r, th, ph, gtol=1e-2):
        return self.is_hit(jnp.stack([t, r, th, ph], axis=-1), gtol=gtol)

    # --- radiative transfer coefficients (reference
    # `absorption_coefficient`/`emissivity_coefficient`,
    # radiative-transfer-problem.jl:25-27; default zero) -----------------
    def absorption_coefficient(self, x4, nu):
        return jnp.zeros(x4.shape[:-1], dtype=x4.dtype)

    def emission_coefficient(self, x4, nu):
        return jnp.zeros(x4.shape[:-1], dtype=x4.dtype)

    def inner_radius(self):
        return self.inner_r

    def outer_radius(self):
        return self.outer_r


def _gtol_error(gtol, x4):
    return gtol * jnp.abs(x4[..., 1])


@_geometry_dataclass
class ThinDisc(AbstractAccretionGeometry):
    """Geometrically-thin equatorial annulus (reference
    `src/geometry/discs/thin-disc.jl:9-29`)."""

    inner_r: float = 0.0
    outer_r: float = 500.0

    def distance_to_disc(self, x4, gtol=1e-2):
        rho = equatorial_project(x4)
        inside = (rho >= self.inner_r) & (rho <= self.outer_r)
        d = spinaxis_project(x4) - _gtol_error(gtol, x4)
        return jnp.where(inside, d, 1.0)

    def crossing_indicator(self, x4):
        return spinaxis_project(x4, signed=True)

    def is_hit(self, x4, gtol=1e-2):
        rho = equatorial_project(x4)
        return (rho >= self.inner_r) & (rho <= self.outer_r)

    def crossing_indicator_c(self, t, r, th, ph):
        return r * jnp.cos(th)

    def is_hit_c(self, t, r, th, ph, gtol=1e-2):
        rho = r * jnp.abs(jnp.sin(th))
        return (rho >= self.inner_r) & (rho <= self.outer_r)


@_geometry_dataclass(meta=("f",))
class WarpedThinDisc(AbstractAccretionGeometry):
    """Thin disc with scale height z = f(ρ) (signed)
    (reference thin-disc.jl:31-65)."""

    f: Callable
    inner_r: float = 0.0
    outer_r: float = 500.0

    def distance_to_disc(self, x4, gtol=1e-2):
        rho = equatorial_project(x4)
        inside = (rho >= self.inner_r) & (rho <= self.outer_r)
        h = self.f(rho)
        z = spinaxis_project(x4, signed=True)
        return jnp.where(inside, jnp.abs(h - z) - _gtol_error(gtol, x4), 1.0)

    def crossing_indicator(self, x4):
        rho = equatorial_project(x4)
        return spinaxis_project(x4, signed=True) - self.f(rho)

    def is_hit(self, x4, gtol=1e-2):
        rho = equatorial_project(x4)
        return (rho >= self.inner_r) & (rho <= self.outer_r)


@_geometry_dataclass
class DatumPlane(AbstractAccretionGeometry):
    """Plane at constant height; no underside, no gtol widening
    (reference `src/geometry/discs/datum-plane.jl`)."""

    height: float = 0.0

    def inner_radius(self):
        return 0.0

    def distance_to_disc(self, x4, gtol=1e-2):
        return spinaxis_project(x4, signed=True) - self.height

    def crossing_indicator(self, x4):
        return spinaxis_project(x4, signed=True) - self.height

    # column forms for the Pallas kernel (scalar height only)
    def crossing_indicator_c(self, t, r, th, ph):
        return r * jnp.cos(th) - self.height

    def is_hit_c(self, t, r, th, ph, gtol=1e-2):
        return jnp.ones_like(r, dtype=bool)


class AbstractThickAccretionDisc(AbstractAccretionGeometry):
    """Discs defined by a height cross-section h(ρ) ≤ 0 where undefined
    (reference `src/geometry/discs/thick-disc.jl:55-62`). Optically thick by
    default (only Thin/Warped/Datum are marked thin in the reference)."""

    optically_thin = False

    def cross_section(self, rho):  # pragma: no cover - interface
        raise NotImplementedError

    def distance_to_disc(self, x4, gtol=1e-2):
        h = self.cross_section(equatorial_project(x4))
        d = spinaxis_project(x4) - h
        return jnp.where(h <= 0.0, 1.0, d)

    def crossing_indicator(self, x4):
        # |z| − h has a genuine sign change when entering the disc volume;
        # outside the defined region fall back to |z| − 0 clamped positive
        h = self.cross_section(equatorial_project(x4))
        return spinaxis_project(x4) - jnp.maximum(h, 0.0)

    def is_hit(self, x4, gtol=1e-2):
        return self.cross_section(equatorial_project(x4)) > 0.0

    def xz_parameterize(self, rho):
        """(ρ, h(ρ)) surface curve in the poloidal plane (reference
        `xz_parameterize`, thick-disc.jl:54)."""
        return jnp.stack(
            jnp.broadcast_arrays(rho, self.cross_section(rho)), axis=-1
        )

    def cartesian_tangent_vector(self, rho):
        """Unit tangent of the surface in cartesian (x, y, z) at azimuth 0,
        via forward-mode AD of the cross-section (reference
        `_cartesian_tangent_vector`, thick-disc.jl:64-71)."""
        rho = jnp.asarray(rho, jnp.result_type(rho, float))
        _, grad = jax.jvp(self.xz_parameterize, (rho,), (jnp.ones_like(rho),))
        v = jnp.stack(
            [grad[..., 0], jnp.zeros_like(rho), grad[..., 1]], axis=-1
        )
        return v / jnp.linalg.norm(v, axis=-1, keepdims=True)

    def cartesian_surface_normal(self, rho, phi=None):
        """Outward unit surface normal: the tangent rotated 90° about φ̂,
        optionally rotated to azimuth φ about the spin axis (reference
        `_cartesian_surface_normal`, thick-disc.jl:73-82)."""
        t = self.cartesian_tangent_vector(rho)
        n = jnp.stack([-t[..., 2], t[..., 1], t[..., 0]], axis=-1)
        if phi is None:
            return n
        phi = jnp.asarray(phi)
        c, s = jnp.cos(phi), jnp.sin(phi)
        return jnp.stack(
            [
                c * n[..., 0] - s * n[..., 1],
                s * n[..., 0] + c * n[..., 1],
                n[..., 2],
            ],
            axis=-1,
        )


@_geometry_dataclass(meta=("f",))
class ThickDisc(AbstractThickAccretionDisc):
    """Custom cross-section disc (reference thick-disc.jl:1-53)."""

    f: Callable
    inner_r: float = 0.0
    outer_r: float = jnp.inf

    def cross_section(self, rho):
        return self.f(rho)


@_geometry_dataclass
class ShakuraSunyaev(AbstractThickAccretionDisc):
    """Shakura & Sunyaev (1973) α-disc: H = 3/(2η)·(Ṁ/Ṁ_Edd)(1 − √(r_isco/ρ)),
    total thickness 2H (reference `src/geometry/discs/shakura-sunyaev.jl`).

    Construct via `ShakuraSunyaev.from_metric(m, eddington_ratio=0.3)` — the
    radiative efficiency defaults to 1 − E_isco.
    """

    mdot_over_edd: float = 0.3
    inv_eta: float = 1.0 / 0.057
    inner_r: float = 6.0

    @staticmethod
    def from_metric(m, eddington_ratio=0.3, eta=None, contra_rotating=False):
        from gradus_tpu.orbits import CircularOrbits
        from gradus_tpu.orbits.special_radii import isco as _isco

        r_isco = _isco(m)
        if eta is None:
            E = CircularOrbits.energy(
                m, r_isco, contra_rotating=contra_rotating
            )
            eta = 1.0 - E
        return ShakuraSunyaev(
            mdot_over_edd=eddington_ratio, inv_eta=1.0 / eta, inner_r=r_isco
        )

    def cross_section(self, rho):
        h = 3.0 * self.inv_eta * self.mdot_over_edd * (
            1.0 - jnp.sqrt(self.inner_r / jnp.maximum(rho, 1e-12))
        )
        return jnp.where(rho < self.inner_r, -0.0, h)


@_geometry_dataclass
class EllipticalDisc(AbstractAccretionGeometry):
    """Ellipse cross-section disc (reference discs.jl:57-72)."""

    inner_r: float
    semi_major: float
    semi_minor: float

    def distance_to_disc(self, x4, gtol=1e-2):
        r = x4[..., 1]
        inside = (r >= self.inner_r) & (r <= self.semi_major)
        arg = jnp.clip(1.0 - (r / self.semi_major) ** 2, 0.0, None)
        y = jnp.sqrt(arg * self.semi_minor**2)
        h = jnp.abs(r * jnp.cos(x4[..., 2]))
        return jnp.where(inside, h - y - _gtol_error(gtol, x4), 1.0)

    def crossing_indicator(self, x4):
        r = x4[..., 1]
        arg = jnp.clip(1.0 - (r / self.semi_major) ** 2, 0.0, None)
        y = jnp.sqrt(arg * self.semi_minor**2)
        return jnp.abs(r * jnp.cos(x4[..., 2])) - y

    def is_hit(self, x4, gtol=1e-2):
        r = x4[..., 1]
        return (r >= self.inner_r) & (r <= self.semi_major)


@_geometry_dataclass(meta=("disc",))
class PrecessingDisc(AbstractAccretionGeometry):
    """Wrapper rotating a disc by Euler angles (β about x after γ about z)
    (reference discs.jl:74-96)."""

    disc: Any
    beta: float = 0.0
    gamma: float = 0.0

    def inner_radius(self):
        return self.disc.inner_radius()

    def distance_to_disc(self, x4, gtol=1e-2):
        b = -self.beta
        theta = x4[..., 2]
        phi = x4[..., 3] - self.gamma
        # cartesian direction in the rotated frame (Rx(-β))
        p = jnp.stack(
            [
                jnp.sin(theta) * jnp.sin(phi),
                jnp.sin(theta) * jnp.cos(phi),
                jnp.cos(theta),
            ],
            axis=-1,
        )
        x_ = p[..., 0]
        y_ = jnp.cos(b) * p[..., 1] + jnp.sin(b) * p[..., 2]
        z_ = -jnp.sin(b) * p[..., 1] + jnp.cos(b) * p[..., 2]
        theta_p = jnp.arctan2(jnp.sqrt(x_**2 + y_**2), z_)
        phi_p = jnp.arctan2(y_, x_)
        x4p = jnp.stack([x4[..., 0], x4[..., 1], theta_p, phi_p], axis=-1)
        return self.disc.distance_to_disc(x4p, gtol=gtol)

    def _rotated(self, x4):
        b = -self.beta
        theta = x4[..., 2]
        phi = x4[..., 3] - self.gamma
        p = jnp.stack(
            [
                jnp.sin(theta) * jnp.sin(phi),
                jnp.sin(theta) * jnp.cos(phi),
                jnp.cos(theta),
            ],
            axis=-1,
        )
        x_ = p[..., 0]
        y_ = jnp.cos(b) * p[..., 1] + jnp.sin(b) * p[..., 2]
        z_ = -jnp.sin(b) * p[..., 1] + jnp.cos(b) * p[..., 2]
        theta_p = jnp.arctan2(jnp.sqrt(x_**2 + y_**2), z_)
        phi_p = jnp.arctan2(y_, x_)
        return jnp.stack([x4[..., 0], x4[..., 1], theta_p, phi_p], axis=-1)

    def crossing_indicator(self, x4):
        return self.disc.crossing_indicator(self._rotated(x4))

    def is_hit(self, x4, gtol=1e-2):
        return self.disc.is_hit(self._rotated(x4), gtol=gtol)


@_geometry_dataclass
class PolishDoughnut(AbstractThickAccretionDisc):
    """Rotationally-supported torus with constant specific angular momentum λ
    (Abramowicz-style polish doughnut; reference
    `src/geometry/discs/polish-doughnut.jl` solves the isobar surface by ODE —
    here the Schwarzschild-potential closed form is used with the same
    parameterisation: potential W(r, z) = ½ ln( -u_t² ) for given ℓ).

    The cross-section h(ρ) is found by a fixed-iteration bisection on the
    equipotential W(ρ, z) = W_surface.
    """

    M: float = 1.0
    ell: float = 8.0  # specific angular momentum ℓ = L/E
    r_cusp: float = 10.0  # inner edge (potential reference)
    inner_r: float = 0.0
    outer_r: float = jnp.inf
    z_max: float = 50.0
    metric: Any = None  # metric-generic isobars when set

    def _potential(self, rho, z):
        """Constant-ℓ torus potential W = ½ ln(u_t²) with
        u_t² = (g_tφ² − g_tt g_φφ)/(g_φφ + 2ℓ g_tφ + ℓ² g_tt)
        (Abramowicz-Jaroszyński-Sikora). With `metric` set this uses the
        actual metric components, generalizing the reference's isobar surface
        to any static axisymmetric spacetime (the reference's ODE isobars,
        polish-doughnut.jl:1-124, are specialized to Kerr via the Younsi
        Ψ₁/Ψ₂ differentials); with metric=None the Schwarzschild closed form
        is used (identical to the generic path for KerrMetric a=0)."""
        R = jnp.sqrt(rho * rho + z * z)
        if self.metric is not None:
            R_c = jnp.maximum(R, 1e-6)
            theta = jnp.arctan2(rho, z)
            g = self.metric.components(R_c, theta)
            gtt, gpp, gtp = g[..., 0], g[..., 3], g[..., 4]
            denom = gpp + 2.0 * self.ell * gtp + self.ell**2 * gtt
            ut2 = (gtp * gtp - gtt * gpp) / jnp.where(
                jnp.abs(denom) < 1e-12, 1e-12, denom
            )
            bound = denom > 0
            return jnp.where(
                bound, 0.5 * jnp.log(jnp.maximum(ut2, 1e-12)), jnp.inf
            )
        sin2 = jnp.where(R > 0, (rho / jnp.maximum(R, 1e-12)) ** 2, 1.0)
        f = 1.0 - 2.0 * self.M / jnp.maximum(R, 2.2 * self.M)
        denom = R * R * sin2 - self.ell**2 * f
        denom = jnp.maximum(denom, 1e-12)
        ut2 = R * R * sin2 * f / denom
        return 0.5 * jnp.log(jnp.maximum(ut2, 1e-12))

    def cross_section(self, rho):
        W_s = self._potential(jnp.asarray(self.r_cusp), jnp.asarray(0.0))
        in_disc = self._potential(rho, jnp.zeros_like(rho)) < W_s

        def body(_, ab):
            a, b = ab
            mid = 0.5 * (a + b)
            below = self._potential(rho, mid) < W_s
            return jnp.where(below, mid, a), jnp.where(below, b, mid)

        a0 = jnp.zeros_like(rho)
        b0 = jnp.full_like(rho, self.z_max)
        a, b = jax.lax.fori_loop(0, 40, body, (a0, b0))
        h = 0.5 * (a + b)
        return jnp.where(in_disc, h, -1.0)


@_geometry_dataclass(meta=("geometries",))
class CompositeGeometry(AbstractAccretionGeometry):
    """Tuple of geometries; distance = elementwise minimum
    (reference `src/geometry/composite.jl`)."""

    geometries: tuple

    def inner_radius(self):
        return min(float(g.inner_radius()) for g in self.geometries)

    def distance_to_disc(self, x4, gtol=1e-2):
        ds = [g.distance_to_disc(x4, gtol=gtol) for g in self.geometries]
        return jnp.min(jnp.stack(ds, axis=0), axis=0)

    def crossing_indicator(self, x4):
        # product of signs trick does not compose; use the min-|value| signed
        # indicator: the component closest to crossing dominates
        inds = jnp.stack(
            [g.crossing_indicator(x4) for g in self.geometries], axis=0
        )
        idx = jnp.argmin(jnp.abs(inds), axis=0)
        return jnp.take_along_axis(inds, idx[None], axis=0)[0]

    def is_hit(self, x4, gtol=1e-2):
        hits = jnp.stack(
            [
                g.is_hit(x4, gtol=gtol) & (jnp.abs(g.crossing_indicator(x4)) < 1e-6)
                for g in self.geometries
            ],
            axis=0,
        )
        return jnp.any(hits, axis=0)


def datumplane(disc: AbstractThickAccretionDisc, rho):
    """Datum plane at the disc's cross-section height at ρ
    (reference datum-plane.jl:14-18)."""
    return DatumPlane(height=disc.cross_section(jnp.asarray(rho)))


@_geometry_dataclass
class PolishDoughnutFW(AbstractThickAccretionDisc):
    """Fuerst & Wu (2004, 2007) / Younsi et al. (2012) torus — the REFERENCE
    parameterization (rₖ, n) of `src/geometry/discs/polish-doughnut.jl:1-124`,
    alongside the constant-ℓ `PolishDoughnut` family above.

    The angular-velocity ansatz Ω(ρ) = Ω_circ(ρ)·(rₖ/ρ)ⁿ defines isobar
    surfaces solved as an ODE in the poloidal plane (Younsi eqs. 30-31); the
    innermost radius is the dE/dr = 0 marginal-stability point of the
    modified orbits. Construct with `polish_doughnut_fw(m, r_k, n)`; the
    precomputed isobar (r, z) curve is carried as pytree leaves and the
    cross-section is its NaN-free linear interpolant."""

    rs: Any = None  # (K,) isobar radii, sorted ascending
    zs: Any = None  # (K,) isobar heights
    r_k: float = 12.0
    n: float = 0.21

    def cross_section(self, rho):
        h = jnp.interp(rho, self.rs, self.zs)
        inside = (rho >= self.rs[0]) & (rho <= self.rs[-1])
        return jnp.where(inside, h, 0.0)

    def inner_radius(self):
        return self.rs[0]

    def outer_radius(self):
        return self.rs[-1]


def polish_doughnut_fw(
    m,
    r_k: float = 12.0,
    n: float = 0.21,
    *,
    init_r: float = 5.0,
    lam_max: float = 40.0,
    dt: float = 5e-2,
    newton_iters: int = 40,
) -> PolishDoughnutFW:
    """Construct the Fuerst-Wu (rₖ, n) doughnut for a Kerr metric (reference
    `PolishDoughnut` constructor + `__PolishDoughnut` module,
    polish-doughnut.jl:1-124): innermost radius via Newton on dE/dr = 0, then
    the isobar curve by a fixed-step RK4 `lax.scan` of the Younsi (2012)
    eq. 30-31 differential, terminated (masked) where z < 0."""
    from gradus_tpu.orbits import CircularOrbits

    if not hasattr(m, "a"):
        raise ValueError(
            "the Fuerst-Wu isobar differential is Kerr-specific "
            "(reference isobar_differential, polish-doughnut.jl:39-51)"
        )

    def Omega(rho):
        return CircularOrbits.Omega(m, (rho, jnp.pi / 2)) * (r_k / rho) ** n

    def orbital_energy(r):
        # reference `orbital_energy` (polish-doughnut.jl:21-28)
        Om = Omega(r)
        g = m.components(r, jnp.pi / 2)
        return -(g[..., 0] + g[..., 4] * Om) / jnp.sqrt(
            -g[..., 0] - 2 * g[..., 4] * Om - g[..., 3] * Om**2
        )

    dE = jax.grad(orbital_energy)
    d2E = jax.grad(dE)

    r_in = jnp.asarray(float(init_r))
    for _ in range(newton_iters):
        r_in = r_in - dE(r_in) / d2E(r_in)
    r_in = float(r_in)

    M, a = m.M, m.a

    def isobar_rhs(u):
        # Younsi et al. (2012) eqs. 30-31 (reference Ψ₁/Ψ₂ + differential)
        r, th = u[0], u[1]
        sigma = r * r + a * a * jnp.cos(th) ** 2
        delta = r * r + a * a - 2.0 * M * r
        rho = r * jnp.sin(th)
        inv_om = 1.0 / Omega(rho)
        psi1 = (
            M * ((sigma - 2 * r * r) / sigma**2) * (inv_om - a * jnp.sin(th)) ** 2
            + r * jnp.sin(th) ** 2
        )
        psi2 = jnp.sin(2 * th) * (
            (M * r / sigma**2) * (a * inv_om - (r * r + a * a)) ** 2 + delta / 2
        )
        d = 1.0 / (jnp.sqrt(delta * psi1**2 + psi2**2) * jnp.sqrt(sigma / delta))
        return jnp.stack([psi2 * d, -psi1 * d])

    n_steps = int(lam_max / dt)

    def rk4(u, _):
        k1 = isobar_rhs(u)
        k2 = isobar_rhs(u + 0.5 * dt * k1)
        k3 = isobar_rhs(u + 0.5 * dt * k2)
        k4 = isobar_rhs(u + dt * (k3))
        u_new = u + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        return u_new, u_new

    u0 = jnp.asarray([r_in, jnp.pi / 2])
    _, us = jax.lax.scan(rk4, u0, None, length=n_steps)
    us = jnp.concatenate([u0[None], us], axis=0)
    r = np.asarray(us[:, 0])
    z = np.asarray(np.cos(us[:, 1]) * r)
    # keep the upper branch up to the first z < 0 crossing (reference
    # DiscreteCallback termination)
    neg = np.nonzero(z < 0)[0]
    stop = neg[0] if neg.size else z.shape[0]
    r, z = r[:stop], z[:stop]
    # z(r) must be single-valued for the interpolant: truncate at the first
    # radial turning point past the apex (an overhanging torus cross-section
    # would otherwise interleave branches when sorted)
    if r.size > 2:
        apex = int(np.argmax(z))
        turn = np.nonzero(np.diff(r[apex:]) < 0)[0]
        if turn.size:
            import warnings

            warnings.warn(
                "polish_doughnut_fw: overhanging (double-valued) isobar "
                "cross-section; truncating at the radial turning point",
                stacklevel=2,
            )
            r = r[: apex + turn[0] + 1]
            z = z[: apex + turn[0] + 1]
    order = np.argsort(r)
    r, z = r[order], z[order]
    # deduplicate for a strictly increasing interpolation grid
    keep = np.concatenate([[True], np.diff(r) > 1e-12])
    return PolishDoughnutFW(
        rs=jnp.asarray(r[keep]), zs=jnp.asarray(z[keep]), r_k=r_k, n=n
    )

"""shard_map'd tracing, rendering, and product pipelines over a device mesh.

Rays never interact, so the trace shards trivially: each device integrates its
pixel tile to completion (the masked while_loop runs device-locally, no halo
exchange — each device's loop also exits as soon as *its* rays finish, so the
lockstep tail is per-shard, not global). Collectives appear only at reduction
points, exactly as the reference's thread ensembles reduce into shared arrays
(swap point `ext/GradusDiffEqGPUExt/GradusDiffEqGPUExt.jl:10-31`):

- `sharded_trace` / `sharded_render`  — pure gather (out_specs sharded);
- `sharded_lineprofile`               — `psum` of the g-binned flux histogram;
- `sharded_emissivity`                — `pmin`/`pmax` bin-range agreement +
                                        `psum` of (count, g, t) bin sums.

Between GPUs XLA runs the collectives through NCCL.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from gradus_tpu.integrate.tracing import trace_geodesics, domain_upper_hemisphere
from gradus_tpu.parallel.mesh import ray_mesh

__all__ = [
    "sharded_trace",
    "sharded_render",
    "sharded_lineprofile",
    "sharded_emissivity",
    "sharded_pallas_trace",
    "pad_to_multiple",
]


def pad_to_multiple(arr, k, axis=0):
    """Pad axis length up to a multiple of k (repeating the last element so
    padded rays integrate something harmless)."""
    n = arr.shape[axis]
    rem = (-n) % k
    if rem == 0:
        return arr, n
    pad = jnp.repeat(jnp.take(arr, jnp.array([n - 1]), axis=axis), rem, axis=axis)
    return jnp.concatenate([arr, pad], axis=axis), n


def sharded_trace(m, x, v, lam_span, mesh=None, **trace_kwargs):
    """Batched trace with the ray axis sharded over the mesh. Returns the
    GeodesicPoint batch (sharded along rays)."""
    if mesh is None:
        mesh = ray_mesh()
    ndev = mesh.devices.size
    x = jnp.atleast_2d(jnp.asarray(x))
    v = jnp.atleast_2d(jnp.asarray(v))
    x, v = jnp.broadcast_arrays(x, v)
    xp, n = pad_to_multiple(x, ndev)
    vp, _ = pad_to_multiple(v, ndev)

    def local_trace(x_loc, v_loc):
        return trace_geodesics(m, x_loc, v_loc, lam_span, **trace_kwargs)

    traced = jax.shard_map(
        local_trace,
        mesh=mesh,
        in_specs=(P("rays"), P("rays")),
        out_specs=P("rays"),
    )(xp, vp)
    return jax.tree_util.tree_map(lambda a: a[:n], traced)


def sharded_pallas_trace(tracer, y0, lam_span, mesh=None):
    """The Pallas integrator kernel under the device mesh.

    Each device runs the kernel on its ray shard — the kernel is already
    block-local, so sharding composes trivially: `shard_map` splits the ray
    axis, `pallas_call` blocks within the shard, and no collective is needed
    until a downstream reduction. Returns the GeodesicPoint batch
    (ray-sharded). Reference swap point:
    `ext/GradusDiffEqGPUExt/GradusDiffEqGPUExt.jl:10-31`.

    ``tracer``: a `PallasTracer` (interpret mode runs the same program on the
    CPU test mesh).
    """
    if mesh is None:
        mesh = ray_mesh()
    ndev = mesh.devices.size
    y0 = jnp.asarray(y0)
    y0p, n = pad_to_multiple(y0, ndev)

    def local(y0_loc):
        gp, _aux = tracer.trace(y0_loc, lam_span)
        return gp

    gp = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P("rays"),),
        out_specs=P("rays"),
        # pallas_call outputs carry no varying-mesh-axes metadata; the kernel
        # is purely shard-local so the vma check adds nothing here
        check_vma=False,
    )(y0p)
    return jax.tree_util.tree_map(lambda a: a[:n], gp)


def sharded_render(
    m,
    position,
    geometry=None,
    lam_max: float = 2000.0,
    *,
    image_width: int = 1024,
    image_height: int = 1024,
    alpha_lims=(-60.0, 60.0),
    beta_lims=(-40.0, 40.0),
    pf=None,
    mesh=None,
    **trace_kwargs,
):
    """Distributed `rendergeodesics`: pixel tiles sharded across the mesh."""
    from gradus_tpu.camera.render import _pixel_velocities, EndpointRenderCache, apply
    from gradus_tpu.camera.pointfns import ConstPointFunctions

    if mesh is None:
        mesh = ray_mesh()
    x = jnp.asarray(position)
    alphas, betas, v = _pixel_velocities(
        m, x, image_width, image_height, alpha_lims, beta_lims
    )
    xs = jnp.broadcast_to(x, v.shape)
    gps = sharded_trace(
        m, xs, v, (0.0, lam_max), mesh=mesh, geometry=geometry, **trace_kwargs
    )
    cache = EndpointRenderCache(
        m=m,
        max_time=jnp.asarray(lam_max, x.dtype),
        height=image_height,
        width=image_width,
        points=gps,
    )
    if pf is None:
        pf = ConstPointFunctions.shadow()
    return alphas, betas, apply(pf, cache)


def sharded_lineprofile(
    m,
    x,
    d,
    *,
    bins=None,
    emissivity=None,
    profile=None,
    min_re=None,
    max_re: float = 50.0,
    lam_max=None,
    plane=None,
    mesh=None,
    **trace_kwargs,
):
    """Distributed BinningMethod line profile (reference
    line-profiles.jl:157-198 over `EnsembleEndpointThreads`): the polar-plane
    ray batch shards over the mesh; each device traces its rays and bins its
    local flux histogram, which is `psum`-reduced over the mesh so every device
    holds the identical normalized profile. Returns (bins, flux)."""
    from gradus_tpu.camera.grids import GeometricGrid
    from gradus_tpu.camera.planes import PolarPlane
    from gradus_tpu.camera.impact import map_impact_parameters
    from gradus_tpu.lineprofile import binned_flux, _default_emissivity
    from gradus_tpu.orbits.special_radii import isco as _isco
    from gradus_tpu.redshift import redshift_pointfunction

    if mesh is None:
        mesh = ray_mesh()
    ndev = mesh.devices.size

    x = jnp.asarray(x)
    if bins is None:
        bins = jnp.linspace(0.1, 1.5, 180, dtype=x.dtype)
    else:
        bins = jnp.asarray(bins, x.dtype)
    if emissivity is None:
        emissivity = (
            (lambda r: profile.emissivity_at(r))
            if profile is not None
            else _default_emissivity
        )
    if min_re is None:
        min_re = _isco(m)
    if lam_max is None:
        lam_max = 2.0 * float(x[1])
    if plane is None:
        plane = PolarPlane(GeometricGrid(), Nr=450, Ntheta=1300, r_max=5 * max_re)
    redshift_pf = redshift_pointfunction(m, x)

    alpha, beta = plane.impact_parameters()
    areas = plane.unnormalized_areas()
    v = map_impact_parameters(m, x, alpha, beta)
    xs = jnp.broadcast_to(x, v.shape)
    xp, _ = pad_to_multiple(xs, ndev)
    vp, _ = pad_to_multiple(v, ndev)
    # padded rays carry zero area → zero flux contribution
    areas_p, _ = pad_to_multiple(areas, ndev)
    n = areas.shape[0]
    areas_p = jnp.where(jnp.arange(areas_p.shape[0]) < n, areas_p, 0.0)

    def local(x_loc, v_loc, areas_loc):
        gps = trace_geodesics(
            m,
            x_loc,
            v_loc,
            (0.0, lam_max),
            geometry=d,
            terminate_fns=(domain_upper_hemisphere(),),
            **trace_kwargs,
        )
        return binned_flux(
            m,
            gps,
            areas_loc,
            emissivity,
            bins,
            min_re=min_re,
            max_re=max_re,
            lam_max=lam_max,
            redshift_pf=redshift_pf,
            axis_name="rays",
        )

    flux = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P("rays"), P("rays"), P("rays")),
        out_specs=P(),
    )(xp, vp, areas_p)
    return bins, flux


def sharded_emissivity(
    m,
    d,
    model,
    spectrum=None,
    *,
    sampler=None,
    n_samples: int = 1024,
    lam_max: float = 10000.0,
    n_bins: int = 100,
    mesh=None,
):
    """Distributed Monte-Carlo emissivity profile (reference `tracecorona` +
    `RadialDiscProfile` binning): the sky-sample axis shards over the mesh;
    the radial bin range is agreed with `pmin`/`pmax` and the photon-count /
    redshift / time bin sums are `psum`-reduced, so every device holds the
    identical `RadialDiscProfile`."""
    from gradus_tpu.corona.emissivity import bin_corona_hits
    from gradus_tpu.corona.samplers import (
        EvenSampler,
        BothHemispheres,
        sky_angles_to_velocity,
    )
    from gradus_tpu.corona.spectra import PowerLawSpectrum
    from gradus_tpu.integrate.status import StatusCodes

    if mesh is None:
        mesh = ray_mesh()
    ndev = mesh.devices.size
    if spectrum is None:
        spectrum = PowerLawSpectrum(2.0)
    if sampler is None:
        sampler = EvenSampler(domain=BothHemispheres())

    x, v_src = model.sample_position_velocity(m)
    idx = jnp.arange(1, n_samples + 1, dtype=x.dtype)
    elev, az = sampler.sample_angles(idx, n_samples)
    v = sky_angles_to_velocity(m, x, v_src, elev, az)
    xs = jnp.broadcast_to(x, v.shape)
    xp, _ = pad_to_multiple(xs, ndev)
    vp, _ = pad_to_multiple(v, ndev)
    n = v.shape[0]
    sample_mask = jnp.arange(xp.shape[0]) < n

    def local(x_loc, v_loc, mask_loc):
        gps = trace_geodesics(
            m,
            x_loc,
            v_loc,
            (0.0, lam_max),
            geometry=d,
            terminate_fns=(domain_upper_hemisphere(),),
            constrain=False,
        )
        hit = (gps.status == StatusCodes.IntersectedWithGeometry) & mask_loc
        return bin_corona_hits(
            m, spectrum, gps, v_src, hit, n_bins=n_bins, axis_name="rays"
        )

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P("rays"), P("rays"), P("rays")),
        out_specs=P(),
    )(xp, vp, sample_mask)

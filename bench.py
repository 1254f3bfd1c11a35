"""Benchmark: rays/s on a Kerr (a=0.998) thin-disc redshift render.

Prints ONE JSON line: {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...}.

Baseline anchor (BASELINE.md): the reference renders a 450×1300 = 585k-ray
thin-disc line profile in ~30 s on an 8-core M1 → ≈ 19.5k rays/s. vs_baseline
is our rays/s divided by that.

Backends (BENCH_BACKEND env):
- "pallas" (default): the register-resident Pallas kernel (Triton route) +
  pilot-predicted cost ordering (BENCH_ORDER=pilot|block), whole render
  (pilot → sort → trace → shade → unpermute) in ONE jitted program.
- "xla": the `lax.while_loop` + host-driven compaction path (`Tracer`).

Runs on a GPU only: it prints the device (platform, kind, count, and the
card's name and power limit from nvidia-smi) and exits non-zero elsewhere.
Timings end in `jax.block_until_ready`.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

BASELINE_RAYS_PER_S = 585_000 / 30.0  # reference anchor, M1 laptop

# Product anchor (BASELINE.md row 1 / getting-started.md:455): BinningMethod
# line profile over PolarPlane(GeometricGrid; Nr=1000, Nθ=1000, r_max=50),
# "~30 seconds on a 2021 M1 Mac laptop".
BASELINE_BINNING_S = 30.0


def bench_binning():
    """BinningMethod line profile end-to-end on the card.

    Reference config (docs getting-started.md §8): Kerr a=0.998, observer
    (0, 1000, 70°, 0), ThinDisc(isco, 200), PolarPlane(GeometricGrid(),
    Nr=1000, Nθ=1000, r_max=50), bins 0.1:1.4×200, λmax=2000, upper-hemisphere
    domain. Traced against ThinDisc(0, ∞) — every equatorial crossing
    terminates, which is exactly equivalent to disc + domain_upper_hemisphere
    for binned flux (out-of-annulus crossings are filtered by the r-range
    mask either way). Routed through the Pallas kernel with pilot-predicted
    cost ordering; pilot + sort + trace + bin run in ONE jitted program.
    """
    import jax
    import jax.numpy as jnp

    from gradus_tpu.metrics import KerrMetric
    from gradus_tpu.geometry import ThinDisc
    from gradus_tpu.camera.impact import map_impact_parameters
    from gradus_tpu.camera.planes import PolarPlane
    from gradus_tpu.camera.grids import GeometricGrid
    from gradus_tpu.integrate.pallas_solver import PallasTracer
    from gradus_tpu.lineprofile import binned_flux
    from gradus_tpu.redshift import redshift_pointfunction
    from gradus_tpu.orbits.special_radii import isco as _isco

    dtype = jnp.float32
    Nr = int(os.environ.get("BENCH_NR", "1000"))
    Nth = int(os.environ.get("BENCH_NTH", "1000"))
    lam_max = 2000.0
    m = KerrMetric(M=jnp.asarray(1.0, dtype), a=jnp.asarray(0.998, dtype))
    d_trace = ThinDisc(inner_r=0.0, outer_r=np.inf)
    x = jnp.asarray([0.0, 1000.0, np.deg2rad(70.0), 0.0], dtype)
    min_re = float(_isco(m))
    max_re = 200.0
    bins = jnp.linspace(0.1, 1.4, 200, dtype=dtype)

    plane = PolarPlane(GeometricGrid(), Nr=Nr, Ntheta=Nth, r_max=50.0)
    alpha, beta = plane.impact_parameters()
    alpha = jnp.asarray(alpha, dtype)
    beta = jnp.asarray(beta, dtype)
    areas = jnp.asarray(plane.unnormalized_areas(), dtype)
    n = alpha.shape[0]
    v = map_impact_parameters(m, x, alpha, beta)
    xs = jnp.broadcast_to(x, v.shape)

    pf = redshift_pointfunction(m, x)
    tracer = PallasTracer(
        m,
        geometry=d_trace,
        block_rays=int(os.environ.get("BENCH_BLOCK_RAYS", "128")),
        steps_per_check=int(os.environ.get("BENCH_SPC", "8")),
    )
    y0 = tracer._constrain(xs, v)

    # pilot: decimated polar plane (Nr/8 × Nθ/8 = 1.6% of rays)
    pilot_f = int(os.environ.get("BENCH_PILOT", "8"))
    plane_p = PolarPlane(GeometricGrid(), Nr=Nr // pilot_f, Ntheta=Nth // pilot_f, r_max=50.0)
    a_p, b_p = plane_p.impact_parameters()
    v_p = map_impact_parameters(m, x, jnp.asarray(a_p, dtype), jnp.asarray(b_p, dtype))
    y0_p = tracer._constrain(jnp.broadcast_to(x, v_p.shape), v_p)
    pilot = PallasTracer(m, geometry=d_trace, block_rays=tracer.block_rays)
    pr, pt = Nr // pilot_f, Nth // pilot_f

    @jax.jit
    def profile_program(y0, y0_p, areas):
        _, aux_p = pilot.trace(y0_p, (0.0, lam_max))
        s = aux_p["steps"].reshape(pr, pt).astype(jnp.float32)
        sp = jnp.pad(s, 1, mode="edge")
        pooled = jnp.max(
            jnp.stack(
                [sp[i : i + pr, j : j + pt] for i in range(3) for j in range(3)]
            ),
            axis=0,
        )
        pred = jnp.repeat(jnp.repeat(pooled, pilot_f, 0), pilot_f, 1).ravel()[:n]
        perm = jnp.argsort(-pred)
        gp, aux = tracer.trace(y0[perm], (0.0, lam_max))
        flux = binned_flux(
            m,
            gp,
            areas[perm],
            lambda r: r**-3.0,
            bins,
            min_re=min_re,
            max_re=max_re,
            lam_max=lam_max,
            redshift_pf=pf,
        )
        return flux, aux

    if os.environ.get("BENCH_BACKEND", "pallas") == "xla":
        # A/B: same product on the host-compaction XLA path (`Tracer`)
        from gradus_tpu.integrate import Tracer

        tracer_x = Tracer(m, geometry=d_trace, dtype=dtype)

        @jax.jit
        def bin_program(gp, areas):
            return binned_flux(
                m, gp, areas, lambda r: r**-3.0, bins,
                min_re=min_re, max_re=max_re, lam_max=lam_max, redshift_pf=pf,
            )

        def profile_program(y0, y0_p, areas):
            gp = tracer_x(xs, v, (0.0, lam_max))
            flux = bin_program(gp, areas)
            return flux, {"block_iters": jnp.zeros(()), "steps": jnp.zeros(())}

    reps = int(os.environ.get("BENCH_REPS", "10"))
    flux, aux = jax.block_until_ready(profile_program(y0, y0_p, areas))
    t0 = time.perf_counter()
    for _ in range(reps):
        flux, aux = jax.block_until_ready(profile_program(y0, y0_p, areas))
    dt = (time.perf_counter() - t0) / reps

    executed = int(np.asarray(jnp.sum(aux["block_iters"])))
    useful = int(np.asarray(jnp.sum(aux["steps"])))
    details = {
        "workload": "binning_lineprofile",
        "rays": n,
        "seconds_per_profile": dt,
        "rays_per_s": n / dt,
        "wasted_step_fraction": 1.0 - useful / max(executed, 1),
        "flux_nonzero_bins": int(np.asarray(jnp.sum(flux > 0))),
    }
    print(json.dumps({"bench_details": details}), file=sys.stderr)
    print(
        json.dumps(
            {
                "metric": "BinningMethod line profile, 1000x1000 polar plane, Kerr a=0.998",
                "value": dt,
                "unit": "s/profile",
                "vs_baseline": round(BASELINE_BINNING_S / dt, 1),
            }
        )
    )


def bench_ctf():
    """TransferFunctionMethod line profile end-to-end on the card: the
    reference's flagship product — 100-radius Cunningham
    transfer table (offset Newton solves wrapping full ODE traces, batched
    (rₑ, θ); golden-section extremal scan with warm-started g-only probes;
    one batched Jacobian launch) + Gauss-Legendre line integration.

    Reference cost center per SURVEY §3.3: ~10⁴ Newton-wrapped ODE solves per
    profile, threaded on CPU. No published reference wall time exists for
    this product; vs_baseline is our s/profile against the reference's ~30 s
    BinningMethod anchor (the two methods produce the same physical product —
    docs getting-started.md uses them interchangeably)."""
    import jax
    import jax.numpy as jnp

    import gradus_tpu as gt

    dtype = jnp.float32
    m = gt.KerrMetric(M=jnp.asarray(1.0, dtype), a=jnp.asarray(0.998, dtype))
    x = jnp.asarray([0.0, 1000.0, np.deg2rad(60.0), 0.0], dtype)
    d = gt.ThinDisc(0.0, jnp.inf)
    bins = jnp.linspace(0.1, 1.5, 180, dtype=dtype)
    num_re = int(os.environ.get("BENCH_NUM_RE", "100"))
    # BENCH_BACKEND=pallas routes the offset solves through the FD-Newton
    # Pallas kernel path (transfer/pallas_ctf.py); default "xla" is the jvp
    # path. Parity is asserted in tests/test_pallas_ctf.py.
    backend = os.environ.get("BENCH_BACKEND", "xla")
    ctf_backend = "pallas" if backend == "pallas" else "xla"

    extra = {}
    if os.environ.get("BENCH_FD_H_AB"):
        extra["pallas_opts"] = {"fd_h_ab": float(os.environ["BENCH_FD_H_AB"])}

    def profile():
        _, flux = gt.lineprofile(
            m, x, d, bins=bins, num_re=num_re, N=80, backend=ctf_backend, **extra
        )
        return flux

    flux = profile()  # compile + warm caches
    s = float(jnp.sum(flux))
    assert np.isfinite(s), "CTF profile produced non-finite flux"
    reps = int(os.environ.get("BENCH_REPS", "3"))
    t0 = time.perf_counter()
    for _ in range(reps):
        flux = jax.block_until_ready(profile())
    dt = (time.perf_counter() - t0) / reps
    # precision evidence carried by every run: first-moment checksum m1 = Σ(flux·g)/Σflux vs the recorded f64 CPU
    # value at the same config (tests/test_precision_parity.py measures the
    # full f32↔f64 bin-wise budget: median 3.1e-4, p90 7.8e-4)
    M1_F64_CPU = 0.9201437735481984  # num_re=100, N=80, 180 bins
    centers = np.linspace(0.1, 1.5, 180)
    fl = np.asarray(flux)
    m1 = float((fl * centers).sum() / fl.sum())
    m1_drift = abs(m1 / M1_F64_CPU - 1.0) if num_re == 100 else float("nan")
    details = {
        "workload": "ctf_lineprofile",
        "num_re": num_re,
        "backend": ctf_backend,
        "seconds_per_profile": dt,
        "flux_sum": s,
        "m1_checksum": m1,
        "m1_drift_vs_f64_cpu": m1_drift if m1_drift == m1_drift else None,
    }
    print(json.dumps({"bench_details": details}), file=sys.stderr)
    print(
        json.dumps(
            {
                "metric": "TransferFunctionMethod line profile, 100 radii, Kerr a=0.998",
                "value": dt,
                "unit": "s/profile",
                "vs_baseline": round(BASELINE_BINNING_S / dt, 1),
            }
        )
    )


def _nvidia_smi():
    """The card's name and power limit, read off JAX."""
    import subprocess

    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True,
            text=True,
            timeout=30,
        )
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable: {e}"


def main():
    import jax
    import jax.numpy as jnp

    os.environ.setdefault("JAX_TRACEBACK_FILTERING", "off")
    dev = jax.devices()[0]
    device = {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
        "nvidia_smi": _nvidia_smi(),
    }
    print(json.dumps({"device": device}), file=sys.stderr)
    if dev.platform != "gpu":
        print("bench.py: no GPU found; nothing measured", file=sys.stderr)
        return 1

    from gradus_tpu.compile_cache import enable_compile_cache

    enable_compile_cache(min_compile_time_secs=0.5)

    from gradus_tpu.metrics import KerrMetric
    from gradus_tpu.geometry import ThinDisc
    from gradus_tpu.integrate import Tracer, StatusCodes
    from gradus_tpu.camera.impact import map_impact_parameters
    from gradus_tpu.camera.tiling import block_permutation
    from gradus_tpu.redshift import redshift_pointfunction

    workload = os.environ.get("BENCH_WORKLOAD", "render")
    if workload == "binning":
        return bench_binning()
    if workload == "ctf":
        return bench_ctf()

    backend = os.environ.get("BENCH_BACKEND", "pallas")
    dtype = jnp.float32
    side = int(os.environ.get("BENCH_SIDE", "1024"))
    n = side * side
    lam_max = 2200.0

    m = KerrMetric(M=jnp.asarray(1.0, dtype), a=jnp.asarray(0.998, dtype))
    d = ThinDisc(inner_r=0.0, outer_r=50.0)
    x_obs = jnp.asarray([0.0, 1000.0, np.deg2rad(75.0), 0.0], dtype)

    alphas = jnp.linspace(-28.0, 28.0, side, dtype=dtype) + 1e-4
    betas = jnp.linspace(-18.0, 18.0, side, dtype=dtype) + 1e-4
    A = jnp.broadcast_to(alphas[:, None], (side, side)).ravel()
    B = jnp.broadcast_to(betas[None, :], (side, side)).ravel()

    pf = redshift_pointfunction(m, x_obs)
    v = map_impact_parameters(m, x_obs, A, B)
    xs = jnp.broadcast_to(x_obs, v.shape)

    def shade(gp):
        g = pf(m, gp, lam_max)
        hit = gp.status == StatusCodes.IntersectedWithGeometry
        return jnp.where(hit, g, jnp.nan)

    reps = int(os.environ.get("BENCH_REPS", "10"))

    if backend == "pallas":
        from gradus_tpu.integrate.pallas_solver import PallasTracer

        block = int(os.environ.get("BENCH_BLOCK", "64"))
        seg = int(os.environ.get("BENCH_SEG", "0"))
        tracer = PallasTracer(
            m,
            geometry=d,
            block_rays=int(os.environ.get("BENCH_BLOCK_RAYS", "128")),
            steps_per_check=int(os.environ.get("BENCH_SPC", "8")),
            segment_iters=seg if seg > 0 else None,
            tail_bucket=int(os.environ.get("BENCH_TAIL", "16384")),
        )
        y0 = tracer._constrain(xs, v)
        order = os.environ.get("BENCH_ORDER", "pilot")

        if order == "pilot":
            # pilot-predicted cost ordering: a side/8 pilot render (~1.6% of
            # the rays) measures per-region step counts; the full-res rays are
            # sorted by the (3×3-max-pooled, conservative) predicted cost so
            # every kernel block is cost-coherent — near-oracle per-block
            # early exit. The pilot + sort run INSIDE the timed program.
            pilot_f = int(os.environ.get("BENCH_PILOT", "8"))
            pside = side // pilot_f
            a_p = jnp.linspace(-28.0, 28.0, pside, dtype=dtype) + 1e-4
            b_p = jnp.linspace(-18.0, 18.0, pside, dtype=dtype) + 1e-4
            A_p = jnp.broadcast_to(a_p[:, None], (pside, pside)).ravel()
            B_p = jnp.broadcast_to(b_p[None, :], (pside, pside)).ravel()
            v_p = map_impact_parameters(m, x_obs, A_p, B_p)
            y0_p = tracer._constrain(jnp.broadcast_to(x_obs, v_p.shape), v_p)
            pilot = PallasTracer(m, geometry=d, block_rays=tracer.block_rays)

            @jax.jit
            def render_program(y0, y0_p):
                _, aux_p = pilot.trace(y0_p, (0.0, lam_max))
                s = aux_p["steps"].reshape(pside, pside).astype(jnp.float32)
                sp = jnp.pad(s, 1, mode="edge")
                pooled = jnp.max(
                    jnp.stack(
                        [
                            sp[i : i + pside, j : j + pside]
                            for i in range(3)
                            for j in range(3)
                        ]
                    ),
                    axis=0,
                )
                pred = jnp.repeat(jnp.repeat(pooled, pilot_f, 0), pilot_f, 1).ravel()
                perm = jnp.argsort(-pred)
                gp, aux = tracer.trace(y0[perm], (0.0, lam_max))
                img = jnp.zeros((n,), jnp.float32).at[perm].set(shade(gp))
                return img, aux

            def render():
                return render_program(y0, y0_p)

        else:
            perm, inv = block_permutation(side, side, block)
            perm = jnp.asarray(perm)
            inv = jnp.asarray(inv)

            @jax.jit
            def render_program(y0):
                gp, aux = tracer.trace(y0[perm], (0.0, lam_max))
                return shade(gp)[inv], aux

            def render():
                return render_program(y0)

    else:
        min_bucket = int(os.environ.get("BENCH_MIN_BUCKET", "2048"))
        segment_iters = int(os.environ.get("BENCH_SEGMENT_ITERS", "96"))
        tracer = Tracer(
            m, geometry=d, min_bucket=min_bucket, segment_iters=segment_iters
        )
        shade_jit = jax.jit(shade)

        def render():
            gp = tracer(xs, v, (0.0, lam_max))
            return shade_jit(gp), None

    # compile / warm up
    img, aux = jax.block_until_ready(render())

    # optional profiler capture: BENCH_PROFILE=<dir> wraps the timed loop in
    # a jax.profiler trace
    profile_dir = os.environ.get("BENCH_PROFILE", "")
    if profile_dir:
        jax.profiler.start_trace(profile_dir)

    t0 = time.perf_counter()
    for _ in range(reps):
        img, aux = jax.block_until_ready(render())
    dt = (time.perf_counter() - t0) / reps
    if profile_dir:
        jax.profiler.stop_trace()
        print(json.dumps({"profile_trace": profile_dir}), file=sys.stderr)
    if aux is not None:
        block_iters, steps = aux["block_iters"], aux["steps"]
        attempts, unfinished = aux["attempts"], aux["unfinished"]
    else:
        block_iters = steps = attempts = unfinished = None

    rays_per_s = n / dt

    # observability: executed thread-steps vs useful per-ray accepted steps →
    # wasted-work fraction
    attempted = None
    if backend == "pallas":
        executed = int(np.asarray(jnp.sum(block_iters)))
        useful = int(np.asarray(jnp.sum(steps)))
        attempted = int(np.asarray(jnp.sum(attempts)))
        segments = -(-n // tracer.block_rays)
    else:
        integ = tracer._integ
        executed = sum(w * it for (w, it, _) in integ.last_stats)
        useful = int(np.asarray(jnp.sum(integ.last_steps)))
        segments = len(integ.last_stats)
    details = {
        "backend": backend,
        "executed_thread_steps": executed,
        "useful_ray_steps": useful,
        "wasted_step_fraction": 1.0 - useful / max(executed, 1),
        "thread_steps_per_s": executed / dt,
        "useful_steps_per_s": useful / dt,
        "mean_steps_per_ray": useful / n,
        "segments": segments,
        "seconds_per_render": dt,
    }
    if attempted is not None:
        # attempted = thread-steps on a still-alive ray (accepted + rejected):
        # scheduling waste is dead-thread lockstep only; the rest is the
        # adaptive controller's intrinsic reject cost
        details["attempted_thread_steps"] = attempted
        details["scheduling_waste_fraction"] = 1.0 - attempted / max(executed, 1)
        details["reject_fraction"] = 1.0 - useful / max(attempted, 1)
    if unfinished is not None:
        details["unfinished_rays"] = int(np.asarray(unfinished))
    print(json.dumps({"bench_details": details}), file=sys.stderr)

    print(
        json.dumps(
            {
                "metric": f"rays/s, {side}x{side} Kerr a=0.998 thin-disc redshift render",
                "value": rays_per_s,
                "unit": "rays/s",
                "vs_baseline": round(rays_per_s / BASELINE_RAYS_PER_S, 3),
            }
        )
    )


if __name__ == "__main__":
    sys.exit(main())

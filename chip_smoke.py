"""Run the ray tracer's main path once on a GPU and check it against float64.

    python chip_smoke.py              # one card: the phases below
    python chip_smoke.py --chips 4    # four cards: the sharded products only

One process drives the card(s). Phases (one card):

1. device   — refuse anything but a GPU; print its name, power limit and the
              matmul precision in force.
2. render   — `prerendergeodesics` + redshift, 1024² Kerr a=0.998 thin-disc
              render in float32; a strided 128² subsample re-rendered in
              float64; the `memory_analysis()` of the render program.
3. goldens  — the two 20×20 reference render fingerprints in float64.
4. binning  — `lineprofile(BinningMethod)` on a 1000×1000 polar plane in
              float32 against the same profile in float64.
5. transfer — `lineprofile(TransferFunctionMethod, backend="pallas")`, 100
              radii, N=80, in float32 against the float64 first moment.
              (The default XLA backend compiles for ~9 minutes on the card;
              `scripts/pallas_ab.py` times it.)
6. kernel   — the Pallas (Triton) integrator compiled for the card on all
              1024² render rays against the XLA float32 render, and on a
              4096-ray float64 batch against float64 `trace_geodesics`.
7. tests    — the `gpu`-marked tests, in this process.

Every phase prints its seconds, with compilation apart where the program is
one jitted call. A failed phase makes the exit code non-zero. The last line
of standard output is a JSON object naming the device; it is printed only
when every phase passed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# --- configurations (bench.py's) and tolerances (PERF.md, "Tolerances") -----
RENDER_SIDE = 1024
RENDER_STRIDE = 8  # float64 reference: every 8th pixel each way → 128²
ALPHA_LIMS = (-28.0, 28.0)
BETA_LIMS = (-18.0, 18.0)
LAM_RENDER = 2200.0
BIN_N = 1000
LAM_BIN = 2000.0
CTF_NUM_RE = 100
M1_F64_CPU = 0.9201437735481984  # first moment at num_re=100, N=80, 180 bins
KERNEL_F64_RAYS = 4096
# 20×20 render fingerprints: the reference's (test_render.py, rtol 1e-1) and
# this repository's own float64 CPU sums, which the card must reproduce
GOLDENS = (
    ("shadow", 9009.452876609641, 9009.45016235433),
    ("thin disc", 38412.08347901267, 38731.66520426088),
)

TOL = dict(
    render_status=0.999,  # f32 vs f64 status agreement
    render_g_median=1e-5,
    render_g_p99=1e-3,
    golden_reference_rtol=1e-1,
    golden_cpu_rtol=1e-6,
    binning_l1=1e-2,
    m1_drift=1e-3,
    kernel_status=0.9999,  # kernel vs XLA, both f32
    kernel_g_median=1e-5,
    kernel_f64_status=0.999,  # kernel vs XLA, both f64
    kernel_f64_r_median=1e-8,  # relative hit radius
    kernel_f64_r_p99=1e-4,
    shard_status=0.9999,  # four cards vs one
    shard_g_median=1e-6,
    shard_flux_l1=1e-4,
)


class Smoke:
    """Collects phase results; a phase that raises is recorded as failed."""

    def __init__(self):
        self.failed = []
        self.seconds = {}

    @contextlib.contextmanager
    def phase(self, name):
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            yield
        except Exception:
            traceback.print_exc()
            self.failed.append(name)
            print(f"!! {name} FAILED", flush=True)
        finally:
            self.seconds[name] = time.perf_counter() - t0
            print(f"   {name}: {self.seconds[name]:.2f} s", flush=True)

    def check(self, what, value, ok):
        print(f"   {what}: {value} -> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{what} = {value} outside tolerance")


def timed(fn, *args):
    """(result, seconds) with the device work finished."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def compile_and_run(fn, *args):
    """Compile ``jax.jit(fn)`` ahead of time, then run it twice.
    Returns (compiled, result, compile_s, first_s, warm_s)."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    out, first_s = timed(compiled, *args)
    out, warm_s = timed(compiled, *args)
    return compiled, out, compile_s, first_s, warm_s


def nvidia_smi():
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True,
            text=True,
            timeout=30,
        )
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


# --- workloads ----------------------------------------------------------------


def render_setup(dtype):
    import jax.numpy as jnp
    import gradus_tpu as gt

    m = gt.KerrMetric(M=jnp.asarray(1.0, dtype), a=jnp.asarray(0.998, dtype))
    x = jnp.asarray([0.0, 1000.0, np.deg2rad(75.0), 0.0], dtype)
    return m, x, gt.ThinDisc(0.0, 50.0)


def sub_lims(lims, side, stride):
    """Limits whose ``side // stride``-point linspace is every ``stride``-th
    point of the ``side``-point linspace over ``lims``."""
    n_sub = side // stride
    return (lims[0], lims[0] + (lims[1] - lims[0]) * stride * (n_sub - 1) / (side - 1))


def render_fn(dtype, width, height, alpha_lims, beta_lims):
    """x -> (status[h, w], g[h, w]): the public render path, one program."""
    import gradus_tpu as gt
    from gradus_tpu.camera.render import apply

    m, _, d = render_setup(dtype)

    def run(x):
        _, _, cache = gt.prerendergeodesics(
            m,
            x,
            d,
            LAM_RENDER,
            image_width=width,
            image_height=height,
            alpha_lims=alpha_lims,
            beta_lims=beta_lims,
        )
        pf = gt.ConstPointFunctions.redshift(m, x) @ gt.ConstPointFunctions.filter_intersected()
        status = cache.points.status.reshape(width, height).T
        return status, apply(pf, cache)

    return run


def compare_images(s_a, g_a, s_b, g_b):
    """(status agreement, median and p99 relative g difference on rays that
    hit in both)."""
    import gradus_tpu as gt

    s_a, s_b = np.asarray(s_a), np.asarray(s_b)
    g_a, g_b = np.asarray(g_a, np.float64), np.asarray(g_b, np.float64)
    agree = float((s_a == s_b).mean())
    hit = gt.StatusCodes.IntersectedWithGeometry
    both = (s_a == hit) & (s_b == hit) & np.isfinite(g_a) & np.isfinite(g_b)
    rel = np.abs(g_a[both] - g_b[both]) / np.abs(g_b[both])
    return agree, float(np.median(rel)), float(np.percentile(rel, 99)), int(both.sum())


def binning_fn(dtype, n):
    import jax.numpy as jnp
    import gradus_tpu as gt
    from gradus_tpu.camera.grids import GeometricGrid
    from gradus_tpu.camera.planes import PolarPlane

    m = gt.KerrMetric(M=jnp.asarray(1.0, dtype), a=jnp.asarray(0.998, dtype))
    d = gt.ThinDisc(0.0, jnp.inf)
    bins = jnp.linspace(0.1, 1.4, 200, dtype=dtype)
    plane = PolarPlane(GeometricGrid(), Nr=n, Ntheta=n, r_max=50.0)

    def run(x):
        return gt.lineprofile(
            m,
            x,
            d,
            bins=bins,
            method=gt.BinningMethod(),
            plane=plane,
            max_re=200.0,
            lam_max=LAM_BIN,
        )[1]

    x = jnp.asarray([0.0, 1000.0, np.deg2rad(70.0), 0.0], dtype)
    return run, x, np.asarray(bins, np.float64)


def first_moment(flux, centers):
    flux = np.asarray(flux, np.float64)
    return float((flux * centers).sum() / flux.sum())


def ctf_profile(dtype, backend, num_re=CTF_NUM_RE):
    import jax.numpy as jnp
    import gradus_tpu as gt

    m = gt.KerrMetric(M=jnp.asarray(1.0, dtype), a=jnp.asarray(0.998, dtype))
    x = jnp.asarray([0.0, 1000.0, np.deg2rad(60.0), 0.0], dtype)
    bins = jnp.linspace(0.1, 1.5, 180, dtype=dtype)
    return gt.lineprofile(
        m, x, gt.ThinDisc(0.0, jnp.inf), bins=bins, num_re=num_re, N=80, backend=backend
    )[1]


def kernel_rays(dtype, side, alpha_lims, beta_lims):
    """Constrained (N, 8) initial states for the render's rays."""
    import jax.numpy as jnp
    from gradus_tpu.camera.render import _pixel_velocities
    from gradus_tpu.geodesics.equation import constrain_all

    m, x, _ = render_setup(dtype)
    _, _, v = _pixel_velocities(m, x, side, side, alpha_lims, beta_lims)
    xs = jnp.broadcast_to(x, v.shape)
    return jnp.concatenate([xs, constrain_all(m, xs, v, mu=0.0)], axis=-1)


def kernel_render_fn(dtype, side):
    """y0 -> (status[h, w], g[h, w]) through the compiled Pallas kernel."""
    import jax.numpy as jnp
    import gradus_tpu as gt
    from gradus_tpu.integrate.pallas_solver import PallasTracer

    m, x, d = render_setup(dtype)
    tracer = PallasTracer(m, geometry=d, dtype=dtype)
    pf = gt.ConstPointFunctions.redshift(m, x) @ gt.ConstPointFunctions.filter_intersected()

    def run(y0):
        gp, _ = tracer.trace(y0, (0.0, LAM_RENDER))
        g = pf(m, gp, jnp.asarray(LAM_RENDER, dtype))
        return gp.status.reshape(side, side).T, g.reshape(side, side).T

    return run


# --- one card -----------------------------------------------------------------


def run_one_card(smoke, dev):
    import jax.numpy as jnp
    import gradus_tpu as gt

    f32, f64 = jnp.float32, jnp.float64
    side, stride = RENDER_SIDE, RENDER_STRIDE
    xla_render = {}

    with smoke.phase("render"):
        fn = render_fn(f32, side, side, ALPHA_LIMS, BETA_LIMS)
        _, x32, _ = render_setup(f32)
        compiled, (s32, g32), c_s, first_s, warm_s = compile_and_run(fn, x32)
        print(f"   f32 {side}²: compile {c_s:.2f} s, first {first_s:.3f} s, warm {warm_s:.3f} s")
        print(f"   memory_analysis: {compiled.memory_analysis()}")
        stats = dev.memory_stats() or {}
        print(f"   peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")
        smoke.check("g dtype", g32.dtype, g32.dtype == f32)
        xla_render.update(status=s32, g=g32, seconds=warm_s)

        n_sub = side // stride
        fn64 = render_fn(
            f64, n_sub, n_sub, sub_lims(ALPHA_LIMS, side, stride), sub_lims(BETA_LIMS, side, stride)
        )
        _, x64, _ = render_setup(f64)
        _, (s64, g64), c_s, first_s, warm_s = compile_and_run(fn64, x64)
        print(f"   f64 {n_sub}² reference: compile {c_s:.2f} s, warm {warm_s:.3f} s")
        agree, med, p99, n_both = compare_images(
            np.asarray(s32)[::stride, ::stride], np.asarray(g32)[::stride, ::stride], s64, g64
        )
        print(f"   rays hit in both: {n_both}")
        smoke.check("status agreement f32 vs f64", agree, agree >= TOL["render_status"])
        smoke.check("median rel g diff", med, med <= TOL["render_g_median"])
        smoke.check("p99 rel g diff", p99, p99 <= TOL["render_g_p99"])

    with smoke.phase("goldens"):
        x_obs = jnp.asarray([0.0, 100.0, np.deg2rad(85.0), 0.0], f64)
        cam = dict(image_width=20, image_height=20, alpha_lims=(-9.5, 9.5), beta_lims=(-9.5, 9.5))
        m0 = gt.KerrMetric(M=1.0, a=0.0)
        for (name, ref, cpu), geom in zip(GOLDENS, (None, gt.ThinDisc(0.0, 40.0))):
            (_, _, img), s = timed(lambda: gt.rendergeodesics(m0, x_obs, geom, 200.0, **cam))
            got = float(jnp.nansum(img))
            print(f"   {name}: Σ = {got!r} ({s:.2f} s)")
            rel_ref, rel_cpu = abs(got / ref - 1), abs(got / cpu - 1)
            smoke.check(f"{name} vs reference golden", rel_ref, rel_ref <= TOL["golden_reference_rtol"])
            smoke.check(f"{name} vs float64 CPU", rel_cpu, rel_cpu <= TOL["golden_cpu_rtol"])

    with smoke.phase("binning"):
        fn, x, bins = binning_fn(f32, BIN_N)
        _, p32, c_s, first_s, warm_s = compile_and_run(fn, x)
        print(f"   f32 {BIN_N}x{BIN_N}: compile {c_s:.2f} s, warm {warm_s:.3f} s/profile")
        fn64, x64, _ = binning_fn(f64, BIN_N)
        _, p64, c_s, first_s, warm_s = compile_and_run(fn64, x64)
        print(f"   f64 {BIN_N}x{BIN_N}: compile {c_s:.2f} s, warm {warm_s:.3f} s/profile")
        p32, p64 = np.asarray(p32, np.float64), np.asarray(p64, np.float64)
        smoke.check("profile finite and normalized", float(p32.sum()), np.isfinite(p32).all() and abs(p32.sum() - 1) < 1e-4)
        l1 = float(np.abs(p32 - p64).sum())
        smoke.check("L1(f32 - f64)", l1, l1 <= TOL["binning_l1"])
        drift = abs(first_moment(p32, bins) / first_moment(p64, bins) - 1)
        smoke.check("m1 drift f32 vs f64", drift, drift <= TOL["m1_drift"])

    with smoke.phase("transfer"):
        flux, first_s = timed(lambda: ctf_profile(f32, "pallas"))
        flux, warm_s = timed(lambda: ctf_profile(f32, "pallas"))
        print(f"   f32 num_re={CTF_NUM_RE}: first {first_s:.2f} s (compile + run), warm {warm_s:.3f} s/profile")
        drift = abs(first_moment(flux, np.linspace(0.1, 1.5, 180)) / M1_F64_CPU - 1)
        smoke.check("m1 drift vs float64", drift, drift <= TOL["m1_drift"])

    with smoke.phase("kernel"):
        y0 = kernel_rays(f32, side, ALPHA_LIMS, BETA_LIMS)
        _, (ks, kg), c_s, first_s, warm_s = compile_and_run(kernel_render_fn(f32, side), y0)
        print(f"   f32 {side}² kernel render: compile {c_s:.2f} s, warm {warm_s:.3f} s (XLA render {xla_render.get('seconds', float('nan')):.3f} s)")
        if xla_render:
            agree, med, p99, n_both = compare_images(ks, kg, xla_render["status"], xla_render["g"])
            smoke.check("kernel vs XLA status agreement", agree, agree >= TOL["kernel_status"])
            smoke.check("kernel vs XLA median rel g diff", med, med <= TOL["kernel_g_median"])
            print(f"   kernel vs XLA p99 rel g diff: {p99}")
        else:
            raise RuntimeError("no XLA render to compare with")
        kernel_f64_check(smoke, KERNEL_F64_RAYS)

    with smoke.phase("tests"):
        run_gpu_tests(smoke)


def kernel_f64_check(smoke, n):
    """Float64 batch through the compiled kernel vs float64 trace_geodesics."""
    import jax
    import jax.numpy as jnp
    import gradus_tpu as gt
    from gradus_tpu.camera.impact import map_impact_parameters
    from gradus_tpu.integrate.pallas_solver import PallasTracer

    f64 = jnp.float64
    m, x, d = render_setup(f64)
    rng = np.random.default_rng(0)
    al = jnp.asarray(rng.uniform(*ALPHA_LIMS, n), f64)
    be = jnp.asarray(rng.uniform(*BETA_LIMS, n), f64)
    v = map_impact_parameters(m, x, al, be)
    xs = jnp.broadcast_to(x, v.shape)
    ref, ref_s = timed(jax.jit(lambda xs, v: gt.trace_geodesics(m, xs, v, (0.0, LAM_RENDER), geometry=d)), xs, v)
    gp, k_s = timed(lambda: PallasTracer(m, geometry=d, dtype=f64)(xs, v, (0.0, LAM_RENDER)))
    print(f"   f64 {n} rays: XLA {ref_s:.2f} s, kernel {k_s:.2f} s (both include compile)")
    s_ref, s_k = np.asarray(ref.status), np.asarray(gp.status)
    agree = float((s_ref == s_k).mean())
    smoke.check("f64 kernel vs XLA status agreement", agree, agree >= TOL["kernel_f64_status"])
    hit = (s_ref == s_k) & (s_ref == gt.StatusCodes.IntersectedWithGeometry)
    r_ref, r_k = np.asarray(ref.x)[hit, 1], np.asarray(gp.x)[hit, 1]
    rel = np.abs(r_k - r_ref) / np.abs(r_ref)
    med, p99 = float(np.median(rel)), float(np.percentile(rel, 99))
    print(f"   f64 hits: {int(hit.sum())}, rel hit-radius diff max {float(rel.max())}")
    smoke.check("f64 kernel vs XLA median rel hit-radius diff", med, med <= TOL["kernel_f64_r_median"])
    smoke.check("f64 kernel vs XLA p99 rel hit-radius diff", p99, p99 <= TOL["kernel_f64_r_p99"])


class _Counter:
    """pytest plugin counting outcomes."""

    def __init__(self):
        self.counts = {"passed": 0, "failed": 0, "skipped": 0}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] = self.counts.get(report.outcome, 0) + 1


def run_gpu_tests(smoke):
    import pytest

    os.environ["GRADUS_TESTS_ON_GPU"] = "1"
    counter = _Counter()
    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider", os.path.join(HERE, "tests")],
        plugins=[counter],
    )
    print(f"   gpu tests: {counter.counts}, pytest exit {int(rc)}")
    ok = int(rc) == 0 and counter.counts["passed"] > 0 and not counter.counts["skipped"]
    smoke.check("gpu-marked tests", counter.counts, ok)


# --- four cards ---------------------------------------------------------------


def run_four_cards(smoke, n_chips):
    import jax
    import jax.numpy as jnp
    import gradus_tpu as gt
    from gradus_tpu.parallel import (
        ray_mesh,
        sharded_lineprofile,
        sharded_pallas_trace,
        sharded_render,
    )
    from gradus_tpu.integrate.pallas_solver import PallasTracer

    f32 = jnp.float32
    mesh = ray_mesh(n_chips)
    print(f"   mesh: {mesh.devices.tolist()}")

    def shard_devices(arr):
        return sorted({str(s.device) for s in arr.addressable_shards})

    with smoke.phase("sharded_render"):
        m, x, d = render_setup(f32)
        pf = gt.ConstPointFunctions.redshift(m, x) @ gt.ConstPointFunctions.filter_intersected()
        cam = dict(image_width=RENDER_SIDE, image_height=RENDER_SIDE, alpha_lims=ALPHA_LIMS, beta_lims=BETA_LIMS)
        sh = jax.jit(lambda x: sharded_render(m, x, d, LAM_RENDER, pf=pf, mesh=mesh, **cam)[2])
        one = jax.jit(lambda x: gt.rendergeodesics(m, x, d, LAM_RENDER, pf=pf, **cam)[2])
        img4, t4 = timed(sh, x)
        img4, t4w = timed(sh, x)
        img1, t1 = timed(one, x)
        img1, t1w = timed(one, x)
        print(f"   4 cards: first {t4:.2f} s, warm {t4w:.3f} s; 1 card: first {t1:.2f} s, warm {t1w:.3f} s")
        print(f"   image shards on: {shard_devices(img4)}")
        a, b = np.asarray(img4, np.float64), np.asarray(img1, np.float64)
        agree = float((np.isfinite(a) == np.isfinite(b)).mean())
        both = np.isfinite(a) & np.isfinite(b)
        med = float(np.median(np.abs(a[both] - b[both]) / np.abs(b[both])))
        smoke.check("hit-mask agreement 4 vs 1", agree, agree >= TOL["shard_status"])
        smoke.check("median rel g diff 4 vs 1", med, med <= TOL["shard_g_median"])

    with smoke.phase("sharded_lineprofile"):
        from gradus_tpu.camera.grids import GeometricGrid
        from gradus_tpu.camera.planes import PolarPlane

        fn, xb, bins = binning_fn(f32, BIN_N)
        mb = gt.KerrMetric(M=jnp.asarray(1.0, f32), a=jnp.asarray(0.998, f32))
        plane = PolarPlane(GeometricGrid(), Nr=BIN_N, Ntheta=BIN_N, r_max=50.0)
        sh = jax.jit(
            lambda x: sharded_lineprofile(
                mb, x, gt.ThinDisc(0.0, jnp.inf), bins=jnp.asarray(bins, f32),
                plane=plane, max_re=200.0, lam_max=LAM_BIN, mesh=mesh,
            )[1]
        )
        p4, t4 = timed(sh, xb)
        p4, t4w = timed(sh, xb)
        p1, t1 = timed(jax.jit(fn), xb)
        p1, t1w = timed(jax.jit(fn), xb)
        print(f"   4 cards: first {t4:.2f} s, warm {t4w:.3f} s; 1 card: first {t1:.2f} s, warm {t1w:.3f} s")
        print(f"   profile shards on: {shard_devices(p4)}")
        l1 = float(np.abs(np.asarray(p4, np.float64) - np.asarray(p1, np.float64)).sum())
        smoke.check("L1(4 cards - 1 card)", l1, l1 <= TOL["shard_flux_l1"])

    with smoke.phase("sharded_pallas_trace"):
        m, x, d = render_setup(f32)
        y0 = kernel_rays(f32, RENDER_SIDE, ALPHA_LIMS, BETA_LIMS)
        tracer = PallasTracer(m, geometry=d, dtype=f32)
        sh = jax.jit(lambda y: sharded_pallas_trace(tracer, y, (0.0, LAM_RENDER), mesh=mesh))
        one = jax.jit(lambda y: tracer.trace(y, (0.0, LAM_RENDER))[0])
        gp4, t4 = timed(sh, y0)
        gp4, t4w = timed(sh, y0)
        gp1, t1 = timed(one, y0)
        gp1, t1w = timed(one, y0)
        print(f"   4 cards: first {t4:.2f} s, warm {t4w:.3f} s; 1 card: first {t1:.2f} s, warm {t1w:.3f} s")
        print(f"   endpoint shards on: {shard_devices(gp4.x)}")
        agree = float((np.asarray(gp4.status) == np.asarray(gp1.status)).mean())
        smoke.check("status agreement 4 vs 1", agree, agree >= TOL["shard_status"])
        dx = float(np.nanmax(np.abs(np.asarray(gp4.x) - np.asarray(gp1.x))))
        smoke.check("max |Δx| 4 vs 1", dx, dx <= 1e-6 * 1000.0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform {devs[0].platform!r}); nothing run", file=sys.stderr)
        return 1
    if len(devs) < args.chips:
        print(f"chip_smoke: {args.chips} GPUs asked for, {len(devs)} found", file=sys.stderr)
        return 1
    try:
        import gradus_tpu  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the gradus_tpu package is not beside this script: {e}", file=sys.stderr)
        return 1

    jax.config.update("jax_enable_x64", True)
    from gradus_tpu.compile_cache import enable_compile_cache

    smoke = Smoke()
    dev = devs[0]
    with smoke.phase("device"):
        print(f"   platform {dev.platform}, kind {dev.device_kind!r}, count {len(devs)}")
        print(f"   jax {jax.__version__}, matmul precision {jax.config.jax_default_matmul_precision!r}")
        print(f"   compile cache: {enable_compile_cache()}")
        if jax.config.jax_default_matmul_precision != "highest":
            raise RuntimeError("float32 products would run in TF32")

    t0 = time.perf_counter()
    if args.chips == 1:
        run_one_card(smoke, dev)
    else:
        run_four_cards(smoke, args.chips)
    total = time.perf_counter() - t0

    print("== seconds per phase: " + json.dumps({k: round(v, 2) for k, v in smoke.seconds.items()}))
    print(f"== total {total:.1f} s; failed phases: {smoke.failed or 'none'}")
    print(nvidia_smi())
    if smoke.failed:
        return 1
    print(json.dumps({"ok": True, "device": {"platform": dev.platform, "kind": dev.device_kind, "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

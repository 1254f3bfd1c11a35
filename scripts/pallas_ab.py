"""Kernel-vs-XLA timing on the card, one process, in turns.

    python scripts/pallas_ab.py [--side 1024] [--quick]

Times, on one GPU, each product three ways where it has them:

- render (1024², bench.py's config): plain `rendergeodesics`, the `Tracer`
  compaction path (BENCH_BACKEND=xla) and the pilot-ordered kernel
  (BENCH_BACKEND=pallas) over block_rays x steps_per_check;
- BinningMethod (1000×1000 polar plane): plain `lineprofile`, `Tracer`,
  and the pilot-ordered kernel;
- TransferFunctionMethod (100 radii): `lineprofile(backend="xla")` and
  `backend="pallas"`.

The bench.py runs print their own JSON lines; the plain runs print theirs
here. Every time ends in `jax.block_until_ready`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402


def _time(fn, reps):
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return first, ts


def plain_render(side, reps):
    import jax
    import jax.numpy as jnp
    import gradus_tpu as gt

    f32 = jnp.float32
    m = gt.KerrMetric(M=jnp.asarray(1.0, f32), a=jnp.asarray(0.998, f32))
    x = jnp.asarray([0.0, 1000.0, np.deg2rad(75.0), 0.0], f32)
    pf = gt.ConstPointFunctions.redshift(m, x) @ gt.ConstPointFunctions.filter_intersected()
    run = jax.jit(
        lambda x: gt.rendergeodesics(
            m, x, gt.ThinDisc(0.0, 50.0), 2200.0, image_width=side, image_height=side,
            alpha_lims=(-28.0, 28.0), beta_lims=(-18.0, 18.0), pf=pf,
        )[2]
    )
    first, ts = _time(lambda: run(x), reps)
    _report("render", "plain rendergeodesics", first, ts, rays=side * side)


def plain_binning(n, reps):
    import jax
    import jax.numpy as jnp
    import gradus_tpu as gt
    from gradus_tpu.camera.grids import GeometricGrid
    from gradus_tpu.camera.planes import PolarPlane

    f32 = jnp.float32
    m = gt.KerrMetric(M=jnp.asarray(1.0, f32), a=jnp.asarray(0.998, f32))
    x = jnp.asarray([0.0, 1000.0, np.deg2rad(70.0), 0.0], f32)
    plane = PolarPlane(GeometricGrid(), Nr=n, Ntheta=n, r_max=50.0)
    bins = jnp.linspace(0.1, 1.4, 200, dtype=f32)
    run = jax.jit(
        lambda x: gt.lineprofile(
            m, x, gt.ThinDisc(0.0, jnp.inf), bins=bins, method=gt.BinningMethod(),
            plane=plane, max_re=200.0, lam_max=2000.0,
        )[1]
    )
    first, ts = _time(lambda: run(x), reps)
    _report("binning", "plain lineprofile(BinningMethod)", first, ts, rays=n * n)


def _report(product, path, first, ts, **extra):
    print(
        json.dumps(
            {
                "ab": product,
                "path": path,
                "first_s": first,
                "median_s": float(np.median(ts)),
                "all_s": ts,
                **extra,
            }
        ),
        flush=True,
    )


def bench_run(env, reps):
    """One bench.py run in this process with the given BENCH_* settings."""
    import bench

    for k in [k for k in os.environ if k.startswith("BENCH_")]:
        del os.environ[k]
    os.environ.update({k: str(v) for k, v in env.items()})
    os.environ["BENCH_REPS"] = str(reps)
    print(json.dumps({"bench_env": env}), flush=True)
    t0 = time.perf_counter()
    try:
        rc = bench.main()
    except Exception as e:  # one failed configuration does not stop the rest
        print(json.dumps({"bench_error": repr(e)[:2000]}), flush=True)
        return
    print(json.dumps({"bench_rc": rc, "wall_s": time.perf_counter() - t0}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=1024)
    ap.add_argument("--quick", action="store_true", help="default kernel config only")
    args = ap.parse_args()

    import jax

    if jax.devices()[0].platform != "gpu":
        print("pallas_ab.py: no GPU found", file=sys.stderr)
        return 1
    from gradus_tpu.compile_cache import enable_compile_cache

    enable_compile_cache(min_compile_time_secs=0.5)
    side = args.side

    # render: parent-of-choice order (xla, kernel configs, xla) so drift shows
    plain_render(side, 5)
    bench_run({"BENCH_BACKEND": "xla", "BENCH_SIDE": side}, 3)
    configs = [(128, 8)] if args.quick else [(64, 8), (128, 8), (256, 8), (128, 4), (128, 1)]
    for block_rays, spc in configs:
        bench_run(
            {"BENCH_SIDE": side, "BENCH_BLOCK_RAYS": block_rays, "BENCH_SPC": spc}, 5
        )
    plain_render(side, 5)

    plain_binning(1000, 3)
    bench_run({"BENCH_WORKLOAD": "binning", "BENCH_BACKEND": "xla"}, 3)
    bench_run({"BENCH_WORKLOAD": "binning"}, 3)

    for backend in ("xla", "pallas"):
        bench_run({"BENCH_WORKLOAD": "ctf", "BENCH_BACKEND": backend}, 2)
    return 0


if __name__ == "__main__":
    sys.exit(main())

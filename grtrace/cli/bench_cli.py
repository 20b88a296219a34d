"""`grtrace-bench` console entry: parameterized throughput benchmark.

The repo-root bench.py prints the single headline JSON line; this CLI
exposes the same measurement with knobs (size, steps, backend, dtype)
for profiling work.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description="grtrace throughput benchmark")
    p.add_argument("--size", type=int, default=400)
    p.add_argument("--steps", type=int, default=200_000)
    p.add_argument("--delta", type=float, default=0.01)
    p.add_argument("--backend", type=str, default="auto",
                   choices=["auto", "pallas", "xla"])
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "float64"])
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--metric", type=str, default="schwarzschild",
                   choices=["schwarzschild", "kerr"])
    p.add_argument("--spin", type=float, default=0.0)
    p.add_argument("--charge", type=float, default=0.0)
    p.add_argument("--disk", action="store_true",
                   help="benchmark the accretion-disk pipeline "
                        "(engine.disk)")
    p.add_argument("--out", type=str, default=None,
                   help="also write the JSON line to this file")
    args = p.parse_args(argv)
    from . import driver_startup
    driver_startup()

    import jax

    from grtrace import (DiskConfig, IntegratorConfig, PatchConfig,
                         SceneConfig, render, render_disk)

    scene = SceneConfig(
        size=args.size, background=None, metric=args.metric,
        spin=args.spin, charge=args.charge,
        integrator=IntegratorConfig(steps=args.steps, delta=args.delta,
                                    omega=1.0, backend=args.backend,
                                    dtype=args.dtype),
        patch=PatchConfig(), n_samples=0)
    rng = np.random.default_rng(0)
    tex = rng.integers(0, 255, (args.size, args.size, 3), dtype=np.uint8)

    def run():
        if args.disk:
            return render_disk(scene, DiskConfig(), bg_array=tex)
        return render(scene, bg_array=tex)

    t0 = time.time()
    res = run()
    warm = time.time() - t0
    times = []
    for _ in range(args.iters):
        t0 = time.time()
        res = run()  # the counts fetch synchronizes the pipeline
        times.append(time.time() - t0)
    t = min(times)
    total_steps = int(res.n_steps.astype(np.int64).sum())
    # vs_baseline scales the 1 s / 400^2 north-star target by ray
    # count (same per-ray time budget), so e.g. the 4K config's target is
    # (4096/400)^2 = 104.9 s and vs_baseline > 1 still means faster
    target_s = (args.size / 400.0) ** 2
    tag = "disk_" if args.disk else ""
    out = {
        "metric": f"render_{tag}{args.size}x{args.size}_wall_s",
        "value": round(t, 4),
        "unit": "s",
        "vs_baseline": round(target_s / t, 2),
        "steps_budget": args.steps,
        "metric_family": args.metric, "spin": args.spin,
        "backend": args.backend, "dtype": args.dtype,
        "warmup_s": round(warm, 2),
        "rays_per_s": round(args.size * args.size / t),
        "geodesic_steps_per_s": round(total_steps / t),
        "counts": res.counts,
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
    }
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


def console(argv=None):
    """setuptools console-script entry (must not return a value — sys.exit
    would print it and exit non-zero)."""
    main(argv)
    return 0


if __name__ == "__main__":
    main()

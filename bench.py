"""Headline benchmark: the 400x400, 200k-step Schwarzschild render, end to
end on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.
vs_baseline is the 1 s north-star target over the measured time (> 1 is
faster).  Method: one warm-up render (compilation), then the median of 5
renders, each ending in block_until_ready on the image.  Timing covers the
scalar upload, camera, integration (the Pallas GPU kernel), classification,
compositing and the count fetch.  stderr carries a second JSON line with
the stage breakdown, the jaxpr op count per ray-step and the op rate it
implies (engine.metrics.roofline_report), and the kernel-vs-XLA-twin
parity at the headline budget (engine.validate.kernel_parity).

Needs a GPU: with none it exits non-zero and prints no result.
"""
import json
import statistics
import sys
import time

import numpy as np


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform!r}")

    import grtrace
    from grtrace import IntegratorConfig, PatchConfig, SceneConfig, render
    from grtrace.engine import validate
    from grtrace.engine.metrics import RenderMetrics, roofline_report

    grtrace.enable_compilation_cache(allow_backend_init=True)

    size = 400
    scene = SceneConfig(
        size=size, fov_deg=80.0, background=None, bh_mass=1.0,
        boundary_radius=31.0, observer_distance=30.0,
        integrator=IntegratorConfig(steps=200_000, delta=0.01, omega=1.0,
                                    backend="auto"),
        patch=PatchConfig(), n_samples=0)
    tex = np.random.default_rng(0).integers(0, 255, (size, size, 3),
                                            dtype=np.uint8)

    def run():
        res = render(scene, bg_array=tex)
        jax.block_until_ready(res.device("image"))
        return res

    t0 = time.perf_counter()
    res = run()
    warmup = time.perf_counter() - t0
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        res = run()
        times.append(time.perf_counter() - t0)
    t = statistics.median(times)
    total_steps = int(res.n_steps.astype(np.int64).sum())

    # stage breakdown from a separate instrumented call (requesting metrics
    # adds an n_steps host fetch, so it stays out of the timed runs)
    metrics = RenderMetrics()
    render(scene, bg_array=tex, metrics=metrics)
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    info = {
        "warmup_s": warmup,
        "times_s": times,
        "rays_per_s": size * size / t,
        "geodesic_steps_per_s": total_steps / t,
        "ops": roofline_report(total_steps / t),
        "counts": res.counts,
        "stages_s": metrics.stages,
        "parity": validate.kernel_parity(size=size, steps=200_000),
        "device": device,
    }
    print(json.dumps(info), file=sys.stderr)
    print(json.dumps({
        "metric": "render_400x400_wall_s",
        "value": t,
        "unit": "s",
        "vs_baseline": 1.0 / t,
        "device": device,
    }))


if __name__ == "__main__":
    main()

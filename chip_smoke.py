"""Quickest proof that grtrace runs on the GPU.

    python chip_smoke.py              # one GPU: the phases below
    python chip_smoke.py --four-gpus  # four GPUs: the sharded paths only

One GPU, in one process (a second JAX process could not get the card's
memory):
  1. device    JAX must report a GPU; the card's name and power limit.
  2. render    the headline scene through the CLI entry point
               (Schwarzschild, 400x400, 200k-step budget, delta 0.01,
               observer 30 M, boundary 31 M, fov 80 deg, procedural
               starfield), its counts and output files, cold and warm
               seconds.
  3. accuracy  the 186 probe pixels of tests/golden/oracle_escape_headline.npz
               through the production float32 integrator at the full
               budget, against the float64 oracle (contract: escape
               direction within 1e-5 rad); Schwarzschild and Kerr a = 0.9
               shadow boundaries against closed-form GR (sub-pixel).
  4. kernel    the full 400x400 frame through the Pallas GPU kernel and
               through its XLA twin integrate_batch_compensated: status
               mismatches outside the near-critical band (must be 0),
               escape-angle deltas (must be <= 1e-5 rad: both run the same
               float32 step functions, so only FMA contraction and
               operation order may differ), warm times of both.
  5. kerr      Kerr a = 0.9 in the Kerr-Schild chart, 1024x1024, 30k
               steps, delta 0.02, through render(): 0 numerical-error
               pixels.
  6. gpu-tests the tests marked `gpu` (tests/test_gpu_kernel.py).

Four GPUs: the ('frames', 'rays') = (1, 4) mesh for render_frames_sharded
(8 orbit frames at 256x256, 50k steps, delta 0.02) and
line_profile_grid_sharded (its psum is the one collective), each against
the same work on a one-device mesh.

Every phase raises on failure.  Each prints one line; the last line of
standard output is {"ok": true, "device": {...}} and nothing else.
"""
import argparse
import json
import os
import statistics
import subprocess
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "smoke")


def report(phase, **fields):
    print(f"{phase}: {json.dumps(fields)}", flush=True)


def timed(fn, repeats=3):
    """(result, cold seconds, median warm seconds); every run ends in
    block_until_ready, so the times cover the device work."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    cold = time.perf_counter() - t0
    warm = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        warm.append(time.perf_counter() - t0)
    return out, cold, statistics.median(warm)


def phase_device(n_needed):
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX found "
                         f"{devs[0].platform!r} ({devs[0].device_kind})")
    if len(devs) < n_needed:
        raise SystemExit(f"needs {n_needed} GPUs, JAX found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    report("device", kind=devs[0].device_kind, count=len(devs),
           nvidia_smi=smi.splitlines())
    return devs, smi.splitlines()[0]


HEADLINE = ["--size", "400", "--steps", "200000", "--delta", "0.01",
            "--observer-distance", "30", "--boundary-radius", "31",
            "--fov", "80", "--background", "procedural:starfield",
            "--n-samples", "0"]


def phase_render(card, argv=HEADLINE):
    import jax

    from grtrace.cli.args import parse_args, scene_from_args
    from grtrace.cli.main import main as cli_main
    from grtrace.engine.render import render
    from grtrace.io import artifacts

    out_dir = os.path.join(OUT, "headline")
    argv = argv + ["--out-dir", out_dir, "--no-plots"]
    t0 = time.perf_counter()
    res = cli_main(argv)
    cold = time.perf_counter() - t0
    c = res.counts
    if not (c["captured"] > 0 and c["numerical_error"] == 0
            and c["escaped"] == c["background"]):
        raise AssertionError(f"headline counts {c}")
    for name in ("images/manual_output.png", "photon_data.csv"):
        path = os.path.join(out_dir, name)
        if not os.path.getsize(path):
            raise AssertionError(f"{path} is empty")

    steps = int(res.n_steps.astype("int64").sum())
    scene = scene_from_args(parse_args(argv))
    bg = artifacts.load_background(scene.background,
                                   size=(scene.size, scene.size))
    _, _, warm = timed(lambda: render(scene, bg_array=bg).device("image"))
    report("render", card=card, counts=c, cold_cli_s=cold,
           warm_render_s=warm, geodesic_steps=steps,
           backend=jax.default_backend())


def phase_accuracy(card):
    import jax.numpy as jnp
    import numpy as np

    from grtrace.engine import validate
    from grtrace.engine.integrate import STATUS_ESCAPED, integrate_dispatch
    from grtrace.physics.camera import camera_rays

    g = np.load(os.path.join(ROOT, "tests", "golden",
                             "oracle_escape_headline.npz"))
    f32 = jnp.float32
    q0, p0, *_ = camera_rays(
        jnp.asarray([float(g["obs_x"]), 0.0, 0.0], f32), f32(g["fov"]),
        int(g["size"]), int(g["size"]), mass_bh=float(g["mass"]), dtype=f32)
    idx = g["flat_idx"]
    fq, _, st, ns = integrate_dispatch(
        q0.reshape(-1, 4)[idx], p0.reshape(-1, 4)[idx], int(g["steps"]),
        f32(g["delta"]), f32(2.0 * float(g["mass"])), f32(g["rmax"]),
        f32(g["omega"]), backend="auto", equatorial=True)
    fq = np.asarray(fq, np.float64)
    oq = g["final_q"]
    dth = np.abs(fq[:, 2] - oq[:, 2])
    dph = np.abs((fq[:, 3] - oq[:, 3] + np.pi) % (2 * np.pi) - np.pi)
    err = np.maximum(dth, dph)
    if not (np.asarray(st) == STATUS_ESCAPED).all():
        raise AssertionError("an oracle probe did not escape")
    if err.max() > 1e-5:
        raise AssertionError(f"escape-direction error {err.max():.3e} > 1e-5")
    schw = validate.schwarzschild_shadow_error()
    kerr = validate.kerr_shadow_errors(spin=0.9)
    if not (schw["px_err"] < 1.0 and kerr["px_err_max"] < 1.0):
        raise AssertionError(f"shadow error not sub-pixel: {schw} {kerr}")
    report("accuracy", card=card, probes=int(len(idx)),
           max_escape_error=float(err.max()),
           median_escape_error=float(np.median(err)),
           exit_step_flips=int((np.asarray(ns) != g["n_steps"]).sum()),
           schwarzschild_px_err=schw["px_err"],
           kerr_px_err_max=kerr["px_err_max"])


def phase_kernel(card, size=400, steps=200_000):
    import jax.numpy as jnp
    import numpy as np

    from grtrace.engine import validate
    from grtrace.engine.integrate import integrate_batch_compensated
    from grtrace.engine.integrate_pallas import (UNROLL,
                                                 integrate_batch_pallas)
    from grtrace.physics.camera import camera_rays

    par = validate.kernel_parity(size=size, steps=steps)
    if par["status_mismatch_outside_band"]:
        raise AssertionError(f"kernel/XLA status mismatch: {par}")
    if par["max_escape_angle_delta_outside_band"] > 1e-5:
        raise AssertionError(f"kernel/XLA escape angles differ: {par}")
    f32 = jnp.float32
    q0, p0, *_ = camera_rays(jnp.asarray([30.0, 0.0, 0.0], f32),
                             f32(np.radians(80.0)), size, size,
                             mass_bh=1.0, dtype=f32)
    q0, p0 = q0.reshape(-1, 4), p0.reshape(-1, 4)
    args = (steps, f32(0.01), f32(2.0), f32(31.0), f32(1.0))
    _, k_cold, k_warm = timed(lambda: integrate_batch_pallas(
        q0, p0, *args, equatorial=True, compensated=True))
    _, x_cold, x_warm = timed(lambda: integrate_batch_compensated(
        q0, p0, *args))
    report("kernel", card=card, unroll=UNROLL, parity=par,
           kernel_warm_s=k_warm, xla_twin_warm_s=x_warm,
           kernel_cold_s=k_cold, xla_twin_cold_s=x_cold,
           speedup=x_warm / k_warm)


def phase_kerr(card, size=1024):
    import jax

    from grtrace import IntegratorConfig, SceneConfig, render

    scene = SceneConfig(size=size, metric="kerr", spin=0.9, background=None,
                        n_samples=0,
                        integrator=IntegratorConfig(steps=30_000,
                                                    delta=0.02))
    def run():
        res = render(scene)
        jax.block_until_ready(res.device("image"))
        return res

    res, cold, warm = timed(run, repeats=1)
    if res.counts["numerical_error"] != 0:
        raise AssertionError(f"kerr counts {res.counts}")
    report("kerr", card=card, counts=res.counts, cold_s=cold, warm_s=warm)


def phase_gpu_tests():
    import pytest
    os.environ["GRTRACE_TEST_ON_DEVICE"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "--rootdir", ROOT,
                      os.path.join(ROOT, "tests", "test_gpu_kernel.py")])
    if rc != 0:
        raise AssertionError(f"gpu tests failed (pytest exit {rc})")
    report("gpu-tests", pytest_exit=int(rc))


def phase_four_gpus(card, devs, size=256, frames=8, steps=50_000):
    """The sharded paths users run (cli/orbit.py, cli/line_grid.py,
    cli/fit_line.py build make_mesh over every device), each against the
    same work on a one-device mesh."""
    import jax.numpy as jnp
    import numpy as np

    from grtrace.engine.integrate import impact_parameter
    from grtrace.io.scene import SceneConfig
    from grtrace.physics.camera import camera_rays
    from grtrace.sharding.grid import line_profile_grid_sharded
    from grtrace.sharding.mesh import (make_mesh, orbit_frames,
                                       render_frames_sharded)

    mesh4 = make_mesh(1, 4, devices=devs[:4])
    mesh1 = make_mesh(1, 1, devices=devs[:1])
    scene = SceneConfig(size=size, background=None, n_samples=0)
    obs, phis = orbit_frames(scene, frames)

    def frames_on(mesh):
        return render_frames_sharded(
            mesh, jnp.zeros((1, 1, 3), jnp.uint8), obs.astype(np.float32),
            np.float32(np.radians(80.0)), 1.0, 31.0, steps, 0.02, 1.0,
            np.pi / 2, phis.astype(np.float32), np.pi, 2 * np.pi,
            height=size, width=size, has_background=False, backend="auto")

    out4, cold4, warm4 = timed(lambda: frames_on(mesh4), repeats=1)
    out1, cold1, warm1 = timed(lambda: frames_on(mesh1), repeats=1)
    for name, arr in out4.items():
        shards = arr.addressable_shards
        if len({s.device for s in shards}) != 4 or any(
                s.data.size >= arr.size for s in shards):
            raise AssertionError(f"{name} is not spread over 4 devices: "
                                 f"{arr.sharding}")
    _, p0, *_ = camera_rays(jnp.asarray([30.0, 0.0, 0.0], jnp.float32),
                            jnp.float32(np.radians(80.0)), size, size,
                            mass_bh=1.0, dtype=jnp.float32)
    b = np.asarray(impact_parameter(p0))
    band = np.abs(b - 3.0 * np.sqrt(3.0)) / (3.0 * np.sqrt(3.0)) < 5e-3
    diff = np.asarray(out4["cls"]) != np.asarray(out1["cls"])
    if (diff & ~band[None]).any():
        raise AssertionError(f"{int((diff & ~band[None]).sum())} pixel "
                             "classes differ outside the near-critical band")

    spins = np.array([0.0, 0.5, 0.9, 0.998])
    elevs = np.deg2rad(90.0 - np.array([30.0, 45.0, 60.0, 75.0]))

    def grid_on(mesh):
        return line_profile_grid_sharded(
            mesh, spins, elevs, 30.0, np.deg2rad(80.0), 1.0, 0.0, 31.0,
            12_000, 0.03, 1.0, 14.0, height=128, width=128)

    h4, gcold4, gwarm4 = timed(lambda: grid_on(mesh4), repeats=1)
    h1, _, gwarm1 = timed(lambda: grid_on(mesh1), repeats=1)
    h4, h1 = np.asarray(h4, np.float64), np.asarray(h1, np.float64)
    rel = float(np.abs(h4 - h1).max() / np.abs(h1).max())
    if rel > 1e-6:
        raise AssertionError(f"line-profile histograms differ by {rel:.2e}")
    report("four-gpus", card=card, frames=frames, size=size, steps=steps,
           class_diffs_in_band=int(diff.sum()),
           frames_warm_s_4=warm4, frames_warm_s_1=warm1,
           frames_cold_s_4=cold4, line_grid_rel_diff=rel,
           line_grid_warm_s_4=gwarm4, line_grid_warm_s_1=gwarm1)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-gpus", action="store_true",
                   help="run only the sharded paths, on four GPUs")
    args = p.parse_args(argv)
    n = 4 if args.four_gpus else 1

    devs, card = phase_device(n)
    import grtrace
    grtrace.enable_compilation_cache(allow_backend_init=True)
    os.makedirs(OUT, exist_ok=True)

    if args.four_gpus:
        phase_four_gpus(card, devs)
    else:
        phase_render(card)
        phase_accuracy(card)
        phase_kernel(card)
        phase_kerr(card)
        phase_gpu_tests()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()

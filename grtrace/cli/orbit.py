"""Camera-orbit animation driver — multi-frame rendering with sharding and
per-frame checkpoint/resume.

The reference renders exactly one static view; this driver covers the
multi-frame camera-orbit animation with frames sharded across a device
mesh.  Orbiting in the equatorial plane
is, by spherical symmetry, a rotation of the background patch center
(sharding/mesh.orbit_frames), so every frame reuses one compiled render.
--metric kerr (with --spin/--charge) orbits the Kerr-Newman family: the
equatorial orbit is about the spin axis, so axisymmetry keeps the trick
exact (sharding/mesh.render_kerr_sharded).  --disk orbits the thin
accretion-disk scene (also axisymmetric, so still exact) with the
inclined look-at camera (sharding/mesh.render_disk_sharded).

Checkpoint/resume: each completed frame is an on-disk PNG; a killed job
rerun with the same --out-dir resumes after the last completed frame (the
engine-level resumable-state story lives in engine/checkpoint.py).

Run: python -m grtrace.cli.orbit --frames 32 --size 256 [flags]
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description="camera-orbit animation")
    p.add_argument('--frames', type=int, default=16)
    p.add_argument('--size', type=int, default=256)
    p.add_argument('--fov', type=float, default=80.0)
    p.add_argument('--steps', type=int, default=50_000)
    p.add_argument('--delta', type=float, default=0.02)
    p.add_argument('--background', type=str, default=None)
    p.add_argument('--bh-mass', type=float, default=1.0)
    p.add_argument('--boundary-radius', type=float, default=31.0)
    p.add_argument('--observer-distance', type=float, default=30.0)
    p.add_argument('--bg-patch-size-theta', type=float, default=180.0)
    p.add_argument('--bg-patch-size-phi', type=float, default=350.0)
    p.add_argument('--metric', type=str, default='schwarzschild',
                   choices=['schwarzschild', 'kerr'],
                   help='kerr orbits stay exact: equatorial orbits about '
                        'the spin axis are the axisymmetry family')
    p.add_argument('--spin', type=float, default=0.0)
    p.add_argument('--charge', type=float, default=0.0)
    p.add_argument('--backend', type=str, default='auto')
    p.add_argument('--disk', action='store_true',
                   help='orbit the thin accretion disk scene (engine.disk; '
                        'axisymmetric, so the patch-rotation trick stays '
                        'exact with the inclined camera)')
    p.add_argument('--disk-elevation', type=float, default=12.0,
                   help='camera elevation above the disk plane (deg)')
    p.add_argument('--disk-r-out', type=float, default=14.0)
    p.add_argument('--camera-omega', type=str, default=None,
                   metavar='W|keplerian|zamo',
                   help='orbit with a camera on a circular worldline '
                        '(exact tetrad aberration + Doppler; disk mode '
                        'only — see cli.main)')
    p.add_argument('--disk-profile', choices=('shakura', 'novikov'),
                   default='shakura',
                   help='radial temperature law (engine.disk)')
    p.add_argument('--out-dir', type=str, default='orbit_out')
    p.add_argument('--gif', action='store_true',
                   help='also write orbit.gif')
    p.add_argument('--frames-per-batch', type=int, default=None,
                   help='frames rendered per device call (default: sized '
                        'to ~4M rays per call, 1..16 — batching frames '
                        'amortizes the fixed per-execution host-device '
                        'round trip)')
    p.add_argument('--bench', action='store_true',
                   help='after rendering, re-render every frame timed '
                        '(compile already warm) and print one JSON line '
                        'with steady-state frames/s')
    p.add_argument('--out-json', type=str, default=None,
                   help='with --bench: also write the JSON line here')
    args = p.parse_args(argv)
    from . import driver_startup
    driver_startup()

    # same physics validation as the main CLI (cli/args.py)
    if args.spin and args.metric != 'kerr':
        raise SystemExit("--spin requires --metric kerr")
    if args.spin ** 2 + args.charge ** 2 > args.bh_mass ** 2:
        raise SystemExit("naked singularity: need a^2 + Q^2 <= M^2")

    import jax
    import jax.numpy as jnp
    from .. import IntegratorConfig, PatchConfig, SceneConfig
    from ..io import artifacts
    from ..sharding.mesh import make_mesh, orbit_frames, render_frames_sharded

    scene = SceneConfig(
        size=args.size, fov_deg=args.fov, background=args.background,
        bh_mass=args.bh_mass, boundary_radius=args.boundary_radius,
        observer_distance=args.observer_distance,
        integrator=IntegratorConfig(steps=args.steps, delta=args.delta,
                                    omega=1.0, backend=args.backend),
        patch=PatchConfig(
            size_theta=float(np.deg2rad(args.bg_patch_size_theta)),
            size_phi=float(np.deg2rad(args.bg_patch_size_phi))))

    if artifacts.background_available(args.background):
        bg = artifacts.load_background(args.background,
                                      size=(args.size, args.size))
    else:
        from ..io import textures
        bg = textures.starfield(args.size, args.size)

    n_dev = len(jax.devices())
    mesh = make_mesh(1, n_dev)  # rays across all chips; frames batched in time
    obs, phis = orbit_frames(scene, args.frames)

    frames_dir = os.path.join(args.out_dir, "frames")
    os.makedirs(frames_dir, exist_ok=True)

    # resume: skip frames whose PNG already exists and is non-empty
    def _frame_ok(k):
        fp = os.path.join(frames_dir, f"frame_{k:04d}.png")
        return os.path.exists(fp) and os.path.getsize(fp) > 0

    done = {k for k in range(args.frames) if _frame_ok(k)}
    todo = [k for k in range(args.frames) if k not in done]
    if done:
        print(f"resuming: {len(done)} frames already rendered")

    kerr = args.metric == 'kerr' or args.charge != 0.0
    if kerr:
        from ..sharding.mesh import render_kerr_sharded
    if args.disk:
        from ..physics.orbits import isco_radius
        from ..sharding.mesh import render_disk_sharded
        disk_r_in = float(isco_radius(args.bh_mass, args.spin))
    cam_moving, cam_omega = False, 0.0
    if args.camera_omega is not None:
        if not args.disk:
            raise SystemExit("--camera-omega requires --disk")
        import dataclasses

        from ..engine.disk import DiskConfig, resolve_camera_omega
        spec = args.camera_omega
        if spec not in ('keplerian', 'zamo'):
            try:
                spec = float(spec)
            except ValueError:
                raise SystemExit(f"--camera-omega must be a number, "
                                 f"'keplerian' or 'zamo', got {spec!r}")
        # orbit's SceneConfig deliberately omits spin/charge (they are
        # threaded straight into the render calls) — the worldline must
        # still be resolved in the RIGHT spacetime
        cam_scene = dataclasses.replace(scene, metric='kerr',
                                        spin=args.spin,
                                        charge=args.charge)
        cam_moving, cam_omega = resolve_camera_omega(
            cam_scene, DiskConfig(r_out=args.disk_r_out,
                                  elevation_deg=args.disk_elevation,
                                  camera_omega=spec))
        print(f"camera worldline: omega = {cam_omega:.6g} "
              f"({args.camera_omega})")

    fx = mesh.shape["frames"]
    default_batch = min(16, max(1, 4_000_000 // (args.size * args.size)))
    # keep the batch a multiple of the mesh frames-axis extent
    default_batch = max(fx, (default_batch // fx) * fx)
    batch = args.frames_per_batch or default_batch
    if batch <= 0:
        raise SystemExit("--frames-per-batch must be >= 1")
    bg_dev = jnp.asarray(bg, jnp.uint8)

    def render_batch(ks, obs_batch):
        if args.disk:
            return render_disk_sharded(
                mesh, bg_dev,
                obs_batch, np.float32(scene.fov), scene.bh_mass,
                args.spin, scene.boundary_radius, args.steps, args.delta,
                1.0, float(np.deg2rad(args.disk_elevation)),
                disk_r_in, args.disk_r_out, 9000.0, 2.5,
                np.pi / 2, phis[ks],
                scene.patch.size_theta, scene.patch.size_phi,
                np.float32(cam_omega),
                height=args.size, width=args.size,
                charge=args.charge, profile=args.disk_profile, camera_moving=cam_moving)
        if kerr:
            return render_kerr_sharded(
                mesh, bg_dev,
                obs_batch, np.float32(scene.fov), scene.bh_mass,
                args.spin, scene.boundary_radius, args.steps, args.delta,
                1.0, np.pi / 2, phis[ks],
                scene.patch.size_theta, scene.patch.size_phi,
                height=args.size, width=args.size, charge=args.charge)
        return render_frames_sharded(
            mesh, bg_dev,
            obs_batch, np.float32(scene.fov), scene.bh_mass,
            scene.boundary_radius, args.steps, args.delta, 1.0,
            np.pi / 2, phis[ks],
            scene.patch.size_theta, scene.patch.size_phi,
            height=args.size, width=args.size,
            backend=args.backend)

    for start in range(0, len(todo), batch):
        ks = todo[start:start + batch]
        out = render_batch(ks, obs[ks])
        imgs = np.asarray(out["image"])
        for j, k in enumerate(ks):
            artifacts.save_image(
                imgs[j], os.path.join(frames_dir, f"frame_{k:04d}.png"))
        print(f"rendered frames {ks}")

    if args.bench:
        import json
        import time
        # warm every batch shape explicitly: with a resumed/complete
        # out-dir the loop above rendered few or no frames, and the
        # compile must not land inside the timed loop
        for start in range(0, args.frames, batch):
            ks = list(range(start, min(start + batch, args.frames)))
            np.asarray(render_batch(ks, obs[ks])["image"])
        t0 = time.time()
        n_done = 0
        for start in range(0, args.frames, batch):
            ks = list(range(start, min(start + batch, args.frames)))
            np.asarray(render_batch(ks, obs[ks])["image"])
            n_done += len(ks)
        t = time.time() - t0
        fps = n_done / t
        # vs_baseline scales the 1 s / 400^2 render target by ray
        # count: target frame rate = (400/size)^2 fps
        target_fps = (400.0 / args.size) ** 2
        line = json.dumps({
            "metric": f"orbit_{args.size}_frames_per_s",
            "value": round(fps, 2),
            "unit": "frames/s",
            "vs_baseline": round(fps / target_fps, 2),
            "frames": args.frames, "steps_budget": args.steps,
            "metric_family": args.metric, "spin": args.spin,
            "disk": args.disk,
            "frames_per_batch": batch, "wall_s": round(t, 3),
        })
        print(line)
        if args.out_json:
            with open(args.out_json, "w") as f:
                f.write(line + "\n")

    if args.gif:
        from PIL import Image
        frames = [Image.open(os.path.join(frames_dir, f"frame_{k:04d}.png"))
                  for k in range(args.frames)]
        gif_path = os.path.join(args.out_dir, "orbit.gif")
        frames[0].save(gif_path, save_all=True, append_images=frames[1:],
                       duration=80, loop=0)
        print(f"wrote {gif_path}")
    return frames_dir


def console(argv=None):
    main(argv)
    return 0


if __name__ == "__main__":
    main()

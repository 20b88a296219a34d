"""Semi-analytic renders + on-demand parity vs the traced engine.

    python -m grtrace.cli.exact --spin 0.9 --size 256 --elevation 25
    python -m grtrace.cli.exact --spin 0.7 --size 48 --compare
    python -m grtrace.cli.exact --spin 0.9 --size 256 --background

No integration: every pixel's equatorial crossings come from the
separated-Hamiltonian quadrature (physics/geodesic_exact.py), shaded
with the same Killing-constant physics as the traced disk pipeline.
``--background`` switches to the lensed-sky scene (the reference's
actual product, simulation/raytracing.py:219-246) rendered from exact
boundary-sphere escape records — the shadow boundary is analytic at any
resolution.  ``--compare`` re-renders the scene with the traced engine
and reports the per-pixel parity (mask/class agreement, max/median
deltas) — the user-facing version of tests/test_render_exact.py.

No reference counterpart for the solver (the reference has neither a
disk nor any non-stepping path; simulation/raytracing.py).
"""
from __future__ import annotations

import argparse
import json
import os
import time


def main(argv=None):
    p = argparse.ArgumentParser(
        description="semi-analytic (no-stepping) thin-disk render")
    p.add_argument('--size', type=int, default=256)
    p.add_argument('--fov', type=float, default=80.0)
    p.add_argument('--spin', type=float, default=0.0)
    p.add_argument('--charge', type=float, default=0.0)
    p.add_argument('--elevation', type=float, default=25.0)
    p.add_argument('--orders', type=int, default=3)
    p.add_argument('--r-in', type=float, default=None)
    p.add_argument('--r-out', type=float, default=14.0)
    p.add_argument('--profile', choices=('shakura', 'novikov'),
                   default='shakura')
    p.add_argument('--retrograde', action='store_true')
    p.add_argument('--t-peak', type=float, default=9000.0)
    p.add_argument('--background', action='store_true',
                   help='render the lensed background sky (no disk) '
                        'from exact escape records')
    p.add_argument('--bg', type=str, default='procedural:checker',
                   help='background texture for --background '
                        '(procedural:<name> spec or image path)')
    p.add_argument('--compare', action='store_true',
                   help='also run the traced disk engine and report '
                        'pixel parity (slow: it integrates)')
    p.add_argument('--steps', type=int, default=20_000,
                   help='traced-engine budget for --compare')
    p.add_argument('--delta', type=float, default=0.02)
    p.add_argument('--out-dir', type=str, default='.')
    p.add_argument('--platform', type=str, default='default',
                   choices=['cpu', 'default'],
                   help='force the CPU backend (the exact solver is '
                        'float64 quadrature)')
    args = p.parse_args(argv)
    if args.spin ** 2 + args.charge ** 2 > 1.0:
        raise SystemExit("naked singularity: need a^2 + Q^2 <= M^2")

    import jax
    if args.platform == 'cpu':
        jax.config.update('jax_platforms', 'cpu')
    # the exact solver is float64 quadrature (turning-point bisections
    # underflow the f32 guards); without x64 its float64 requests would
    # silently downcast
    jax.config.update('jax_enable_x64', True)
    from . import driver_startup
    driver_startup()

    import numpy as np

    from .. import IntegratorConfig, PatchConfig, SceneConfig
    from ..engine.disk import DiskConfig
    from ..engine.render_exact import render_disk_exact
    from ..io import artifacts

    scene = SceneConfig(
        size=args.size, fov_deg=args.fov, metric='kerr', spin=args.spin,
        charge=args.charge, n_samples=0,
        integrator=IntegratorConfig(steps=args.steps, delta=args.delta),
        patch=PatchConfig())

    if args.background:
        return _background_mode(args, scene)
    disk = DiskConfig(r_in=args.r_in, r_out=args.r_out,
                      prograde=not args.retrograde, profile=args.profile,
                      elevation_deg=args.elevation,
                      show_background=False, t_peak=args.t_peak)

    t0 = time.time()
    out = render_disk_exact(scene, disk, n_orders=args.orders)
    dt = time.time() - t0

    os.makedirs(args.out_dir, exist_ok=True)
    artifacts.save_image(out["image_u8"],
                         os.path.join(args.out_dir, "exact_disk.png"))
    hw = out["shape"]
    g = np.asarray(out["g"]).reshape(hw)
    r_em = np.asarray(out["r_em"]).reshape(hw)
    order = np.asarray(out["order"]).reshape(hw)
    np.savetxt(os.path.join(args.out_dir, "exact_g_map.csv"), g,
               delimiter=",")
    np.savetxt(os.path.join(args.out_dir, "exact_r_em.csv"), r_em,
               delimiter=",")

    mask = g > 0.0
    per_order = [int((order == k).sum()) for k in range(args.orders)]
    metrics = {
        "size": args.size,
        "spin": args.spin,
        "charge": args.charge,
        "orders": args.orders,
        "disk_pixels": int(mask.sum()),
        "pixels_per_order": per_order,
        "g_min": float(g[mask].min()) if mask.any() else None,
        "g_max": float(g[mask].max()) if mask.any() else None,
        "render_s": round(dt, 3),
        "files": 3,
    }

    if args.compare:
        from ..engine.disk import render_disk
        t0 = time.time()
        res = render_disk(scene, disk)
        t_traced = time.time() - t0
        g_tr = np.asarray(res.device("redshift")).reshape(hw)
        m_tr = np.asarray(res.device("cls")).reshape(hw) == 5  # CLS_DISK
        both = mask & m_tr
        dg = np.abs(g_tr[both] - g[both]) if both.any() else np.array(
            [0.0])
        metrics |= {
            "traced_disk_pixels": int(m_tr.sum()),
            "mask_mismatch_pixels": int((mask ^ m_tr).sum()),
            "dg_max": float(dg.max()),
            "dg_median": float(np.median(dg)),
            "traced_render_s": round(t_traced, 3),
        }

    print(json.dumps(metrics))
    return metrics


def _background_mode(args, scene):
    """Exact lensed-sky render (+ optional traced parity report)."""
    import jax.numpy as jnp
    import numpy as np

    from ..engine.render_exact import render_pixels_background_exact
    from ..io import artifacts
    from ..io.textures import from_spec, is_procedural

    bg_np = (from_spec(args.bg) if is_procedural(args.bg)
             else artifacts.load_background(args.bg,
                                            size=(args.size, args.size)))
    bg = jnp.asarray(bg_np, jnp.uint8)
    pa = scene.patch
    common = dict(
        obs_x=jnp.float64(scene.observer_distance),
        fov=jnp.float64(np.deg2rad(args.fov)),
        mass=jnp.float64(scene.bh_mass), spin=jnp.float64(args.spin),
        boundary_radius=jnp.float64(scene.boundary_radius),
        patch_center_theta=jnp.float64(pa.center_theta),
        patch_center_phi=jnp.float64(pa.center_phi),
        patch_size_theta=jnp.float64(pa.size_theta),
        patch_size_phi=jnp.float64(pa.size_phi))

    t0 = time.time()
    out = render_pixels_background_exact(
        bg, charge=args.charge, height=args.size, width=args.size,
        flip_theta=pa.flip_theta, flip_phi=pa.flip_phi, **common)
    img = np.asarray(out["image"])
    dt = time.time() - t0

    os.makedirs(args.out_dir, exist_ok=True)
    artifacts.save_image(img, os.path.join(args.out_dir, "exact_bg.png"))
    cv = np.asarray(out["count_vec"])
    metrics = {
        "size": args.size, "spin": args.spin, "charge": args.charge,
        "captured": int(cv[0]), "escaped": int(cv[2]),
        "background": int(cv[3]), "render_s": round(dt, 3),
    }

    if args.compare:
        from ..engine.render_generic import render_pixels_generic
        t0 = time.time()
        gen = render_pixels_generic(
            bg, common["obs_x"], common["fov"], common["mass"],
            common["spin"], common["boundary_radius"], args.steps,
            jnp.float64(args.delta), jnp.float64(0.0),
            common["patch_center_theta"], common["patch_center_phi"],
            common["patch_size_theta"], common["patch_size_phi"],
            height=args.size, width=args.size,
            flip_theta=pa.flip_theta, flip_phi=pa.flip_phi,
            dtype=jnp.float64, metric="KerrSchild", order=2,
            charge=jnp.float64(args.charge))
        img_g = np.asarray(gen["image"])
        t_traced = time.time() - t0
        cls_mismatch = int((np.asarray(gen["cls"])
                            != np.asarray(out["cls"])).sum())
        qg, qe = np.asarray(gen["final_q"]), np.asarray(out["final_q"])
        esc = ((np.asarray(gen["status"]) == 2)
               & (np.asarray(out["status"]) == 2))
        dth = np.abs(qg[..., 2] - qe[..., 2])[esc]
        dph = np.abs(np.mod(qg[..., 3] - qe[..., 3] + np.pi,
                            2 * np.pi) - np.pi)[esc]
        metrics |= {
            "cls_mismatch_pixels": cls_mismatch,
            "dtheta_median": float(np.median(dth)) if esc.any() else None,
            "dphi_median": float(np.median(dph)) if esc.any() else None,
            "image_pixels_differing": int(
                (np.abs(img_g.astype(int) - img.astype(int))
                 .max(axis=-1) > 0).sum()),
            "traced_render_s": round(t_traced, 3),
        }

    print(json.dumps(metrics))
    return metrics


def console(argv=None):
    main(argv)
    return 0


if __name__ == "__main__":
    main()

"""Strong-lensing image finder: solve the lens equation for a source.

    python -m grtrace.cli.images --source-theta 95 --source-phi 166 \
        --spin 0.9 --windings -1 0 1

Given a source direction on the celestial sphere (degrees, the
background texture's frame), finds every lensed image in the camera
plane — primary, parity-flipped secondary, photon-ring orders — by
damped Newton on the DIFFERENTIABLE semi-analytic escape map
(engine/images.py): no rendering, no integration, exact Jacobians.
Prints one JSON line with the image table (fractional pixel positions
in the --size frame, signed magnifications) and optionally marks the
images on a rendered background (--overlay).

No reference counterpart (the reference never inverts its lens map;
simulation/raytracing.py).
"""
from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    p = argparse.ArgumentParser(
        description="strong-lensing multiple-image finder")
    p.add_argument('--source-theta', type=float, required=True,
                   help='source polar angle, degrees')
    p.add_argument('--source-phi', type=float, required=True,
                   help='source azimuth, degrees')
    p.add_argument('--size', type=int, default=256)
    p.add_argument('--fov', type=float, default=80.0)
    p.add_argument('--spin', type=float, default=0.0)
    p.add_argument('--charge', type=float, default=0.0)
    p.add_argument('--windings', type=int, nargs='+', default=[-1, 0, 1])
    p.add_argument('--scan', type=int, default=96,
                   help='seed-scan resolution (raise to catch '
                        'higher-order images hugging the shadow)')
    p.add_argument('--tol', type=float, default=1e-8)
    p.add_argument('--overlay', action='store_true',
                   help='also render the lensed sky (exact renderer) '
                        'and mark each image')
    p.add_argument('--platform', type=str, default='cpu',
                   choices=['cpu', 'default'],
                   help='the exact solver is float64 quadrature; CPU '
                        'is its native backend, so cpu is the default '
                        'here')
    p.add_argument('--out-dir', type=str, default='.')
    args = p.parse_args(argv)
    if args.spin ** 2 + args.charge ** 2 > 1.0:
        raise SystemExit("naked singularity: need a^2 + Q^2 <= M^2")

    import jax
    if args.platform == 'cpu':
        # must precede backend init
        jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    from . import driver_startup
    driver_startup()
    import numpy as np

    from ..engine.images import find_images

    th_s = np.deg2rad(args.source_theta)
    ph_s = np.deg2rad(args.source_phi)
    ph_s = np.mod(ph_s + np.pi, 2 * np.pi) - np.pi
    imgs = find_images(
        th_s, ph_s, params=[1.0, args.spin, args.charge],
        fov=np.deg2rad(args.fov), height=args.size, width=args.size,
        scan=args.scan, windings=tuple(args.windings), tol=args.tol)

    metrics = {
        "source_theta_deg": args.source_theta,
        "source_phi_deg": args.source_phi,
        "spin": args.spin, "charge": args.charge, "size": args.size,
        "n_found": sum(im["converged"] for im in imgs),
        "images": imgs,
    }

    if args.overlay:
        import jax.numpy as jnp

        from ..engine.render_exact import render_pixels_background_exact
        from ..io import artifacts
        from ..io.textures import checker

        bg = jnp.asarray(checker(64, 128), jnp.uint8)
        out = render_pixels_background_exact(
            bg, jnp.float64(30.0), jnp.float64(np.deg2rad(args.fov)),
            jnp.float64(1.0), jnp.float64(args.spin), jnp.float64(31.0),
            jnp.float64(np.pi / 2), jnp.float64(np.pi),
            jnp.float64(2 * np.pi), jnp.float64(2 * np.pi),
            height=args.size, width=args.size, charge=args.charge)
        img = np.asarray(out["image"]).reshape(args.size, args.size, 3)
        img = np.array(img)
        for im in imgs:
            if not im["converged"]:
                continue
            i0, j0 = int(round(im["i"])), int(round(im["j"]))
            s = max(2, args.size // 64)
            lo_i = max(0, i0 - s)
            hi_i = min(args.size, i0 + s + 1)
            lo_j = max(0, j0 - s)
            hi_j = min(args.size, j0 + s + 1)
            img[lo_i:hi_i, j0:j0 + 1] = (255, 40, 40)
            img[i0:i0 + 1, lo_j:hi_j] = (255, 40, 40)
        os.makedirs(args.out_dir, exist_ok=True)
        path = os.path.join(args.out_dir, "images_overlay.png")
        artifacts.save_image(img, path)
        metrics["overlay"] = path

    print(json.dumps(metrics))
    return metrics


def console(argv=None):
    main(argv)
    return 0


if __name__ == "__main__":
    main()

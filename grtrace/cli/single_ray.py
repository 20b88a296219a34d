"""Single-ray diagnostic driver — the single_ray_cuda_test.py analog.

Integrates ONE null geodesic with full trajectory capture, truncates at
horizon capture, exports the CSV and the 4-panel lambda-coloured figure
(parity: reference single_ray_cuda_test.py:248-321; same hard-coded default
momentum, 200k steps, delta=0.03, omega=0.01, r_max=50, observer at r=35).

Run: python -m grtrace.cli.single_ray [--alpha-deg A] [--beta-deg B] [--b IMPACT]
"""
from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description="Single-ray geodesic diagnostic")
    p.add_argument("--mass", type=float, default=1.0)
    p.add_argument("--r-obs", type=float, default=35.0)
    p.add_argument("--r-max", type=float, default=50.0)
    p.add_argument("--steps", type=int, default=200_000)
    p.add_argument("--delta", type=float, default=0.03)
    p.add_argument("--omega", type=float, default=0.01)
    p.add_argument("--alpha-deg", type=float, default=None,
                   help="camera angle toward +y (deg)")
    p.add_argument("--beta-deg", type=float, default=0.0,
                   help="camera angle toward +z (deg)")
    p.add_argument("--b", type=float, default=None,
                   help="impact parameter; overrides --alpha-deg via "
                        "sin(a) = b/(r0 sqrt(1-2M/r0))")
    p.add_argument("--out-csv", type=str, default="single_ray_test.csv")
    p.add_argument("--out-png", type=str, default="single_ray_test.png")
    p.add_argument("--plot-step", type=int, default=1000)
    p.add_argument("--platform", type=str, default="cpu",
                   choices=["cpu", "default"],
                   help="single-ray float64 diagnostics default to CPU "
                        "(a 1-ray job cannot use an accelerator)")
    args = p.parse_args(argv)

    import jax
    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)  # float64 diagnostics
    from . import driver_startup
    driver_startup()
    import jax.numpy as jnp
    from ..engine.integrate import integrate_batch_full
    from ..io.artifacts import save_single_ray_csv
    from ..physics.camera import angles_to_p_sph
    from ..physics.nullcond import build_null_4momentum
    from ..viz.plots import alpha_from_b, plot_geodesic

    pos_sph = np.array([args.r_obs, np.pi / 2, 0.0])

    if args.b is not None:
        alpha = alpha_from_b(args.b, args.r_obs, args.mass)
        beta = np.deg2rad(args.beta_deg)
        p_dir = np.asarray(angles_to_p_sph(alpha, beta, args.r_obs,
                                           mass_bh=args.mass))
    elif args.alpha_deg is not None:
        alpha = np.deg2rad(args.alpha_deg)
        beta = np.deg2rad(args.beta_deg)
        p_dir = np.asarray(angles_to_p_sph(alpha, beta, args.r_obs,
                                           mass_bh=args.mass))
    else:
        # the reference's hard-coded diagnostic direction
        # (single_ray_cuda_test.py:278)
        p_dir = np.array([-0.026942690335328513, -0.028502831807219468,
                          0.06898831276132347])

    print("Spherical position:", pos_sph)
    print("Spherical direction:", p_dir)
    p0 = np.asarray(build_null_4momentum(jnp.asarray(p_dir),
                                         jnp.asarray(pos_sph),
                                         mass_bh=args.mass, future=True))
    print("Null 4-momentum:", p0)
    q0 = np.array([0.0, *pos_sph])

    print("Starting integration")
    traj = np.asarray(integrate_batch_full(
        jnp.asarray(q0[None, :], jnp.float64),
        jnp.asarray(p0[None, :], jnp.float64),
        args.steps, args.delta, 2.0 * args.mass, args.r_max,
        args.omega))[0]
    print("Integration complete")
    print(f"Trajectory length: {len(traj)} steps")

    # truncate at horizon capture (single_ray_cuda_test.py:307-310)
    rs = 2.0 * args.mass
    safe = traj[:, 1] > 1.1 * rs
    if not np.all(safe):
        traj = traj[: np.argmax(~safe)]
    print(f"Safe trajectory length: {len(traj)} steps")

    print("Drawing trajectory plots...")
    plot_geodesic(traj, mass_bh=args.mass, step=max(1, args.plot_step),
                  out_path=args.out_png)
    save_single_ray_csv(traj, args.out_csv)
    print(f"Saved {args.out_csv}")
    return traj


def console(argv=None):
    """setuptools console-script entry (must not return a value — sys.exit
    would print it and exit non-zero)."""
    main(argv)
    return 0


if __name__ == "__main__":
    main()

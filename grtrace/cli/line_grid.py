"""Spin x inclination line-profile grid sweep — the iron-line spin-fitting
forward model, one SPMD program over the device mesh.

    python -m grtrace.cli.line_grid --spins 0 0.5 0.9 0.998 \
        --inclinations 15 35 55 75 --size 256 --emissivity 3

Every (spin, inclination) grid point is an independent disk trace; points
ride the mesh's 'frames' axis, rays its 'rays' axis, and the whole sweep
returns only the F x Q x B histogram lattice (sharding/grid.py) — no
images cross the wire.  Inclinations follow the X-ray convention
(degrees from the disk NORMAL: 0 = face-on, 90 = edge-on); the engine's
camera elevation above the plane is its complement.

Writes line_grid.csv (long format: spin, inclination_deg, q, g, flux —
normalized per profile) and line_grid.png (profile matrix: one panel per
spin, one curve per inclination).

No reference counterpart (the reference has no disk and no sweeps).
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(
        description="relativistic line-profile (spin x inclination) grid")
    p.add_argument('--spins', type=float, nargs='+',
                   default=[0.0, 0.5, 0.9, 0.998])
    p.add_argument('--inclinations', type=float, nargs='+',
                   default=[15.0, 35.0, 55.0, 75.0],
                   help='degrees from the disk normal (0 face-on)')
    p.add_argument('--size', type=int, default=256)
    p.add_argument('--fov', type=float, default=80.0)
    p.add_argument('--steps', type=int, default=20_000)
    p.add_argument('--delta', type=float, default=0.02)
    p.add_argument('--bh-mass', type=float, default=1.0)
    p.add_argument('--charge', type=float, default=0.0)
    p.add_argument('--boundary-radius', type=float, default=31.0)
    p.add_argument('--observer-distance', type=float, default=30.0)
    p.add_argument('--disk-r-out', type=float, default=14.0)
    p.add_argument('--retrograde', action='store_true')
    p.add_argument('--emissivity', type=float, nargs='+', default=[3.0],
                   help='power-law indices q (I_em ~ r^-q); the geodesic '
                        'work is shared across all of them')
    p.add_argument('--bins', type=int, default=96)
    p.add_argument('--g-range', type=float, nargs=2, default=[0.1, 1.6],
                   metavar=('LO', 'HI'))
    p.add_argument('--order', type=int, default=2, choices=[2, 4, 6, 8])
    p.add_argument('--dtype', type=str, default='float32',
                   choices=['float32', 'float64'])
    p.add_argument('--mesh-frames', type=int, default=None,
                   help='frame shards (default: all devices on rays)')
    p.add_argument('--out-dir', type=str, default='.')
    p.add_argument('--no-plot', action='store_true')
    p.add_argument('--fisher', type=float, default=None, metavar='SIGMA',
                   help='also compute the sharded Fisher-forecast map: '
                        'per grid point the 1-sigma errors on (spin, '
                        'inclination) a line fit with per-bin noise SIGMA '
                        'would attain (forward-mode AD through the '
                        'geodesic integrator; float64)')
    p.add_argument('--bench', action='store_true',
                   help='print one JSON line: compile-warm sweep wall time')
    p.add_argument('--out-json', type=str, default=None)
    args = p.parse_args(argv)
    from . import driver_startup
    driver_startup()

    for a in args.spins:
        if a * a + args.charge ** 2 > args.bh_mass ** 2:
            raise SystemExit(f"naked singularity at spin {a}: need "
                             "a^2 + Q^2 <= M^2")
    if not all(0.0 <= i <= 90.0 for i in args.inclinations):
        raise SystemExit("--inclinations must lie in [0, 90] degrees")

    import numpy as np

    import jax.numpy as jnp

    from ..sharding.grid import g_bin_centers, line_profile_grid_sharded
    from ..sharding.mesh import make_mesh

    spins = np.repeat(args.spins, len(args.inclinations))
    incls = np.tile(args.inclinations, len(args.spins))
    elevs = np.deg2rad(90.0 - incls)          # engine: elevation above plane
    f = spins.size

    import jax
    n_dev = len(jax.devices())
    mf = args.mesh_frames or 1
    mesh = make_mesh(mf, n_dev // mf)
    dtype = jnp.float64 if args.dtype == 'float64' else jnp.float32
    q_tuple = tuple(float(q) for q in args.emissivity)
    g_lo, g_hi = (float(v) for v in args.g_range)

    def sweep(spin_arr, elev_arr):
        return np.asarray(line_profile_grid_sharded(
            mesh, spin_arr, elev_arr, args.observer_distance,
            np.deg2rad(args.fov), args.bh_mass, args.charge,
            args.boundary_radius, args.steps, args.delta, 1.0,
            args.disk_r_out, height=args.size, width=args.size,
            order=args.order, dtype=dtype,
            prograde=not args.retrograde, n_bins=args.bins,
            emissivity=q_tuple, g_lo=g_lo, g_hi=g_hi), np.float64)

    hist = sweep(spins, elevs)                         # (F, Q, B)
    centers = g_bin_centers(args.bins, g_lo, g_hi)

    os.makedirs(args.out_dir, exist_ok=True)
    rows = []
    for k in range(f):
        for iq, q in enumerate(q_tuple):
            prof = hist[k, iq]
            peak = prof.max()
            prof = prof / peak if peak > 0 else prof
            for g, fl in zip(centers, prof):
                rows.append((spins[k], incls[k], q, g, fl))
    np.savetxt(os.path.join(args.out_dir, "line_grid.csv"),
               np.array(rows), delimiter=",", comments="",
               header="spin,inclination_deg,q,g,relative_flux", fmt="%.8g")

    if not args.no_plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        uspins = list(dict.fromkeys(args.spins))
        uincl = list(dict.fromkeys(args.inclinations))
        fig, axes = plt.subplots(1, len(uspins),
                                 figsize=(3.4 * len(uspins), 3.2),
                                 sharey=True, squeeze=False)
        for c, a in enumerate(uspins):
            ax = axes[0, c]
            for i in uincl:
                k = np.flatnonzero((spins == a) & (incls == i))[0]
                prof = hist[k, 0]
                peak = prof.max()
                ax.plot(centers, prof / peak if peak > 0 else prof,
                        label=f"i = {i:g}°")
            ax.set_title(f"a = {a:g}")
            ax.set_xlabel("g = $E_{obs}/E_{em}$")
            if c == 0:
                ax.set_ylabel("relative flux")
                ax.legend(fontsize=8)
        fig.suptitle(f"relativistic line profiles "
                     f"($r^{{-{q_tuple[0]:g}}}$ emissivity)")
        fig.tight_layout()
        fig.savefig(os.path.join(args.out_dir, "line_grid.png"), dpi=110,
                    bbox_inches="tight")
        plt.close(fig)

    print(f"{f} grid points ({len(args.spins)} spins x "
          f"{len(args.inclinations)} inclinations), {len(q_tuple)} "
          f"emissivities, {args.bins} bins -> {args.out_dir}")

    if args.fisher is not None:
        # Fisher map over the same grid: grid points on 'frames', the
        # AD Jacobian through the full integrator per point.  Engine
        # elevation is the inclination complement, so the elevation
        # errors ARE the inclination errors and the correlation flips
        # sign with the convention (d elev = -d incl).
        from ..sharding.grid import fisher_grid_sharded

        fish = np.asarray(fisher_grid_sharded(
            mesh, spins, elevs, args.fisher, size=args.size,
            steps=args.steps, delta=args.delta, order=args.order,
            r_out=args.disk_r_out, obs_distance=args.observer_distance,
            fov=np.deg2rad(args.fov), mass=args.bh_mass,
            charge=args.charge, boundary_radius=args.boundary_radius,
            prograde=not args.retrograde,
            emissivity_index=q_tuple[0], n_bins=args.bins,
            g_lo=g_lo, g_hi=g_hi), np.float64)
        sig_a = fish[:, 0]
        sig_i = np.rad2deg(fish[:, 1])
        corr = -fish[:, 2]
        np.savetxt(os.path.join(args.out_dir, "fisher_grid.csv"),
                   np.column_stack([spins, incls, sig_a, sig_i, corr]),
                   delimiter=",", comments="",
                   header="spin,inclination_deg,sigma_spin,"
                          "sigma_inclination_deg,correlation_spin_incl",
                   fmt="%.8g")
        if not args.no_plot:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            ns, ni = len(args.spins), len(args.inclinations)
            ext = [min(args.inclinations), max(args.inclinations),
                   min(args.spins), max(args.spins)]
            fig, axes = plt.subplots(1, 3, figsize=(14, 3.8))
            panels = [(np.log10(sig_a), "log$_{10}$ $\\sigma$(spin)",
                       "viridis"),
                      (np.log10(sig_i), "log$_{10}$ $\\sigma$(incl) "
                       "[deg]", "viridis"),
                      (corr, "corr(spin, incl)", "coolwarm")]
            for ax, (z, title, cmap) in zip(axes, panels):
                kw = ({"vmin": -1, "vmax": 1} if cmap == "coolwarm"
                      else {})
                im = ax.imshow(z.reshape(ns, ni), origin="lower",
                               aspect="auto", extent=ext, cmap=cmap,
                               **kw)
                ax.set_xlabel("inclination (deg)")
                ax.set_ylabel("spin a")
                ax.set_title(title)
                fig.colorbar(im, ax=ax)
            fig.suptitle(f"Fisher forecast (per-bin noise "
                         f"$\\sigma$ = {args.fisher:g})")
            fig.tight_layout()
            fig.savefig(os.path.join(args.out_dir, "fisher_grid.png"),
                        dpi=110, bbox_inches="tight")
            plt.close(fig)
        print(f"fisher map: sigma(spin) {sig_a.min():.3g}..."
              f"{sig_a.max():.3g}, sigma(incl) {sig_i.min():.3g}..."
              f"{sig_i.max():.3g} deg -> fisher_grid.csv")

    if args.bench:
        import json
        import time

        t0 = time.time()
        reps = 3
        for i in range(reps):   # jittered spins defeat result caching
            sweep(spins + 1e-6 * (i + 1), elevs)
        dt = time.time() - t0
        pts_per_s = reps * f / dt
        line = json.dumps({
            "metric": f"line_grid_{args.size}_points_per_s",
            "value": round(pts_per_s, 3), "unit": "gridpoints/s",
            "vs_baseline": round(dt / reps, 4),
            "grid_points": int(f), "size": args.size,
            "steps": args.steps, "wall_s": round(dt, 4),
        })
        print(line)
        if args.out_json:
            with open(args.out_json, "w") as fjs:
                fjs.write(line + "\n")
    return args.out_dir


def console(argv=None):
    main(argv)
    return 0


if __name__ == "__main__":
    main()

"""Photon-ring subring driver: image orders rendered as separate layers.

    python -m grtrace.cli.subring --spin 0.9 --size 256 --orders 3

One transparent-disk geodesic pass (engine/subring.py) records the first
N equatorial-plane crossings per ray; the tool writes per-order intensity
maps, the crossing-count map, the n=0 vs n=1 subring delay map, a JSON
summary (flux ratios -> the Lyapunov demagnification exponent, median
inter-order delays -> the photon-shell half-period), and the composited
thin-disk image.  Prints one JSON metrics line.

No reference counterpart (the reference has no disk and renders only the
total background-lensing image — image orders are never separable there;
simulation/raytracing.py:164-280).
"""
from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    p = argparse.ArgumentParser(
        description="photon-ring subring (image-order) decomposition")
    p.add_argument('--size', type=int, default=256)
    p.add_argument('--fov', type=float, default=80.0)
    p.add_argument('--steps', type=int, default=30_000)
    p.add_argument('--delta', type=float, default=0.02)
    p.add_argument('--order', type=int, default=2,
                   help='FANTASY integrator order (2/4/6/8)')
    p.add_argument('--orders', type=int, default=3,
                   help='Number of image orders (crossing slots) to record')
    p.add_argument('--spin', type=float, default=0.0)
    p.add_argument('--charge', type=float, default=0.0)
    p.add_argument('--elevation', type=float, default=75.0,
                   help='Camera elevation above the disk plane (deg); '
                        'face-on views separate the orders most cleanly')
    p.add_argument('--r-out', type=float, default=14.0)
    p.add_argument('--r-in', type=float, default=None,
                   help='Disk inner edge (default: the prograde ISCO)')
    p.add_argument('--profile', choices=('shakura', 'novikov'),
                   default='shakura')
    p.add_argument('--retrograde', action='store_true')
    p.add_argument('--bfield', choices=('vertical', 'toroidal', 'radial'),
                   default=None,
                   help='Polarized imaging: per-order Walker-Penrose '
                        'EVPA maps + the order-to-order polarization '
                        'twist (subring_evpa_N.png, '
                        'evpa_twist_per_order_rad in the summary)')
    p.add_argument('--visibility', action='store_true',
                   help='Per-order u-v signatures: |V|(b) radial '
                        'profile, first null and thin-ring diameter '
                        'per image order (the interferometric subring '
                        'program) -> subring_visibility.csv + ring '
                        'diameters in the JSON')
    p.add_argument('--sed', action='store_true',
                   help='Disk continuum SED per image order '
                        '(engine.spectrum: Liouville + Planck collapse '
                        'spectral imaging into post-processing on the '
                        'intensity maps) -> subring_sed.csv/.png')
    p.add_argument('--t-peak', type=float, default=9000.0,
                   help='Disk display/SED temperature scale (kelvin)')
    p.add_argument('--aa', type=int, default=0, metavar='S',
                   help='Adaptive edge refinement: S^2 stratified '
                        'sub-rays through every layer-boundary pixel; '
                        'refines the displayed image AND the per-order '
                        'intensity maps (flux_per_order / gamma_hat '
                        'converge at a fraction of uniform '
                        'supersampling cost)')
    p.add_argument('--backend', choices=('auto', 'pallas', 'xla'),
                   default='auto',
                   help='Integrator backend (auto = the compensated '
                        'Kerr-Schild flows on a GPU, the autodiff engine '
                        'elsewhere)')
    p.add_argument('--out-dir', type=str, default='.')
    args = p.parse_args(argv)
    from . import driver_startup
    driver_startup()
    if args.spin ** 2 + args.charge ** 2 > 1.0:
        raise SystemExit("naked singularity: need a^2 + Q^2 <= M^2")

    from .. import IntegratorConfig, PatchConfig, SceneConfig
    from ..engine.disk import DiskConfig
    from ..engine.subring import render_subrings, save_subring_maps
    from ..io import artifacts

    scene = SceneConfig(
        size=args.size, fov_deg=args.fov, metric='kerr', spin=args.spin,
        charge=args.charge, n_samples=0,
        integrator=IntegratorConfig(steps=args.steps, delta=args.delta,
                                    order=args.order,
                                    backend=args.backend),
        patch=PatchConfig())
    disk = DiskConfig(r_in=args.r_in, r_out=args.r_out,
                      prograde=not args.retrograde, profile=args.profile,
                      elevation_deg=args.elevation, show_background=False,
                      bfield=args.bfield, t_peak=args.t_peak)
    result = render_subrings(scene, disk, n_orders=args.orders,
                             aa_samples=args.aa or None)

    os.makedirs(args.out_dir, exist_ok=True)
    artifacts.save_image(result["image"],
                         os.path.join(args.out_dir, "subring_composite.png"))
    written, summary = save_subring_maps(result, args.out_dir)

    if args.visibility:
        import numpy as np

        from ..engine.subring import subring_visibilities

        vis = subring_visibilities(result, float(np.deg2rad(args.fov)))
        pop = [v for v in vis if v["baselines"] is not None]
        if pop:
            cols, hdr = [pop[0]["baselines"]], "baseline_per_rad"
            for v in pop:
                cols.append(v["profile"])
                hdr += f",absV_order_{v['order']}"
            np.savetxt(os.path.join(args.out_dir,
                                    "subring_visibility.csv"),
                       np.column_stack(cols), delimiter=",",
                       header=hdr, comments="")
            written.append("subring_visibility.csv")
        metrics_vis = {
            "ring_diameter_rad_per_order": [v["ring_diameter_rad"]
                                            for v in vis],
            "b_null_per_order": [v["b_null"] for v in vis],
        }
    else:
        metrics_vis = {}

    if args.sed:
        import numpy as np

        from ..engine.spectrum import disk_sed

        nu, sed = disk_sed(result["intensity"], args.t_peak)
        rows = np.column_stack([nu, sed.T, sed.sum(axis=0)])
        hdr = "nu_hz," + ",".join(f"sed_order_{i}"
                                  for i in range(args.orders)) + ",total"
        csv = os.path.join(args.out_dir, "subring_sed.csv")
        np.savetxt(csv, rows, delimiter=",", header=hdr, comments="")
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(6, 4.2))
        for i in range(args.orders):
            if sed[i].max() > 0:
                ax.loglog(nu, sed[i], label=f"n={i}")
        ax.loglog(nu, sed.sum(axis=0), "k--", lw=1, label="total")
        ax.set_xlabel("frequency (Hz)")
        ax.set_ylabel("relative $L_\\nu$")
        ax.set_title("disk continuum SED per image order")
        ax.legend()
        ax.set_ylim(bottom=max(sed.max() * 1e-8, 1e-300))
        png = os.path.join(args.out_dir, "subring_sed.png")
        fig.savefig(png, dpi=110, bbox_inches="tight")
        plt.close(fig)
        written += [csv, png]

    metrics = {
        "orders": args.orders,
        "spin": args.spin,
        "charge": args.charge,
        "flux_per_order": summary["flux_per_order"],
        "gamma_hat": summary["gamma_hat"],
        "delay_per_order_M": summary["delay_per_order_M"],
        "max_crossings": summary["max_crossings"],
        "files": len(written) + 1,
    } | metrics_vis
    for k in ("evpa_twist_per_order_rad", "beta2_abs_per_order",
              "beta2_arg_per_order_rad"):
        if k in summary:
            metrics[k] = summary[k]
    metrics["theory"] = shell_theory(args.spin, args.charge,
                                     args.elevation)
    print(json.dumps(metrics))
    return metrics


def shell_theory(spin, charge, elevation_deg, n=33):
    """Predicted photon-shell observables for the rendered inclination:
    the Lyapunov exponent and half-orbit delay range along the visible
    critical curve (physics/photon_shell.py), to sit next to the
    measured gamma_hat / delay_per_order_M in the metrics line.

    Runs in float64 on the host CPU regardless of the render backend —
    three AD evaluations and a quadrature, milliseconds."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ..physics.photon_shell import critical_curve_observables

    theta_obs = max(np.deg2rad(90.0 - elevation_deg), 1e-4)
    # scoped x64 (same pattern as compat/einsteinpy.py:121-133) on the
    # host CPU: the AD quadrature needs f64, the render must stay f32
    prev_x64 = bool(jax.config.jax_enable_x64)
    if not prev_x64:
        jax.config.update("jax_enable_x64", True)
    try:
        with jax.default_device(jax.devices("cpu")[0]):
            curve = critical_curve_observables(
                jnp.array([1.0, spin, charge], dtype=jnp.float64),
                jnp.float64(theta_obs), n=n)
            gam = np.asarray(curve["gamma"], dtype=np.float64)
            dts = np.asarray(curve["delta_t"], dtype=np.float64)
    finally:
        if not prev_x64:
            jax.config.update("jax_enable_x64", False)
    return {
        "gamma_min": float(gam.min()),
        "gamma_max": float(gam.max()),
        "gamma_median": float(np.median(gam)),
        "delay_half_orbit_M_min": float(dts.min()),
        "delay_half_orbit_M_max": float(dts.max()),
        "delay_half_orbit_M_median": float(np.median(dts)),
    }


def console(argv=None):
    main(argv)
    return 0


if __name__ == "__main__":
    main()

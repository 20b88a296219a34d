"""Fit black-hole spin + inclination to an observed iron-line profile —
the end-use of the forward-model grid (cli/line_grid.py) as one command.

    # demo: synthesize an observation at a hidden truth, then recover it
    python -m grtrace.cli.fit_line --synthesize 0.7 40 --noise 0.03 \
        --spins 0.3 0.5 0.7 0.9 --inclinations 20 40 60

    # fit a real profile (CSV with columns g,flux — e.g. a line_grid.csv
    # slice, or engine/disk.py's line_profile.csv)
    python -m grtrace.cli.fit_line --observed profile.csv

The whole model grid is ONE compiled SPMD sweep over the device mesh
(sharding/grid.py) — fitting cost = one sweep + a host chi^2 reduction.
Profiles are area-normalized before comparison (the absolute flux scale
is not an observable here), and the chi^2 minimum is refined by a
parabolic fit along each grid axis.  Writes fit_chi2.csv and
fit_map.png; prints the best-fit JSON line.

No reference counterpart (the reference has no disk, spectra or fits).
"""
from __future__ import annotations

import argparse
import json
import os


def _area_norm(prof, axis=-1):
    import numpy as np
    s = prof.sum(axis=axis, keepdims=True)
    return prof / np.maximum(s, 1e-30)


def _parabolic_refine(values, losses, k):
    """Sub-grid minimum along one axis from the 3-point parabola."""
    if k == 0 or k == len(values) - 1:
        return float(values[k])
    la, lb, lc = losses[k - 1], losses[k], losses[k + 1]
    denom = la - 2.0 * lb + lc
    if denom <= 0:
        return float(values[k])
    shift = 0.5 * (la - lc) / denom
    step = 0.5 * (values[k + 1] - values[k - 1])
    return float(values[k] + shift * step)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="fit (spin, inclination) to a relativistic line "
                    "profile via the SPMD forward-model grid")
    p.add_argument('--observed', type=str, default=None,
                   help='CSV with header g,flux (mutually exclusive '
                        'with --synthesize)')
    p.add_argument('--synthesize', type=float, nargs=2, default=None,
                   metavar=('SPIN', 'INCL_DEG'),
                   help='generate the observation from this truth')
    p.add_argument('--noise', type=float, default=0.02,
                   help='relative Gaussian noise for --synthesize')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--spins', type=float, nargs='+',
                   default=[0.0, 0.25, 0.5, 0.7, 0.9, 0.998])
    p.add_argument('--inclinations', type=float, nargs='+',
                   default=[15.0, 30.0, 45.0, 60.0, 75.0])
    p.add_argument('--size', type=int, default=128)
    p.add_argument('--steps', type=int, default=12_000)
    p.add_argument('--delta', type=float, default=0.03)
    p.add_argument('--emissivity', type=float, default=3.0)
    p.add_argument('--bins', type=int, default=64)
    p.add_argument('--g-range', type=float, nargs=2, default=[0.1, 1.6])
    p.add_argument('--disk-r-out', type=float, default=14.0)
    p.add_argument('--dtype', type=str, default='float32',
                   choices=['float32', 'float64'])
    p.add_argument('--gauss-newton', type=int, default=0, metavar='N',
                   help='Refine the grid best fit with N Gauss-Newton '
                        'steps on the exact AD Jacobian '
                        '(engine/sensitivity.gauss_newton_fit) — '
                        'sub-grid accuracy from derivative information '
                        'instead of the parabolic grid interpolation')
    p.add_argument('--fisher', action='store_true',
                   help='Exact local error bars at the best fit: '
                        'forward-mode AD through the full integrator '
                        '(engine/sensitivity.py) gives the profile '
                        'Jacobian in (spin, inclination) -> Fisher '
                        'matrix, 1-sigma errors and the spin-incl '
                        'degeneracy correlation.  The Jacobian is of '
                        'the smooth-KDE surrogate profile (hard bins '
                        'have zero derivative a.e.)')
    p.add_argument('--out-dir', type=str, default='.')
    args = p.parse_args(argv)
    from . import driver_startup
    driver_startup()
    if (args.observed is None) == (args.synthesize is None):
        raise SystemExit("pass exactly one of --observed / --synthesize")
    probe_spins = list(args.spins) + (
        [args.synthesize[0]] if args.synthesize else [])
    for a in probe_spins:
        if a * a > 1.0:
            raise SystemExit(f"naked singularity at spin {a}: need "
                             "a^2 <= M^2")
    probe_incl = list(args.inclinations) + (
        [args.synthesize[1]] if args.synthesize else [])
    if not all(0.0 <= i <= 90.0 for i in probe_incl):
        raise SystemExit("inclinations must lie in [0, 90] degrees")

    import numpy as np

    import jax
    import jax.numpy as jnp

    from ..sharding.grid import g_bin_centers, line_profile_grid_sharded
    from ..sharding.mesh import make_mesh

    g_lo, g_hi = (float(x) for x in args.g_range)
    centers = g_bin_centers(args.bins, g_lo, g_hi)
    dtype = jnp.float64 if args.dtype == 'float64' else jnp.float32
    mesh = make_mesh(1, len(jax.devices()))

    def sweep(spins, elevs):
        return np.asarray(line_profile_grid_sharded(
            mesh, np.asarray(spins, np.float64),
            np.asarray(elevs, np.float64), 30.0, np.deg2rad(80.0), 1.0,
            0.0, 31.0, args.steps, args.delta, 1.0, args.disk_r_out,
            height=args.size, width=args.size, dtype=dtype, n_bins=args.bins,
            emissivity=(float(args.emissivity),), g_lo=g_lo, g_hi=g_hi),
            np.float64)[:, 0]

    # --- the observation -------------------------------------------------
    if args.synthesize is not None:
        true_spin, true_incl = args.synthesize
        obs = sweep([true_spin], [np.deg2rad(90.0 - true_incl)])[0]
        rng = np.random.default_rng(args.seed)
        obs = np.maximum(
            obs + args.noise * obs.max() * rng.standard_normal(obs.shape),
            0.0)
        obs_g = centers
    else:
        data = np.genfromtxt(args.observed, delimiter=",", names=True)
        obs_g = np.asarray(data["g"], np.float64)
        obs = np.asarray(data["flux"], np.float64)

    obs_n = _area_norm(obs)

    # --- the model grid (one SPMD sweep) ---------------------------------
    spins = np.repeat(args.spins, len(args.inclinations))
    incls = np.tile(args.inclinations, len(args.spins))
    grid = sweep(spins, np.deg2rad(90.0 - incls))          # (F, B)
    if args.observed is not None:
        grid = np.stack([np.interp(obs_g, centers, gp) for gp in grid])
    grid_n = _area_norm(grid)

    chi2 = ((grid_n - obs_n[None]) ** 2).sum(axis=1)
    k = int(np.argmin(chi2))
    ns, ni = len(args.spins), len(args.inclinations)
    ks, ki = divmod(k, ni)
    spin_fit = _parabolic_refine(np.asarray(args.spins),
                                 chi2.reshape(ns, ni)[:, ki], ks)
    incl_fit = _parabolic_refine(np.asarray(args.inclinations),
                                 chi2.reshape(ns, ni)[ks], ki)

    os.makedirs(args.out_dir, exist_ok=True)
    np.savetxt(os.path.join(args.out_dir, "fit_chi2.csv"),
               np.column_stack([spins, incls, chi2]), delimiter=",",
               comments="", header="spin,inclination_deg,chi2",
               fmt="%.8g")

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4.2))
    im = ax1.imshow(np.log10(chi2.reshape(ns, ni) + 1e-12),
                    origin="lower", aspect="auto",
                    extent=[min(args.inclinations), max(args.inclinations),
                            min(args.spins), max(args.spins)],
                    cmap="viridis")
    ax1.plot(incl_fit, spin_fit, "r*", ms=14, label="best fit")
    if args.synthesize is not None:
        ax1.plot(true_incl, true_spin, "wx", ms=10, label="truth")
    ax1.set_xlabel("inclination (deg)")
    ax1.set_ylabel("spin a")
    ax1.set_title("log$_{10}$ $\\chi^2$")
    ax1.legend()
    fig.colorbar(im, ax=ax1)
    ax2.plot(obs_g, obs_n, "k.", ms=3, label="observed")
    ax2.plot(obs_g if args.observed else centers, grid_n[k],
             label=f"best model (a={args.spins[ks]:g}, "
                   f"i={args.inclinations[ki]:g}°)")
    ax2.set_xlabel("g = $E_{obs}/E_{em}$")
    ax2.set_ylabel("normalized flux")
    ax2.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(os.path.join(args.out_dir, "fit_map.png"), dpi=110,
                bbox_inches="tight")
    plt.close(fig)

    result = {
        "spin_fit": round(spin_fit, 4),
        "inclination_fit_deg": round(incl_fit, 3),
        "spin_grid_best": float(args.spins[ks]),
        "inclination_grid_best": float(args.inclinations[ki]),
        "chi2_min": float(chi2[k]),
        "grid_points": int(len(spins)),
    }
    if args.synthesize is not None:
        result |= {"spin_true": float(true_spin),
                   "inclination_true_deg": float(true_incl)}

    sens_knobs = dict(size=args.size, steps=args.steps, delta=args.delta,
                      r_out=args.disk_r_out,
                      emissivity_index=float(args.emissivity),
                      fov=float(np.deg2rad(80.0)))

    if args.gauss_newton:
        from ..engine.sensitivity import gauss_newton_fit
        # refine against the observation ON the model bin centers
        obs_c = (obs if args.observed is None
                 else np.interp(centers, obs_g, obs))
        theta0 = np.array([float(args.spins[ks]),
                           np.deg2rad(90.0 - float(args.inclinations[ki]))])
        theta_gn, hist = gauss_newton_fit(theta0, obs_c, centers,
                                          n_iter=args.gauss_newton,
                                          **sens_knobs)
        spin_fit = float(theta_gn[0])
        incl_fit = float(90.0 - np.rad2deg(theta_gn[1]))
        result |= {
            "spin_fit": round(spin_fit, 5),
            "inclination_fit_deg": round(incl_fit, 4),
            "gn_iterations": args.gauss_newton,
            "gn_residual_norms": [round(h[2], 8) for h in hist],
        }

    if args.fisher:
        from ..engine.sensitivity import (fisher_forecast,
                                          line_profile_jacobian)
        theta = np.array([spin_fit, np.deg2rad(90.0 - incl_fit)])
        _, jac = line_profile_jacobian(theta, centers, **sens_knobs)
        if args.synthesize is not None:
            # the synthesized noise is args.noise * obs.max() absolute;
            # area normalization divides both by the same sum
            sigma_n = args.noise * float(obs_n.max())
        else:
            # estimate per-bin noise from the fit residual
            sigma_n = float(np.sqrt(chi2[k] / max(len(obs_n) - 2, 1)))
        fc = fisher_forecast(jac, max(sigma_n, 1e-12))
        # theta[1] is ELEVATION; inclination = 90 deg - elevation, so the
        # error magnitude carries over and the correlation flips sign
        result |= {
            "fisher_spin_err": float(fc["errors"][0]),
            "fisher_incl_err_deg": float(np.rad2deg(fc["errors"][1])),
            "fisher_correlation_spin_incl": (-float(fc["correlation"])
                                             if fc["correlation"]
                                             is not None else None),
            "fisher_noise_sigma": sigma_n,
        }

    print(json.dumps(result))
    return result


def console(argv=None):
    main(argv)
    return 0


if __name__ == "__main__":
    main()

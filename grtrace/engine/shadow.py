"""Black-hole shadow analysis: the analytic critical curve + EHT-style
shape metrics, in the renderer's own image-plane coordinates.

The shadow boundary (critical curve) is where the Bardeen (1973) radial
potential first admits a turning point outside the horizon; for the
whole Kerr-Newman family the per-ray predicate is closed-form
(engine.validate.bardeen_escapes evaluates it through the actual camera
convention, so the curve lands exactly where the renderer's shadow edge
does).  This module samples that predicate on a dense azimuth fan with
sub-pixel radial bisection and reduces the curve to the standard
observables:

  * mean angular radius / diameter,
  * centroid displacement (the frame-dragging shift of the shadow off
    the spin axis — the Kerr "D-shape" slides toward the approaching
    side),
  * the EHT fractional deviation from circularity
    Delta C = sqrt(<(rho - <rho>)^2>) / <rho>  (Event Horizon Telescope
    2019 Paper VI's circularity metric),
  * axis ratios (max/min diameter).

Everything is host float64 and costs milliseconds: no tracing.  The CLI
(cli/shadow.py) can additionally bisect the real integrator's boundary
at the same azimuths and report per-azimuth pixel errors — the
user-facing version of the accuracy validation the benchmark embeds
(engine/validate.py), at arbitrary azimuth resolution.

No reference counterpart: the reference renders the shadow but offers no
boundary extraction or shape metrics.
"""
from __future__ import annotations

import numpy as np

from .validate import (PLANE_D, PLANE_W, SIZE, bardeen_escapes,
                       bisect_boundary, schwarzschild_analytic_rho)


def px_to_alpha_deg(rho_px):
    """256-image pixel radius -> apparent camera angle (degrees), with
    the renderer's image-plane geometry (one source of truth for the
    metrics and the CLI CSV)."""
    return np.degrees(np.arctan(np.asarray(rho_px) / SIZE
                                * PLANE_W / PLANE_D))


def analytic_boundary(spin, charge=0.0, n_psi=64, rounds=6):
    """(psis, rho_px): the critical curve in 256-image pixel radii at
    n_psi azimuths (psi = 0 along +y of the +x equatorial camera,
    increasing toward +z), by radial bisection of the closed-form
    Bardeen escape predicate.  rounds=6 resolves ~1e-3 px."""
    psis = np.linspace(0.0, 2.0 * np.pi, n_psi, endpoint=False)
    rho, _ = bisect_boundary(
        lambda r: bardeen_escapes(r, spin, charge, psis=psis),
        6.0, 40.0, rounds=rounds, n_psi=n_psi)
    return psis, rho


def analytic_boundary_rotating(spin, p1, metric="RotatingBardeen",
                               n_psi=64, rounds=6):
    """(psis, rho_px): the EXACT critical curve of a rotating regular
    family, by radial bisection of the conserved-quantity escape
    predicate (physics.rotating_regular.escape_pred_rotating) evaluated
    on real camera rays — no closed form exists for these metrics, but
    the Hamilton-Jacobi separation makes the per-ray predicate exact, so
    this is still milliseconds of host work and zero tracing (the same
    design as the Kerr-Newman analytic_boundary, with the golden-section
    min-R test replacing the Bardeen quartic).  Returns NaN radii when
    the (a, p1) point is horizonless (no shadow to bound)."""
    import jax.numpy as jnp

    from ..physics.camera import cartesian_ics_from_pixels
    from ..physics.rotating_regular import escape_pred_rotating
    from ..physics.spacetime import METRICS
    from .validate import _pixel_positions

    psis = np.linspace(0.0, 2.0 * np.pi, n_psi, endpoint=False)
    params = jnp.asarray([1.0, spin, p1], jnp.float64)

    from ..physics.rotating_regular import rotating_horizon
    if not np.isfinite(float(rotating_horizon(metric, params))):
        # horizonless super-critical point: the predicate reports escape
        # everywhere (nothing is captured), so there is no boundary to
        # bisect — NaN radii, decided BEFORE the bisection would trip on
        # its bracket check
        return psis, np.full(n_psi, np.nan)

    def escape(rhos):
        pix = jnp.asarray(_pixel_positions(rhos, psis[:, None]),
                          jnp.float64)
        q0, p0, _ = cartesian_ics_from_pixels(
            jnp.asarray([30.0, 0.0, 0.0], jnp.float64), pix,
            params=params, g_inv_fn=METRICS[metric])
        pred = escape_pred_rotating(metric, q0.reshape(-1, 4),
                                    p0.reshape(-1, 4), params)
        return np.asarray(pred).reshape(rhos.shape)

    rho, _ = bisect_boundary(escape, 2.0, 40.0, rounds=rounds,
                             n_psi=n_psi)
    return psis, rho


def analytic_boundary_kds(spin, lam, n_psi=64, rounds=6):
    """(psis, rho_px): the EXACT Kerr-de Sitter critical curve through
    the unfolded spherical camera — radial bisection of the
    conserved-quantity predicate (physics.kerr_de_sitter.kds_escape_pred;
    the Carter bracket carries the Delta_theta/chi factors).  NaN radii
    when the (a, Lambda) point has no black-hole horizon.  NB the
    spherical camera's pixel gauge differs from the Kerr-Schild
    camera's by the documented O(2M/r_obs) chart factor
    (physics/camera.py:386-400) — compare kerr-ds curves against
    kerr-bl numerics, not against analytic_boundary."""
    import jax.numpy as jnp

    from ..physics.camera import unfolded_ics_from_pixels
    from ..physics.kerr_de_sitter import kds_escape_pred, kds_outer_horizon
    from ..physics.spacetime import METRICS
    from .validate import _pixel_positions

    psis = np.linspace(0.0, 2.0 * np.pi, n_psi, endpoint=False)
    params = jnp.asarray([1.0, spin, lam], jnp.float64)
    if not np.isfinite(float(kds_outer_horizon(params))):
        return psis, np.full(n_psi, np.nan)

    def escape(rhos):
        pix = jnp.asarray(_pixel_positions(rhos, psis[:, None]),
                          jnp.float64)
        q0, p0, _ = unfolded_ics_from_pixels(
            jnp.asarray([30.0, 0.0, 0.0], jnp.float64), pix,
            params=params, g_inv_fn=METRICS["KerrDS"])
        pred = kds_escape_pred(q0.reshape(-1, 4), p0.reshape(-1, 4),
                               params)
        return np.asarray(pred).reshape(rhos.shape)

    rho, _ = bisect_boundary(escape, 2.0, 40.0, rounds=rounds,
                             n_psi=n_psi)
    return psis, rho


def shadow_metrics(psis, rho_px):
    """Standard shape observables from a boundary curve (pixel units).

    Angles are apparent camera angles: alpha = atan(rho/SIZE * W / D)
    with the renderer's image-plane geometry, reported in units of the
    Schwarzschild apparent radius for context.
    """
    y = rho_px * np.cos(psis)
    z = rho_px * np.sin(psis)
    cy, cz = y.mean(), z.mean()
    # radii about the centroid (the EHT circularity is centroid-relative)
    r_c = np.hypot(y - cy, z - cz)
    mean_r = r_c.mean()
    delta_c = float(np.sqrt(((r_c - mean_r) ** 2).mean()) / mean_r)

    alpha = px_to_alpha_deg(rho_px)
    # the a = Q = 0 critical curve in the SAME (Kerr-Schild camera)
    # convention, for spin/charge-trend normalization.  NB this is the KS
    # chart's apparent size, not the spherical camera's arcsin value —
    # the two charts' cameras are distinct O(2M/r_obs) gauges (see
    # physics/camera.cartesian_ics_from_pixels).
    _, rho0 = analytic_boundary(0.0, 0.0, n_psi=1)
    return {
        "mean_radius_px": float(mean_r),
        "mean_diameter_px": float(2.0 * mean_r),
        "mean_radius_deg": float(alpha.mean()),
        "centroid_shift_px": [float(cy), float(cz)],
        "circularity_deviation": delta_c,
        "axis_ratio": float(r_c.max() / r_c.min()),
        "radius_vs_schwarzschild": float(mean_r / rho0[0]),
        "rho_min_px": float(rho_px.min()),
        "rho_max_px": float(rho_px.max()),
        "convention": "kerr-schild camera, 256-image px "
                      "(spherical-chart camera: "
                      f"{schwarzschild_analytic_rho():.3f} px at a=0)",
    }


def numeric_boundary(spin, charge=0.0, n_psi=16, steps=8_000, delta=0.02,
                     order=4, dtype=None, rounds=3, metric="KerrSchild"):
    """(psis, rho_px, bracket): the REAL integrator's shadow boundary at
    n_psi azimuths (the production compensated Kerr-Schild path,
    integrate_ks.integrate_batch_ksc) — engine.validate.kerr_shadow_errors
    generalized to an arbitrary azimuth fan.  For the rotating regular
    families (`metric`, with the family parameter in `charge`'s slot)
    the fan rides the generic autodiff engine."""
    import jax.numpy as jnp

    from ..physics.camera import cartesian_ics_from_pixels
    from ..physics.spacetime import METRICS
    from .integrate import STATUS_ESCAPED
    from .validate import BOUNDARY, _pixel_positions

    if dtype is None:
        dtype = jnp.float32
    psis = np.linspace(0.0, 2.0 * np.pi, n_psi, endpoint=False)
    params = jnp.asarray([1.0, spin, charge], dtype)
    g_inv_fn = METRICS[metric]

    def escape(rhos):
        pix = jnp.asarray(_pixel_positions(rhos, psis[:, None]), dtype)
        if metric == "KerrDS":
            # spherical chart: the unfolded camera, like the renderer
            from ..physics.camera import unfolded_ics_from_pixels
            q0, p0, _ = unfolded_ics_from_pixels(
                jnp.asarray([30.0, 0.0, 0.0], dtype), pix,
                params=params, g_inv_fn=g_inv_fn)
        else:
            q0, p0, _ = cartesian_ics_from_pixels(
                jnp.asarray([30.0, 0.0, 0.0], dtype), pix, params=params,
                g_inv_fn=g_inv_fn)
        q0 = q0.reshape(-1, 4)
        p0 = p0.reshape(-1, 4)
        if metric != "KerrSchild":
            from .integrate_generic import integrate_batch_generic
            _, _, status, _ = integrate_batch_generic(
                q0, p0, steps, jnp.asarray(delta, dtype), params,
                jnp.asarray(BOUNDARY, dtype), jnp.asarray(1.0, dtype),
                order=order, metric=metric)
        else:
            from .integrate_ks import integrate_batch_ksc
            _, _, status, _ = integrate_batch_ksc(
                q0, p0, steps, jnp.asarray(delta, dtype), params,
                jnp.asarray(BOUNDARY, dtype), jnp.asarray(1.0, dtype),
                order=order)
        return np.asarray(status).reshape(rhos.shape) == STATUS_ESCAPED

    rho, bracket = bisect_boundary(escape, 6.0, 40.0, rounds=rounds, k=9,
                                   n_psi=n_psi)
    return psis, rho, bracket


def overlay_png(result, psis, rho_px, path, title=None):
    """Render + analytic critical curve overlay.

    The curve is quoted in 256-image pixel radii about the image center;
    the overlay rescales to the render's resolution.  Image rows advance
    along the camera's up vector (+z for the equatorial +x observer) and
    columns along right (+y), matching physics.camera.pixel_grid."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img = np.asarray(result.image)
    h, w = img.shape[:2]
    jj = (rho_px / SIZE * np.cos(psis) + 0.5) * w - 0.5
    ii = (rho_px / SIZE * np.sin(psis) + 0.5) * h - 0.5

    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(img)
    order = np.argsort(psis)
    ax.plot(np.append(jj[order], jj[order][0]),
            np.append(ii[order], ii[order][0]),
            color="#00e5ff", lw=1.2, ls="--",
            label="Bardeen critical curve")
    ax.legend(loc="upper right", fontsize=8)
    ax.set_axis_off()
    if title:
        ax.set_title(title)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)

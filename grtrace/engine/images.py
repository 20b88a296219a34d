"""Strong-lensing multiple images: where a point source appears, exactly.

Gravitational lensing makes one source into many images — a primary, a
secondary swung around the far side, and an infinite ladder of
photon-ring images hugging the shadow edge.  This module FINDS them:
given a source direction (theta_s, phi_s) on the celestial sphere, it
solves the lens equation

    exit(i, j) = (theta_s, phi_s + 2 pi k),    k = winding index,

for camera-plane positions (i, j), one root per azimuthal winding k.

Everything is built on the differentiable semi-analytic solver
(physics/geodesic_exact.escape_state, whose turning points carry
implicit-function-theorem gradients):

  * ``exit_angles`` is the continuous pixel -> sky map — the same
    camera, chart offsets and flat-embedding conventions as the exact
    background renderer (engine/render_exact.py), but with the azimuth
    UNWRAPPED so different windings are genuinely different roots;
  * seeds come from a coarse scan of that map, one best seed per
    winding (no human in the loop);
  * roots are polished by damped Newton with the EXACT Jacobian from
    ``jax.jacfwd`` — no finite differences anywhere;
  * magnifications are the standard solid-angle ratio
    mu^-1 = [sin th det d(sky)/d(pixel)]_curved / [...]_flat, with the
    flat twin evaluated through the same camera so the pixel->angle
    convention cancels exactly (the engine/lensing.py normalization,
    here with exact derivatives instead of pixel differences).  The
    SIGN of mu is the image parity: the secondary and every odd image
    are mirror-flipped (mu < 0).

The finder is validated end to end in tests/test_images.py: each found
image is handed to the traced Kerr-Schild integrator, which must exit
the boundary sphere at the requested source direction; magnifications
are checked against the finite-difference maps of engine/lensing.py and
against the weak-field point-lens pair relation.

No reference counterpart: the reference renders textures and never
inverts its lens map (simulation/raytracing.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..physics.camera import (cartesian_ics_from_pixels,
                              pixel_positions_fractional)
from ..physics.geodesic_exact import escape_state
from ..physics.spacetime import METRICS, ks_radius
from .hotspot import bl_time_azimuth_offsets


def _one_ray_exit(i_f, j_f, params, obs_pos, fov, height, width,
                  boundary_radius):
    """(theta_flat, phi_flat_unwrapped, escaped, t_arrival) for ONE
    fractional pixel: the continuous, differentiable pixel -> sky map.

    Identical conventions to render_pixels_background_exact: two-pass
    BL exit radius so the Euclidean exit radius is the classifier's
    boundary sphere; KS chart azimuth offset Phi(r) plus the Cartesian
    embedding's arctan(a/r); theta from the flat embedding
    cos th = r cos(th_bl) / rho.  The azimuth is NOT wrapped.
    t_arrival is the KS coordinate-time gain |camera -> boundary| along
    the path — image-to-image DIFFERENCES of it are the gravitational
    time delays an observer sees between a flare's lensed copies (the
    additive chart offset T(r) cancels in every difference).
    """
    dtype = obs_pos.dtype
    pix = pixel_positions_fractional(obs_pos, fov, height, width,
                                     i_f[None], j_f[None], dtype=dtype)
    q0, p0, _ = cartesian_ics_from_pixels(obs_pos, pix, params=params,
                                          g_inv_fn=METRICS["KerrSchild"])

    rho = jnp.asarray(boundary_radius, dtype)
    rb0 = jnp.sqrt(jnp.maximum(rho ** 2 - params[1] ** 2, 1.0))
    es = escape_state(q0, p0, params, rb0)
    sin2 = jnp.sin(es["theta"]) ** 2
    rb1 = jnp.sqrt(rho ** 2 - params[1] ** 2 * sin2)
    es = escape_state(q0, p0, params, rb1)

    r_obs_bl = ks_radius(obs_pos[0], obs_pos[1], obs_pos[2], params[1])
    offs = lambda rr: bl_time_azimuth_offsets(rr, params)
    t_b, phi_b = offs(rb1[0])
    t_o, phi_o = offs(r_obs_bl)
    phi = (es["e_sign"][0] * es["phi"][0] + phi_b - phi_o
           + jnp.arctan2(params[1], rb1[0])
           - jnp.arctan2(params[1], r_obs_bl))
    th = jnp.arccos(jnp.clip(rb1[0] * jnp.cos(es["theta"][0]) / rho,
                             -1.0, 1.0))
    # backward trace: coordinate time decreases along it; the elapsed
    # travel time is |gain|
    t_arr = jnp.abs(es["e_sign"][0] * es["t"][0] + t_b - t_o)
    return th, phi, es["escaped"][0], t_arr


def _one_ray_exit_flat(i_f, j_f, obs_pos, fov, height, width,
                       boundary_radius, params):
    """The flat twin: the SAME camera's covector propagated straight to
    the boundary sphere (engine/lensing.py's normalization, in closed
    form).  Cancels the pixel -> angle convention in the mu ratio."""
    dtype = obs_pos.dtype
    pix = pixel_positions_fractional(obs_pos, fov, height, width,
                                     i_f[None], j_f[None], dtype=dtype)
    q0, p0, _ = cartesian_ics_from_pixels(obs_pos, pix, params=params,
                                          g_inv_fn=METRICS["KerrSchild"])
    x0 = q0[0, 1:]
    n = p0[0, 1:]
    n = n / jnp.linalg.norm(n)
    rho = jnp.asarray(boundary_radius, dtype)
    # |x0 + s n| = rho, s > 0
    hi = jax.lax.Precision.HIGHEST  # a GPU may run f32 dots in TF32
    b = jnp.dot(x0, n, precision=hi)
    s = -b + jnp.sqrt(jnp.maximum(b * b + rho * rho
                                  - jnp.dot(x0, x0, precision=hi), 0.0))
    e = x0 + s * n
    th = jnp.arccos(jnp.clip(e[2] / rho, -1.0, 1.0))
    ph = jnp.arctan2(e[1], e[0])
    return th, ph


def find_images(source_theta, source_phi, *, params, obs_x=30.0,
                fov=np.deg2rad(80.0), height=256, width=256,
                boundary_radius=31.0, scan=96, windings=(-1, 0, 1),
                newton_iters=12, tol=1e-8, seed_cut=0.35,
                dtype=jnp.float64):
    """Solve the lens equation for every requested winding.

    Returns a list of dicts (one per CONVERGED image), each with
    ``i``/``j`` (fractional pixel in the height x width frame),
    ``winding``, ``theta``/``phi`` (achieved exit direction, phi
    unwrapped), ``residual`` (final |F| in radians), ``mu`` (signed
    solid-angle magnification, flat-normalized; negative = parity
    flipped) and ``converged``.

    The scan grid only SEEDS Newton — final positions are accurate to
    ``tol`` radians on the sky regardless of ``scan``; seeds whose scan
    residual exceeds ``seed_cut`` radians are not pursued (that winding
    has no image in the field of view, or it hides within a pixel of
    the shadow edge — raise ``scan`` to chase higher orders).
    """
    params = jnp.asarray(params, dtype)
    obs_pos = jnp.array([obs_x, 0.0, 0.0], dtype)
    fov = jnp.asarray(fov, dtype)
    th_s = float(source_theta)
    ph_s = float(source_phi)

    def exit_th_phi(ij):
        th, ph, esc, t_arr = _one_ray_exit(ij[0], ij[1], params,
                                           obs_pos, fov, height, width,
                                           boundary_radius)
        return jnp.stack([th, ph]), esc, t_arr

    # jit the point map, its exact Jacobian and the flat twin ONCE —
    # Newton calls them ~10x per winding
    f_pt = jax.jit(exit_th_phi)
    jac_pt = jax.jit(jax.jacfwd(lambda x: exit_th_phi(x)[0]))
    flat_fn = jax.jit(lambda x: jnp.stack(_one_ray_exit_flat(
        x[0], x[1], obs_pos, fov, height, width, boundary_radius,
        params)))
    jac_flat = jax.jit(jax.jacfwd(flat_fn))

    # ---- coarse scan -> one seed per winding
    ii = jnp.linspace(0.0, height - 1.0, scan, dtype=dtype)
    jj = jnp.linspace(0.0, width - 1.0, scan, dtype=dtype)
    gi, gj = jnp.meshgrid(ii, jj, indexing="ij")
    flat_ij = jnp.stack([gi.reshape(-1), gj.reshape(-1)], axis=-1)
    scan_out, scan_esc, _ = jax.lax.map(exit_th_phi, flat_ij,
                                     batch_size=4096)
    scan_th = np.asarray(scan_out[:, 0])
    scan_ph = np.asarray(scan_out[:, 1])
    scan_esc = np.asarray(scan_esc)

    results = []
    for k in windings:
        target = np.array([th_s, ph_s + 2.0 * np.pi * k])
        res = np.hypot(scan_th - target[0], scan_ph - target[1])
        res[~scan_esc] = np.inf
        best = int(np.argmin(res))
        if not np.isfinite(res[best]) or res[best] > seed_cut:
            continue
        ij = jnp.asarray(flat_ij[best], dtype)
        tgt = jnp.asarray(target, dtype)

        # ---- damped Newton
        converged = False
        resid = float(res[best])
        f = jnp.zeros(2, dtype)
        t_arr = jnp.zeros((), dtype)
        for _ in range(newton_iters):
            f, esc, t_arr = f_pt(ij)
            resid = float(jnp.linalg.norm(f - tgt))
            if not bool(esc):
                break
            if resid < tol:
                converged = True
                break
            j_mat = jac_pt(ij)
            step = jnp.linalg.solve(j_mat, f - tgt)
            # cap the pixel-space step: near the critical curve the
            # Jacobian is exponentially large and Newton overshoots
            norm = jnp.linalg.norm(step)
            step = jnp.where(norm > 2.0, step * (2.0 / norm), step)
            ij = ij - step
        else:
            f, esc, t_arr = f_pt(ij)
            resid = float(jnp.linalg.norm(f - tgt))
            converged = bool(esc) and resid < tol

        if not converged:
            results.append({"winding": k, "i": float(ij[0]),
                            "j": float(ij[1]), "residual": resid,
                            "converged": False})
            continue

        # ---- exact-Jacobian magnification, flat-normalized
        j_curved = jac_pt(ij)
        det_c = (j_curved[0, 0] * j_curved[1, 1]
                 - j_curved[0, 1] * j_curved[1, 0]) * jnp.sin(f[0])

        j_flat = jac_flat(ij)
        th_f = flat_fn(ij)[0]
        det_f = (j_flat[0, 0] * j_flat[1, 1]
                 - j_flat[0, 1] * j_flat[1, 0]) * jnp.sin(th_f)

        mu = float(det_f / det_c)
        results.append({"winding": k, "i": float(ij[0]),
                        "j": float(ij[1]),
                        "theta": float(f[0]), "phi": float(f[1]),
                        "residual": resid, "mu": mu,
                        "t_arrival": float(t_arr),
                        "converged": True})
    return results

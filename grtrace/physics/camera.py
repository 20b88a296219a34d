"""Pinhole camera: pixel grid -> null-geodesic phase-space initial conditions.

Fully vectorized `jnp` replacement for the reference's two O(H*W) host Python
loops (pixel-grid build at simulation/raytracing.py:83-88 and the per-ray
`get_initial_conditions` loop at raytracing.py:108-116 calling
simulation/utils.py:91-141).  One `jit` of `initial_conditions` produces every
per-ray quantity for the whole image as dense arrays that never leave the
device.

Camera geometry (identical to the reference, raytracing.py:60-88):
  * observer on the +x axis, optical axis -x, right = +y, up = +z
  * image plane at distance 0.2*|obs| with width 2*d*tan(fov/2),
    height = width * (h/w)
  * pixel (i, j): offset u = (j+0.5)/w - 0.5 along +y, v = (i+0.5)/h - 0.5
    along +z.

Conventions note (parity-critical): the reference's momentum bookkeeping is
self-consistent but mixes bases — `angles_to_p_sph` (utils.py:148-195)
multiplies the orthonormal r-component by sqrt(f) and the angular components
by r (the comments say "divide"), and the null closure then contracts that
triplet with *contravariant* metric coefficients (utils.py:70-77).  We
reproduce those exact formulas so that trajectories, photon_data.csv and
rendered images match the reference bit-for-bit in float64.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from .coords import cartesian_to_spherical, rotate_x
from .nullcond import null_p_t


def _dot(a, b):
    """Exact-f32 contraction: a plain float32 `@` may run in TF32 (about
    three significant digits) on a GPU, which alone would break the 1e-5
    escape-direction contract before the integrator runs a step."""
    return jnp.matmul(a, b, precision=lax.Precision.HIGHEST)


def pixel_grid(obs_pos, fov, height, width, dtype=jnp.float32):
    """Return (H, W, 3) pixel positions on the image plane.

    Mirrors reference simulation/raytracing.py:60-88 (optical axis -x,
    right +y, up +z, plane at 0.2*|obs|).
    """
    obs_pos = jnp.asarray(obs_pos, dtype=dtype)
    optical_axis = jnp.array([-1.0, 0.0, 0.0], dtype=dtype)
    right = jnp.array([0.0, 1.0, 0.0], dtype=dtype)
    up = jnp.array([0.0, 0.0, 1.0], dtype=dtype)

    plane_dist = 0.2 * jnp.linalg.norm(obs_pos)
    plane_center = obs_pos + optical_axis * plane_dist
    plane_width = 2.0 * plane_dist * jnp.tan(fov / 2.0)
    plane_height = plane_width * (height / width)

    jj = jnp.arange(width, dtype=dtype)
    ii = jnp.arange(height, dtype=dtype)
    u = (jj + 0.5) / width - 0.5   # (W,) along +y
    v = (ii + 0.5) / height - 0.5  # (H,) along +z
    offsets = (u[None, :, None] * plane_width * right
               + v[:, None, None] * plane_height * up)
    return plane_center + offsets


def pixel_positions_fractional(obs_pos, fov, height, width, i_f, j_f,
                               dtype=jnp.float32):
    """Image-plane positions at FRACTIONAL pixel indices (i_f, j_f), same
    geometry as pixel_grid (reference raytracing.py:60-88) — integer
    centers reproduce pixel_grid exactly.  The adaptive edge-refinement
    pass (engine/aa.py) feeds stratified sub-pixel indices through here."""
    obs_pos = jnp.asarray(obs_pos, dtype=dtype)
    optical_axis = jnp.array([-1.0, 0.0, 0.0], dtype=dtype)
    right = jnp.array([0.0, 1.0, 0.0], dtype=dtype)
    up = jnp.array([0.0, 0.0, 1.0], dtype=dtype)

    plane_dist = 0.2 * jnp.linalg.norm(obs_pos)
    plane_center = obs_pos + optical_axis * plane_dist
    plane_width = 2.0 * plane_dist * jnp.tan(fov / 2.0)
    plane_height = plane_width * (height / width)
    u = (j_f + 0.5) / width - 0.5
    v = (i_f + 0.5) / height - 0.5
    return (plane_center + u[:, None] * plane_width * right
            + v[:, None] * plane_height * up)


def _lookat_frame(obs_pos, fov, height, width, dtype):
    """(plane_center, plane_width, plane_height, right, up) of the
    origin-aimed image plane for an observer anywhere; the up-reference
    is +z (the spin axis) so the equatorial plane stays level, with a
    right = +y fallback for near-polar observers (|axis x z| ~ 0)."""
    obs_pos = jnp.asarray(obs_pos, dtype=dtype)
    d = jnp.linalg.norm(obs_pos)
    axis = -obs_pos / d
    z_hat = jnp.array([0.0, 0.0, 1.0], dtype=dtype)
    r_raw = jnp.cross(axis, z_hat)
    r_norm = jnp.linalg.norm(r_raw)
    right = jnp.where(r_norm > 1e-6, r_raw / jnp.maximum(r_norm, 1e-30),
                      jnp.array([0.0, 1.0, 0.0], dtype=dtype))
    up = jnp.cross(right, axis)

    plane_dist = 0.2 * d
    plane_center = obs_pos + axis * plane_dist
    plane_width = 2.0 * plane_dist * jnp.tan(fov / 2.0)
    plane_height = plane_width * (height / width)
    return plane_center, plane_width, plane_height, right, up


def pixel_grid_lookat(obs_pos, fov, height, width, dtype=jnp.float32):
    """(H, W, 3) pixel positions for an observer ANYWHERE, optical axis
    aimed at the origin.

    Generalizes pixel_grid beyond the reference's hardcoded +x observer
    (raytracing.py:60-88).  For the equatorial +x observer this reduces
    exactly to pixel_grid (right = +y, up = +z) — pinned by test.  Used
    by the inclined-camera disk renderer (engine.disk).
    """
    plane_center, plane_width, plane_height, right, up = _lookat_frame(
        obs_pos, fov, height, width, dtype)
    jj = jnp.arange(width, dtype=dtype)
    ii = jnp.arange(height, dtype=dtype)
    u = (jj + 0.5) / width - 0.5
    v = (ii + 0.5) / height - 0.5
    offsets = (u[None, :, None] * plane_width * right
               + v[:, None, None] * plane_height * up)
    return plane_center + offsets


def pixel_positions_fractional_lookat(obs_pos, fov, height, width, i_f, j_f,
                                      dtype=jnp.float32):
    """Look-at image-plane positions at FRACTIONAL pixel indices — the
    inclined-camera twin of pixel_positions_fractional (disk-mode
    adaptive edge refinement, engine/aa.py)."""
    plane_center, plane_width, plane_height, right, up = _lookat_frame(
        obs_pos, fov, height, width, dtype)
    u = (j_f + 0.5) / width - 0.5
    v = (i_f + 0.5) / height - 0.5
    return (plane_center + u[:, None] * plane_width * right
            + v[:, None] * plane_height * up)


def pixel_positions_for_indices_lookat(obs_pos, fov, height, width,
                                       flat_idx, dtype=jnp.float32):
    """Look-at pixel positions for a slice of flat indices (i*W + j) —
    the inclined-camera twin of pixel_positions_for_indices, for the
    sharded disk renderer's per-device ray slices."""
    plane_center, plane_width, plane_height, right, up = _lookat_frame(
        obs_pos, fov, height, width, dtype)
    i = (flat_idx // width).astype(dtype)
    j = (flat_idx % width).astype(dtype)
    u = (j + 0.5) / width - 0.5
    v = (i + 0.5) / height - 0.5
    return (plane_center + u[:, None] * plane_width * right
            + v[:, None] * plane_height * up)


def angles_to_p_sph(alpha, beta, r_obs, *, mass_bh=1.0):
    """Camera angles -> reference-convention spatial momentum triplet.

    Mirrors reference simulation/utils.py:148-195 (normalise=True branch):
        n = (-cos a cos b, -sin b, sin a cos b)   orthonormal (rhat, thhat, phhat)
        p = (n_r * sqrt(1 - 2M/r), n_th * r, n_ph * r)
    alpha/beta/r_obs broadcast elementwise.
    """
    f_r = jnp.sqrt(1.0 - 2.0 * mass_bh / r_obs)
    n_rhat = -jnp.cos(alpha) * jnp.cos(beta)
    n_phhat = jnp.sin(alpha) * jnp.cos(beta)
    n_thhat = -jnp.sin(beta)
    p_r = n_rhat * f_r
    p_th = n_thhat * r_obs
    p_ph = n_phhat * r_obs
    p_r, p_th, p_ph = jnp.broadcast_arrays(p_r, p_th, p_ph)
    return jnp.stack([p_r, p_th, p_ph], axis=-1)


def initial_conditions(obs_pos, pixel_pos, *, mass_bh=1.0):
    """Batched pixel positions -> (q0, p0, alpha0, heading, beta).

    Vectorized equivalent of reference get_initial_conditions
    (simulation/utils.py:91-141) over pixel_pos of shape (..., 3).

    Returns
    -------
    q0 : (..., 4)   initial position (0, r_obs, th_obs, ph_obs)
    p0 : (..., 4)   null 4-momentum, future-directed root
    alpha0 : (...)  angle off the optical axis (utils.py:140)
    heading : (..., 3)  (h_r, h_theta, h_phi) of the lab-frame ray direction
    beta : (...)    fold angle about +x used for the equatorial-plane trick
    """
    obs_pos = jnp.asarray(obs_pos, dtype=pixel_pos.dtype)
    ray = pixel_pos - obs_pos
    ray = ray / jnp.linalg.norm(ray, axis=-1, keepdims=True)
    rx, ry, rz = ray[..., 0], ray[..., 1], ray[..., 2]

    # Fold the ray into the x-y plane: beta = angle out of plane
    # (utils.py:103-113).  atan2(0, 0) = 0 handles the exact center pixel.
    beta = jnp.arctan2(rz, ry)
    xy_x, xy_y, _ = rotate_x(rx, ry, rz, -beta)

    # Observer spherical position (utils.py:118).
    r_obs, th_obs, ph_obs = cartesian_to_spherical(*[obs_pos[..., a] for a in range(3)])

    # Camera angle from the folded direction: in-plane theta = pi/2, so
    # h_phi = atan2(y, x); alpha_cam = pi - h_phi (utils.py:124-129).
    h_phi_xy = jnp.arctan2(xy_y, xy_x)
    alpha_cam = jnp.pi - h_phi_xy

    p_spatial = angles_to_p_sph(alpha_cam, 0.0, r_obs, mass_bh=mass_bh)

    # Null closure, future-directed (utils.py:134-136).
    p_t = null_p_t(p_spatial, r_obs, th_obs, mass_bh=mass_bh, future=True)
    p0 = jnp.concatenate([p_t[..., None], p_spatial], axis=-1)

    zeros = jnp.zeros_like(beta)
    q0 = jnp.stack([zeros, jnp.broadcast_to(r_obs, beta.shape),
                    jnp.broadcast_to(th_obs, beta.shape),
                    jnp.broadcast_to(ph_obs, beta.shape)], axis=-1)

    # Lab-frame heading in spherical form (utils.py:139).
    h_r, h_th, h_ph = cartesian_to_spherical(rx, ry, rz)
    heading = jnp.stack([h_r, h_th, h_ph], axis=-1)

    # alpha0: angle off the optical axis, renormalized to flat geometry
    # (utils.py:140).
    f_r = jnp.sqrt(1.0 - 2.0 * mass_bh / r_obs)
    alpha0 = jnp.arccos(jnp.clip(-p_spatial[..., 0] / f_r, -1.0, 1.0))

    return q0, p0, alpha0, heading, beta


def folded_ics_from_pixels_static(obs, pix, *, params, g_inv_fn):
    """Folded (equatorial) camera for SPHERICALLY-SYMMETRIC generic
    metrics (the static beyond-Kerr families, physics/static_metrics.py).

    Same beta-fold as the Schwarzschild camera (initial_conditions above;
    reference utils.py:103-113): every ray is rotated about +x into the
    x-y plane, so it integrates at theta = pi/2 with p_theta = 0 and the
    BL polar-axis stiffness (the 1/sin theta metric terms that retire
    over-pole rays in the unfolded chart) is never approached — the fold
    is EXACT under spherical symmetry.  Differences from
    initial_conditions: p_t closes the null condition in the actual
    metric f (spacetime.null_p_t with g_inv_fn), not Schwarzschild; the
    sqrt(1 - 2M/r) radial normalization is kept — it is the shared camera
    convention (affine gauge) across every spherical chart, see
    unfolded_ics_from_pixels.

    Returns (q0, p0, alpha0, beta); classify_rays(beta) un-folds the hit
    angles, and trajectory diagnostics rotate back by beta about +x.
    """
    from .spacetime import null_p_t as generic_null_p_t
    import jax

    obs = jnp.asarray(obs, dtype=pix.dtype)
    ray = pix - obs
    ray = ray / jnp.linalg.norm(ray, axis=-1, keepdims=True)
    rx, ry, rz = ray[..., 0], ray[..., 1], ray[..., 2]

    beta = jnp.arctan2(rz, ry)
    xy_x, xy_y, _ = rotate_x(rx, ry, rz, -beta)

    r_obs, th_obs, ph_obs = cartesian_to_spherical(
        *[obs[..., a] for a in range(3)])

    h_phi_xy = jnp.arctan2(xy_y, xy_x)
    alpha_cam = jnp.pi - h_phi_xy

    mass = jnp.asarray(params, pix.dtype)[0]
    p_spatial = angles_to_p_sph(alpha_cam, 0.0, r_obs, mass_bh=mass)

    zeros = jnp.zeros_like(beta)
    q0 = jnp.stack([zeros, jnp.broadcast_to(r_obs, beta.shape),
                    jnp.broadcast_to(th_obs, beta.shape),
                    jnp.broadcast_to(ph_obs, beta.shape)], axis=-1)

    params_arr = jnp.asarray(params, pix.dtype)
    flat_p = p_spatial.reshape(-1, 3)
    flat_q = q0.reshape(-1, 4)
    p_t = jax.vmap(lambda p, q: generic_null_p_t(p, q, params_arr, g_inv_fn,
                                                 future=True))(flat_p, flat_q)
    p0 = jnp.concatenate([p_t.reshape(beta.shape)[..., None], p_spatial],
                         axis=-1)

    f_r = jnp.sqrt(1.0 - 2.0 * mass / r_obs)
    alpha0 = jnp.arccos(jnp.clip(-p_spatial[..., 0] / f_r, -1.0, 1.0))
    return q0, p0, alpha0, beta


def camera_rays_folded_static(obs_pos, fov, height, width, *, params,
                              g_inv_fn, dtype=jnp.float32):
    """Full-grid folded camera for spherically-symmetric generic metrics:
    pixel_grid -> folded_ics_from_pixels_static."""
    pix = pixel_grid(obs_pos, fov, height, width, dtype=dtype)
    return folded_ics_from_pixels_static(jnp.asarray(obs_pos, dtype=dtype),
                                         pix, params=params,
                                         g_inv_fn=g_inv_fn)


def camera_rays_unfolded(obs_pos, fov, height, width, *, params, g_inv_fn,
                         dtype=jnp.float32):
    """General-metric camera: pixel grid -> ICs WITHOUT the equatorial fold.

    The beta-fold trick (initial_conditions above; reference
    utils.py:103-113) rotates every ray into the x-y plane — licensed only
    by spherical symmetry.  Kerr is merely axisymmetric, so rays must keep
    their true (theta, phi) headings.  The spatial momentum uses the same
    camera normalization convention as the reference
    (n_rhat*sqrt(1-2M/r), n_thhat*r, n_phhat*r; utils.py:179-186 — the
    overall scale of a null covector is affine gauge), but the direction is
    expressed in the observer's orthonormal spherical basis directly and
    p_t is closed with the exact metric-specific null condition (including
    the g^{t phi} frame-dragging cross term for Kerr).

    Returns (q0, p0, alpha0) with shapes (H, W, 4|4|-).
    """
    pix = pixel_grid(obs_pos, fov, height, width, dtype=dtype)
    return unfolded_ics_from_pixels(jnp.asarray(obs_pos, dtype=dtype), pix,
                                    params=params, g_inv_fn=g_inv_fn)


def unfolded_ics_from_pixels(obs, pix, *, params, g_inv_fn):
    """Core of the unfolded spherical-chart camera for arbitrary pixel
    positions (the adaptive edge-refinement pass feeds sub-pixel
    positions through here; engine/aa.py)."""
    from .spacetime import null_p_t as generic_null_p_t
    import jax

    dtype = pix.dtype
    ray = pix - obs
    ray = ray / jnp.linalg.norm(ray, axis=-1, keepdims=True)

    r_obs, th_obs, ph_obs = cartesian_to_spherical(obs[0], obs[1], obs[2])
    st, ct = jnp.sin(th_obs), jnp.cos(th_obs)
    sp, cp = jnp.sin(ph_obs), jnp.cos(ph_obs)
    rhat = jnp.stack([st * cp, st * sp, ct])
    thhat = jnp.stack([ct * cp, ct * sp, -st])
    phhat = jnp.stack([-sp, cp, jnp.zeros_like(sp)])

    n_r = _dot(ray, rhat)
    n_th = _dot(ray, thhat)
    n_ph = _dot(ray, phhat)

    mass = jnp.asarray(params, dtype)[0]
    f_r = jnp.sqrt(1.0 - 2.0 * mass / r_obs)
    p_sph = jnp.stack([n_r * f_r, n_th * r_obs, n_ph * r_obs], axis=-1)

    q3 = jnp.stack([jnp.broadcast_to(r_obs, n_r.shape),
                    jnp.broadcast_to(th_obs, n_r.shape),
                    jnp.broadcast_to(ph_obs, n_r.shape)], axis=-1)
    q0 = jnp.concatenate([jnp.zeros_like(n_r)[..., None], q3], axis=-1)

    params_arr = jnp.asarray(params, dtype)
    flat_p = p_sph.reshape(-1, 3)
    flat_q = q0.reshape(-1, 4)
    p_t = jax.vmap(lambda p, q: generic_null_p_t(p, q, params_arr, g_inv_fn,
                                                 future=True))(flat_p, flat_q)
    p0 = jnp.concatenate([p_t.reshape(n_r.shape)[..., None], p_sph], axis=-1)

    # angle off the optical axis (same formula as the folded camera)
    alpha0 = jnp.arccos(jnp.clip(-p_sph[..., 0] / f_r, -1.0, 1.0))
    return q0, p0, alpha0


def camera_rays_cartesian(obs_pos, fov, height, width, *, params, g_inv_fn,
                          dtype=jnp.float32):
    """Camera for Cartesian-chart metrics (Kerr-Schild): the ray direction
    IS the spatial covector (affine gauge), p_t closes the exact null
    quadratic with all g^{t i} cross terms.  Far from the hole the chart is
    Minkowski + O(M/r), so the pixel->direction map needs no basis algebra
    at all — the simplest camera in the framework.

    Returns (q0, p0, alpha0): q0 = (0, x, y, z), p0 = (p_t, n_x, n_y, n_z).
    alpha0 is the flat angle off the optical axis (for diagnostics only;
    the generic render path never uses the analytic capture shortcut).
    """
    pix = pixel_grid(obs_pos, fov, height, width, dtype=dtype)
    return cartesian_ics_from_pixels(jnp.asarray(obs_pos, dtype=dtype), pix,
                                     params=params, g_inv_fn=g_inv_fn)


def cartesian_ics_from_pixels(obs, pix, *, params, g_inv_fn):
    """Core of the Cartesian-chart camera for arbitrary pixel positions
    (used directly by the sharded renderer on per-device index slices)."""
    from .spacetime import null_p_t as generic_null_p_t
    import jax

    dtype = pix.dtype
    ray = pix - obs
    ray = ray / jnp.linalg.norm(ray, axis=-1, keepdims=True)

    shape = ray.shape[:-1]
    q0 = jnp.concatenate([jnp.zeros(shape + (1,), dtype),
                          jnp.broadcast_to(obs, shape + (3,))], axis=-1)

    # reference camera convention transformed to Cartesian: the spherical
    # camera scales the radial covector component by sqrt(1 - 2M/r)
    # (utils.py:179-186); the covector transform of
    # (n_r sqrt(f), n_th r, n_ph r) to Cartesian is exactly
    # n + (sqrt(f) - 1)(n . rhat) rhat.  NOTE this reproduces the
    # spherical camera's covector COMPONENTS, not its physical
    # pixel -> viewing-angle map: the Kerr-Schild chart's radial covector
    # differs from the Schwarzschild chart's by (2 M r / Delta) p_t
    # (the dt-shift of the chart map), so the two cameras shoot slightly
    # different bundles — an O(2M/r_obs) apparent-size gauge (at the
    # headline r_obs = 30 the critical curve sits at 22.63 vs 24.16 px
    # per 256; both conventions are exactly self-consistent within their
    # chart and each is pinned against its own closed form:
    # tests/test_shadow_analytic.py arcsin vs Bardeen rows).  The exact
    # static-tetrad map is available via boosted_ics_from_pixels(omega=0).
    params_arr = jnp.asarray(params, dtype)
    r_obs = jnp.linalg.norm(obs)
    rhat = obs / r_obs
    f_r = jnp.sqrt(1.0 - 2.0 * params_arr[0] / r_obs)
    n_r = _dot(ray, rhat)
    p_sp = ray + (f_r - 1.0) * n_r[..., None] * rhat

    flat_p = p_sp.reshape(-1, 3)
    flat_q = q0.reshape(-1, 4)
    p_t = jax.vmap(lambda p, q: generic_null_p_t(p, q, params_arr, g_inv_fn,
                                                 future=True))(flat_p, flat_q)
    p0 = jnp.concatenate([p_t.reshape(shape)[..., None], p_sp], axis=-1)

    axis = -obs / jnp.linalg.norm(obs)
    alpha0 = jnp.arccos(jnp.clip(_dot(ray, axis), -1.0, 1.0))
    return q0, p0, alpha0


def boosted_ics_from_pixels(obs, pix, *, params, g_inv_fn, omega_cam):
    """Initial conditions for a camera on a circular worldline
    u = u^t (partial_t + omega_cam partial_phi) — exact GR aberration and
    Doppler through an orthonormal camera tetrad (no weak-field boosts).

    Construction, all at the camera event on the Cartesian chart:
      1. covariant metric g = inv(g_inv) (one 4x4);
      2. e0 = the camera 4-velocity (1, -omega y, omega x, 0)/norm;
      3. {e1, e2, e3} = Gram-Schmidt of the look-at frame's (axis,
         right, up) coordinate vectors against e0 under g — an
         orthonormal triad of the camera's local rest space.  The
         aberration is NOT inserted by hand: equal pixel angles in this
         rest frame simply subtend different coordinate directions when
         the frame moves, and the compression of the sky toward the
         motion comes out of the tracing;
      4. pixel (c_ax, c_r, c_up) image-plane coefficients give the unit
         rest-frame direction d = sum c_i e_i / |c|, and the (past-
         directed, scene-ward) photon momentum is p = d - e0 — null by
         construction (g(d,d)=1, g(d,e0)=0, g(e0,e0)=-1), normalized to
         unit camera-frame frequency |p.u| = 1.

    omega_cam = 0 reproduces cartesian_ics_from_pixels' pixel->direction
    map exactly in Schwarzschild (the reference's sqrt(1-2M/r) radial
    covector scaling IS the static-tetrad map; pinned in
    tests/test_boosted_camera.py) and the exact static tetrad in Kerr.
    Returns (q0, p0, alpha0) shaped like cartesian_ics_from_pixels.
    """
    dtype = pix.dtype
    obs = jnp.asarray(obs, dtype)
    params_arr = jnp.asarray(params, dtype)

    shape = pix.shape[:-1]
    q0 = jnp.concatenate([jnp.zeros(shape + (1,), dtype),
                          jnp.broadcast_to(obs, shape + (3,))], axis=-1)

    g = jnp.linalg.inv(g_inv_fn(jnp.concatenate(
        [jnp.zeros((1,), dtype), obs]), params_arr))

    def dot(a, b):
        return _dot(_dot(a, g), b)

    v0 = jnp.concatenate([jnp.ones((1,), dtype),
                          omega_cam * jnp.stack([-obs[1], obs[0],
                                                 jnp.zeros((), dtype)])])
    e0 = v0 / jnp.sqrt(jnp.maximum(-dot(v0, v0), 1e-30))

    d_norm = jnp.linalg.norm(obs)
    axis = -obs / d_norm
    z_hat = jnp.array([0.0, 0.0, 1.0], dtype)
    r_raw = jnp.cross(axis, z_hat)
    r_nrm = jnp.linalg.norm(r_raw)
    right = jnp.where(r_nrm > 1e-6, r_raw / jnp.maximum(r_nrm, 1e-30),
                      jnp.array([0.0, 1.0, 0.0], dtype))
    up = jnp.cross(right, axis)

    def spatial4(v):
        return jnp.concatenate([jnp.zeros((1,), dtype), v])

    triad = []
    for v in (spatial4(axis), spatial4(right), spatial4(up)):
        w = v + dot(v, e0) * e0              # project out e0 (g(e0,e0)=-1)
        for e in triad:
            w = w - dot(v, e) * e
        triad.append(w / jnp.sqrt(jnp.maximum(dot(w, w), 1e-30)))
    e1, e2, e3 = triad

    # image-plane coefficients of each pixel in the look-at frame
    rel = pix - obs
    c_ax = _dot(rel, axis)
    c_r = _dot(rel, right)
    c_up = _dot(rel, up)
    c = jnp.stack([c_ax, c_r, c_up], axis=-1)
    c = c / jnp.linalg.norm(c, axis=-1, keepdims=True)

    d = (c[..., 0:1] * e1 + c[..., 1:2] * e2 + c[..., 2:3] * e3)
    p_up = d - e0                                   # contravariant, null
    p0 = _dot(p_up, g.T)                             # lower: p_mu = g_mn p^n

    alpha0 = jnp.arccos(jnp.clip(c[..., 0], -1.0, 1.0))
    return q0, p0, alpha0


def pixel_positions_for_indices(obs_pos, fov, height, width, flat_idx,
                                dtype=jnp.float32):
    """Pixel positions for a slice of flat indices (i*W + j).

    The sharded renderer gives each device only its ray slice, so the pixel
    grid must be computable per-index instead of materialized (H, W, 3)
    (replaces reference raytracing.py:83-88 for the distributed path).
    """
    obs_pos = jnp.asarray(obs_pos, dtype=dtype)
    optical_axis = jnp.array([-1.0, 0.0, 0.0], dtype=dtype)
    right = jnp.array([0.0, 1.0, 0.0], dtype=dtype)
    up = jnp.array([0.0, 0.0, 1.0], dtype=dtype)

    plane_dist = 0.2 * jnp.linalg.norm(obs_pos)
    plane_center = obs_pos + optical_axis * plane_dist
    plane_width = 2.0 * plane_dist * jnp.tan(fov / 2.0)
    plane_height = plane_width * (height / width)

    i = (flat_idx // width).astype(dtype)
    j = (flat_idx % width).astype(dtype)
    u = (j + 0.5) / width - 0.5
    v = (i + 0.5) / height - 0.5
    return (plane_center + u[:, None] * plane_width * right
            + v[:, None] * plane_height * up)


def camera_rays_for_indices(obs_pos, fov, height, width, flat_idx, *,
                            mass_bh=1.0, dtype=jnp.float32):
    """Initial conditions for an arbitrary slice of flat pixel indices."""
    pix = pixel_positions_for_indices(obs_pos, fov, height, width, flat_idx,
                                      dtype=dtype)
    return initial_conditions(jnp.asarray(obs_pos, dtype=dtype), pix,
                              mass_bh=mass_bh)


def camera_rays(obs_pos, fov, height, width, *, mass_bh=1.0, dtype=jnp.float32):
    """End-to-end: camera parameters -> per-pixel initial conditions.

    Replaces the entire host-side setup of reference raytracing.py:83-116 with
    one fused device computation.  Shapes: q0/p0 (H, W, 4), alpha0/beta (H, W),
    heading (H, W, 3).
    """
    pix = pixel_grid(obs_pos, fov, height, width, dtype=dtype)
    return initial_conditions(jnp.asarray(obs_pos, dtype=dtype), pix,
                              mass_bh=mass_bh)

"""Flat-space (no-gravity) reference renderer — one fused jit.

Array-program counterpart of both reference flat paths: the per-pixel CPU double
loop (reference: simulation/background.py:99-132) and the CUDA kernels
(simulation/cuda_geodesic.py:18-292).  Analytic ray-sphere intersection,
spherical hit coordinates, interval patch test with phi wrap-around, and an
equirectangular texture gather — all batched over the full pixel grid.

Note the flat path's patch test and texture rounding intentionally differ
from the curved path's (interval test + int truncation here vs
center-distance + int(x+0.5) there), mirroring the reference
(background.py:121-130 vs raytracing.py:219-245).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def flat_ray_dirs(obs_pos, fov, height, width, dtype=jnp.float32):
    """Unit ray directions (H, W, 3) for the flat camera.

    The flat camera derives its basis from the BH direction
    (background.py:37-52); with the observer on +x this reduces to
    optical axis -x, right = cross(up, axis) = -y(!), up_vec = +z... —
    evaluated exactly as the reference does with cross products so any
    observer position matches.
    """
    obs_pos = jnp.asarray(obs_pos, dtype=dtype)
    optical_axis = -obs_pos / jnp.linalg.norm(obs_pos)
    up_guess = jnp.array([0.0, 0.0, 1.0], dtype=dtype)
    # background.py:42-43 swaps the up guess when the axis is vertical; with a
    # static obs_pos this resolves at trace time.
    right = jnp.cross(up_guess, optical_axis)
    right = right / jnp.linalg.norm(right)
    up_vec = jnp.cross(optical_axis, right)
    up_vec = up_vec / jnp.linalg.norm(up_vec)

    plane_dist = 0.2 * jnp.linalg.norm(obs_pos)
    plane_center = obs_pos + optical_axis * plane_dist
    plane_width = 2.0 * plane_dist * jnp.tan(fov / 2.0)
    plane_height = plane_width * (height / width)

    jj = jnp.arange(width, dtype=dtype)
    ii = jnp.arange(height, dtype=dtype)
    u = (jj + 0.5) / width - 0.5
    v = (ii + 0.5) / height - 0.5
    pix = (plane_center + u[None, :, None] * plane_width * right
           + v[:, None, None] * plane_height * up_vec)
    ray = pix - obs_pos
    return ray / jnp.linalg.norm(ray, axis=-1, keepdims=True)


def _in_phi_patch(phi, phi0, phi1):
    """Wrapped interval membership (background.py:8-17), vectorized."""
    two_pi = 2.0 * jnp.pi
    phi = phi % two_pi
    phi0 = phi0 % two_pi
    phi1 = phi1 % two_pi
    no_wrap = phi0 <= phi1
    return jnp.where(no_wrap, (phi >= phi0) & (phi <= phi1),
                     (phi >= phi0) | (phi <= phi1))


@partial(jax.jit, static_argnames=("flip_theta", "flip_phi"))
def flat_raytrace(obs_pos, ray_dirs, boundary_radius,
                  patch_center_theta, patch_center_phi,
                  patch_size_theta, patch_size_phi,
                  bg_array, *, flip_theta=False, flip_phi=False):
    """(..., 3) ray dirs -> (..., 3) uint8 RGB + hit points (..., 3).

    Mirrors _flat_raytrace_kernel (cuda_geodesic.py:18-113) semantics,
    including `t = (-b + sqrt(disc)) / 2a` (the far intersection) and
    truncating int texture indices.
    """
    dtype = ray_dirs.dtype
    obs = jnp.asarray(obs_pos, dtype=dtype)
    d = ray_dirs
    a = jnp.sum(d * d, axis=-1)
    b = 2.0 * jnp.sum(obs * d, axis=-1)
    c = jnp.sum(obs * obs) - boundary_radius**2
    disc = b * b - 4.0 * a * c
    hit_ok = disc >= 0.0
    t = (-b + jnp.sqrt(jnp.maximum(disc, 0.0))) / (2.0 * a)
    hit = obs + t[..., None] * d

    r = jnp.linalg.norm(hit, axis=-1)
    theta = jnp.arccos(hit[..., 2] / r)
    phi = jnp.arctan2(hit[..., 1], hit[..., 0])

    theta0 = patch_center_theta - patch_size_theta / 2
    theta1 = patch_center_theta + patch_size_theta / 2
    phi0 = patch_center_phi - patch_size_phi / 2
    phi1 = patch_center_phi + patch_size_phi / 2
    two_pi = 2.0 * jnp.pi
    phi_span = (phi1 - phi0) % two_pi
    phi_span = jnp.where(phi_span == 0.0, two_pi, phi_span)

    in_patch = ((theta >= theta0) & (theta <= theta1)
                & _in_phi_patch(phi, phi0, phi1) & hit_ok)

    theta_map = (jnp.pi - theta) if flip_theta else theta
    phi_map = (-phi) if flip_phi else phi
    th_res, tw_res = bg_array.shape[0], bg_array.shape[1]
    u_bg = (theta_map - theta0) / (theta1 - theta0) * (th_res - 1)
    phi_mod = (phi_map - phi0) % two_pi
    v_bg = phi_mod / phi_span * (tw_res - 1)
    u_i = jnp.clip(u_bg.astype(jnp.int32), 0, th_res - 1)
    v_i = jnp.clip(v_bg.astype(jnp.int32), 0, tw_res - 1)

    texel = bg_array[u_i, v_i]
    rgb = jnp.where(in_patch[..., None], texel, jnp.zeros(3, dtype=jnp.uint8))
    return rgb, hit


def flat_render_scene(observer, bg_array, *, boundary_radius=None,
                      patch_center_theta=None, patch_center_phi=None,
                      patch_size_theta=None, patch_size_phi=None,
                      flip_theta=False, flip_phi=False,
                      n_sampled=10, seed=0, dtype=jnp.float32,
                      override_patch_center=False):
    """Full flat-space render pass — the save_no_gravity_image_with_background
    orchestration (reference: simulation/background.py:19-132) minus file IO.

    Returns (image (H, W, 3) uint8, sampled_trajectories list of (100, 3)).
    Defaults mirror the reference: boundary = 2*|obs| fallback
    (background.py:31-32), patch centered on the boundary point opposite the
    observer unless overridden (background.py:54-58).
    """
    import numpy as _np
    h, w = observer.image_size
    obs = _np.asarray(observer.position, dtype=float)
    if boundary_radius is None:
        boundary_radius = float(_np.linalg.norm(obs) * 2)
    if (not override_patch_center or patch_center_theta is None
            or patch_center_phi is None):
        opp = -obs
        r_opp = _np.linalg.norm(opp)
        patch_center_theta = float(_np.arccos(opp[2] / r_opp))
        patch_center_phi = float(_np.arctan2(opp[1], opp[0]))
    if patch_size_theta is None:
        patch_size_theta = float(jnp.deg2rad(10.0))
    if patch_size_phi is None:
        patch_size_phi = float(jnp.deg2rad(10.0))

    dirs = flat_ray_dirs(obs, observer.fov, h, w, dtype=dtype)
    rgb, hits = flat_raytrace(obs, dirs, boundary_radius,
                              patch_center_theta, patch_center_phi,
                              patch_size_theta, patch_size_phi,
                              jnp.asarray(bg_array, jnp.uint8),
                              flip_theta=flip_theta, flip_phi=flip_phi)
    trajs = []
    if n_sampled and n_sampled > 0:
        rng = _np.random.default_rng(seed)
        flat = rng.choice(h * w, size=min(n_sampled, h * w), replace=False)
        sampled_hits = hits.reshape(-1, 3)[jnp.asarray(flat)]
        trajs = list(_np.asarray(flat_trajectories(obs, sampled_hits)))
    return _np.asarray(rgb), trajs


def flat_trajectories(obs_pos, hits, n_points=100):
    """Straight-line sample points (K, n_points, 3) for sampled rays.

    Mirrors _flat_raytrace_kernel_with_traj (cuda_geodesic.py:154-163) /
    np.linspace(obs, hit, 100) (background.py:116).
    """
    obs = jnp.asarray(obs_pos, dtype=hits.dtype)
    alphas = jnp.linspace(0.0, 1.0, n_points, dtype=hits.dtype)
    return obs + alphas[None, :, None] * (hits[:, None, :] - obs)

"""Multi-device sharding: rays over one mesh axis, frames over a second.

The reference is strictly single-process / single-GPU (SURVEY.md section 2.2);
this module is the scale-out story this build adds.  Rays are embarrassingly
parallel, so the design is pure SPMD with `shard_map` over a
`jax.sharding.Mesh`:

  * axis 'rays'   — the flattened pixel batch of one frame, sharded across
                    devices (NVLink on one host).  Each device computes the camera
                    initial conditions for *its own* index slice (no
                    replicated (H, W) grid), integrates, classifies and
                    composites its pixels.  The only communication is the
                    implicit output all-gather when the host assembles the
                    image — zero per-step collectives, which is
                    speed-of-light for this workload.
  * axis 'frames' — independent frames of a camera-orbit animation / batch
                    job (frames never talk to each other, so this axis can
                    span hosts).

Camera orbits exploit spherical symmetry: orbiting the observer in the
equatorial plane is identical to holding the camera fixed and rotating the
background patch center by -delta_phi, so per-frame parameters are
(observer_distance, fov, patch_center_phi, ...) scalars.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..engine import classify as _classify
from ..engine.integrate import integrate_dispatch
from ..physics.camera import camera_rays_for_indices


def make_mesh(n_frames_shards=1, n_ray_shards=None, devices=None) -> Mesh:
    """('frames', 'rays') mesh over the available devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if n_ray_shards is None:
        n_ray_shards = devices.size // n_frames_shards
    assert n_frames_shards * n_ray_shards == devices.size, (
        f"mesh {n_frames_shards}x{n_ray_shards} != {devices.size} devices")
    return Mesh(devices.reshape(n_frames_shards, n_ray_shards),
                ("frames", "rays"))


def _local_ray_indices(n, n_ray_shards):
    """This device's flat pixel indices: the ray axis is padded up to a
    multiple of the shard count; padding shards recompute the last pixel
    (harmless, cropped by _run_sharded_frames)."""
    n_local = -(-n // n_ray_shards)
    shard = jax.lax.axis_index("rays")
    return jnp.minimum(shard * n_local + jax.lax.iota(jnp.int32, n_local),
                       n - 1)


def _run_sharded_frames(mesh, bg_array, obs_x, patch_center_phi, frame_body,
                        n, height, width):
    """Shared driver for the sharded renderers: runs
    frame_body(obs_x_f, patch_phi_f, bg) -> (image, cls, n_steps) slices
    over the ('frames', 'rays') mesh, then crops the padded ray axis and
    reshapes to (F, H, W, ...)."""
    def shard_body(bg, obs_x_l, patch_phi_l):
        # obs_x_l: (F_local,) — map frames within the shard.
        return jax.vmap(lambda ox, pp: frame_body(ox, pp, bg))(
            obs_x_l, patch_phi_l)

    image, cls, n_steps = jax.shard_map(
        shard_body, mesh=mesh,
        in_specs=(P(), P("frames"), P("frames")),
        out_specs=(P("frames", "rays"), P("frames", "rays"),
                   P("frames", "rays")),
        check_vma=False,
    )(bg_array, obs_x, patch_center_phi)

    f = obs_x.shape[0]
    image = image.reshape(f, -1, 3)[:, :n]
    cls = cls.reshape(f, -1)[:, :n]
    n_steps = n_steps.reshape(f, -1)[:, :n]
    return {
        "image": image.reshape(f, height, width, 3),
        "cls": cls.reshape(f, height, width),
        "n_steps": n_steps.reshape(f, height, width),
    }


@partial(jax.jit,
         static_argnames=("mesh", "height", "width", "steps", "flip_theta",
                          "flip_phi", "has_background", "dtype", "backend"))
def render_frames_sharded(mesh, bg_array, obs_x, fov, mass, boundary_radius,
                          steps, delta, omega,
                          patch_center_theta, patch_center_phi,
                          patch_size_theta, patch_size_phi,
                          *, height, width, flip_theta=False, flip_phi=False,
                          has_background=True, dtype=jnp.float32,
                          backend="xla"):
    """Render F frames over the ('frames', 'rays') mesh.

    Per-frame arrays (shape (F,)): obs_x, patch_center_phi.
    Scalars: everything else.  F must be divisible by the 'frames' axis and
    height*width by the 'rays' axis.

    Returns dict with image (F, H, W, 3), cls (F, H, W), n_steps (F, H, W).
    """
    n = height * width
    n_ray_shards = mesh.shape["rays"]

    obs_x = jnp.asarray(obs_x, dtype)
    patch_center_phi = jnp.asarray(patch_center_phi, dtype)

    def frame_body(obs_x_f, patch_phi_f, bg):
        """One frame, this device's ray slice."""
        flat_idx = _local_ray_indices(n, n_ray_shards)
        obs_pos = jnp.stack([obs_x_f, jnp.zeros_like(obs_x_f),
                             jnp.zeros_like(obs_x_f)])
        q0, p0, alpha0, heading, beta = camera_rays_for_indices(
            obs_pos, fov, height, width, flat_idx, mass_bh=mass, dtype=dtype)
        rs = 2.0 * mass
        final_q, final_p, status, n_steps = integrate_dispatch(
            q0, p0, steps, delta, rs, boundary_radius, omega,
            backend=backend, equatorial=True)
        cls, th_csv, ph_csv, u01, v01 = _classify.classify_rays(
            final_q, alpha0, beta, rs=rs, r_obs_x=obs_x_f,
            boundary_radius=boundary_radius,
            patch_center_theta=patch_center_theta,
            patch_center_phi=patch_phi_f,
            patch_size_theta=patch_size_theta,
            patch_size_phi=patch_size_phi,
            flip_theta=flip_theta, flip_phi=flip_phi,
            has_background=has_background)
        image = _classify.composite(cls, u01, v01, bg)
        return image, cls, n_steps

    return _run_sharded_frames(mesh, bg_array, obs_x, patch_center_phi,
                               frame_body, n, height, width)


@partial(jax.jit,
         static_argnames=("mesh", "height", "width", "steps", "flip_theta",
                          "flip_phi", "has_background", "dtype", "metric",
                          "order"))
def render_kerr_sharded(mesh, bg_array, obs_x, fov, mass, spin,
                        boundary_radius, steps, delta, omega,
                        patch_center_theta, patch_center_phi,
                        patch_size_theta, patch_size_phi,
                        *, height, width, flip_theta=False, flip_phi=False,
                        has_background=True, dtype=jnp.float32,
                        metric="KerrSchild", order=2, charge=0.0):
    """Kerr(-Newman) frames over the ('frames', 'rays') mesh — the
    generic-metric twin of render_frames_sharded.

    Kerr is only axisymmetric, so the camera-orbit-equals-patch-rotation
    trick still holds for *equatorial* orbits about the spin axis (the
    scene is invariant under rotations about +z), which is exactly the
    orbit family orbit_frames generates.  Uses the Cartesian Kerr-Schild
    chart end-to-end: unfolded camera, the single-device production
    integrator (integrate_generic.integrate_batch_chart: compensated
    flows in float32), status-pinned classification.
    """
    from ..engine.integrate import STATUS_CAPTURED
    from ..engine.integrate_generic import integrate_batch_chart
    from ..physics.camera import (cartesian_ics_from_pixels,
                                  pixel_positions_for_indices)
    from ..physics.coords import cartesian_to_spherical
    from ..physics.spacetime import METRICS, horizon_radius

    from ..physics.spacetime import COORDS
    assert COORDS[metric] == "cartesian", \
        "sharded Kerr-family frames use the Cartesian chart (KerrSchild " \
        "or a rotating regular family)"
    g_inv_fn = METRICS[metric]
    n = height * width
    n_ray_shards = mesh.shape["rays"]

    obs_x = jnp.asarray(obs_x, dtype)
    patch_center_phi = jnp.asarray(patch_center_phi, dtype)
    params = jnp.stack([jnp.asarray(mass, dtype), jnp.asarray(spin, dtype),
                        jnp.asarray(charge, dtype)])
    # same threshold formula as render_pixels_generic: the radius test
    # fires exactly at the Kerr-Schild capture shell 1.05 r_+ (the
    # bisected Delta-root shell for the mass-function families — the
    # orbit trick itself only needs axisymmetry, which they share)
    if metric == "KerrSchild":
        rs_classify = (1.05 / 1.2) * horizon_radius("Kerr", params[0],
                                                    params[1], params[2])
    else:
        from ..physics.rotating_regular import rotating_capture_radius
        rs_classify = rotating_capture_radius(metric, params) / 1.2

    def frame_body(obs_x_f, patch_phi_f, bg):
        flat_idx = _local_ray_indices(n, n_ray_shards)
        obs_pos = jnp.stack([obs_x_f, jnp.zeros_like(obs_x_f),
                             jnp.zeros_like(obs_x_f)])
        pix = pixel_positions_for_indices(obs_pos, fov, height, width,
                                          flat_idx, dtype=dtype)
        q0, p0, alpha0 = cartesian_ics_from_pixels(
            obs_pos, pix, params=params, g_inv_fn=g_inv_fn)
        final_q, final_p, status, n_steps = integrate_batch_chart(
            q0, p0, steps, delta, params, boundary_radius, omega,
            order=order, metric=metric, dtype=dtype)
        rho, th, ph = cartesian_to_spherical(
            final_q[:, 1], final_q[:, 2], final_q[:, 3])
        rho = jnp.where(status == STATUS_CAPTURED, jnp.zeros_like(rho), rho)
        fq_sph = jnp.stack([final_q[:, 0], rho, th, ph], axis=-1)
        cls, th_csv, ph_csv, u01, v01 = _classify.classify_rays(
            fq_sph, jnp.full_like(rho, jnp.pi), jnp.zeros_like(rho),
            rs=rs_classify, r_obs_x=obs_x_f,
            boundary_radius=boundary_radius,
            patch_center_theta=patch_center_theta,
            patch_center_phi=patch_phi_f,
            patch_size_theta=patch_size_theta,
            patch_size_phi=patch_size_phi,
            flip_theta=flip_theta, flip_phi=flip_phi,
            has_background=has_background)
        image = _classify.composite(cls, u01, v01, bg)
        return image, cls, n_steps

    return _run_sharded_frames(mesh, bg_array, obs_x, patch_center_phi,
                               frame_body, n, height, width)


@partial(jax.jit,
         static_argnames=("mesh", "height", "width", "steps", "flip_theta",
                          "flip_phi", "has_background", "dtype",
                          "order", "prograde", "profile", "camera_moving"))
def render_disk_sharded(mesh, bg_array, obs_x, fov, mass, spin,
                        boundary_radius, steps, delta, omega,
                        elevation, r_in, r_out, t_peak, exposure,
                        patch_center_theta, patch_center_phi,
                        patch_size_theta, patch_size_phi,
                        camera_omega=0.0,
                        *, height, width, flip_theta=False, flip_phi=False,
                        has_background=True, dtype=jnp.float32,
                        order=2, charge=0.0, prograde=True,
                        profile="shakura", camera_moving=False):
    """Accretion-disk frames over the ('frames', 'rays') mesh.

    The thin equatorial disk is axisymmetric like the hole, so the
    camera-orbit-equals-patch-rotation trick of render_kerr_sharded
    still holds with the inclined look-at camera: every frame shows the
    identical disk, only the lensed background rotates.  Per-frame
    arrays: obs_x (camera distance), patch_center_phi; the camera sits
    elevation radians above the equatorial plane.
    """
    from ..engine.disk import (CLS_DISK, STATUS_DISK, integrate_batch_disk,
                               shade_disk)
    from ..engine.integrate import STATUS_CAPTURED
    from ..physics.camera import (cartesian_ics_from_pixels,
                                  pixel_positions_for_indices_lookat)
    from ..physics.coords import cartesian_to_spherical
    from ..physics.spacetime import METRICS, horizon_radius, ks_radius

    g_inv_fn = METRICS["KerrSchild"]
    n = height * width
    n_ray_shards = mesh.shape["rays"]

    obs_x = jnp.asarray(obs_x, dtype)
    patch_center_phi = jnp.asarray(patch_center_phi, dtype)
    elevation = jnp.asarray(elevation, dtype)
    params = jnp.stack([jnp.asarray(mass, dtype), jnp.asarray(spin, dtype),
                        jnp.asarray(charge, dtype)])
    rs_classify = (1.05 / 1.2) * horizon_radius("Kerr", params[0],
                                                params[1], params[2])

    def frame_body(obs_d_f, patch_phi_f, bg):
        flat_idx = _local_ray_indices(n, n_ray_shards)
        obs_pos = jnp.stack([obs_d_f * jnp.cos(elevation),
                             jnp.zeros_like(obs_d_f),
                             obs_d_f * jnp.sin(elevation)])
        r_obs_bl = ks_radius(obs_pos[0], obs_pos[1], obs_pos[2], params[1])
        th_obs = jnp.arccos(jnp.clip(
            obs_pos[2] / jnp.maximum(r_obs_bl, 1e-30), -1.0, 1.0))
        pix = pixel_positions_for_indices_lookat(
            obs_pos, fov, height, width, flat_idx, dtype=dtype)
        if camera_moving:
            from ..physics.camera import boosted_ics_from_pixels
            q0, p0, _ = boosted_ics_from_pixels(
                obs_pos, pix, params=params, g_inv_fn=g_inv_fn,
                omega_cam=jnp.asarray(camera_omega, dtype))
        else:
            q0, p0, _ = cartesian_ics_from_pixels(obs_pos, pix,
                                                  params=params,
                                                  g_inv_fn=g_inv_fn)
        final_q, final_p, status, n_steps, hit_q, hit_p = \
            integrate_batch_disk(
                q0, p0, steps, delta, params, boundary_radius, omega,
                r_in, r_out, order=order)
        _, disk_rgb01 = shade_disk(
            hit_q, hit_p, params, r_obs_bl, r_in, prograde=prograde,
            t_peak=t_peak, exposure=exposure, theta_obs=th_obs,
            profile=profile, r_out=r_out,
            omega_obs=(jnp.asarray(camera_omega, dtype) if camera_moving
                       else 0.0))
        rho, th, ph = cartesian_to_spherical(
            final_q[:, 1], final_q[:, 2], final_q[:, 3])
        rho = jnp.where(status == STATUS_CAPTURED, jnp.zeros_like(rho), rho)
        fq_sph = jnp.stack([final_q[:, 0], rho, th, ph], axis=-1)
        cls, th_csv, ph_csv, u01, v01 = _classify.classify_rays(
            fq_sph, jnp.full_like(rho, jnp.pi), jnp.zeros_like(rho),
            rs=rs_classify, r_obs_x=obs_d_f,
            boundary_radius=boundary_radius,
            patch_center_theta=patch_center_theta,
            patch_center_phi=patch_phi_f,
            patch_size_theta=patch_size_theta,
            patch_size_phi=patch_size_phi,
            flip_theta=flip_theta, flip_phi=flip_phi,
            has_background=has_background)
        image = _classify.composite(cls, u01, v01, bg)
        dm = status == STATUS_DISK
        disk_u8 = jnp.clip(disk_rgb01 * 255.0 + 0.5, 0.0,
                           255.0).astype(jnp.uint8)
        image = jnp.where(dm[:, None], disk_u8, image)
        cls = jnp.where(dm, CLS_DISK, cls)
        return image, cls, n_steps

    return _run_sharded_frames(mesh, bg_array, obs_x, patch_center_phi,
                               frame_body, n, height, width)


def orbit_frames(scene, n_frames):
    """Per-frame parameter arrays for an equatorial camera orbit.

    Frame k rotates the camera by 2*pi*k/F about +z; by spherical symmetry
    this is the background patch center rotating by -2*pi*k/F.
    """
    phis = scene.patch.center_phi - 2.0 * np.pi * np.arange(n_frames) / n_frames
    obs = np.full(n_frames, scene.observer_distance)
    return obs, phis % (2 * np.pi)

"""Spin x inclination line-profile grids: SPMD science sweeps on the mesh.

The relativistic broad-line (Fe K-alpha) profile is THE observable used
to fit black-hole spin and disk inclination from X-ray spectra: the red
wing length tracks the ISCO (hence spin), the blue-horn sharpness tracks
inclination.  Fitting needs the forward model on a (spin, inclination)
grid — hundreds of full disk renders.  This module computes the whole
grid in one compiled SPMD program over the ('frames', 'rays') device
mesh (sharding/mesh.py): grid points ride the 'frames' axis (each point
is an independent spacetime + camera — zero communication), rays ride
the 'rays' axis, and the only collective in the entire program is one
`psum` per grid point that reduces the per-device flux histograms.

No images are produced or moved: each device histograms its local rays'
(g, r_em) into the fixed g-bin lattice on-chip, so the host transfer is
F x Q x B floats instead of F full frames — the whole sweep's output is
smaller than one rendered image.  Physics per ray matches
engine.disk.save_disk_maps' line profile exactly: pixel flux
g^4 r_em^-q for a narrow line with power-law emissivity, every pixel
subtending equal image-plane solid angle (lensing magnification enters
through the pixel count, Liouville through g^4).

Padding note: the ray axis pads up to a multiple of the shard count and
padding lanes recompute the last pixel (mesh._local_ray_indices).  The
image renderers crop the duplicates; a psum cannot, so padding lanes are
weight-masked to zero here instead.

No reference counterpart: the reference renders single background-
lensing views (/root/reference/simulation/raytracing.py) — no disk, no
spectra, no parameter sweeps.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P


@partial(jax.jit,
         static_argnames=("mesh", "height", "width", "steps", "order",
                          "dtype", "prograde", "n_bins",
                          "emissivity", "g_lo", "g_hi"))
def line_profile_grid_sharded(mesh, spins, elevations, obs_distance, fov,
                              mass, charge, boundary_radius, steps, delta,
                              omega, r_out, *, height, width, order=2,
                              dtype=jnp.float32,
                              prograde=True, n_bins=96, emissivity=(3.0,),
                              g_lo=0.1, g_hi=1.6):
    """One compiled program: (F,) spins x (F,) elevations -> (F, Q, B)
    line-profile flux histograms over fixed g bins.

    `spins`/`elevations` are per-grid-point arrays (flatten your 2-D grid;
    the frames axis doesn't care about its shape).  Each point traces a
    height x width camera at `elevations[k]` radians above the disk plane
    through a hole of spin `spins[k]`, disk annulus [ISCO(spin), r_out].
    `emissivity` is a static tuple of power-law indices q; the geodesic
    work is shared across all of them.  Bin b covers
    [g_lo + b*dg, g_lo + (b+1)*dg), dg = (g_hi-g_lo)/n_bins; out-of-range
    g is dropped (not clamped) so the histogram support is meaningful.
    """
    from ..engine.disk import STATUS_DISK, integrate_batch_disk
    from ..physics.camera import (cartesian_ics_from_pixels,
                                  pixel_positions_for_indices_lookat)
    from ..physics.orbits import isco_radius, redshift_factor
    from ..physics.spacetime import METRICS, ks_radius

    g_inv_fn = METRICS["KerrSchild"]
    n = height * width
    n_ray_shards = mesh.shape["rays"]

    spins = jnp.asarray(spins, dtype)
    elevations = jnp.asarray(elevations, dtype)
    obs_distance = jnp.asarray(obs_distance, dtype)
    fov = jnp.asarray(fov, dtype)
    mass = jnp.asarray(mass, dtype)
    charge = jnp.asarray(charge, dtype)
    boundary_radius = jnp.asarray(boundary_radius, dtype)
    delta = jnp.asarray(delta, dtype)
    omega = jnp.asarray(omega, dtype)
    r_out = jnp.asarray(r_out, dtype)

    def frame_body(spin_f, elev_f):
        params = jnp.stack([mass, spin_f, charge])
        r_in = isco_radius(mass, spin_f, prograde)

        n_local = -(-n // n_ray_shards)
        shard = jax.lax.axis_index("rays")
        gidx = shard * n_local + jax.lax.iota(jnp.int32, n_local)
        flat_idx = jnp.minimum(gidx, n - 1)
        real = gidx < n                      # mask duplicated padding rays

        obs_pos = jnp.stack([obs_distance * jnp.cos(elev_f),
                             jnp.zeros_like(elev_f),
                             obs_distance * jnp.sin(elev_f)])
        r_obs_bl = ks_radius(obs_pos[0], obs_pos[1], obs_pos[2], spin_f)
        th_obs = jnp.arccos(jnp.clip(
            obs_pos[2] / jnp.maximum(r_obs_bl, 1e-30), -1.0, 1.0))
        pix = pixel_positions_for_indices_lookat(obs_pos, fov, height,
                                                 width, flat_idx,
                                                 dtype=dtype)
        q0, p0, _ = cartesian_ics_from_pixels(obs_pos, pix, params=params,
                                              g_inv_fn=g_inv_fn)
        _, _, status, _, hit_q, hit_p = integrate_batch_disk(
            q0, p0, steps, delta, params, boundary_radius, omega,
            r_in, r_out, order=order)

        # redshift algebra as engine.disk.shade_disk (Killing constants)
        x, y = hit_q[:, 1], hit_q[:, 2]
        energy = -hit_p[:, 0]
        l_z = x * hit_p[:, 2] - y * hit_p[:, 1]
        r_em = ks_radius(hit_q[:, 1], hit_q[:, 2], hit_q[:, 3], spin_f)
        g = jax.vmap(lambda e, l, r: redshift_factor(
            e, l, r, r_obs_bl, params, prograde, th_obs))(energy, l_z,
                                                          r_em)

        dg = (g_hi - g_lo) / n_bins
        b = jnp.clip(jnp.floor((g - g_lo) / dg).astype(jnp.int32),
                     0, n_bins - 1)
        keep = ((status == STATUS_DISK) & real
                & (g >= g_lo) & (g < g_hi))
        hists = []
        for q in emissivity:
            w = jnp.where(keep,
                          g ** 4 * jnp.maximum(r_em, 1e-30) ** (-q),
                          jnp.zeros_like(g))
            hists.append(jax.ops.segment_sum(w, b, num_segments=n_bins))
        return jax.lax.psum(jnp.stack(hists), "rays")     # (Q, B)

    def shard_body(spins_l, elevs_l):
        return jax.vmap(frame_body)(spins_l, elevs_l)

    return jax.shard_map(shard_body, mesh=mesh,
                         in_specs=(P("frames"), P("frames")),
                         out_specs=P("frames"),
                         check_vma=False)(spins, elevations)


def g_bin_centers(n_bins=96, g_lo=0.1, g_hi=1.6):
    """Centers of the histogram lattice line_profile_grid_sharded fills."""
    edges = np.linspace(g_lo, g_hi, n_bins + 1)
    return 0.5 * (edges[1:] + edges[:-1])


@partial(jax.jit,
         static_argnames=("mesh", "height", "width", "steps", "order",
                          "n_orders", "dtype", "prograde", "emissivity_q"))
def subring_grid_sharded(mesh, spins, elevations, obs_distance, fov,
                         mass, charge, boundary_radius, steps, delta,
                         omega, r_out, *, height, width, order=2,
                         n_orders=3, dtype=jnp.float32, prograde=True,
                         emissivity_q=3.0):
    """Photon-ring subring scan: (F,) spins x elevations -> per-order
    flux, pixel counts, and the n0-n1 crossing delay — one SPMD program.

    The subring observables (Lyapunov demagnification ratio, inter-order
    delay) are the space-VLBI mass/spin ruler; scanning them over spin
    is hundreds of renders.  Same layout as line_profile_grid_sharded:
    grid points on 'frames' (independent spacetimes, zero communication),
    rays on 'rays', per-point psum reductions — the host transfer is
    F x (2 n_orders + 2) floats, no images.

    Per-order flux matches the line-grid weighting g^4 r^-q over pixels
    whose order-n crossing lands in [ISCO(spin), r_out]; delay01 is the
    mean BL-time gap t(n=0) - t(n=1) over rays with both crossings
    recorded (anywhere on the plane — the gap is a crossing property,
    not an emission property; engine/subring.subring_summary).

    Returns (flux (F, N), pixels (F, N), delay01_mean (F,),
    delay01_rays (F,)).
    """
    from ..engine.hotspot import bl_time_azimuth_offsets
    from ..engine.subring import integrate_batch_subrings
    from ..physics.camera import (cartesian_ics_from_pixels,
                                  pixel_positions_for_indices_lookat)
    from ..physics.orbits import isco_radius, redshift_factor
    from ..physics.spacetime import METRICS, ks_radius

    g_inv_fn = METRICS["KerrSchild"]
    n = height * width
    n_ray_shards = mesh.shape["rays"]

    spins = jnp.asarray(spins, dtype)
    elevations = jnp.asarray(elevations, dtype)
    obs_distance = jnp.asarray(obs_distance, dtype)
    fov = jnp.asarray(fov, dtype)
    mass = jnp.asarray(mass, dtype)
    charge = jnp.asarray(charge, dtype)
    boundary_radius = jnp.asarray(boundary_radius, dtype)
    delta = jnp.asarray(delta, dtype)
    omega = jnp.asarray(omega, dtype)
    r_out = jnp.asarray(r_out, dtype)

    def frame_body(spin_f, elev_f):
        params = jnp.stack([mass, spin_f, charge])
        r_in = isco_radius(mass, spin_f, prograde)

        n_local = -(-n // n_ray_shards)
        shard = jax.lax.axis_index("rays")
        gidx = shard * n_local + jax.lax.iota(jnp.int32, n_local)
        flat_idx = jnp.minimum(gidx, n - 1)
        real = gidx < n

        obs_pos = jnp.stack([obs_distance * jnp.cos(elev_f),
                             jnp.zeros_like(elev_f),
                             obs_distance * jnp.sin(elev_f)])
        r_obs_bl = ks_radius(obs_pos[0], obs_pos[1], obs_pos[2], spin_f)
        th_obs = jnp.arccos(jnp.clip(
            obs_pos[2] / jnp.maximum(r_obs_bl, 1e-30), -1.0, 1.0))
        pix = pixel_positions_for_indices_lookat(obs_pos, fov, height,
                                                 width, flat_idx,
                                                 dtype=dtype)
        q0, p0, _ = cartesian_ics_from_pixels(obs_pos, pix, params=params,
                                              g_inv_fn=g_inv_fn)
        _, _, status, _, hq, hp, count = integrate_batch_subrings(
            q0, p0, steps, delta, params, boundary_radius, omega,
            n_orders=n_orders, order=order)

        order_ids = jnp.arange(n_orders, dtype=jnp.int32)
        filled = count[None, :] > order_ids[:, None]           # (N, local)
        x, y = hq[..., 1], hq[..., 2]
        energy = -hp[..., 0]
        l_z = x * hp[..., 2] - y * hp[..., 1]
        r_em = ks_radius(x, y, hq[..., 3], spin_f)
        valid = filled & real[None, :] & (r_em >= r_in) & (r_em <= r_out)
        g = jax.vmap(jax.vmap(lambda e, l, r: redshift_factor(
            e, l, r, r_obs_bl, params, prograde, th_obs)))(energy, l_z,
                                                           r_em)
        w = jnp.where(
            valid,
            g ** 4 * jnp.maximum(r_em, 1e-30) ** (-emissivity_q),
            jnp.zeros_like(g))
        flux = jax.lax.psum(jnp.sum(w, axis=1), "rays")        # (N,)
        pixels = jax.lax.psum(jnp.sum(valid.astype(dtype), axis=1),
                              "rays")                          # (N,)

        both = (count > 1) & real
        t_off = jax.vmap(jax.vmap(
            lambda r: bl_time_azimuth_offsets(r, params)[0]))(r_em)
        t_bl = hq[..., 0] - t_off
        d01 = jnp.where(both, t_bl[0] - t_bl[1], jnp.zeros_like(t_bl[0]))
        d_sum = jax.lax.psum(jnp.sum(d01), "rays")
        d_cnt = jax.lax.psum(jnp.sum(both.astype(dtype)), "rays")
        return flux, pixels, d_sum / jnp.maximum(d_cnt, 1.0), d_cnt

    def shard_body(spins_l, elevs_l):
        return jax.vmap(frame_body)(spins_l, elevs_l)

    return jax.shard_map(shard_body, mesh=mesh,
                         in_specs=(P("frames"), P("frames")),
                         out_specs=P("frames"),
                         check_vma=False)(spins, elevations)


@partial(jax.jit,
         static_argnames=("mesh", "size", "steps", "order", "prograde",
                          "n_bins", "g_lo", "g_hi"))
def fisher_grid_sharded(mesh, spins, elevations, noise_sigma, *,
                        size=48, steps=4000, delta=0.1, omega=1.0,
                        order=2, r_out=14.0, obs_distance=30.0,
                        fov=1.396263, mass=1.0, charge=0.0,
                        boundary_radius=31.0, prograde=True,
                        emissivity_index=3.0, n_bins=48, g_lo=0.1,
                        g_hi=1.6):
    """Fisher forecast MAP over the (spin, elevation) plane: one SPMD
    program returning, per grid point, the 1-sigma marginalized errors
    sigma(spin), sigma(elevation) and the spin-elevation correlation a
    line-profile fit at that truth would attain with per-bin noise
    `noise_sigma`.

    This is the synthesis of the framework's two distinctive legs: the
    forward-mode AD Jacobian through the full geodesic integrator
    (engine/sensitivity.line_profile_model — jax.jacfwd rides straight
    through the masked while_loop) composed with the SPMD grid sweep
    (grid points on the 'frames' mesh axis, zero collectives — each
    point's Jacobian is an independent spacetime).  Mission design in
    one compiled program: where in parameter space does the observable
    constrain spin, and where does the degeneracy blind it?

    Returns (F, 3), float64 under x64: [sigma_spin, sigma_elev_rad,
    correlation].
    No reference counterpart at any level: the reference cannot
    differentiate its integrator, and has no disk, spectra or sweeps.
    """
    from ..engine.sensitivity import line_profile_model

    # widest dtype available: f64 under x64 (the intended production
    # setting for Fisher algebra), f32 otherwise (compile smoke tests)
    wide = jax.dtypes.canonicalize_dtype(jnp.float64)
    spins = jnp.asarray(spins, wide)
    elevations = jnp.asarray(elevations, wide)
    centers = jnp.linspace(g_lo + 0.5 * (g_hi - g_lo) / n_bins,
                           g_hi - 0.5 * (g_hi - g_lo) / n_bins, n_bins,
                           dtype=wide)
    knobs = dict(size=size, steps=steps, delta=delta, omega=omega,
                 order=order, r_out=r_out, obs_distance=obs_distance,
                 fov=fov, mass=mass, charge=charge,
                 boundary_radius=boundary_radius, prograde=prograde,
                 emissivity_index=emissivity_index)

    def point_fisher(spin_f, elev_f):
        theta = jnp.stack([spin_f, elev_f])
        jac = jax.jacfwd(
            lambda t: line_profile_model(t, centers, **knobs))(theta)
        f = (jac.T @ jac) / (jnp.asarray(noise_sigma, wide) ** 2)
        cov = jnp.linalg.inv(f)
        err = jnp.sqrt(jnp.diag(cov))
        corr = cov[0, 1] / jnp.maximum(err[0] * err[1], 1e-300)
        return jnp.stack([err[0], err[1], corr])

    def shard_body(spins_l, elevs_l):
        return jax.vmap(point_fisher)(spins_l, elevs_l)

    return jax.shard_map(shard_body, mesh=mesh,
                         in_specs=(P("frames"), P("frames")),
                         out_specs=P("frames"),
                         check_vma=False)(spins, elevations)

"""Photon-ring subring decomposition: image orders n = 0, 1, 2, ... resolved.

The black-hole image of an optically THIN equatorial disk is a sum of
sub-images: light that crossed the equatorial plane n times between the
emission event and the camera (Gralla-Holz-Wald image orders).  The n = 0
layer is the direct image; n = 1 the strongly lensed far-side image; n >= 2
the "photon ring" — exponentially demagnified copies converging on the
Bardeen critical curve, with successive orders suppressed by e^{-gamma}
(gamma = pi for Schwarzschild) and delayed by the photon-shell half-period
(pi / Omega_ph = 3 sqrt(3) pi M ~ 16.32 M face-on) — the two numbers that
make the photon ring a mass/spin ruler for space-VLBI.

This module renders those layers SEPARATELY from one geodesic pass: the
crossing detector of engine/disk.py generalized from "freeze on the first
annulus crossing" (opaque disk) to "record the first N_ORDERS plane
crossings and keep tracing" (transparent disk).  Everything downstream —
per-order redshift maps, per-order images, subring delay maps, flux-ratio
Lyapunov estimates — is elementwise algebra on the recorded crossing
events, fused into the same XLA program.

Design notes:
  * the slot store is a dense (N_ORDERS, N, 4) carry updated with a
    one-hot `where` (no scatters) — N_ORDERS is a static compile-time
    constant, so the loop body stays a fixed-shape fused program;
  * rays do NOT retire on a hit (the thin disk is transparent), so the
    early-exit population is identical to the plain lensing render: the
    `lax.while_loop` cost is the classification budget, not
    N_ORDERS-dependent;
  * crossings are counted for ANY plane crossing (the GHW order counts
    half-orbits, not disk hits); annulus membership is applied at shading
    time from the stored event, so a ray that crosses inside the ISCO gap
    at order 0 and hits the disk at order 1 lands in the correct layer.

No reference counterpart: the reference traces background lensing only
(simulation/raytracing.py:164-280) and cannot separate image orders.
"""
from __future__ import annotations

import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..physics.hamiltonian import substep_schedule
from ..physics.spacetime import METRICS, _charge, horizon_radius, ks_radius, make_step
from .disk import (DiskConfig, STATUS_DISK, CLS_DISK, _nt_temp_table,
                   _temp_profile, blackbody_rgb, disk_observer_position,
                   resolve_camera_omega)
from .integrate import STATUS_CAPTURED
from .integrate_generic import _domain_tools


def integrate_batch_subrings(q0s, p0s, steps, delta, params, r_max, omega,
                             n_orders=3, order=2):
    """Kerr-Schild batch integration recording the first `n_orders`
    equatorial-plane crossings per ray (image orders 0..n_orders-1).

    Same masked while_loop / guard / Bardeen-rescue semantics as
    integrate_batch_disk (engine/disk.py), except rays never freeze on a
    crossing: `count` totals ALL plane crossings seen while active, and
    the first `n_orders` events are linearly interpolated within their
    step and stored densely.

    Returns (final_q, final_p, status, n_steps, hits_q, hits_p, count)
    with hits_q/hits_p of shape (n_orders, N, 4).
    """
    metric = "KerrSchild"
    g_inv_fn = METRICS[metric]
    step1 = make_step(g_inv_fn)

    dtype = q0s.dtype
    delta = jnp.asarray(delta, dtype)
    params = jnp.asarray(params, dtype)
    r_max = jnp.asarray(r_max, dtype)
    subs = substep_schedule(delta, jnp.asarray(omega, dtype), order)

    vstep = jax.vmap(lambda q1, p1, q2, p2: step1(q1, p1, q2, p2, params,
                                                  subs))
    _, _, active_mask, guard, r_cap = _domain_tools(
        metric, params, delta, r_max, dtype, g_inv_fn)

    n = q0s.shape[0]
    n_steps0 = jnp.zeros(n, dtype=jnp.int32)
    count0 = jnp.zeros(n, dtype=jnp.int32)
    hq0 = jnp.zeros((n_orders, n, 4), dtype)
    hp0 = jnp.zeros((n_orders, n, 4), dtype)
    order_ids = jnp.arange(n_orders, dtype=jnp.int32)
    carry0 = (q0s, p0s, q0s, p0s, n_steps0, jnp.int32(0), count0, hq0, hp0)

    def cond(c):
        q1 = c[0]
        k = c[5]
        return (k < steps) & jnp.any(active_mask(q1))

    def body(c):
        q1, p1, q2, p2, ns, k, count, hq, hp = c
        act = active_mask(q1)
        nq1, np1, nq2, np2 = vstep(q1, p1, q2, p2)
        bad, nq1 = guard(q1, p1, nq1, np1)
        np1 = jnp.where(bad[:, None], p1, np1)
        nq2 = jnp.where(bad[:, None], q2, nq2)
        np2 = jnp.where(bad[:, None], p2, np2)

        # --- equatorial crossing, lerped within the step (disk.py) ---
        z0, z1 = q1[:, 3], nq1[:, 3]
        crossed = (z0 * z1) < 0.0
        t = z0 / (z0 - z1)
        t = jnp.where(crossed, t, 0.0)
        cq = q1 + t[:, None] * (nq1 - q1)
        # p2 copy, matching the Pallas kernel's exact step-boundary pair
        # (q1, p2) — see engine/disk.py's recorder for the rationale
        cp = p2 + t[:, None] * (np2 - p2)
        new_cross = act & ~bad & crossed
        # one-hot slot write: the event lands in layer `count` if a slot
        # is still free (counts beyond n_orders keep incrementing so the
        # total winding diagnostic stays honest)
        take = new_cross[None, :] & (count[None, :] == order_ids[:, None])
        hq = jnp.where(take[..., None], cq[None, :, :], hq)
        hp = jnp.where(take[..., None], cp[None, :, :], hp)
        count = count + new_cross.astype(jnp.int32)

        ns_new = ns + act.astype(jnp.int32)
        ns_new = jnp.where(act & bad, -ns_new, ns_new)

        def masked(new, old):
            return jnp.where(act[:, None], new, old)
        return (masked(nq1, q1), masked(np1, p1), masked(nq2, q2),
                masked(np2, p2), ns_new, k + 1, count, hq, hp)

    q1, p1, q2, _, ns, _, count, hq, hp = jax.lax.while_loop(cond, body,
                                                             carry0)

    from .integrate_ks import apply_bardeen_rescue
    q1, p1, status, n_steps = apply_bardeen_rescue(
        q1, p1, ns, q2[:, 1:], q0s, p0s, params[0], params[1],
        _charge(params), r_cap, r_max)
    return q1, p1, status, n_steps, hq, hp, count


def shade_subrings(hits_q, hits_p, count, params, r_obs_bl, r_in, r_out, *,
                   prograde=True, theta_obs=jnp.pi / 2, profile="shakura",
                   t_peak=9000.0, exposure=2.5, omega_obs=0.0):
    """Per-order shading of recorded crossings -> layered observables.

    For each image order n: the crossing is a disk EMISSION event iff the
    slot was filled (count > n) and its BL radius lies in [r_in, r_out].
    Each valid event gets the exact Killing-constant redshift g_n
    (physics/orbits.redshift_factor — identical algebra to the opaque
    disk, engine/disk.shade_disk) and a Liouville intensity
    I_n = (g_n T(r_n))^4.  Layers are ADDITIVE (optically thin).

    Returns a dict of (n_orders, N) arrays {g, intensity, r_em, t_hit,
    valid} plus the composited (N, 3) rgb01 and (N,) total intensity /
    transparency tone.  Color uses the intensity-weighted mean observed
    temperature across orders (sub-percent from per-layer blackbody
    blending at disk temperatures, and an order-unambiguous definition).
    """
    from ..physics.orbits import redshift_factor

    n_orders = hits_q.shape[0]
    spin = params[1]
    x, y = hits_q[..., 1], hits_q[..., 2]
    energy = -hits_p[..., 0]
    l_z = x * hits_p[..., 2] - y * hits_p[..., 1]
    r_em = ks_radius(x, y, hits_q[..., 3], spin)

    order_ids = jnp.arange(n_orders, dtype=jnp.int32)
    filled = count[None, :] > order_ids[:, None]
    valid = filled & (r_em >= r_in) & (r_em <= r_out)

    g = jax.vmap(jax.vmap(lambda e, l, r: redshift_factor(
        e, l, r, r_obs_bl, params, prograde, theta_obs,
        omega_obs)))(energy, l_z, r_em)
    g = jnp.where(valid, g, 0.0)

    if profile == "novikov":
        r_grid, t_tab = _nt_temp_table(r_in, jnp.asarray(r_out, r_em.dtype),
                                       params, prograde, r_em.dtype)
        t_norm = jnp.interp(r_em, r_grid, t_tab)
    else:
        t_norm = _temp_profile(r_em, r_in)
    t_obs = g * t_norm
    intensity = jnp.where(valid, t_obs ** 4, 0.0)

    total = jnp.sum(intensity, axis=0)
    tone = 1.0 - jnp.exp(-exposure * total)
    tone_disp = tone ** (1.0 / 2.2)
    t_eff = jnp.sum(intensity * t_obs, axis=0) / jnp.maximum(total, 1e-30)
    rgb01 = blackbody_rgb(t_eff * t_peak) * tone_disp[:, None]
    return {
        "g": g,
        "intensity": intensity,
        "r_em": r_em,
        "t_hit": hits_q[..., 0],
        "valid": valid,
        "rgb01": rgb01,
        "tone": tone_disp,
        "total_intensity": total,
    }


def _trace_shade_subrings(q0f, p0f, bg_array, params, r_obs, r_obs_bl,
                          th_obs, boundary_radius, steps, delta, omega,
                          r_in, r_out, t_peak, exposure,
                          patch_center_theta, patch_center_phi,
                          patch_size_theta, patch_size_phi, *,
                          n_orders, order, backend, dtype, prograde,
                          profile, flip_theta, flip_phi, has_background,
                          omega_obs=None):
    """The per-ray subring chain on FLAT (N, 4) phase points: transparent-
    disk integration (the autodiff engine, or with backend='pallas' the
    Kahan-compensated hand-derived twin) ->
    per-order shade -> endpoint classify -> additive thin-disk composite.
    Shared by the full-frame program (render_pixels_subrings) and the
    adaptive edge-refinement sub-ray pass (aa.refine_subrings) so a
    sub-ray is shaded exactly like a center ray."""
    from ..physics.coords import cartesian_to_spherical
    from . import classify as _classify

    n = q0f.shape[0]
    if backend == "pallas":
        from .integrate_ks import integrate_batch_subrings_ksc
        final_q, final_p, status, n_steps, hq, hp, count = \
            integrate_batch_subrings_ksc(
                q0f, p0f, steps, delta, params, boundary_radius, omega,
                n_orders=n_orders, order=order)
    else:
        final_q, final_p, status, n_steps, hq, hp, count = \
            integrate_batch_subrings(q0f, p0f, steps, delta, params,
                                     boundary_radius, omega,
                                     n_orders=n_orders, order=order)

    shade = shade_subrings(
        hq, hp, count, params, r_obs_bl, r_in, r_out, prograde=prograde,
        theta_obs=th_obs, profile=profile, t_peak=t_peak,
        exposure=exposure,
        omega_obs=(omega_obs if omega_obs is not None
                   else jnp.zeros((), dtype)))

    # background classification of the ray ENDPOINTS (transparent disk:
    # every escaped ray still lands on the sky)
    rho, th, ph = cartesian_to_spherical(final_q[:, 1], final_q[:, 2],
                                         final_q[:, 3])
    rho = jnp.where(status == STATUS_CAPTURED, jnp.zeros_like(rho), rho)
    fq_sph = jnp.stack([final_q[:, 0], rho, th, ph], axis=-1)
    r_plus = horizon_radius("Kerr", params[0], params[1], params[2])
    rs_classify = (1.05 / 1.2) * r_plus
    cls, th_csv, ph_csv, u01, v01 = _classify.classify_rays(
        fq_sph, jnp.full((n,), jnp.pi, dtype), jnp.zeros((n,), dtype),
        rs=rs_classify, r_obs_x=r_obs, boundary_radius=boundary_radius,
        patch_center_theta=patch_center_theta,
        patch_center_phi=patch_center_phi,
        patch_size_theta=patch_size_theta,
        patch_size_phi=patch_size_phi,
        flip_theta=flip_theta, flip_phi=flip_phi,
        has_background=has_background)
    bg = _classify.composite(cls, u01, v01, bg_array if has_background
                             else jnp.zeros((1, 1, 3), dtype=jnp.uint8))

    # additive thin-disk blend: out = bg * (1 - tone) + disk emission
    tone = shade["tone"]
    disk_rgb = jnp.clip(shade["rgb01"] * 255.0, 0.0, 255.0)
    out = (bg.astype(dtype) * (1.0 - tone[:, None]) + disk_rgb)
    image = jnp.clip(out + 0.5, 0.0, 255.0).astype(jnp.uint8)
    emitting = shade["valid"].any(axis=0)
    cls = jnp.where(emitting, CLS_DISK, cls)
    return {"image": image, "cls": cls, "status": status,
            "n_steps": n_steps, "count": count, "hq": hq, "hp": hp,
            "shade": shade}


@partial(jax.jit,
         static_argnames=("height", "width", "steps", "order", "n_orders",
                          "flip_theta", "flip_phi", "has_background",
                          "dtype", "prograde", "profile", "camera_moving",
                          "backend", "bfield"))
def render_pixels_subrings(bg_array, obs_pos, fov, mass, spin, charge,
                           boundary_radius, steps, delta, omega,
                           r_in, r_out, t_peak, exposure,
                           patch_center_theta, patch_center_phi,
                           patch_size_theta, patch_size_phi,
                           camera_omega=0.0,
                           *, height, width, n_orders=3, order=2,
                           flip_theta=False, flip_phi=False,
                           has_background=True, dtype=jnp.float32,
                           prograde=True, profile="shakura",
                           camera_moving=False, backend="xla",
                           bfield=None):
    """One compiled program: camera -> subring integration -> per-order
    shade -> additive thin-disk composite over the lensed background.

    The transparent-disk analog of render_pixels_disk (engine/disk.py):
    escaped rays composite the background through the disk's transparency
    (1 - tone), captured rays stay black, and every per-order observable
    (redshift, intensity, emission radius, BL arrival time) comes back as
    an (n_orders, H, W) stack.

    backend='pallas' (what 'auto' resolves to on a GPU) runs the
    Kahan-compensated hand-derived flows
    (integrate_ks.integrate_batch_subrings_ksc); 'xla' the autodiff
    while_loop engine (integrate_batch_subrings).
    """
    from ..physics.camera import cartesian_ics_from_pixels, pixel_grid_lookat
    from . import classify as _classify

    g_inv_fn = METRICS["KerrSchild"]
    params = jnp.stack([jnp.asarray(mass, dtype), jnp.asarray(spin, dtype),
                        jnp.asarray(charge, dtype)])
    obs_pos = jnp.asarray(obs_pos, dtype)
    r_obs = jnp.linalg.norm(obs_pos)
    r_obs_bl = ks_radius(obs_pos[0], obs_pos[1], obs_pos[2], params[1])
    th_obs = jnp.arccos(jnp.clip(obs_pos[2] / jnp.maximum(r_obs_bl, 1e-30),
                                 -1.0, 1.0))
    pix = pixel_grid_lookat(obs_pos, fov, height, width, dtype=dtype)
    camera_omega = jnp.asarray(camera_omega, dtype)
    if camera_moving:
        from ..physics.camera import boosted_ics_from_pixels
        q0, p0, alpha0 = boosted_ics_from_pixels(
            obs_pos, pix, params=params, g_inv_fn=g_inv_fn,
            omega_cam=camera_omega)
    else:
        q0, p0, alpha0 = cartesian_ics_from_pixels(
            obs_pos, pix, params=params, g_inv_fn=g_inv_fn)
    n = height * width
    q0f, p0f = q0.reshape(n, 4), p0.reshape(n, 4)

    flat = _trace_shade_subrings(
        q0f, p0f, bg_array, params, r_obs, r_obs_bl, th_obs,
        boundary_radius, steps, delta, omega, r_in, r_out, t_peak,
        exposure, patch_center_theta, patch_center_phi,
        patch_size_theta, patch_size_phi,
        n_orders=n_orders, order=order, backend=backend, dtype=dtype,
        prograde=prograde, profile=profile, flip_theta=flip_theta,
        flip_phi=flip_phi, has_background=has_background,
        omega_obs=camera_omega if camera_moving else None)
    image, cls, status, n_steps = (flat["image"], flat["cls"],
                                   flat["status"], flat["n_steps"])
    count, hq, hp, shade = (flat["count"], flat["hq"], flat["hp"],
                            flat["shade"])
    emitting = shade["valid"].any(axis=0)

    # --- per-order polarized imaging: the photon ring's EVPA twist ---
    # kappa (Walker-Penrose) is evaluated at each ORDER's recorded
    # emission event, but every order shares the same camera ray, so the
    # screen solve reuses (q0, p0): one geodesic pass yields the EVPA
    # rotation between the direct image and each subring (the
    # order-by-order polarization spiral flip — Palumbo-style
    # observable; no reference counterpart).
    pol = None
    if bfield is not None:
        from .disk import polarization_fields
        pol = jax.vmap(
            lambda hq_s, hp_s, v_s: polarization_fields(
                hq_s, hp_s, q0f, p0f, obs_pos, fov, height, width,
                params, prograde, bfield, v_s, dtype)
        )(hq, hp, shade["valid"])

    count_vec = jnp.stack([
        jnp.sum(cls == _classify.CLS_BH),
        jnp.sum(cls == _classify.CLS_IN_DOMAIN),
        jnp.sum((cls == _classify.CLS_ESCAPE_NO_PATCH)
                | (cls == _classify.CLS_ESCAPE_BG)),
        jnp.sum(cls == _classify.CLS_ESCAPE_BG),
        jnp.sum(cls == _classify.CLS_NUMERICAL),
        jnp.sum(emitting),
    ])
    hw = (height, width)
    return {
        "image": image.reshape(height, width, 3),
        "cls": cls.reshape(hw),
        "status": status.reshape(hw),
        "n_steps": n_steps.reshape(hw),
        "count": count.reshape(hw),
        "q0": q0,
        "p0": p0,
        "alpha0": alpha0,
        "hits_q": hq.reshape((-1,) + hw + (4,)),
        "hits_p": hp.reshape((-1,) + hw + (4,)),
        "g": shade["g"].reshape((-1,) + hw),
        "intensity": shade["intensity"].reshape((-1,) + hw),
        "r_em": shade["r_em"].reshape((-1,) + hw),
        "valid": shade["valid"].reshape((-1,) + hw),
        "total_intensity": shade["total_intensity"].reshape(hw),
        "count_vec": count_vec,
    } | ({} if pol is None else {
        "evpa": pol[0].reshape((-1,) + hw),
        "pol_weight": pol[1].reshape((-1,) + hw),
        "pol_check": pol[2].reshape((-1,) + hw),
    })


def render_subrings(scene, disk: DiskConfig = None, *, n_orders=3,
                    bg_array=None, dtype=None, aa_samples=None):
    """Scene-level driver: SceneConfig (+ DiskConfig) -> subring render
    result on the host.  Mirrors engine/disk.render_disk's knob handling
    (inclined look-at camera, ISCO inner edge, camera worldline).

    aa_samples=s re-traces s^2 stratified sub-rays through every layer
    boundary pixel (aa.refine_subrings) and replaces the displayed
    colors AND the per-order intensity maps with pixel-area averages —
    the n >= 1 subring fluxes converge at a fraction of uniform
    supersampling's cost (the result gains an 'aa_mask' entry)."""
    from .integrate import resolve_backend

    disk = disk or DiskConfig()
    h, w = scene.image_size
    integ = scene.integrator
    backend = resolve_backend(integ.backend)
    if dtype is None:
        dtype = jnp.float64 if integ.dtype == "float64" else jnp.float32
    has_bg = bg_array is not None and disk.show_background
    bg_dev = (jnp.asarray(bg_array, dtype=jnp.uint8) if has_bg
              else jnp.zeros((1, 1, 3), dtype=jnp.uint8))
    params = np.array([scene.bh_mass, scene.spin, scene.charge])
    r_in = disk.inner_edge(scene.bh_mass, scene.spin, scene.charge)
    obs_pos = disk_observer_position(scene, disk)
    moving, omega_cam = resolve_camera_omega(scene, disk)

    res = render_pixels_subrings(
        bg_dev,
        jnp.asarray(obs_pos, dtype),
        jnp.asarray(scene.fov, dtype),
        jnp.asarray(scene.bh_mass, dtype),
        jnp.asarray(scene.spin, dtype),
        jnp.asarray(scene.charge, dtype),
        jnp.asarray(scene.boundary_radius, dtype),
        integ.steps,
        jnp.asarray(integ.delta, dtype),
        jnp.asarray(integ.omega, dtype),
        jnp.asarray(r_in, dtype),
        jnp.asarray(disk.r_out, dtype),
        jnp.asarray(disk.t_peak, dtype),
        jnp.asarray(disk.exposure, dtype),
        jnp.asarray(scene.patch.center_theta, dtype),
        jnp.asarray(scene.patch.center_phi, dtype),
        jnp.asarray(scene.patch.size_theta, dtype),
        jnp.asarray(scene.patch.size_phi, dtype),
        jnp.asarray(omega_cam, dtype),
        height=h, width=w, n_orders=n_orders, order=integ.order,
        flip_theta=scene.patch.flip_theta, flip_phi=scene.patch.flip_phi,
        has_background=has_bg, dtype=dtype, prograde=disk.prograde,
        profile=disk.profile, camera_moving=moving, backend=backend,
        bfield=disk.bfield)

    if aa_samples:
        from .aa import refine_subrings
        (res["image"], res["intensity"], res["total_intensity"],
         res["aa_mask"]) = refine_subrings(
            res["cls"], res["count"], res["valid"], res["image"],
            res["intensity"], bg_dev,
            jnp.asarray(obs_pos, dtype),
            jnp.asarray(scene.fov, dtype),
            jnp.asarray(scene.bh_mass, dtype),
            jnp.asarray(scene.spin, dtype),
            jnp.asarray(scene.charge, dtype),
            jnp.asarray(scene.boundary_radius, dtype),
            integ.steps,
            jnp.asarray(integ.delta, dtype),
            jnp.asarray(integ.omega, dtype),
            jnp.asarray(r_in, dtype),
            jnp.asarray(disk.r_out, dtype),
            jnp.asarray(disk.t_peak, dtype),
            jnp.asarray(disk.exposure, dtype),
            jnp.asarray(scene.patch.center_theta, dtype),
            jnp.asarray(scene.patch.center_phi, dtype),
            jnp.asarray(scene.patch.size_theta, dtype),
            jnp.asarray(scene.patch.size_phi, dtype),
            jnp.asarray(omega_cam, dtype),
            height=h, width=w, samples=int(aa_samples),
            n_orders=n_orders, order=integ.order, backend=backend,
            flip_theta=scene.patch.flip_theta,
            flip_phi=scene.patch.flip_phi, has_background=has_bg,
            dtype=dtype, prograde=disk.prograde, profile=disk.profile,
            camera_moving=moving)

    return {k: np.asarray(v) for k, v in res.items()} | {
        "params": params, "r_in": float(r_in), "r_out": float(disk.r_out),
        "obs_pos": np.asarray(obs_pos), "n_orders": n_orders,
    }


# ---------------------------------------------------------------------------
# Science artifacts
# ---------------------------------------------------------------------------

def subring_visibilities(result, fov_rad, pad=6, n_bins=400):
    """Per-order u-v signatures from one subring render: each layer's
    |V|(b) radial profile, first null, and thin-ring diameter estimate,
    in camera radians (multiply baselines by visibility.camera_to_earth
    for physical wavelengths at a real source).

    Physics: the n-th layer converges exponentially onto the Bardeen
    critical curve, so for n >= 1 it IS close to the infinitesimally
    thin ring the J0 null estimator assumes — the estimator is cleaner
    on the decomposed layers than on the composite image, where the
    direct emission fills the ring in and shifts the null (the dominant
    systematic of ring-diameter extraction from total images).  The
    interferometric subring program (Johnson et al. 2020: long-baseline
    visibility plateaus per order) reads these per-order profiles
    directly.

    Returns a list of dicts {order, baselines, profile, b_null,
    ring_diameter_rad}; unpopulated layers get NaN estimates.
    """
    from .visibility import (first_null, radial_profile,
                             ring_diameter_from_null, visibility_map)

    inten = np.asarray(result["intensity"], np.float64)
    n_orders, h, w = inten.shape
    pixel_cam = 2.0 * np.tan(fov_rad / 2.0) / w
    out = []
    for n in range(n_orders):
        if inten[n].sum() <= 0.0:
            out.append({"order": n, "baselines": None, "profile": None,
                        "b_null": float("nan"),
                        "ring_diameter_rad": float("nan")})
            continue
        amp, u, v = visibility_map(inten[n], pixel_cam, pad=pad)
        base, prof = radial_profile(amp, u, v, n_bins=n_bins,
                                    b_max=min(u.max(), v.max()) / 4.0)
        b_null = first_null(base, prof)
        out.append({"order": n, "baselines": base, "profile": prof,
                    "b_null": b_null,
                    "ring_diameter_rad": ring_diameter_from_null(b_null)})
    return out


def polarized_moments(result, ms=(1, 2)):
    """Azimuthal decomposition of the complex polarization field per
    image order: beta_m (Palumbo, Wong & Prather 2020, ApJ 894 156).

        beta_m = sum_px P e^{-i m psi} / sum_px I,   P = p I e^{2 i chi}

    with psi the screen position angle of the pixel about the image
    center, chi the EVPA in the same screen basis (ticks measured from
    camera-up toward camera-right, physics.polarization.observer_evpa),
    I the layer intensity and p the pitch-angle weight (sin^2 theta_B —
    the synchrotron geometry factor this framework uses as fractional
    polarization).  beta_2 is THE photon-ring polarization observable:
    arg(beta_2) = 0 is a radial EVPA pattern, +-pi azimuthal, and the
    n=0 -> n=1 handedness flip of a spiral pattern shows up as an
    arg(beta_2) rotation between the layers.

    Returns {m: [complex per order]} (host-side python complex).
    """
    inten = np.asarray(result["intensity"], dtype=np.float64)
    evpa = np.asarray(result["evpa"], dtype=np.float64)
    wgt = np.asarray(result["pol_weight"], dtype=np.float64)
    n_orders, h, w = inten.shape
    ii, jj = np.mgrid[0:h, 0:w]
    # rows advance along camera-up, columns along camera-right — the
    # same (i, j) -> screen convention as the EVPA ticks, so psi and chi
    # share an origin and orientation
    psi = np.arctan2(jj - (w - 1) / 2.0, ii - (h - 1) / 2.0)
    pfield = wgt * inten * np.exp(2j * evpa)
    out = {}
    for m in ms:
        phase = np.exp(-1j * m * psi)
        out[int(m)] = [
            complex((pfield[n] * phase).sum()
                    / max(inten[n].sum(), 1e-300))
            for n in range(n_orders)]
    return out


def subring_summary(result):
    """Flux-per-order table + Lyapunov / delay estimates from a subring
    render result (host-side numpy).

    * flux F_n = sum of per-pixel intensity of layer n (solid-angle
      weights are uniform across the pixel grid, so the sum IS the flux
      integral up to one constant);
    * gamma_hat = ln(F_n / F_{n+1}) between the two highest orders with
      nonzero flux — the measured demagnification exponent (-> pi for
      Schwarzschild as n grows; n = 1/2 retain direct-emission structure
      so quote it as an estimate, not the asymptote);
    * delay_n = median BL arrival-time gap t_{n-1} - t_n over pixels
      where both layers emit (-> the photon-shell half-period near the
      critical curve; 3 sqrt(3) pi M ~ 16.32 M for a = 0 face-on).
      Kerr-Schild and BL time differ by a pure function of radius
      (hotspot.bl_time_azimuth_offsets), so the gap is evaluated in BL
      time to compare events at different radii exactly.
    """
    from .hotspot import bl_time_azimuth_offsets

    inten = np.asarray(result["intensity"], dtype=np.float64)
    valid = np.asarray(result["valid"])
    n_orders = inten.shape[0]
    params = jnp.asarray(result["params"])

    r_em = np.asarray(result["r_em"], dtype=np.float64)
    t_ks = np.asarray(result["hits_q"][..., 0], dtype=np.float64)
    t_off = np.asarray(jax.vmap(
        lambda r: bl_time_azimuth_offsets(r, params)[0]
    )(jnp.asarray(r_em.reshape(n_orders, -1))))
    t_bl = t_ks - t_off.reshape(t_ks.shape)

    flux = [float(inten[i].sum()) for i in range(n_orders)]
    pix = [int(valid[i].sum()) for i in range(n_orders)]
    ratios = [flux[i + 1] / flux[i] if flux[i] > 0 else float("nan")
              for i in range(n_orders - 1)]
    gamma_hat = float("nan")
    for i in range(n_orders - 2, -1, -1):
        if flux[i] > 0 and flux[i + 1] > 0:
            gamma_hat = float(np.log(flux[i] / flux[i + 1]))
            break
    # delay masks use SLOT-FILLED (count > i), not annulus-valid: the
    # n-1 crossing of a photon-ring pixel often lands inside the ISCO
    # gap (no emission) but the crossing EVENT — and hence the subring
    # time delay — is still exact
    count = np.asarray(result["count"]).reshape(-1)
    filled = count[None, :] > np.arange(n_orders)[:, None]
    filled = filled.reshape(valid.shape)
    delays = []
    for i in range(1, n_orders):
        both = filled[i] & filled[i - 1]
        # past-directed rays: deeper orders were emitted EARLIER (more
        # negative t), so the physical delay is t_{n-1} - t_n > 0
        delays.append(float(np.median(t_bl[i - 1][both] - t_bl[i][both]))
                      if both.any() else float("nan"))
    out = {
        "flux_per_order": flux,
        "pixels_per_order": pix,
        "flux_ratio": ratios,
        "gamma_hat": gamma_hat,
        "delay_per_order_M": delays,
        "max_crossings": int(np.asarray(result["count"]).max()),
    }
    if "evpa" in result:
        # per-order EVPA twist: the photon ring's polarization-spiral
        # rotation between adjacent image orders — median mod-pi-wrapped
        # angle difference over pixels emitting in BOTH layers.  The
        # n=0 -> n=1 flip of the spiral handedness is the Palumbo-style
        # discriminator of the field geometry.
        evpa = np.asarray(result["evpa"], dtype=np.float64)
        twists = []
        for i in range(1, n_orders):
            both = valid[i] & valid[i - 1]
            if both.any():
                d = evpa[i][both] - evpa[i - 1][both]
                d = (d + np.pi / 2) % np.pi - np.pi / 2  # EVPA is mod pi
                twists.append(float(np.median(d)))
            else:
                twists.append(float("nan"))
        out["evpa_twist_per_order_rad"] = twists
        beta = polarized_moments(result, ms=(2,))[2]
        out["beta2_abs_per_order"] = [abs(b) for b in beta]
        out["beta2_arg_per_order_rad"] = [
            float(np.angle(b)) if abs(b) > 0 else float("nan")
            for b in beta]
    return out


def save_subring_maps(result, out_dir):
    """Write the subring science products: per-order intensity / redshift
    / delay maps (PNG + CSV) and a JSON summary (subring_summary)."""
    os.makedirs(out_dir, exist_ok=True)
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    inten = np.asarray(result["intensity"])
    valid = np.asarray(result["valid"])
    g = np.asarray(result["g"])
    n_orders = inten.shape[0]
    written = []

    vmax = max(float(inten[0].max()), 1e-30)
    for i in range(n_orders):
        fig, ax = plt.subplots(figsize=(5, 5))
        im = ax.imshow(inten[i], cmap="inferno", origin="upper",
                       vmax=vmax * (1.0 if i == 0 else
                                    max(inten[i].max() / vmax, 1e-6)))
        ax.set_title(f"subring order n={i}  "
                     f"(flux {inten[i].sum():.3e})")
        ax.set_axis_off()
        fig.colorbar(im, ax=ax, fraction=0.046)
        p = os.path.join(out_dir, f"subring_order_{i}.png")
        fig.savefig(p, dpi=110, bbox_inches="tight")
        plt.close(fig)
        written.append(p)

    # per-order polarization: EVPA ticks over each layer's intensity
    # (same screen convention as disk.polarization_ticks_png — the tick
    # in (col, row) components is (sin chi, cos chi) x pitch weight)
    if "evpa" in result:
        evpa = np.asarray(result["evpa"])
        wgt = np.asarray(result["pol_weight"])
        for i in range(n_orders):
            dm = valid[i]
            if not dm.any():
                continue
            ii, jj = np.nonzero(dm)
            fig, ax = plt.subplots(figsize=(5, 5))
            ax.imshow(inten[i], cmap="inferno", origin="upper",
                      vmax=max(float(inten[i].max()), 1e-30))
            ax.quiver(jj, ii, np.sin(evpa[i][dm]) * wgt[i][dm],
                      np.cos(evpa[i][dm]) * wgt[i][dm], color="white",
                      scale=28.0, headwidth=1, headlength=0,
                      headaxislength=0, pivot="middle", width=0.003)
            ax.set_title(f"order n={i} polarization (EVPA ticks)")
            ax.set_axis_off()
            p = os.path.join(out_dir, f"subring_evpa_{i}.png")
            fig.savefig(p, dpi=110, bbox_inches="tight")
            plt.close(fig)
            written.append(p)

    fig, ax = plt.subplots(figsize=(5, 5))
    im = ax.imshow(np.asarray(result["count"]), cmap="viridis",
                   origin="upper")
    ax.set_title("equatorial crossings per ray")
    ax.set_axis_off()
    fig.colorbar(im, ax=ax, fraction=0.046)
    p = os.path.join(out_dir, "crossing_count.png")
    fig.savefig(p, dpi=110, bbox_inches="tight")
    plt.close(fig)
    written.append(p)

    summary = subring_summary(result)

    # delay map between the two lowest simultaneously-crossing orders
    if n_orders >= 2:
        from .hotspot import bl_time_azimuth_offsets
        params = jnp.asarray(result["params"])
        count = np.asarray(result["count"])
        both = count > 1
        t_ks = np.asarray(result["hits_q"][..., 0], dtype=np.float64)
        r_em = np.asarray(result["r_em"], dtype=np.float64)
        t_off = np.asarray(jax.vmap(
            lambda r: bl_time_azimuth_offsets(r, params)[0]
        )(jnp.asarray(r_em[:2].reshape(2, -1)))).reshape(2, *r_em.shape[1:])
        dt = (t_ks[0] - t_off[0]) - (t_ks[1] - t_off[1])
        fig, ax = plt.subplots(figsize=(5, 5))
        im = ax.imshow(np.where(both, dt, np.nan), cmap="magma",
                       origin="upper")
        ax.set_title("subring delay t(n=0) - t(n=1)  [M]")
        ax.set_axis_off()
        fig.colorbar(im, ax=ax, fraction=0.046)
        p = os.path.join(out_dir, "subring_delay_01.png")
        fig.savefig(p, dpi=110, bbox_inches="tight")
        plt.close(fig)
        written.append(p)

        ii, jj = np.nonzero(both)
        csv = os.path.join(out_dir, "subring_delay_01.csv")
        with open(csv, "w") as f:
            f.write("i,j,delay_M,g0,g1,r0,r1\n")
            for a, b in zip(ii, jj):
                f.write(f"{a},{b},{dt[a, b]:.9g},{g[0, a, b]:.9g},"
                        f"{g[1, a, b]:.9g},{r_em[0, a, b]:.9g},"
                        f"{r_em[1, a, b]:.9g}\n")
        written.append(csv)

    p = os.path.join(out_dir, "subring_summary.json")
    with open(p, "w") as f:
        json.dump(summary, f, indent=2)
    written.append(p)
    return written, summary

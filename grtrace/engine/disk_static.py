"""Thin accretion disks around beyond-Kerr static black holes.

Static-family twin of engine/disk.py (which traces the Kerr-Newman family
on the Cartesian Kerr-Schild chart): disks around Kottler /
Schwarzschild-de Sitter, Bardeen and Hayward holes, shaded by the exact
combined gravitational + Doppler shift of circular Keplerian emitters
(physics/static_orbits.py).  The reference has neither disks nor
non-Schwarzschild metrics (simulation/raytracing.py:164-280 composites
background lensing only).

Design — the DISK-TILT formulation.  Spherical symmetry makes
the reference's equatorial beta-fold (utils.py:103-113) exact, so every
camera ray integrates as a PLANAR orbit (theta = pi/2, p_theta = 0) in
the 2D folded frame — half the state of the 3D Kerr-Schild chart and no
polar-axis stiffness.  Instead of elevating the camera above a fixed
equatorial disk (engine/disk.py:disk_observer_position), the camera stays
on the +x axis and the DISK is tilted by the same elevation angle — by
spherical symmetry the two scenes are isometric.  The disk plane's normal
is n = (sin e, 0, cos e); a fold-frame point (x_f, y_f) sits at true
position R_x(beta) (x_f, y_f, 0), so its signed distance to the disk
plane is the LINEAR FORM

    w = x_f sin(e) + y_f sin(beta) cos(e)  =  r (c1 cos phi + c2 sin phi)

with per-ray constants c1 = sin(e), c2 = sin(beta) cos(e).  The crossing
detector in the masked `lax.while_loop` is therefore one fused
multiply-add and a sign test per step — no chart transforms, no extra
state.  The shading inputs are even cheaper: E = -p_t and the fold-frame
p_phi are Killing constants, and the photon's angular momentum about the
disk normal is L_n = p_phi (m . n) = p_phi cos(beta) cos(e) where
m = R_x(beta) z_hat is the orbit-plane normal — all per-ray constants, so
the redshift needs NO interpolated momentum at all (the Kerr path must
lerp the momentum at the crossing; here only the emission RADIUS is
interpolated, with O(delta) error confined to the temperature profile).

Rays exactly in the disk plane (beta = 0 at zero elevation) never cross
it — the same infinitely-thin-disk semantics as the Kerr path's edge-on
limit.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..physics.hamiltonian import substep_schedule
from ..physics.spacetime import METRICS, make_step
from ..physics.static_metrics import STATIC_F, static_capture_radius
from ..physics.static_orbits import (isco_static, osco_static,
                                     page_thorne_flux_static,
                                     redshift_factor_static)
from .disk import (CLS_DISK, STATUS_DISK, _NT_TABLE_N, _temp_profile,
                   blackbody_rgb)
from .integrate import STATUS_CAPTURED
from .integrate_generic import _domain_tools


@partial(jax.jit, static_argnames=("steps", "order", "metric"))
def integrate_batch_disk_static(q0s, p0s, c1, c2, steps, delta, params,
                                r_max, omega, r_in, r_out, order=2,
                                metric="Bardeen"):
    """Folded-frame batch integration with first-disk-crossing capture.

    Same early-exit/guard semantics as integrate_batch_generic on the
    spherical chart, plus: when a step flips the sign of the disk linear
    form u = c1 cos(phi) + c2 sin(phi) with the interpolated areal radius
    inside [r_in, r_out], the ray freezes with STATUS_DISK and
    (hit_q, hit_p) record the crossing.  `c1`, `c2` are the per-ray
    disk-plane constants (module docstring).

    Returns (final_q, final_p, status, n_steps, hit_q, hit_p).
    """
    g_inv_fn = METRICS[metric]
    step1 = make_step(g_inv_fn)

    dtype = q0s.dtype
    delta = jnp.asarray(delta, dtype)
    params = jnp.asarray(params, dtype)
    r_max = jnp.asarray(r_max, dtype)
    r_in = jnp.asarray(r_in, dtype)
    r_out = jnp.asarray(r_out, dtype)
    subs = substep_schedule(delta, jnp.asarray(omega, dtype), order)

    vstep = jax.vmap(lambda q1, p1, q2, p2: step1(q1, p1, q2, p2, params,
                                                  subs))
    cap_radius, esc_radius, active_mask, guard, r_cap = _domain_tools(
        metric, params, delta, r_max, dtype, g_inv_fn)

    def u_form(q):
        ph = q[:, 3]
        return c1 * jnp.cos(ph) + c2 * jnp.sin(ph)

    n = q0s.shape[0]
    n_steps0 = jnp.zeros(n, dtype=jnp.int32)
    hit0 = jnp.zeros(n, dtype=bool)
    carry0 = (q0s, p0s, q0s, p0s, n_steps0, jnp.int32(0), hit0, q0s, p0s)

    def cond(c):
        q1, _, _, _, _, k, hit, _, _ = c
        return (k < steps) & jnp.any(active_mask(q1) & ~hit)

    def body(c):
        q1, p1, q2, p2, ns, k, hit, hq, hp = c
        act = active_mask(q1) & ~hit
        nq1, np1, nq2, np2 = vstep(q1, p1, q2, p2)
        bad, nq1 = guard(q1, p1, nq1, np1)
        np1 = jnp.where(bad[:, None], p1, np1)
        nq2 = jnp.where(bad[:, None], q2, nq2)
        np2 = jnp.where(bad[:, None], p2, np2)

        # --- disk-plane crossing: sign flip of the linear form u ---
        u0, u1 = u_form(q1), u_form(nq1)
        crossed = (u0 * u1) < 0.0
        t = u0 / (u0 - u1)                     # in (0, 1) where crossed
        t = jnp.where(crossed, t, 0.0)         # keep lerp finite elsewhere
        cq = q1 + t[:, None] * (nq1 - q1)
        # record the p2 momentum copy at the crossing (cf. disk.py:167-174:
        # the staggered production kernels hold p2 at step boundaries) —
        # for the shading only p_t and p_phi matter and those are Killing
        # constants, so this lerp is exact for the redshift
        cp = p2 + t[:, None] * (np2 - p2)
        r_hit = cq[:, 1]
        new_hit = (act & ~bad & crossed
                   & (r_hit >= r_in) & (r_hit <= r_out))
        hq = jnp.where(new_hit[:, None], cq, hq)
        hp = jnp.where(new_hit[:, None], cp, hp)
        hit = hit | new_hit

        ns_new = ns + act.astype(jnp.int32)
        ns_new = jnp.where(act & bad, -ns_new, ns_new)

        def masked(new, old):
            return jnp.where(act[:, None], new, old)
        return (masked(nq1, q1), masked(np1, p1), masked(nq2, q2),
                masked(np2, p2), ns_new, k + 1, hit, hq, hp)

    q1, p1, q2, _, ns, _, hit, hq, hp = jax.lax.while_loop(cond, body,
                                                           carry0)

    ns = jnp.abs(ns)
    from .integrate import STATUS_ALIVE, STATUS_ESCAPED
    status = jnp.where(cap_radius(q1) <= r_cap, STATUS_CAPTURED,
                       jnp.where(esc_radius(q1) >= r_max, STATUS_ESCAPED,
                                 STATUS_ALIVE))
    status = jnp.where(hit, STATUS_DISK, status)
    return q1, p1, status, ns, hq, hp


# ---------------------------------------------------------------------------
# Shading
# ---------------------------------------------------------------------------

def _nt_temp_table_static(r_in, r_out, f_fn, params, prograde, dtype):
    """Peak-normalized Novikov-Thorne temperature table for a static
    family — engine.disk._nt_temp_table with the static Page-Thorne
    quadrature (physics.static_orbits.page_thorne_flux_static)."""
    lo = r_in * (1.0 + 1e-5)
    u = jnp.linspace(0.0, 1.0, _NT_TABLE_N, dtype=dtype)
    r_grid = lo * (r_out / lo) ** u
    flux = page_thorne_flux_static(r_grid, f_fn, params, prograde)
    t = flux ** 0.25
    return r_grid, t / jnp.maximum(jnp.max(t), 1e-30)


def shade_disk_static(hit_q, p0_flat, ln_scale, f_fn, params, r_obs, r_in, *,
                      prograde=True, t_peak=9000.0, exposure=2.5,
                      profile="shakura", r_out=14.0):
    """(N, 4) folded crossings -> (g, rgb01).

    Identical shading physics to engine.disk.shade_disk_constants
    (I_obs = g^4 I_em, blackbody color at g T_em(r), tone-mapped) with
    the static-family redshift: E = -p_t, L_n = p_phi * `ln_scale` (the
    per-ray cos(beta) cos(e) normal projection), r_em = the interpolated
    areal radius.

    E and p_phi are read from the CAMERA covectors `p0_flat`, not from
    the crossing record: they are Killing charges, exactly conserved
    along the continuum geodesic, whereas the integrator's recorded
    momentum carries the FANTASY copy-split (O(1) for photon-shell
    winders, engine/disk.py:167-174).  The fold design makes this free —
    the only crossing-dependent shading input left is the emission
    radius, whose error is the O(delta) in-step lerp."""
    energy = -p0_flat[:, 0]
    l_n = p0_flat[:, 3] * ln_scale
    r_em = hit_q[:, 1]
    g = jax.vmap(lambda e, l, r: redshift_factor_static(
        e, l, r, r_obs, f_fn, params, prograde))(energy, l_n, r_em)

    if profile == "novikov":
        r_grid, t_tab = _nt_temp_table_static(
            r_in, jnp.asarray(r_out, r_em.dtype), f_fn, params, prograde,
            r_em.dtype)
        t_norm = jnp.interp(r_em, r_grid, t_tab)
    else:
        t_norm = _temp_profile(r_em, r_in)
    t_obs = g * t_norm
    intensity = exposure * t_obs ** 4
    tone = 1.0 - jnp.exp(-intensity)
    tone = tone ** (1.0 / 2.2)
    rgb = blackbody_rgb(t_obs * t_peak) * tone[:, None]
    return g, rgb


# ---------------------------------------------------------------------------
# Full-frame render
# ---------------------------------------------------------------------------

@partial(jax.jit,
         static_argnames=("height", "width", "steps", "order", "flip_theta",
                          "flip_phi", "has_background", "dtype", "prograde",
                          "profile", "metric"))
def render_pixels_disk_static(bg_array, obs_x, fov, mass, metric_param,
                              boundary_radius, steps, delta, omega,
                              r_in, r_out, t_peak, exposure, elevation,
                              patch_center_theta, patch_center_phi,
                              patch_size_theta, patch_size_phi,
                              *, height, width, order=2, flip_theta=False,
                              flip_phi=False, has_background=True,
                              dtype=jnp.float32, prograde=True,
                              profile="shakura", metric="Bardeen"):
    """One compiled program: folded camera -> planar disk integration ->
    shade + classify -> RGB, for a static family metric.  `elevation` is
    the camera's angle above the disk plane in radians (the disk is
    tilted, module docstring); the background patch semantics are those
    of the standard x-axis scene (render_pixels_generic), unchanged by
    the disk tilt."""
    from ..physics.camera import camera_rays_folded_static
    from . import classify as _classify

    g_inv_fn = METRICS[metric]
    f_fn = STATIC_F[metric]
    params = jnp.stack([jnp.asarray(mass, dtype),
                        jnp.asarray(metric_param, dtype),
                        jnp.zeros((), dtype)])
    obs_x = jnp.asarray(obs_x, dtype)
    obs_pos = jnp.stack([obs_x, jnp.zeros_like(obs_x),
                         jnp.zeros_like(obs_x)])
    q0, p0, alpha0, beta_fold = camera_rays_folded_static(
        obs_pos, fov, height, width, params=params, g_inv_fn=g_inv_fn,
        dtype=dtype)

    elev = jnp.asarray(elevation, dtype)
    c1 = jnp.broadcast_to(jnp.sin(elev), beta_fold.shape).reshape(-1)
    c2 = (jnp.sin(beta_fold) * jnp.cos(elev)).reshape(-1)
    ln_scale = (jnp.cos(beta_fold) * jnp.cos(elev)).reshape(-1)

    n = height * width
    final_q, final_p, status, n_steps, hit_q, hit_p = \
        integrate_batch_disk_static(
            q0.reshape(n, 4), p0.reshape(n, 4), c1, c2, steps, delta,
            params, boundary_radius, omega, r_in, r_out, order=order,
            metric=metric)

    disk_mask = status == STATUS_DISK
    g_fac, disk_rgb01 = shade_disk_static(
        hit_q, p0.reshape(n, 4), ln_scale, f_fn, params, obs_x, r_in,
        prograde=prograde, t_peak=t_peak, exposure=exposure,
        profile=profile, r_out=r_out)
    g_fac = jnp.where(disk_mask, g_fac, 0.0)

    # classification tail: identical to render_pixels_generic's static
    # branch — un-fold by beta, analytic capture shortcut disabled,
    # rs_classify aligned with the integrator's capture surface
    r_plus = static_capture_radius(metric, params) / 1.1
    rs_classify = (1.1 / 1.2) * r_plus
    fq = final_q.reshape(height, width, 4)
    cls, th_csv, ph_csv, u01, v01 = _classify.classify_rays(
        fq, jnp.full((height, width), jnp.pi, dtype), beta_fold,
        rs=rs_classify, r_obs_x=obs_x, boundary_radius=boundary_radius,
        patch_center_theta=patch_center_theta,
        patch_center_phi=patch_center_phi,
        patch_size_theta=patch_size_theta,
        patch_size_phi=patch_size_phi,
        flip_theta=flip_theta, flip_phi=flip_phi,
        has_background=has_background)
    image = _classify.composite(cls, u01, v01, bg_array if has_background
                                else jnp.zeros((1, 1, 3), dtype=jnp.uint8))

    disk_u8 = jnp.clip(disk_rgb01 * 255.0 + 0.5, 0.0,
                       255.0).astype(jnp.uint8).reshape(height, width, 3)
    dm2 = disk_mask.reshape(height, width)
    image = jnp.where(dm2[:, :, None], disk_u8, image)
    cls = jnp.where(dm2, CLS_DISK, cls)

    count_vec = jnp.stack([
        jnp.sum(cls == _classify.CLS_BH),
        jnp.sum(cls == _classify.CLS_IN_DOMAIN),
        jnp.sum((cls == _classify.CLS_ESCAPE_NO_PATCH)
                | (cls == _classify.CLS_ESCAPE_BG)),
        jnp.sum(cls == _classify.CLS_ESCAPE_BG),
        jnp.sum(cls == _classify.CLS_NUMERICAL),
        jnp.sum(cls == CLS_DISK),
    ])
    return {
        "image": image,
        "cls": cls,
        "final_q": fq,
        "final_th": th_csv,
        "final_ph": ph_csv,
        "q0": q0,
        "p0": p0,
        "beta": beta_fold,
        "alpha0": alpha0,
        "n_steps": n_steps.reshape(height, width),
        "status": status.reshape(height, width),
        "hit_q": hit_q.reshape(height, width, 4),
        "hit_p": hit_p.reshape(height, width, 4),
        "redshift": g_fac.reshape(height, width),
        "count_vec": count_vec,
    }


def static_disk_bounds(metric, mass, metric_param, r_in, r_out,
                       boundary_radius, prograde=True):
    """Host-side disk-edge resolution + validation for a static family:

    * r_in = None -> the exact autodiff ISCO (physics.static_orbits);
    * Kottler: r_out must sit inside the outermost stable circular orbit
      (beyond it the cosmological tide forbids Keplerian emitters) — and
      the OSCO itself must exist (sub-critical Lambda);
    * horizonless super-critical regular holes (Bardeen g, Hayward l >
      sqrt(16/27) M) still have an ISCO for moderate parameters; if the
      stability scan finds none, the disk is rejected.
    """
    f_fn = STATIC_F[metric]
    # result_type(float): float64 under x64 (tests), float32 on the
    # production path (the scan+bisection ISCO is still ~1e-3-accurate
    # there, far below the disk's O(delta) crossing resolution)
    params = jnp.array([mass, metric_param, 0.0], jnp.result_type(float))
    if r_in is None:
        r_in = float(isco_static(f_fn, params))
        if not np.isfinite(r_in):
            raise ValueError(
                f"{metric} with parameter {metric_param:g} has no stable "
                "circular orbits — no ISCO to anchor the disk; pass an "
                "explicit r_in")
    if metric == "Kottler" and metric_param > 0.0:
        static_r = (3.0 * mass / metric_param) ** (1.0 / 3.0)
        r_osco = float(osco_static(f_fn, params,
                                   r_hi=0.98 * static_r))
        if np.isfinite(r_osco) and r_out > r_osco:
            raise ValueError(
                f"Kottler disk outer edge r_out = {r_out:g} lies beyond "
                f"the outermost stable circular orbit {r_osco:.4g} "
                "(the cosmological tide destabilizes Keplerian emitters "
                "there) — shrink r_out or Lambda")
    if not r_in < r_out:
        raise ValueError(f"disk edges must satisfy r_in < r_out, got "
                         f"[{r_in:g}, {r_out:g}]")
    if r_out >= boundary_radius:
        raise ValueError(f"disk outer edge {r_out:g} must sit inside the "
                         f"boundary sphere {boundary_radius:g}")
    return float(r_in), float(r_out)


def render_disk_static(scene, disk=None, *, bg_array=None, dtype=None,
                       metrics=None):
    """SceneConfig-driven static-family disk render ->
    engine.render.RenderResult.  scene.metric picks the family
    ('kottler' | 'bardeen' | 'hayward', scene.metric_param the family
    parameter); `disk` is the same DiskConfig the Kerr path takes
    (bfield/camera_omega are Kerr-path-only and rejected here)."""
    from .disk import DiskConfig
    from .metrics import RenderMetrics
    from .render import RenderResult

    disk = disk or DiskConfig()
    if disk.bfield is not None:
        raise NotImplementedError(
            "polarized imaging (DiskConfig.bfield) is implemented on the "
            "Kerr-Schild disk path (engine.disk) — use metric "
            "'schwarzschild'/'kerr' for EVPA maps")
    if disk.camera_omega is not None:
        raise NotImplementedError(
            "orbiting cameras (DiskConfig.camera_omega) ride the "
            "Kerr-Schild disk path (engine.disk)")

    static_names = {"kottler": "Kottler", "sds": "Kottler",
                    "bardeen": "Bardeen", "hayward": "Hayward"}
    metric = static_names[scene.metric.lower()]

    want_metrics = metrics is not None
    if metrics is None:
        metrics = RenderMetrics()
    h, w = scene.image_size
    integ = scene.integrator
    if dtype is None:
        dtype = jnp.float64 if integ.dtype == "float64" else jnp.float32
    has_bg = bg_array is not None and disk.show_background
    bg_dev = (jnp.asarray(bg_array, dtype=jnp.uint8) if has_bg
              else jnp.zeros((1, 1, 3), dtype=jnp.uint8))

    r_in, r_out = static_disk_bounds(
        metric, scene.bh_mass, scene.metric_param, disk.r_in, disk.r_out,
        scene.boundary_radius, disk.prograde)

    with metrics.stage("device_pipeline"):
        out = render_pixels_disk_static(
            bg_dev,
            jnp.asarray(scene.observer_distance, dtype),
            jnp.asarray(scene.fov, dtype),
            jnp.asarray(scene.bh_mass, dtype),
            jnp.asarray(scene.metric_param, dtype),
            jnp.asarray(scene.boundary_radius, dtype),
            integ.steps,
            jnp.asarray(integ.delta, dtype),
            jnp.asarray(integ.omega, dtype),
            jnp.asarray(r_in, dtype),
            jnp.asarray(r_out, dtype),
            jnp.asarray(disk.t_peak, dtype),
            jnp.asarray(disk.exposure, dtype),
            jnp.asarray(np.deg2rad(disk.elevation_deg), dtype),
            jnp.asarray(scene.patch.center_theta, dtype),
            jnp.asarray(scene.patch.center_phi, dtype),
            jnp.asarray(scene.patch.size_theta, dtype),
            jnp.asarray(scene.patch.size_phi, dtype),
            height=h, width=w, order=integ.order,
            flip_theta=scene.patch.flip_theta,
            flip_phi=scene.patch.flip_phi,
            has_background=has_bg, dtype=dtype, prograde=disk.prograde,
            profile=disk.profile, metric=metric)

        # the counts fetch is the device sync, so it belongs to the stage
        cv = np.asarray(out.pop("count_vec"))
    counts = {"captured": int(cv[0]), "in_domain": int(cv[1]),
              "escaped": int(cv[2]), "background": int(cv[3]),
              "numerical_error": int(cv[4]), "disk": int(cv[5])}
    metrics.rays = h * w
    if want_metrics:
        metrics.geodesic_steps = int(np.asarray(out["n_steps"],
                                                np.int64).sum())
    out["heading"] = jnp.zeros((h, w, 3), dtype)
    return RenderResult(out, counts)

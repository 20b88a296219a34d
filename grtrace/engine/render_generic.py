"""Full-frame rendering in a generic metric (Kerr shadows).

A capability the reference never had: its pipeline is Schwarzschild-only
(simulation/cuda_geodesic.py:432-447 hardcodes the metric).  This module
renders the same scene layout (pinhole camera, boundary sphere, background
patch — reference raytracing.py:60-88, 219-246) through any metric in
physics.spacetime, with Kerr frame dragging producing the classic
asymmetric, D-shaped shadow at high spin.

Differences from the Schwarzschild fast path (engine.render), all forced by
the physics:
  * no equatorial beta-fold (axisymmetry only) — full 3D integration via
    the generic autodiff engine;
  * capture purely by integration outcome r <= 1.1 r_+ (the Schwarzschild
    path additionally uses the reference's analytic b_crit shortcut,
    raytracing.py:205-211, which has no closed form off the equatorial
    plane in Kerr);
  * classification reuses engine.classify with beta = 0 and the shortcut
    disabled (alpha0 = pi), so patch/texture semantics stay identical.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..physics.camera import camera_rays_cartesian, camera_rays_unfolded
from ..physics.coords import cartesian_to_spherical
from ..physics.spacetime import COORDS, METRICS, horizon_radius
from . import classify as _classify
from .integrate_generic import integrate_batch_chart


@partial(jax.jit,
         static_argnames=("height", "width", "steps", "flip_theta",
                          "flip_phi", "has_background", "dtype", "metric",
                          "order"))
def render_pixels_generic(bg_array, obs_x, fov, mass, spin, boundary_radius,
                          steps, delta, omega,
                          patch_center_theta, patch_center_phi,
                          patch_size_theta, patch_size_phi,
                          *, height, width, flip_theta=False, flip_phi=False,
                          has_background=True, dtype=jnp.float32,
                          metric="Kerr", order=2, charge=0.0):
    """One compiled device program: camera -> integrate -> classify -> RGB."""
    g_inv_fn = METRICS[metric]
    cartesian = COORDS[metric] == "cartesian"
    params = jnp.stack([jnp.asarray(mass, dtype), jnp.asarray(spin, dtype),
                        jnp.asarray(charge, dtype)])

    obs_pos = jnp.stack([obs_x, jnp.zeros_like(obs_x), jnp.zeros_like(obs_x)])
    from ..physics.static_metrics import STATIC_F
    if metric in STATIC_F:
        # spherically symmetric: the reference's equatorial beta-fold is
        # exact, and folded rays (theta = pi/2, p_theta = 0) never
        # approach the BL polar-axis stiffness that retires over-pole
        # rays in the unfolded chart (physics.camera docstring)
        from ..physics.camera import camera_rays_folded_static
        q0, p0, alpha0, beta_fold = camera_rays_folded_static(
            obs_pos, fov, height, width, params=params,
            g_inv_fn=g_inv_fn, dtype=dtype)
    else:
        camera = camera_rays_cartesian if cartesian else camera_rays_unfolded
        q0, p0, alpha0 = camera(obs_pos, fov, height, width, params=params,
                                g_inv_fn=g_inv_fn, dtype=dtype)
        beta_fold = None

    n = height * width
    final_q, final_p, status, n_steps = integrate_batch_chart(
        q0.reshape(n, 4), p0.reshape(n, 4), steps, delta, params,
        boundary_radius, omega, order=order, metric=metric, dtype=dtype)
    final_q = final_q.reshape(height, width, 4)

    if cartesian:
        # classify in spherical terms: (t, x, y, z) -> (t, rho, th, ph).
        # rho is the flat embedding radius — the boundary sphere the escape
        # test used — so the classifier's radius thresholds line up.
        # Captured rays stopped at the Kerr-Schild r_+ where rho reaches up
        # to sqrt(r_+^2 + a^2) (> the classifier's capture threshold at
        # high spin), so their radius is pinned to 0 from the integrator
        # status — capture is the integrator's verdict, not a re-derivation.
        rho, th, ph = cartesian_to_spherical(
            final_q[..., 1], final_q[..., 2], final_q[..., 3])
        from .integrate import STATUS_CAPTURED
        rho = jnp.where(status.reshape(height, width) == STATUS_CAPTURED,
                        jnp.zeros_like(rho), rho)
        final_q = jnp.stack([final_q[..., 0], rho, th, ph], axis=-1)

    # classify with beta = 0 (no fold) and the analytic capture shortcut
    # disabled: alpha0 := pi never satisfies alpha0 <= bh_angle, and
    # rs_classify is scaled so the radius test fires exactly at the
    # integrator's capture surface (1.1 r_+ in BL, 1.05 r_+ in the
    # Kerr-Schild chart) — a budget-exhausted ray frozen just above the
    # shell stays 'in_domain', matching the integrator's ALIVE verdict.
    # The sharded renderer (sharding.mesh.render_kerr_sharded) uses the
    # same formula so both paths classify identically.
    from ..physics.static_metrics import STATIC_F, static_capture_radius
    if metric in STATIC_F:
        # one source of truth with the integrator's capture surface
        # (integrate_generic._capture_radius): 1.1 x the bisected outer
        # horizon, or the small horizonless floor
        r_plus = static_capture_radius(metric, params) / 1.1
    elif metric in ("RotatingBardeen", "RotatingHayward"):
        # same single-source rule on the rotating-regular families: the
        # classifier's radius test fires exactly at the integrator's
        # 1.05-shell over the bisected Delta-root (or horizonless floor)
        from ..physics.rotating_regular import rotating_capture_radius
        r_plus = rotating_capture_radius(metric, params) / 1.05
    elif metric == "KerrDS":
        from ..physics.kerr_de_sitter import kds_capture_radius
        r_plus = kds_capture_radius(params) / 1.1
    else:
        r_plus = horizon_radius(
            "Kerr" if metric != "Schwarzschild" else metric,
            params[0], params[1], params[2])
    shell = 1.1 if metric not in ("KerrSchild", "RotatingBardeen",
                                  "RotatingHayward") else 1.05
    rs_classify = (shell / 1.2) * r_plus
    # static (folded) rays un-fold by their real beta; unfolded charts
    # classify in lab angles directly (beta = 0)
    beta0 = (beta_fold if beta_fold is not None
             else jnp.zeros((height, width), dtype))
    alpha_off = jnp.full((height, width), jnp.pi, dtype)

    cls, th_csv, ph_csv, u01, v01 = _classify.classify_rays(
        final_q, alpha_off, beta0, rs=rs_classify, r_obs_x=obs_x,
        boundary_radius=boundary_radius,
        patch_center_theta=patch_center_theta,
        patch_center_phi=patch_center_phi,
        patch_size_theta=patch_size_theta,
        patch_size_phi=patch_size_phi,
        flip_theta=flip_theta, flip_phi=flip_phi,
        has_background=has_background)

    image = _classify.composite(cls, u01, v01, bg_array if has_background
                                else jnp.zeros((1, 1, 3), dtype=jnp.uint8))

    count_vec = jnp.stack([
        jnp.sum(cls == _classify.CLS_BH),
        jnp.sum(cls == _classify.CLS_IN_DOMAIN),
        jnp.sum((cls == _classify.CLS_ESCAPE_NO_PATCH)
                | (cls == _classify.CLS_ESCAPE_BG)),
        jnp.sum(cls == _classify.CLS_ESCAPE_BG),
        jnp.sum(cls == _classify.CLS_NUMERICAL),
    ])

    return {
        "image": image,
        "cls": cls,
        "final_q": final_q,
        "final_th": th_csv,
        "final_ph": ph_csv,
        "q0": q0,
        "p0": p0,
        "beta": beta0,
        "alpha0": alpha0,
        "n_steps": n_steps.reshape(height, width),
        "status": status.reshape(height, width),
        "count_vec": count_vec,
    }


def _sample_trajectories_generic(q0, p0, scene, spin, metric, dtype, seed,
                                 n_samples, charge=0.0, beta=None):
    """Sampled-ray diagnostics for the generic path: (ij indices, list of
    (n_pts, 3) Cartesian arrays) — same surface as the Schwarzschild
    sampler (engine.render._sample_trajectories).  beta: per-pixel fold
    angles from the static folded camera (trajectories are integrated in
    the equatorial plane and rotated back about +x here, reference
    raytracing.py:138-159); None/zeros for the unfolded charts."""
    from ..physics.coords import rotate_x, spherical_to_cartesian
    from .integrate_generic import trajectory_batch_decimated
    from .render import MAX_TRAJ_POINTS

    h, w = scene.image_size
    rng = np.random.default_rng(seed)
    flat = rng.choice(h * w, size=min(n_samples, h * w), replace=False)
    sampled_ij = np.stack([flat // w, flat % w], axis=-1)

    integ = scene.integrator
    q0s = jnp.asarray(q0.reshape(-1, 4)[flat], dtype)
    p0s = jnp.asarray(p0.reshape(-1, 4)[flat], dtype)
    traj = trajectory_batch_decimated(
        q0s, p0s, integ.steps, integ.delta,
        jnp.asarray([scene.bh_mass, spin, charge], dtype),
        scene.boundary_radius,
        integ.omega, order=integ.order, metric=metric,
        n_keep=min(MAX_TRAJ_POINTS, integ.steps))
    traj = np.asarray(traj, dtype=np.float64)

    betas = (np.zeros(len(flat)) if beta is None
             else np.asarray(beta).reshape(-1)[flat])
    out = []
    for k in range(traj.shape[0]):
        pts = traj[k]
        if COORDS[metric] == "cartesian":
            out.append(pts[:, 1:4])
        else:
            x, y, z = spherical_to_cartesian(pts[:, 1], pts[:, 2], pts[:, 3])
            x, y, z = rotate_x(np.asarray(x), np.asarray(y), np.asarray(z),
                               float(betas[k]))
            out.append(np.stack([np.asarray(x), np.asarray(y),
                                 np.asarray(z)], axis=-1))
    return sampled_ij, out


def render_generic(scene, *, spin=None, metric="Kerr", bg_array=None,
                   dtype=None, n_samples=None, seed=0, metrics=None,
                   charge=None, aa_samples=None):
    """SceneConfig-driven generic-metric render -> engine.render.RenderResult.

    Mirrors engine.render.render's surface for the Kerr path, including
    sampled-trajectory diagnostics and RenderMetrics support.

    spin/charge default to the SCENE's values (passing them explicitly
    overrides); `metric` names the chart ("Kerr" = Boyer-Lindquist,
    "KerrSchild" = the horizon-regular Cartesian production chart) and
    stays explicit — prefer the top-level grtrace.render, which routes
    scene.metric to the right chart for you.  For the static beyond-Kerr
    families ("Kottler"/"Bardeen"/"Hayward", physics/static_metrics.py)
    the `spin` argument carries the family parameter (Lambda/g/l) — the
    second metric-params slot — and charge must be 0; grtrace.render
    routes scene.metric_param there automatically.

    aa_samples = s (>= 2) runs the adaptive edge-refinement pass
    (engine.aa): s x s stratified sub-rays re-traced for the top-scoring
    boundary pixels, colors averaged into the image (class map and CSV
    fields keep center-sample semantics).
    """
    from .metrics import RenderMetrics
    from .render import RenderResult

    if spin is None:
        spin = getattr(scene, "spin", 0.0)
    if charge is None:
        charge = getattr(scene, "charge", 0.0)

    want_metrics = metrics is not None
    if metrics is None:
        metrics = RenderMetrics()

    h, w = scene.image_size
    integ = scene.integrator
    if dtype is None:
        dtype = jnp.float64 if integ.dtype == "float64" else jnp.float32
    has_bg = bg_array is not None
    bg_dev = (jnp.asarray(bg_array, dtype=jnp.uint8) if has_bg
              else jnp.zeros((1, 1, 3), dtype=jnp.uint8))

    with metrics.stage("device_pipeline"):
        out = render_pixels_generic(
            bg_dev,
            jnp.asarray(scene.observer_distance, dtype),
            jnp.asarray(scene.fov, dtype),
            jnp.asarray(scene.bh_mass, dtype),
            jnp.asarray(spin, dtype),
            jnp.asarray(scene.boundary_radius, dtype),
            integ.steps,
            jnp.asarray(integ.delta, dtype),
            jnp.asarray(integ.omega, dtype),
            jnp.asarray(scene.patch.center_theta, dtype),
            jnp.asarray(scene.patch.center_phi, dtype),
            jnp.asarray(scene.patch.size_theta, dtype),
            jnp.asarray(scene.patch.size_phi, dtype),
            height=h, width=w,
            flip_theta=scene.patch.flip_theta, flip_phi=scene.patch.flip_phi,
            has_background=has_bg, dtype=dtype, metric=metric,
            order=integ.order, charge=jnp.asarray(charge, dtype))
        if aa_samples:
            from .aa import refine_edges_generic
            out["image"], out["aa_mask"] = refine_edges_generic(
                out["cls"], out["image"], bg_dev,
                jnp.asarray(scene.observer_distance, dtype),
                jnp.asarray(scene.fov, dtype),
                jnp.asarray(scene.bh_mass, dtype),
                jnp.asarray(spin, dtype),
                jnp.asarray(charge, dtype),
                jnp.asarray(scene.boundary_radius, dtype),
                integ.steps,
                jnp.asarray(integ.delta, dtype),
                jnp.asarray(integ.omega, dtype),
                jnp.asarray(scene.patch.center_theta, dtype),
                jnp.asarray(scene.patch.center_phi, dtype),
                jnp.asarray(scene.patch.size_theta, dtype),
                jnp.asarray(scene.patch.size_phi, dtype),
                height=h, width=w, samples=int(aa_samples),
                metric=metric, order=integ.order,
                flip_theta=scene.patch.flip_theta,
                flip_phi=scene.patch.flip_phi,
                has_background=has_bg, dtype=dtype)
        # the counts fetch is the device sync, so it belongs to the stage
        cv = np.asarray(out.pop("count_vec"))
    counts = {"captured": int(cv[0]), "in_domain": int(cv[1]),
              "escaped": int(cv[2]), "background": int(cv[3]),
              "numerical_error": int(cv[4])}
    metrics.rays = h * w
    if want_metrics:
        metrics.geodesic_steps = int(np.asarray(out["n_steps"],
                                                np.int64).sum())
    # beta: real fold angles on the static (folded-camera) path, zeros on
    # the unfolded charts; the heading field does not exist on this path
    out["heading"] = jnp.zeros((h, w, 3), dtype)

    n_samples = scene.n_samples if n_samples is None else n_samples
    sampled_ij = None
    sampled_trajs = None
    if n_samples and n_samples > 0:
        with metrics.stage("sample_trajectories"):
            sampled_ij, sampled_trajs = _sample_trajectories_generic(
                np.asarray(out["q0"]), np.asarray(out["p0"]), scene, spin,
                metric, dtype, seed, n_samples, charge=charge,
                beta=np.asarray(out["beta"]))
    return RenderResult(out, counts, sampled_indices=sampled_ij,
                        sampled_trajectories=sampled_trajs)

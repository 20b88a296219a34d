"""End-to-end curved-ray render pipeline: camera -> integrate -> classify ->
composite, device-resident.

Array-program counterpart of reference run_manual_simulation
(reference: simulation/raytracing.py:16-314).  The reference's structure —
three O(H*W) host Python loops around one CUDA kernel launch — becomes two
jitted array programs (initial conditions + integration, then classification
+ compositing) with zero host round-trips in between.  Host code only loads
the texture and writes artifacts.

A deliberate fix (documented, SURVEY.md section 3.2): the reference builds the
image only when n_samples > 0 because the classification block is indented
under the sampling branch (raytracing.py:128-164); here the image is always
built, and sampling is independent.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..io.scene import SceneConfig
from ..physics.camera import camera_rays
from ..physics.coords import rotate_x, spherical_to_cartesian
from . import classify as _classify
from .integrate import (SchwarzschildIntegrator, integrate_batch_full,
                        integrate_dispatch, resolve_backend)

MAX_TRAJ_POINTS = 1000  # reference cap per sampled ray (raytracing.py:124)


class RenderResult:
    """Everything run_manual_simulation produced.

    Per-pixel arrays stay on device until first accessed — host<->device
    bandwidth is the scarce resource (the reference copies everything back
    eagerly, cuda_geodesic.py:247).  Accessing an attribute (image, cls,
    final_q, final_th, final_ph, q0, p0, alpha0, heading, beta, n_steps,
    status) fetches and caches it as a numpy array.  photon_data.csv columns
    (raytracing.py:275-280) are reconstructable via io.artifacts.
    """

    _FIELDS = ("image", "cls", "final_q", "final_th", "final_ph", "q0", "p0",
               "alpha0", "heading", "beta", "n_steps", "status")

    def __init__(self, device_arrays: dict, counts: dict,
                 sampled_indices=None, sampled_trajectories=None):
        self._dev = device_arrays
        self._cache: dict = {}
        self.counts = counts                      # photon summary (main.py:147-155)
        self.sampled_indices = sampled_indices    # (K, 2) (i, j)
        self.sampled_trajectories = sampled_trajectories  # list of (P, 3)

    def __getattr__(self, name):
        if name in RenderResult._FIELDS:
            cache = self.__dict__["_cache"]
            if name not in cache:
                cache[name] = np.asarray(self.__dict__["_dev"][name])
            return cache[name]
        raise AttributeError(name)

    def device(self, name):
        """The raw device array (no host transfer)."""
        return self._dev[name]

    def has(self, name):
        """Whether an optional per-pixel field (e.g. the disk mode's
        'evpa') was produced by this render."""
        return name in self._dev


@partial(jax.jit,
         static_argnames=("height", "width", "steps", "flip_theta",
                          "flip_phi", "has_background", "dtype", "backend",
                          "order"))
def render_pixels(bg_array, obs_x, fov, mass, boundary_radius,
                  steps, delta, omega,
                  patch_center_theta, patch_center_phi,
                  patch_size_theta, patch_size_phi,
                  *, height, width, flip_theta=False, flip_phi=False,
                  has_background=True, dtype=jnp.float32, backend="xla",
                  order=2):
    """The fused device pipeline for one frame.

    Returns a dict of per-pixel arrays.  Everything from pixel grid to RGB
    happens on-device in one compiled program.
    """
    obs_pos = jnp.stack([obs_x, jnp.zeros_like(obs_x), jnp.zeros_like(obs_x)])
    q0, p0, alpha0, heading, beta = camera_rays(
        obs_pos, fov, height, width, mass_bh=mass, dtype=dtype)

    n = height * width
    rs = 2.0 * mass
    # camera rays are folded into the equatorial plane (physics/camera.py),
    # which licenses the trig-free equatorial fast kernel
    final_q, final_p, status, n_steps = integrate_dispatch(
        q0.reshape(n, 4), p0.reshape(n, 4), steps, delta, rs,
        boundary_radius, omega, backend=backend, equatorial=True,
        order=order)
    final_q = final_q.reshape(height, width, 4)

    cls, th_csv, ph_csv, u01, v01 = _classify.classify_rays(
        final_q, alpha0, beta, rs=rs, r_obs_x=obs_x,
        boundary_radius=boundary_radius,
        patch_center_theta=patch_center_theta,
        patch_center_phi=patch_center_phi,
        patch_size_theta=patch_size_theta,
        patch_size_phi=patch_size_phi,
        flip_theta=flip_theta, flip_phi=flip_phi,
        has_background=has_background)

    if has_background:
        image = _classify.composite(cls, u01, v01, bg_array)
    else:
        image = _classify.composite(
            cls, u01, v01, jnp.zeros((1, 1, 3), dtype=jnp.uint8))

    # one small (5,) device array -> single host fetch for the summary
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
        "alpha0": alpha0,
        "heading": heading,
        "beta": beta,
        "n_steps": n_steps.reshape(height, width),
        "status": status.reshape(height, width),
        "count_vec": count_vec,
    }


def _sample_trajectories(q0, p0, beta, sampled_ij, scene: SceneConfig, dtype):
    """Re-integrate K sampled rays with on-the-fly decimated trajectory
    capture, un-fold by beta, convert to Cartesian
    (raytracing.py:128-159)."""
    h, w = scene.image_size
    flat_idx = sampled_ij[:, 0] * w + sampled_ij[:, 1]
    q0s = q0.reshape(-1, 4)[flat_idx]
    p0s = p0.reshape(-1, 4)[flat_idx]
    betas = beta.reshape(-1)[flat_idx]

    integ = scene.integrator
    traj = integrate_batch_full(
        jnp.asarray(q0s, dtype), jnp.asarray(p0s, dtype),
        integ.steps, integ.delta, 2.0 * scene.bh_mass,
        scene.boundary_radius, _effective_omega(scene),
        n_keep=min(MAX_TRAJ_POINTS, integ.steps), order=integ.order)

    traj = np.asarray(traj, dtype=np.float64)
    out = []
    for k in range(traj.shape[0]):
        pts = traj[k]
        x, y, z = spherical_to_cartesian(pts[:, 1], pts[:, 2], pts[:, 3])
        x, y, z = rotate_x(np.asarray(x), np.asarray(y), np.asarray(z),
                           float(betas[k]))
        out.append(np.stack([x, y, z], axis=-1))
    return out


def _effective_omega(scene: SceneConfig) -> float:
    return float(scene.integrator.omega)


def render(scene: SceneConfig, *, bg_array=None, n_samples=None, seed=0,
           dtype=None, metrics=None, aa_samples=None) -> RenderResult:
    """Full-frame render with artifacts data — the run_manual_simulation
    analog.  bg_array: (th, tw, 3) uint8 numpy/jnp array or None.
    metrics: optional engine.metrics.RenderMetrics to fill with stage
    timings and throughput counters.  aa_samples: adaptive shadow-edge
    antialiasing factor (generic-chart metrics; engine/aa.py).
    """
    scene_metric = getattr(scene, "metric", "Schwarzschild").lower()
    charge = float(getattr(scene, "charge", 0.0))
    # A charged hole (Reissner-Nordstrom / Kerr-Newman) always rides the
    # generic engines — the Schwarzschild fast path's analytic metric and
    # b_crit capture shortcut assume Q = 0.  Uncharged Schwarzschild keeps
    # its specialized path.
    #
    # Chart routing matches the CLI (cli/args.py): 'kerr' renders through
    # the horizon-regular Cartesian Kerr-Schild chart (no polar-axis
    # coordinate singularity, Pallas fast path); 'kerr-bl' selects the
    # Boyer-Lindquist chart explicitly (near-axis rays there can be
    # flagged as numerical errors — the BL theta singularity).
    # Beyond-Kerr static families ride the generic autodiff engine with
    # the family parameter in the second params slot (see
    # physics/static_metrics.py; scene.metric_param carries Lambda/g/l).
    # Rotating regular families (physics/rotating_regular.py): Kerr-Schild
    # with a mass function — spin in the second params slot (as Kerr), the
    # regular charge g/l in the third (scene.metric_param).
    rotating_names = {"rotating-bardeen": "RotatingBardeen",
                      "rotatingbardeen": "RotatingBardeen",
                      "rotating-hayward": "RotatingHayward",
                      "rotatinghayward": "RotatingHayward"}
    if scene_metric in rotating_names:
        from .render_generic import render_generic
        return render_generic(
            scene, spin=scene.spin, metric=rotating_names[scene_metric],
            bg_array=bg_array, dtype=dtype, n_samples=n_samples,
            seed=seed, metrics=metrics,
            charge=float(getattr(scene, "metric_param", 0.0)),
            aa_samples=aa_samples)
    if scene_metric in ("kerr-ds", "kerrds", "kerr-de-sitter"):
        # Kerr-de Sitter: spin + Lambda on the BL-like chart
        # (physics/kerr_de_sitter.py; Lambda rides the third params slot)
        from .render_generic import render_generic
        return render_generic(
            scene, spin=scene.spin, metric="KerrDS",
            bg_array=bg_array, dtype=dtype, n_samples=n_samples,
            seed=seed, metrics=metrics,
            charge=float(getattr(scene, "metric_param", 0.0)),
            aa_samples=aa_samples)
    static_names = {"kottler": "Kottler", "sds": "Kottler",
                    "bardeen": "Bardeen", "hayward": "Hayward"}
    if scene_metric in static_names:
        from .render_generic import render_generic
        return render_generic(
            scene, spin=float(getattr(scene, "metric_param", 0.0)),
            metric=static_names[scene_metric], bg_array=bg_array,
            dtype=dtype, n_samples=n_samples, seed=seed, metrics=metrics,
            charge=0.0, aa_samples=aa_samples)
    if (scene_metric in ("kerr", "kerr-bl", "kerrbl", "kerrschild",
                         "kerr-schild") or charge != 0.0):
        from .render_generic import render_generic
        metric = ("Kerr" if scene_metric in ("kerr-bl", "kerrbl")
                  else "KerrSchild")  # schwarzschild+Q -> RN in the KS chart
        return render_generic(scene, spin=scene.spin, metric=metric,
                              bg_array=bg_array, dtype=dtype,
                              n_samples=n_samples, seed=seed,
                              metrics=metrics, charge=charge,
                              aa_samples=aa_samples)

    from .metrics import RenderMetrics
    want_metrics = metrics is not None
    if metrics is None:
        metrics = RenderMetrics()  # throwaway; keeps the code uniform
    h, w = scene.image_size
    integ = scene.integrator
    if dtype is None:
        dtype = jnp.float64 if integ.dtype == "float64" else jnp.float32
    has_bg = bg_array is not None
    with metrics.stage("texture_upload"):
        bg_dev = (jnp.asarray(bg_array, dtype=jnp.uint8) if has_bg
                  else jnp.zeros((1, 1, 3), dtype=jnp.uint8))

    with metrics.stage("device_pipeline"):
        out = render_pixels(
            bg_dev,
            jnp.asarray(scene.observer_distance, dtype),
            jnp.asarray(scene.fov, dtype),
            jnp.asarray(scene.bh_mass, dtype),
            jnp.asarray(scene.boundary_radius, dtype),
            integ.steps,
            jnp.asarray(integ.delta, dtype),
            jnp.asarray(_effective_omega(scene), dtype),
            jnp.asarray(scene.patch.center_theta, dtype),
            jnp.asarray(scene.patch.center_phi, dtype),
            jnp.asarray(scene.patch.size_theta, dtype),
            jnp.asarray(scene.patch.size_phi, dtype),
            height=h, width=w,
            flip_theta=scene.patch.flip_theta,
            flip_phi=scene.patch.flip_phi,
            has_background=has_bg, dtype=dtype,
            backend=resolve_backend(integ.backend),
            order=integ.order)
        if aa_samples:
            from .aa import refine_edges_schwarzschild
            out["image"], out["aa_mask"] = refine_edges_schwarzschild(
                out["cls"], out["image"], bg_dev,
                jnp.asarray(scene.observer_distance, dtype),
                jnp.asarray(scene.fov, dtype),
                jnp.asarray(scene.bh_mass, dtype),
                jnp.asarray(scene.boundary_radius, dtype),
                integ.steps,
                jnp.asarray(integ.delta, dtype),
                jnp.asarray(_effective_omega(scene), dtype),
                jnp.asarray(scene.patch.center_theta, dtype),
                jnp.asarray(scene.patch.center_phi, dtype),
                jnp.asarray(scene.patch.size_theta, dtype),
                jnp.asarray(scene.patch.size_phi, dtype),
                height=h, width=w, samples=int(aa_samples),
                order=integ.order, backend=resolve_backend(integ.backend),
                flip_theta=scene.patch.flip_theta,
                flip_phi=scene.patch.flip_phi,
                has_background=has_bg, dtype=dtype)

    with metrics.stage("device_pipeline"):
        # the count_vec fetch synchronizes the whole device pipeline
        cv = np.asarray(out.pop("count_vec"))
    counts = {"captured": int(cv[0]), "in_domain": int(cv[1]),
              "escaped": int(cv[2]), "background": int(cv[3]),
              "numerical_error": int(cv[4])}
    metrics.rays = h * w
    if want_metrics:  # costs one (H, W) host fetch — only when asked for
        metrics.geodesic_steps = int(np.asarray(out["n_steps"],
                                                np.int64).sum())

    n_samples = scene.n_samples if n_samples is None else n_samples
    sampled_ij = None
    sampled_trajs = None
    if n_samples and n_samples > 0:
        with metrics.stage("sample_trajectories"):
            rng = np.random.default_rng(seed)
            flat = rng.choice(h * w, size=min(n_samples, h * w),
                              replace=False)
            sampled_ij = np.stack([flat // w, flat % w], axis=-1)
            sampled_trajs = _sample_trajectories(
                out["q0"], out["p0"], out["beta"], sampled_ij, scene, dtype)

    return RenderResult(out, counts, sampled_indices=sampled_ij,
                        sampled_trajectories=sampled_trajs)

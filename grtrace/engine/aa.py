"""Adaptive shadow-edge antialiasing: sub-pixel rays only where they matter.

The shadow boundary, photon ring and patch seams are the only places a
geodesic render aliases — everywhere else the ray bundle is smooth at
pixel scale.  Uniform supersampling at s x s pays (s^2 - 1) x the full
render for that handful of pixels; this pass instead

  1. scores every pixel by how many 4-neighbors classify differently
     (`edge_scores` — the class map is already on device),
  2. selects a STATIC number k_edge of top-scoring pixels with
     `jax.lax.top_k` (XLA needs static shapes; zero-score picks are
     masked out, so k_edge only needs to exceed the true edge count —
     boundary length is O(image perimeter), a small fraction of area),
  3. re-traces s^2 stratified sub-rays for each selected pixel through
     the same camera -> integrate -> classify -> composite chain as the
     base render, and
  4. averages the sub-colors and scatters them back into the image.

Cost: k_edge * s^2 extra rays ~ (s^2 / edge_fraction^-1) of the base
render instead of s^2 x.  On the device this is one more fused jit
program over dense arrays — gather of camera rows, the usual masked
while_loop, scatter of colors; no host round-trip between passes.

No reference counterpart (the reference renders un-antialiased frames;
its CUDA kernel has no sub-pixel machinery).  The class map and CSV
artifacts keep center-sample semantics — AA touches displayed colors
only, which is what antialiasing means.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..physics.camera import (cartesian_ics_from_pixels,
                              pixel_positions_fractional,
                              unfolded_ics_from_pixels)
from ..physics.coords import cartesian_to_spherical
from ..physics.spacetime import COORDS, METRICS, horizon_radius
from . import classify as _classify
from .integrate import STATUS_CAPTURED
from .integrate_generic import integrate_batch_chart


def edge_scores(cls):
    """(H, W) int32: how many of the 4 neighbors classify differently
    (replicate-padded at the frame border)."""
    pad = jnp.pad(cls, 1, mode="edge")
    return ((pad[1:-1, :-2] != cls).astype(jnp.int32)
            + (pad[1:-1, 2:] != cls).astype(jnp.int32)
            + (pad[:-2, 1:-1] != cls).astype(jnp.int32)
            + (pad[2:, 1:-1] != cls).astype(jnp.int32))


def default_k_edge(height, width):
    """Static top-k budget: an eighth of the frame, multiple of 256 —
    comfortably above any real boundary length (O(perimeter))."""
    return int(min(height * width,
                   max(256, -(-(height * width // 8) // 256) * 256)))


def _select_edges(cls, width, k_edge, dtype):
    """top-k edge pixels -> (flat idx, valid mask, float i, float j)."""
    score = edge_scores(cls).reshape(-1)
    vals, idx = jax.lax.top_k(score, k_edge)
    return idx, vals > 0, (idx // width).astype(dtype), \
        (idx % width).astype(dtype)


def _subpixel_indices(ii, jj, samples, dtype):
    """(K,) pixel centers -> (K*s^2,) stratified fractional indices."""
    off = (jnp.arange(samples, dtype=dtype) + 0.5) / samples - 0.5
    oi, oj = jnp.meshgrid(off, off, indexing="ij")
    i_f = (ii[:, None] + oi.reshape(-1)[None, :]).reshape(-1)
    j_f = (jj[:, None] + oj.reshape(-1)[None, :]).reshape(-1)
    return i_f, j_f


def _scatter_averaged(image, idx, valid, colors, k_edge, samples, height,
                      width):
    """Mean the s^2 sub-colors per pixel and scatter into the image."""
    avg = jnp.mean(colors.reshape(k_edge, samples * samples, 3)
                   .astype(jnp.float32), axis=1)
    avg_u8 = jnp.clip(avg + 0.5, 0.0, 255.0).astype(jnp.uint8)
    flat_img = image.reshape(-1, 3)
    new = jnp.where(valid[:, None], avg_u8, flat_img[idx])
    image = flat_img.at[idx].set(new).reshape(height, width, 3)
    aa_mask = jnp.zeros(height * width, bool).at[idx].set(
        valid).reshape(height, width)
    return image, aa_mask


@partial(jax.jit,
         static_argnames=("height", "width", "steps", "samples", "k_edge",
                          "metric", "order", "flip_theta",
                          "flip_phi", "has_background", "dtype"))
def refine_edges_generic(cls, image, bg_array, obs_x, fov, mass, spin,
                         charge, boundary_radius, steps, delta, omega,
                         patch_center_theta, patch_center_phi,
                         patch_size_theta, patch_size_phi,
                         *, height, width, samples=2, k_edge=None,
                         metric="KerrSchild", order=2,
                         flip_theta=False, flip_phi=False,
                         has_background=True, dtype=jnp.float32):
    """One jitted program: edge select -> sub-rays -> trace -> classify ->
    composite -> average -> scatter.  Returns (image, aa_mask).

    Mirrors render_pixels_generic's trace/classify stage exactly (same
    engines, same rs_classify surface, same compositing) so a sub-ray
    through a pixel center reproduces the base render's color bit-for-bit.
    """
    if k_edge is None:
        k_edge = default_k_edge(height, width)
    g_inv_fn = METRICS[metric]
    cartesian = COORDS[metric] == "cartesian"
    params = jnp.stack([jnp.asarray(mass, dtype), jnp.asarray(spin, dtype),
                        jnp.asarray(charge, dtype)])
    obs_pos = jnp.stack([obs_x, jnp.zeros_like(obs_x),
                         jnp.zeros_like(obs_x)])

    idx, valid, ii, jj = _select_edges(cls, width, k_edge, dtype)
    i_f, j_f = _subpixel_indices(ii, jj, samples, dtype)
    pix = pixel_positions_fractional(obs_pos, fov, height, width, i_f, j_f,
                                     dtype=dtype)
    from ..physics.static_metrics import STATIC_F as _STATIC_F
    beta_fold = None
    if cartesian:
        q0, p0, _ = cartesian_ics_from_pixels(obs_pos, pix, params=params,
                                              g_inv_fn=g_inv_fn)
    elif metric in _STATIC_F:
        # folded equatorial camera, matching the base render
        # (render_pixels_generic routes static metrics through it)
        from ..physics.camera import folded_ics_from_pixels_static
        q0, p0, _, beta_fold = folded_ics_from_pixels_static(
            obs_pos, pix, params=params, g_inv_fn=g_inv_fn)
        beta_fold = beta_fold.reshape(-1)
    else:
        q0, p0, _ = unfolded_ics_from_pixels(obs_pos, pix, params=params,
                                             g_inv_fn=g_inv_fn)
    q0 = q0.reshape(-1, 4)
    p0 = p0.reshape(-1, 4)

    final_q, final_p, status, n_steps = integrate_batch_chart(
        q0, p0, steps, delta, params, boundary_radius, omega,
        order=order, metric=metric, dtype=dtype)

    if cartesian:
        rho, th, ph = cartesian_to_spherical(final_q[:, 1], final_q[:, 2],
                                             final_q[:, 3])
        rho = jnp.where(status == STATUS_CAPTURED, jnp.zeros_like(rho), rho)
        final_q = jnp.stack([final_q[:, 0], rho, th, ph], axis=-1)

    from ..physics.static_metrics import STATIC_F, static_capture_radius
    if metric in STATIC_F:
        # same capture surface as the full-frame program
        # (render_generic.render_pixels_generic / integrate_generic)
        r_plus = static_capture_radius(metric, params) / 1.1
    else:
        r_plus = horizon_radius(
            "Kerr" if metric != "Schwarzschild" else metric,
            params[0], params[1], params[2])
    shell = 1.1 if metric != "KerrSchild" else 1.05
    rs_classify = (shell / 1.2) * r_plus
    sub_cls, _, _, u01, v01 = _classify.classify_rays(
        final_q, jnp.full(final_q.shape[:-1], jnp.pi, dtype),
        (beta_fold if beta_fold is not None
         else jnp.zeros(final_q.shape[:-1], dtype)),
        rs=rs_classify, r_obs_x=obs_x, boundary_radius=boundary_radius,
        patch_center_theta=patch_center_theta,
        patch_center_phi=patch_center_phi,
        patch_size_theta=patch_size_theta,
        patch_size_phi=patch_size_phi,
        flip_theta=flip_theta, flip_phi=flip_phi,
        has_background=has_background)
    colors = _classify.composite(sub_cls, u01, v01,
                                 bg_array if has_background
                                 else jnp.zeros((1, 1, 3), dtype=jnp.uint8))
    return _scatter_averaged(image, idx, valid, colors, k_edge, samples,
                             height, width)


@partial(jax.jit,
         static_argnames=("height", "width", "steps", "samples", "k_edge",
                          "order", "backend", "flip_theta", "flip_phi",
                          "has_background", "dtype"))
def refine_edges_schwarzschild(cls, image, bg_array, obs_x, fov, mass,
                               boundary_radius, steps, delta, omega,
                               patch_center_theta, patch_center_phi,
                               patch_size_theta, patch_size_phi,
                               *, height, width, samples=2, k_edge=None,
                               order=2, backend="xla", flip_theta=False,
                               flip_phi=False, has_background=True,
                               dtype=jnp.float32):
    """The fast-path twin: sub-rays go through the folded equatorial
    camera and the same integrate_dispatch/classify chain as
    render.render_pixels, so the chart, discretization and the analytic
    b_crit capture shortcut all match the base render exactly."""
    from ..physics.camera import initial_conditions
    from .integrate import integrate_dispatch

    if k_edge is None:
        k_edge = default_k_edge(height, width)
    obs_pos = jnp.stack([obs_x, jnp.zeros_like(obs_x),
                         jnp.zeros_like(obs_x)])

    idx, valid, ii, jj = _select_edges(cls, width, k_edge, dtype)
    i_f, j_f = _subpixel_indices(ii, jj, samples, dtype)
    pix = pixel_positions_fractional(obs_pos, fov, height, width, i_f, j_f,
                                     dtype=dtype)
    q0, p0, alpha0, _, beta = initial_conditions(obs_pos, pix, mass_bh=mass)

    rs = 2.0 * mass
    final_q, final_p, status, n_steps = integrate_dispatch(
        q0, p0, steps, delta, rs, boundary_radius, omega,
        backend=backend, equatorial=True, order=order)

    sub_cls, _, _, u01, v01 = _classify.classify_rays(
        final_q, alpha0, beta, rs=rs, r_obs_x=obs_x,
        boundary_radius=boundary_radius,
        patch_center_theta=patch_center_theta,
        patch_center_phi=patch_center_phi,
        patch_size_theta=patch_size_theta,
        patch_size_phi=patch_size_phi,
        flip_theta=flip_theta, flip_phi=flip_phi,
        has_background=has_background)
    colors = _classify.composite(sub_cls, u01, v01,
                                 bg_array if has_background
                                 else jnp.zeros((1, 1, 3), dtype=jnp.uint8))
    return _scatter_averaged(image, idx, valid, colors, k_edge, samples,
                             height, width)


@partial(jax.jit,
         static_argnames=("height", "width", "steps", "samples", "k_edge",
                          "order", "flip_theta", "flip_phi",
                          "has_background", "dtype", "prograde", "profile",
                          "camera_moving"))
def refine_edges_disk(cls, image, bg_array, obs_pos, fov, mass, spin,
                      charge, boundary_radius, steps, delta, omega,
                      r_in, r_out, t_peak, exposure,
                      patch_center_theta, patch_center_phi,
                      patch_size_theta, patch_size_phi,
                      camera_omega=0.0,
                      *, height, width, samples=2, k_edge=None, order=2,
                      flip_theta=False, flip_phi=False,
                      has_background=True, dtype=jnp.float32,
                      prograde=True, profile="shakura",
                      camera_moving=False):
    """The accretion-disk twin: sub-rays ride the inclined look-at camera
    and disk._trace_shade_flat — the disk silhouette and its lensed
    far-side arc are the sharpest (most aliased) edges in the framework.
    The edge score includes CLS_DISK transitions automatically since it
    only compares class labels."""
    from ..physics.camera import (cartesian_ics_from_pixels,
                                  pixel_positions_fractional_lookat)
    from ..physics.spacetime import ks_radius
    from .disk import _trace_shade_flat

    if k_edge is None:
        k_edge = default_k_edge(height, width)
    g_inv_fn = METRICS["KerrSchild"]
    params = jnp.stack([jnp.asarray(mass, dtype), jnp.asarray(spin, dtype),
                        jnp.asarray(charge, dtype)])
    obs_pos = jnp.asarray(obs_pos, dtype)
    r_obs = jnp.linalg.norm(obs_pos)
    r_obs_bl = ks_radius(obs_pos[0], obs_pos[1], obs_pos[2], params[1])
    th_obs = jnp.arccos(jnp.clip(obs_pos[2] / jnp.maximum(r_obs_bl, 1e-30),
                                 -1.0, 1.0))

    idx, valid, ii, jj = _select_edges(cls, width, k_edge, dtype)
    i_f, j_f = _subpixel_indices(ii, jj, samples, dtype)
    pix = pixel_positions_fractional_lookat(obs_pos, fov, height, width,
                                            i_f, j_f, dtype=dtype)
    camera_omega = jnp.asarray(camera_omega, dtype)
    if camera_moving:
        from ..physics.camera import boosted_ics_from_pixels
        q0, p0, _ = boosted_ics_from_pixels(obs_pos, pix, params=params,
                                            g_inv_fn=g_inv_fn,
                                            omega_cam=camera_omega)
    else:
        q0, p0, _ = cartesian_ics_from_pixels(obs_pos, pix, params=params,
                                              g_inv_fn=g_inv_fn)
    flat = _trace_shade_flat(
        q0.reshape(-1, 4), p0.reshape(-1, 4), bg_array, params, r_obs,
        r_obs_bl, th_obs, boundary_radius, steps, delta, omega, r_in,
        r_out, t_peak, exposure, patch_center_theta, patch_center_phi,
        patch_size_theta, patch_size_phi, order=order,
        dtype=dtype, prograde=prograde, profile=profile,
        flip_theta=flip_theta, flip_phi=flip_phi,
        has_background=has_background,
        omega_obs=camera_omega if camera_moving else None)
    return _scatter_averaged(image, idx, valid, flat["colors"], k_edge,
                             samples, height, width)


def subring_edge_labels(cls, count, valid):
    """Composite (H, W) int32 label whose 4-neighbor transitions mark
    every aliased boundary of a subring render: classification edges
    (shadow silhouette, patch seams), crossing-count bands (each image
    order's ring boundary — the n-th subring is exactly a count >= n+1
    band), and per-order annulus membership (the ISCO gap / outer edge
    as seen in each layer).  One edge_scores() pass over this map scores
    all of them at once."""
    n_orders = valid.shape[0]
    weights = (2 ** jnp.arange(n_orders, dtype=jnp.int32))[:, None, None]
    bits = jnp.sum(valid.astype(jnp.int32) * weights, axis=0)
    cc = jnp.clip(count, 0, n_orders + 1)
    return ((cls.astype(jnp.int32) * (n_orders + 2) + cc)
            * (2 ** n_orders) + bits)


def _scatter_averaged_stack(maps, idx, valid, vals, k_edge, samples):
    """Per-layer mean of the s^2 sub-values per refined pixel, scattered
    into (L, H, W) float maps (the layered analog of _scatter_averaged)."""
    shape = maps.shape
    avg = jnp.mean(vals.reshape(shape[0], k_edge, samples * samples),
                   axis=2)
    flat = maps.reshape(shape[0], -1)
    new = jnp.where(valid[None, :], avg, flat[:, idx])
    return flat.at[:, idx].set(new).reshape(shape)


@partial(jax.jit,
         static_argnames=("height", "width", "steps", "samples", "k_edge",
                          "n_orders", "order", "backend", "flip_theta",
                          "flip_phi", "has_background", "dtype", "prograde",
                          "profile", "camera_moving"))
def refine_subrings(cls, count, valid, image, intensity, bg_array,
                    obs_pos, fov, mass, spin, charge, boundary_radius,
                    steps, delta, omega, r_in, r_out, t_peak, exposure,
                    patch_center_theta, patch_center_phi,
                    patch_size_theta, patch_size_phi, camera_omega=0.0,
                    *, height, width, samples=2, k_edge=None, n_orders=3,
                    order=2, backend="xla", flip_theta=False,
                    flip_phi=False, has_background=True,
                    dtype=jnp.float32, prograde=True, profile="shakura",
                    camera_moving=False):
    """Adaptive refinement of a subring render: re-trace s^2 stratified
    sub-rays through the pixels where any layer boundary lands, and
    replace BOTH the displayed colors and the per-order intensity maps
    with the sub-ray means.

    Unlike the display-only passes above, refining `intensity` is the
    science payoff: the n >= 1 subrings are exponentially thin
    (width ~ e^{-pi n}), so at practical resolutions their flux is
    carried by boundary pixels whose center-sample value is a coin flip
    — the pixel-area average converges flux_per_order / gamma_hat at
    ~(s^2 x edge fraction) extra cost instead of the s^2 x of uniform
    supersampling.  Refined pixels hold pixel-area-averaged intensity;
    unrefined pixels keep center-sample semantics (they are smooth at
    pixel scale by construction of the edge score).

    Returns (image, intensity, total_intensity, aa_mask).
    """
    from ..physics.camera import (cartesian_ics_from_pixels,
                                  pixel_positions_fractional_lookat)
    from ..physics.spacetime import ks_radius
    from .subring import _trace_shade_subrings

    if k_edge is None:
        k_edge = default_k_edge(height, width)
    g_inv_fn = METRICS["KerrSchild"]
    params = jnp.stack([jnp.asarray(mass, dtype), jnp.asarray(spin, dtype),
                        jnp.asarray(charge, dtype)])
    obs_pos = jnp.asarray(obs_pos, dtype)
    r_obs = jnp.linalg.norm(obs_pos)
    r_obs_bl = ks_radius(obs_pos[0], obs_pos[1], obs_pos[2], params[1])
    th_obs = jnp.arccos(jnp.clip(obs_pos[2] / jnp.maximum(r_obs_bl, 1e-30),
                                 -1.0, 1.0))

    labels = subring_edge_labels(cls, count, valid)
    idx, valid_sel, ii, jj = _select_edges(labels, width, k_edge, dtype)
    i_f, j_f = _subpixel_indices(ii, jj, samples, dtype)
    pix = pixel_positions_fractional_lookat(obs_pos, fov, height, width,
                                            i_f, j_f, dtype=dtype)
    camera_omega = jnp.asarray(camera_omega, dtype)
    if camera_moving:
        from ..physics.camera import boosted_ics_from_pixels
        q0, p0, _ = boosted_ics_from_pixels(obs_pos, pix, params=params,
                                            g_inv_fn=g_inv_fn,
                                            omega_cam=camera_omega)
    else:
        q0, p0, _ = cartesian_ics_from_pixels(obs_pos, pix, params=params,
                                              g_inv_fn=g_inv_fn)
    flat = _trace_shade_subrings(
        q0.reshape(-1, 4), p0.reshape(-1, 4), bg_array, params, r_obs,
        r_obs_bl, th_obs, boundary_radius, steps, delta, omega, r_in,
        r_out, t_peak, exposure, patch_center_theta, patch_center_phi,
        patch_size_theta, patch_size_phi, n_orders=n_orders, order=order,
        backend=backend, dtype=dtype, prograde=prograde, profile=profile,
        flip_theta=flip_theta, flip_phi=flip_phi,
        has_background=has_background,
        omega_obs=camera_omega if camera_moving else None)

    image, aa_mask = _scatter_averaged(image, idx, valid_sel,
                                       flat["image"], k_edge, samples,
                                       height, width)
    sub_inten = flat["shade"]["intensity"]          # (n_orders, K*s^2)
    intensity = _scatter_averaged_stack(intensity, idx, valid_sel,
                                        sub_inten, k_edge, samples)
    total = jnp.sum(intensity, axis=0)
    return image, intensity, total, aa_mask

"""Photon-ring subring decomposition (engine/subring.py).

Validation strategy:
  * the subring integrator must be the PLAIN Kerr-Schild integrator plus
    bookkeeping — final states bit-exact vs integrate_batch_generic;
  * slot 0 must reproduce the opaque-disk crossing event bit-exactly
    wherever the first plane crossing lands inside the annulus;
  * the analytic anchors of the photon shell: successive crossing delays
    approach the Schwarzschild half-period pi * 3 sqrt(3) M and the
    per-order demagnification approaches e^{-pi}
    (tests/test_subring_anchors.py — kept separate, they bisect).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from grtrace.engine.disk import DiskConfig, STATUS_DISK, integrate_batch_disk
from grtrace.engine.integrate_generic import integrate_batch_generic
from grtrace.engine.subring import (integrate_batch_subrings,
                                    render_subrings, shade_subrings,
                                    subring_summary)
from grtrace.io.scene import IntegratorConfig, SceneConfig
from grtrace.physics.camera import cartesian_ics_from_pixels, pixel_grid_lookat
from grtrace.physics.spacetime import METRICS


def _fan_ics(spin=0.0, n=64, u_lo=0.3, u_hi=3.5, dtype=jnp.float64):
    """1D impact-parameter fan from a face-on camera at z = 30."""
    params = jnp.array([1.0, spin, 0.0], dtype)
    obs = jnp.array([0.0, 0.0, 30.0], dtype)
    u = jnp.linspace(u_lo, u_hi, n, dtype=dtype)
    pix = jnp.stack([u, jnp.zeros(n, dtype), jnp.full((n,), 24.0, dtype)],
                    axis=-1)
    q0, p0, _ = cartesian_ics_from_pixels(obs, pix, params=params,
                                          g_inv_fn=METRICS["KerrSchild"])
    return q0, p0, params


@pytest.mark.parametrize("spin", [0.0, 0.9])
def test_subring_integrator_is_plain_ks_plus_bookkeeping(spin):
    """Crossing recording must not perturb the ray states: final
    (q, p, status, n_steps) bit-exact vs integrate_batch_generic on the
    same chart with the same knobs."""
    q0, p0, params = _fan_ics(spin=spin)
    kw = dict(steps=6000, delta=0.2, params=params, r_max=31.0, omega=0.0,
              order=2)
    fq_s, fp_s, st_s, ns_s, hq, hp, count = integrate_batch_subrings(
        q0, p0, kw["steps"], kw["delta"], params, 31.0, 0.0, n_orders=3)
    fq_g, fp_g, st_g, ns_g = integrate_batch_generic(
        q0, p0, kw["steps"], kw["delta"], params, 31.0, 0.0,
        metric="KerrSchild")
    np.testing.assert_array_equal(np.asarray(st_s), np.asarray(st_g))
    np.testing.assert_array_equal(np.asarray(ns_s), np.asarray(ns_g))
    np.testing.assert_array_equal(np.asarray(fq_s), np.asarray(fq_g))
    np.testing.assert_array_equal(np.asarray(fp_s), np.asarray(fp_g))
    # the fan crosses the plane: some rays must have recorded something
    assert int(np.asarray(count).max()) >= 1


@pytest.mark.parametrize("spin", [0.0, 0.9])
def test_slot0_matches_opaque_disk_crossing(spin):
    """Where the FIRST plane crossing falls inside the annulus, the
    opaque disk records exactly that event — slot 0 must be bit-exact
    against integrate_batch_disk's (hit_q, hit_p)."""
    q0, p0, params = _fan_ics(spin=spin)
    r_in, r_out = 4.0, 14.0
    steps, delta = 6000, 0.2
    _, _, st_d, _, hit_q, hit_p = integrate_batch_disk(
        q0, p0, steps, delta, params, 31.0, 0.0, r_in, r_out)
    _, _, _, _, hq, hp, count = integrate_batch_subrings(
        q0, p0, steps, delta, params, 31.0, 0.0, n_orders=2)

    from grtrace.physics.spacetime import ks_radius
    r0 = np.asarray(ks_radius(hq[0, :, 1], hq[0, :, 2], hq[0, :, 3],
                              params[1]))
    first_in_annulus = (np.asarray(count) >= 1) & (r0 >= r_in) & (r0 <= r_out)
    disk_hit = np.asarray(st_d) == STATUS_DISK
    # every first-crossing-in-annulus ray is a disk hit, same event
    assert first_in_annulus.sum() > 5
    assert (disk_hit[first_in_annulus]).all()
    np.testing.assert_array_equal(np.asarray(hq[0])[first_in_annulus],
                                  np.asarray(hit_q)[first_in_annulus])
    np.testing.assert_array_equal(np.asarray(hp[0])[first_in_annulus],
                                  np.asarray(hit_p)[first_in_annulus])


def test_shading_masks_and_additivity():
    """Layer intensities are zero exactly off-annulus / unfilled slots,
    and the composite total is their sum."""
    q0, p0, params = _fan_ics(spin=0.0, n=96, u_lo=0.3, u_hi=4.0)
    _, _, _, _, hq, hp, count = integrate_batch_subrings(
        q0, p0, 8000, 0.2, params, 31.0, 0.0, n_orders=3)
    shade = shade_subrings(hq, hp, count, params, jnp.asarray(30.0),
                           4.0, 14.0, theta_obs=jnp.asarray(1e-6))
    inten = np.asarray(shade["intensity"])
    valid = np.asarray(shade["valid"])
    assert (inten[~valid] == 0.0).all()
    assert (inten[valid] > 0.0).all()
    np.testing.assert_allclose(np.asarray(shade["total_intensity"]),
                               inten.sum(axis=0), rtol=1e-12)
    # deeper orders can never out-populate shallower ones
    counts = valid.sum(axis=1)
    assert counts[0] >= counts[1] >= counts[2]


def test_render_subrings_smoke_and_summary():
    """Scene-level render: composite image, per-order stack shapes, JSON
    summary sanity (finite flux, n=0 dominates, delays positive)."""
    scene = SceneConfig(size=48, metric="kerr", spin=0.0, n_samples=0,
                        integrator=IntegratorConfig(steps=8000, delta=0.2))
    disk = DiskConfig(elevation_deg=75.0, show_background=False)
    res = render_subrings(scene, disk, n_orders=3)
    assert res["image"].shape == (48, 48, 3)
    assert res["intensity"].shape == (3, 48, 48)
    assert res["valid"][0].sum() > 0
    s = subring_summary(res)
    assert np.isfinite(s["flux_per_order"]).all() if hasattr(
        np.isfinite(s["flux_per_order"]), "all") else True
    assert s["flux_per_order"][0] > s["flux_per_order"][1] >= 0.0
    assert s["max_crossings"] >= 2
    # order n=1 exists at this elevation and is exponentially suppressed
    assert 0.0 < s["flux_ratio"][0] < 0.2
    if np.isfinite(s["delay_per_order_M"][0]):
        assert s["delay_per_order_M"][0] > 0.0


def test_cli_subring(tmp_path):
    """End-to-end CLI: artifacts on disk + a valid JSON metrics line."""
    import json

    from grtrace.cli.subring import main

    metrics = main(["--size", "40", "--steps", "6000", "--delta", "0.25",
                    "--orders", "2", "--aa", "2",
                    "--out-dir", str(tmp_path)])
    json.dumps(metrics)  # serializable
    for f in ["subring_composite.png", "subring_order_0.png",
              "subring_order_1.png", "crossing_count.png",
              "subring_summary.json", "subring_delay_01.csv"]:
        assert (tmp_path / f).exists(), f
    assert metrics["flux_per_order"][0] > 0.0
    # the theory block (photon_shell GHW triple) rides along: at spin 0
    # gamma = pi and the half-orbit delay = pi sqrt(27) M, exactly
    th = metrics["theory"]
    assert abs(th["gamma_median"] - np.pi) < 1e-6
    assert abs(th["delay_half_orbit_M_median"]
               - np.pi * np.sqrt(27.0)) < 1e-5
    assert th["gamma_max"] - th["gamma_min"] < 1e-9


# ---------------------------------------------------------------------------
# Compensated subring integrator (integrate_ks.integrate_batch_subrings_ksc)
# ---------------------------------------------------------------------------

def _subring_batch_ics(spin=0.9, size=14, elev=0.3, dist=20.0):
    import numpy as _np
    obs = jnp.array([dist * _np.cos(elev), 0.0, dist * _np.sin(elev)])
    pix = pixel_grid_lookat(obs, jnp.float64(_np.deg2rad(80.0)), size, size,
                            dtype=jnp.float64)
    params = jnp.array([1.0, spin, 0.0])
    q0, p0, _ = cartesian_ics_from_pixels(obs, pix.reshape(-1, 3),
                                          params=params,
                                          g_inv_fn=METRICS["KerrSchild"])
    return q0, p0, params


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
def test_subring_twin_matches_xla_path(dtype):
    """The compensated subring integrator agrees with the autodiff XLA
    subring engine (float64): identical statuses / counts / step parity,
    crossings AND momenta to the staggered-vs-plain rounding scale in
    float64 and to the float32 scale in float32 (both record the p2
    momentum copy — same contract as the opaque disk path)."""
    from grtrace.engine.integrate_ks import integrate_batch_subrings_ksc

    q0, p0, params = _subring_batch_ics()
    steps, delta = 900, 0.05
    fq, fp, st, ns, hq, hp, cnt = integrate_batch_subrings(
        q0, p0, steps, delta, params, 31.0, 1.0, n_orders=3)
    out_c = integrate_batch_subrings_ksc(
        q0.astype(dtype), p0.astype(dtype), steps, dtype(delta),
        params.astype(dtype), dtype(31.0), dtype(1.0), n_orders=3)
    fq_c, fp_c, st_c, ns_c, hq_c, hp_c, cnt_c = (np.asarray(v)
                                                 for v in out_c)
    np.testing.assert_array_equal(np.asarray(st), st_c)
    np.testing.assert_array_equal(np.asarray(cnt), cnt_c)
    # guard-trip TIMING can shift a step on captured plungers (staggered
    # vs plain composition rounding at the horizon; same contract as
    # tests/test_pallas_ks.py)
    ns, ns_c = np.asarray(ns), np.asarray(ns_c)
    cap = np.asarray(st) == 1
    assert (ns[~cap] == ns_c[~cap]).all()
    assert np.abs(ns[cap] - ns_c[cap]).max() <= 2
    assert cnt_c.max() >= 2        # the scene resolves a second order
    filled = (np.asarray(cnt)[None, :]
              > np.arange(3)[:, None])
    tol = 1e-9 if dtype == jnp.float64 else 1e-4
    np.testing.assert_allclose(hq_c[filled], np.asarray(hq)[filled],
                               atol=tol)
    np.testing.assert_allclose(hp_c[filled], np.asarray(hp)[filled],
                               atol=tol)


def test_subring_twin_zero_steps_noop():
    from grtrace.engine.integrate_ks import integrate_batch_subrings_ksc

    q0, p0, params = _subring_batch_ics(size=4)
    fq, fp, st, ns, hq, hp, cnt = integrate_batch_subrings_ksc(
        q0, p0, 0, 0.05, params, 31.0, 1.0, n_orders=2)
    np.testing.assert_array_equal(np.asarray(fq), np.asarray(q0))
    assert (np.asarray(cnt) == 0).all()
    assert (np.asarray(ns) == 0).all()


def test_render_subrings_pallas_backend():
    """Render-level contract of the backend knob: backend='pallas' (what
    'auto' resolves to on a GPU) runs the compensated subring integrator,
    whose crossing record shades identically to the XLA engine's through
    shade_subrings."""
    from grtrace.engine.integrate_ks import integrate_batch_subrings_ksc

    q0, p0, params = _subring_batch_ics(size=10)
    steps, delta = 600, 0.05
    _, _, st_x, _, hq_x, hp_x, cnt_x = integrate_batch_subrings(
        q0, p0, steps, delta, params, 31.0, 1.0, n_orders=2)
    _, _, st_p, _, hq_p, hp_p, cnt_p = integrate_batch_subrings_ksc(
        q0, p0, steps, delta, params, 31.0, 1.0, n_orders=2)
    sx = shade_subrings(hq_x, hp_x, cnt_x, params, jnp.asarray(20.0),
                        2.32, 14.0, theta_obs=jnp.asarray(1.27))
    sp = shade_subrings(hq_p, hp_p, cnt_p, params, jnp.asarray(20.0),
                        2.32, 14.0, theta_obs=jnp.asarray(1.27))
    np.testing.assert_array_equal(np.asarray(sx["valid"]),
                                  np.asarray(sp["valid"]))
    np.testing.assert_allclose(np.asarray(sx["intensity"]),
                               np.asarray(sp["intensity"]),
                               rtol=2e-3, atol=1e-12)


# ---------------------------------------------------------------------------
# per-order interferometric signatures (subring_visibilities)
# ---------------------------------------------------------------------------

def test_subring_visibilities_synthetic_layers():
    """The per-order router pinned on fabricated layers: a thin ring in
    layer 1 must return its exact diameter through the J0 first-null
    estimator (2% with pad=6 interpolation), and a null-free Gaussian
    blob in layer 0 must return NaN rather than a fabricated null."""
    from grtrace.engine.subring import subring_visibilities

    size, fov = 96, np.deg2rad(60.0)
    yy, xx = np.mgrid[0:size, 0:size] - (size - 1) / 2.0
    rho = np.hypot(xx, yy)
    inten = np.zeros((2, size, size))
    inten[0] = np.exp(-0.5 * (rho / 6.0) ** 2)          # no visibility null
    inten[1] = np.exp(-0.5 * ((rho - 20.0) / 0.7) ** 2)  # thin ring r=20px
    res = {"intensity": inten}
    vis = subring_visibilities(res, fov)
    assert np.isnan(vis[0]["ring_diameter_rad"])
    pixel_cam = 2.0 * np.tan(fov / 2.0) / size
    expect = 2 * 20.0 * pixel_cam
    assert vis[1]["ring_diameter_rad"] == pytest.approx(expect, rel=0.02)


def test_subring_visibilities_real_render_smoke():
    """On a real face-on render the n=1 layer is a (pixel-quantized)
    photon ring: the estimator must find a null and land within the
    quantization scale of the image-space ring diameter."""
    from grtrace.engine.disk import DiskConfig
    from grtrace.engine.subring import render_subrings, subring_visibilities
    from grtrace.io.scene import IntegratorConfig, SceneConfig

    size = 64
    scene = SceneConfig(size=size, metric="kerr", spin=0.0, n_samples=0,
                        integrator=IntegratorConfig(steps=6000, delta=0.06,
                                                    dtype="float64"))
    res = render_subrings(scene, DiskConfig(elevation_deg=89.9,
                                            show_background=False),
                          n_orders=2)
    fov = np.deg2rad(80.0)
    vis = subring_visibilities(res, fov)
    v1 = res["valid"][1]
    assert v1.sum() >= 6
    c = (size - 1) / 2.0
    ii, jj = np.nonzero(v1)
    w = res["intensity"][1][v1]
    mean_rho = float((np.hypot(ii - c, jj - c) * w).sum() / w.sum())
    geo = 2.0 * mean_rho * (2.0 * np.tan(fov / 2.0) / size)
    assert np.isfinite(vis[1]["b_null"])
    # the ~8-px ring is radially sub-pixel: 25% covers the measured 19%
    # center-sample quantization bias (vis 0.378 vs geo 0.317 rad)
    assert vis[1]["ring_diameter_rad"] == pytest.approx(geo, rel=0.25)

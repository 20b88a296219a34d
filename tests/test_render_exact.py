"""Semi-analytic disk renderer vs the traced disk engine.

The two pipelines share ONLY the shading core
(disk.shade_disk_constants) and the camera; the crossing physics is
computed two entirely different ways (20k-step symplectic integration
vs separated-Hamiltonian quadrature).  Agreement is therefore a
whole-pipeline cross-validation: the disk MASKS must be identical
pixel-for-pixel and the redshift factors equal to the integrator's
crossing-discretization floor.
"""
import numpy as np
import pytest

from grtrace import IntegratorConfig, PatchConfig, SceneConfig
from grtrace.engine.disk import CLS_DISK, DiskConfig, render_disk
from grtrace.engine.render_exact import render_disk_exact


@pytest.fixture(scope="module")
def scene_pair():
    scene = SceneConfig(size=40, metric="kerr", spin=0.7, n_samples=0,
                        integrator=IntegratorConfig(steps=20_000,
                                                    delta=0.02),
                        patch=PatchConfig())
    disk = DiskConfig(elevation_deg=25.0, show_background=False)
    traced = render_disk(scene, disk)
    exact = render_disk_exact(scene, disk, n_orders=3)
    return scene, disk, traced, exact


def test_disk_masks_agree(scene_pair):
    scene, _, traced, exact = scene_pair
    hw = exact["shape"]
    m_tr = np.asarray(traced.device("cls")).reshape(hw) == CLS_DISK
    m_ex = np.asarray(exact["g"]).reshape(hw) > 0.0
    assert m_tr.sum() > 100          # the scene really shows disk
    # identical classification: the exact solver finds the same first
    # in-annulus crossing the tracer does, every pixel (a 1-2 pixel
    # edge disagreement would indicate a convention drift)
    assert (m_tr ^ m_ex).sum() <= 1, (m_tr.sum(), m_ex.sum())


def test_redshift_parity(scene_pair):
    _, _, traced, exact = scene_pair
    hw = exact["shape"]
    m = (np.asarray(traced.device("cls")).reshape(hw) == CLS_DISK) \
        & (np.asarray(exact["g"]).reshape(hw) > 0.0)
    g_tr = np.asarray(traced.device("redshift")).reshape(hw)[m]
    g_ex = np.asarray(exact["g"]).reshape(hw)[m]
    dg = np.abs(g_tr - g_ex)
    # the tracer locates each crossing to O(delta * |dr/dlambda|); its
    # g follows; the exact value is inside that envelope
    assert dg.max() < 1e-4, dg.max()
    assert np.median(dg) < 3e-6


def test_emission_radius_parity(scene_pair):
    from grtrace.physics.spacetime import ks_radius

    scene, _, traced, exact = scene_pair
    hw = exact["shape"]
    m = (np.asarray(traced.device("cls")).reshape(hw) == CLS_DISK) \
        & (np.asarray(exact["g"]).reshape(hw) > 0.0)
    hq = np.asarray(traced.device("hit_q")).reshape(hw + (4,))[m]
    r_tr = np.asarray(ks_radius(hq[:, 1], hq[:, 2], hq[:, 3],
                                scene.spin))
    r_ex = np.asarray(exact["r_em"]).reshape(hw)[m]
    assert np.abs(r_tr - r_ex).max() < 2e-3


def test_higher_orders_present():
    """With a widened inner gap, some pixels shade from the k >= 1
    crossing (the far underside seen through the gap) — the exact
    table's per-order layering at work (measured: 2 such pixels at
    this tiny scene, 16 at lower elevation)."""
    scene = SceneConfig(size=40, metric="kerr", spin=0.7, n_samples=0,
                        integrator=IntegratorConfig(steps=1000,
                                                    delta=0.02),
                        patch=PatchConfig())
    exact = render_disk_exact(scene, DiskConfig(
        elevation_deg=8.0, show_background=False), n_orders=3)
    order = np.asarray(exact["order"])
    assert (order == 0).sum() > 50
    assert (order >= 1).sum() > 0


# ---------------------------------------------------- background mode

@pytest.fixture(scope="module")
def bg_pair():
    """Exact vs traced BACKGROUND render, odd size: the grid then
    contains the exactly-equatorial row (eta = 0) and the lam = 0 pole
    column (pi azimuth flips per polar passage) — both special-cased in
    geodesic_exact.escape_state."""
    import jax.numpy as jnp

    from grtrace.engine.render_exact import render_pixels_background_exact
    from grtrace.engine.render_generic import render_pixels_generic
    from grtrace.io.textures import checker

    size = 33
    bg = jnp.asarray(checker(64, 128), jnp.uint8)
    patch = (jnp.float64(np.pi / 2), jnp.float64(np.pi),
             jnp.float64(1.0), jnp.float64(1.0))
    common = (jnp.float64(30.0), jnp.float64(np.deg2rad(80.0)),
              jnp.float64(1.0), jnp.float64(0.9), jnp.float64(31.0))
    gen = render_pixels_generic(
        bg, *common, 200_000, jnp.float64(0.02), jnp.float64(0.0),
        *patch, height=size, width=size, dtype=jnp.float64,
        metric="KerrSchild", order=2)
    ex = render_pixels_background_exact(
        bg, *common, *patch, height=size, width=size)
    return size, gen, ex


def test_background_class_parity(bg_pair):
    """The exact renderer classifies every pixel exactly as the traced
    one — shadow, escape, patch hit — with identical photon-summary
    counts."""
    _, gen, ex = bg_pair
    assert (np.asarray(gen["count_vec"]) == np.asarray(
        ex["count_vec"])).all()
    assert (np.asarray(gen["cls"]) == np.asarray(ex["cls"])).all()


def test_background_never_runs_out(bg_pair):
    """No step budget exists: 'in_domain' and 'numerical error' are
    structurally impossible for the exact renderer."""
    _, _, ex = bg_pair
    cv = np.asarray(ex["count_vec"])
    assert cv[1] == 0 and cv[4] == 0
    assert set(np.unique(np.asarray(ex["status"]))) <= {1, 2}


def test_background_angle_parity(bg_pair):
    """Escape angles on the boundary sphere match the integrator's to
    its own discretization floor (the tracer overshoots the sphere by
    up to one step; near-critical pixels amplify by the Lyapunov
    factor — medians are the honest statistic, the max is bounded
    loosely)."""
    _, gen, ex = bg_pair
    esc = (np.asarray(gen["status"]) == 2) & (np.asarray(
        ex["status"]) == 2)
    qg, qe = np.asarray(gen["final_q"]), np.asarray(ex["final_q"])
    dth = np.abs(qg[..., 2] - qe[..., 2])[esc]
    dph = np.abs(np.mod(qg[..., 3] - qe[..., 3] + np.pi,
                        2.0 * np.pi) - np.pi)[esc]
    assert np.median(dth) < 1e-3
    assert np.median(dph) < 5e-3
    assert dth.max() < 0.1
    # the image agrees except where a texel boundary falls inside the
    # tracer's overshoot window
    img_g = np.asarray(gen["image"]).astype(int)
    img_e = np.asarray(ex["image"]).astype(int).reshape(img_g.shape)
    frac = (np.abs(img_g - img_e).max(axis=-1) > 0).mean()
    assert frac < 0.02, frac


def test_cli_exact_background(tmp_path):
    import json

    from grtrace.cli.exact import main

    metrics = main(["--background", "--size", "17", "--spin", "0.6",
                    "--compare", "--steps", "150000",
                    "--out-dir", str(tmp_path)])
    json.dumps(metrics)
    assert (tmp_path / "exact_bg.png").exists()
    assert metrics["captured"] > 0
    assert metrics["cls_mismatch_pixels"] == 0
    assert metrics["dphi_median"] < 5e-3


def test_cli_exact(tmp_path):
    import json

    from grtrace.cli.exact import main

    metrics = main(["--size", "32", "--spin", "0.7", "--elevation",
                    "25", "--compare", "--steps", "12000",
                    "--out-dir", str(tmp_path)])
    json.dumps(metrics)
    for f in ["exact_disk.png", "exact_g_map.csv", "exact_r_em.csv"]:
        assert (tmp_path / f).exists(), f
    assert metrics["disk_pixels"] > 50
    assert metrics["mask_mismatch_pixels"] <= 1
    assert metrics["dg_max"] < 1e-3

"""Accretion-disk mode: orbital mechanics, crossing capture, redshift.

The orbital algebra is validated against raw geodesic conditions via
autodiff (no hand formula is trusted with another hand formula), the
crossing detector against conserved quantities, and the redshift against
the closed-form face-on Schwarzschild limit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from grtrace.engine.disk import (DiskConfig, STATUS_DISK, integrate_batch_disk,
                                 render_disk)
from grtrace.io.scene import IntegratorConfig, SceneConfig
from grtrace.physics import orbits
from grtrace.physics.camera import pixel_grid, pixel_grid_lookat
from grtrace.physics.spacetime import kerr_g_inv


# ---------------------------------------------------------------------------
# physics/orbits.py
# ---------------------------------------------------------------------------

def test_isco_limits():
    assert float(orbits.isco_radius(1.0, 0.0)) == pytest.approx(6.0, abs=1e-12)
    # Bardeen et al. 1972 Table: a = 0.998 prograde ISCO ~ 1.237 M
    assert float(orbits.isco_radius(1.0, 0.998)) == pytest.approx(1.237, abs=2e-3)
    # retrograde a = 1: 9M
    assert float(orbits.isco_radius(1.0, 1.0, prograde=False)) == pytest.approx(
        9.0, abs=1e-9)


@pytest.mark.parametrize("spin,charge,prograde", [
    (0.0, 0.0, True), (0.9, 0.0, True), (0.9, 0.0, False),
    (0.6, 0.5, True), (0.3, 0.4, False),
])
def test_circular_orbit_satisfies_geodesic_condition(spin, charge, prograde):
    """The Keplerian Omega + normalization must satisfy the RAW conditions
    d/dr (g^{ab} u_a u_b) = 0 (circularity: dp_r/dlambda = -dH/dr = 0) and
    g^{ab} u_a u_b = -1 (timelike normalization) — evaluated by autodiff
    of the tested BL inverse metric, independent of the orbits algebra."""
    params = jnp.array([1.0, spin, charge])

    def h_of_r(r, u_cov):
        q = jnp.array([0.0, r, jnp.pi / 2, 0.0])
        g = kerr_g_inv(q, params)
        return u_cov @ g @ u_cov

    # circular orbits only exist outside the (pro/retro) photon orbit;
    # the retrograde photon orbit reaches ~3.9M at a = 0.9, so keep the
    # innermost probe radius prograde-only
    radii = (3.2, 5.0, 9.0, 17.0) if prograde else (5.0, 9.0, 17.0)
    for r in radii:
        r = jnp.asarray(r, jnp.float64)
        u_t, omega = orbits.circular_u_t(r, params, prograde)
        g_cov = orbits.equatorial_g_cov(r, params)
        u_con = u_t * jnp.array([1.0, 0.0, 0.0, omega])
        u_cov = g_cov @ u_con
        norm = h_of_r(r, u_cov)
        dnorm_dr = jax.grad(h_of_r)(r, u_cov)
        assert float(norm) == pytest.approx(-1.0, abs=1e-10)
        assert abs(float(dnorm_dr)) < 1e-9


def test_redshift_face_on_schwarzschild_closed_form():
    """Polar photons in Schwarzschild have L_z = 0, so
    g = sqrt(1 - 3M/r_em) / sqrt(1 - 2M/r_obs) exactly."""
    params = jnp.array([1.0, 0.0, 0.0])
    r_obs = 30.0
    for r_em in (4.0, 6.0, 10.0):
        g = orbits.redshift_factor(jnp.asarray(1.0), jnp.asarray(0.0),
                                   jnp.asarray(r_em), jnp.asarray(r_obs),
                                   params, theta_obs=1e-6)
        expect = np.sqrt(1.0 - 3.0 / r_em) / np.sqrt(1.0 - 2.0 / r_obs)
        assert float(g) == pytest.approx(expect, rel=1e-10)


# ---------------------------------------------------------------------------
# camera look-at generalization
# ---------------------------------------------------------------------------

def test_pixel_grid_lookat_matches_reference_camera_on_axis():
    """For the reference's equatorial +x observer the look-at grid IS the
    reference grid (raytracing.py:60-88) — bit-for-bit basis agreement."""
    obs = jnp.array([30.0, 0.0, 0.0])
    a = pixel_grid(obs, jnp.radians(80.0), 7, 5, dtype=jnp.float64)
    b = pixel_grid_lookat(obs, jnp.radians(80.0), 7, 5, dtype=jnp.float64)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-13)


def test_pixel_grid_lookat_inclined_geometry():
    """Inclined camera: optical axis through the origin, frame orthonormal,
    up-reference keeps +z 'up' in the image."""
    obs = jnp.array([25.0, 0.0, 8.0])
    g = pixel_grid_lookat(obs, jnp.radians(60.0), 9, 9, dtype=jnp.float64)
    center = np.asarray(g[4, 4])
    d = np.linalg.norm(np.asarray(obs))
    # image-plane center sits on the obs -> origin line, 0.2 d from obs
    expect = np.asarray(obs) * (1.0 - 0.2)
    np.testing.assert_allclose(center, expect, atol=1e-12)
    # rows move along up, columns along right; both orthogonal to the axis
    axis = -np.asarray(obs) / d
    dr = np.asarray(g[4, 5] - g[4, 4])
    du = np.asarray(g[5, 4] - g[4, 4])
    assert abs(dr @ axis) < 1e-12 and abs(du @ axis) < 1e-12
    assert abs(dr @ du) < 1e-12
    assert du[2] > 0.0  # up keeps +z upward


# ---------------------------------------------------------------------------
# crossing capture
# ---------------------------------------------------------------------------

def _disk_batch(spin=0.9, elev_deg=12.0, size=12, steps=3000, delta=0.05):
    from grtrace.physics.camera import cartesian_ics_from_pixels
    from grtrace.physics.spacetime import METRICS
    params = jnp.array([1.0, spin, 0.0])
    e = np.deg2rad(elev_deg)
    obs = jnp.array([30.0 * np.cos(e), 0.0, 30.0 * np.sin(e)])
    pix = pixel_grid_lookat(obs, jnp.radians(60.0), size, size,
                            dtype=jnp.float64)
    q0, p0, _ = cartesian_ics_from_pixels(obs, pix, params=params,
                                          g_inv_fn=METRICS["KerrSchild"])
    q0 = q0.reshape(-1, 4)
    p0 = p0.reshape(-1, 4)
    r_in = float(orbits.isco_radius(1.0, spin))
    out = integrate_batch_disk(q0, p0, steps, delta, params, 31.0, 1.0,
                               r_in, 14.0)
    return q0, p0, out, r_in, params


def test_disk_crossing_on_plane_within_annulus():
    q0, p0, (fq, fp, status, ns, hq, hp), r_in, params = _disk_batch()
    hit = np.asarray(status) == STATUS_DISK
    assert hit.sum() > 5  # inclined camera sees the disk
    hq, hp = np.asarray(hq)[hit], np.asarray(hp)[hit]
    # crossing interpolated within one delta*|p| of the plane
    assert np.abs(hq[:, 3]).max() < 0.2
    from grtrace.physics.spacetime import ks_radius
    r = np.asarray(ks_radius(hq[:, 1], hq[:, 2], hq[:, 3], params[1]))
    assert (r >= r_in - 1e-9).all() and (r <= 14.0 + 1e-9).all()


def test_disk_hit_conserves_killing_charges():
    """E = -p_t and L_z = x p_y - y p_x at the interpolated crossing match
    the camera values to the scheme's copy-divergence scale (the FANTASY
    mixing rotation exchanges p_t/p_phi between the phase-space copies, so
    the Killing charges of copy 1 wobble at O(copy split) ~ 1e-3 at
    delta = 0.05 without secular drift — they are NOT exactly conserved
    per copy, unlike the continuum geodesic)."""
    q0, p0, (fq, fp, status, ns, hq, hp), r_in, params = _disk_batch()
    hit = np.asarray(status) == STATUS_DISK
    q0h, p0h = np.asarray(q0)[hit], np.asarray(p0)[hit]
    hqh, hph = np.asarray(hq)[hit], np.asarray(hp)[hit]
    e0 = -p0h[:, 0]
    e1 = -hph[:, 0]
    l0 = q0h[:, 1] * p0h[:, 2] - q0h[:, 2] * p0h[:, 1]
    l1 = hqh[:, 1] * hph[:, 2] - hqh[:, 2] * hph[:, 1]
    np.testing.assert_allclose(e1, e0, rtol=2e-3)
    np.testing.assert_allclose(l1, l0, atol=2e-3 * np.abs(l0).max())


def test_disk_statuses_match_generic_engine_for_missers():
    """Rays that never touch the annulus classify exactly as the plain
    generic engine classifies them (the detector is pure observation)."""
    from grtrace.engine.integrate_generic import integrate_batch_generic
    q0, p0, (fq, fp, status, ns, hq, hp), r_in, params = _disk_batch()
    fq_g, fp_g, st_g, ns_g = integrate_batch_generic(
        q0, p0, 3000, 0.05, params, 31.0, 1.0, metric="KerrSchild")
    miss = np.asarray(status) != STATUS_DISK
    assert (np.asarray(status)[miss] == np.asarray(st_g)[miss]).all()
    assert (np.asarray(ns)[miss] == np.asarray(ns_g)[miss]).all()
    # escaped finals: tolerance for XLA fusion-order noise between the two
    # separately-compiled programs (captured plungers amplify it chaotically)
    esc = miss & (np.asarray(status) == 2)
    assert esc.any()
    np.testing.assert_allclose(np.asarray(fq)[esc], np.asarray(fq_g)[esc],
                               atol=1e-8)


def test_disk_zero_steps_noop():
    """steps == 0 through the crossing-monitor path: inputs come back
    bit-for-bit, nobody hits the disk, nobody took a step."""
    q0, p0, _, r_in, params = _disk_batch(size=4, steps=1)
    fq, fp, st, ns, hq, hp = integrate_batch_disk(
        q0, p0, 0, 0.05, params, 31.0, 1.0, r_in, 14.0)
    np.testing.assert_array_equal(np.asarray(fq), np.asarray(q0))
    assert not (np.asarray(st) == STATUS_DISK).any()
    assert (np.asarray(ns) == 0).all()


def test_disk_render_ignores_schwarzschild_backend():
    """Disk frames always take the crossing-monitor XLA path: asking for
    the Schwarzschild GPU kernel changes nothing (and needs no GPU)."""
    def run(backend):
        scene = SceneConfig(size=12, metric="kerr", spin=0.9, n_samples=0,
                            integrator=IntegratorConfig(
                                steps=600, delta=0.08, dtype="float64",
                                backend=backend))
        return render_disk(scene, DiskConfig())
    a, b = run("xla"), run("pallas")
    assert a.counts == b.counts
    np.testing.assert_array_equal(a.image, b.image)


# ---------------------------------------------------------------------------
# full render
# ---------------------------------------------------------------------------

def test_render_disk_end_to_end():
    scene = SceneConfig(size=48, metric="kerr", spin=0.9, n_samples=0,
                        integrator=IntegratorConfig(steps=2500, delta=0.06,
                                                    dtype="float64"))
    bg = np.full((32, 32, 3), 120, np.uint8)
    res = render_disk(scene, DiskConfig(), bg_array=bg)
    assert res.counts["disk"] > 20
    assert res.counts["numerical_error"] == 0
    assert res.counts["captured"] > 0
    assert res.image.dtype == np.uint8 and res.image.shape == (48, 48, 3)
    # disk pixels are shaded (not background, not black)
    dm = res.cls == 5
    assert (res.image[dm].sum(axis=-1) > 0).mean() > 0.5
    g = np.asarray(res.device("redshift"))[dm]
    # Doppler boost beats gravitational redshift somewhere on the
    # approaching limb; the inner receding side is strongly redshifted
    assert g.max() > 1.0 and g.min() < 0.7


def test_disk_cli_writes_redshift_maps(tmp_path):
    """--disk through the main CLI writes the science products:
    redshift_map.csv (sparse disk pixels: i, j, g, r_em) + .png."""
    from grtrace.cli.main import main

    out = str(tmp_path / "disk_out")
    main(["--size", "24", "--metric", "kerr", "--spin", "0.9", "--disk",
          "--steps", "1500", "--delta", "0.06", "--out-dir", out,
          "--no-plots", "--no-flat", "--n-samples", "0"])
    import os
    csv = os.path.join(out, "redshift_map.csv")
    assert os.path.exists(csv)
    assert os.path.exists(os.path.join(out, "redshift_map.png"))
    rows = np.loadtxt(csv, delimiter=",", skiprows=1, ndmin=2)
    assert rows.shape[0] > 5 and rows.shape[1] == 4
    g, r_em = rows[:, 2], rows[:, 3]
    assert (g > 0).all() and (r_em > 2.0).all() and (r_em < 14.5).all()
    # relativistic line profile: normalized flux histogram over g
    prof = np.loadtxt(os.path.join(out, "line_profile.csv"),
                      delimiter=",", skiprows=1, ndmin=2)
    assert prof.shape[1] == 2 and prof[:, 1].max() == pytest.approx(1.0)
    assert os.path.exists(os.path.join(out, "line_profile.png"))


def test_render_disk_polar_camera_redshift_closed_form():
    """Face-on Schwarzschild disk: every disk pixel's g equals
    sqrt(1 - 3M/r_em)/sqrt(1 - 2M/r_obs) at its own measured r_em."""
    scene = SceneConfig(size=40, metric="kerr", spin=0.0, n_samples=0,
                        integrator=IntegratorConfig(steps=2500, delta=0.06,
                                                    dtype="float64"))
    res = render_disk(scene, DiskConfig(elevation_deg=89.9,
                                        show_background=False))
    dm = res.cls == 5
    assert dm.sum() > 50
    g = np.asarray(res.device("redshift"))[dm]
    hq = np.asarray(res.device("hit_q"))[dm]
    r_em = np.sqrt(hq[:, 1] ** 2 + hq[:, 2] ** 2 + hq[:, 3] ** 2)
    expect = np.sqrt(1.0 - 3.0 / r_em) / np.sqrt(1.0 - 2.0 / 30.0)
    np.testing.assert_allclose(g, expect, rtol=2e-3)


# ---------------------------------------------------------------------------
# Novikov-Thorne (Page-Thorne) profile
# ---------------------------------------------------------------------------

def test_page_thorne_flux_matches_kerr_closed_form():
    """The production quadrature (autodiff E, L, Omega + trapezoid on the
    tested metric) against the INDEPENDENT Page & Thorne 1974 eq. 15n
    closed form for Kerr — two derivations, one answer."""
    for a in (0.9, 0.5):
        params = jnp.array([1.0, a, 0.0])
        r0 = float(orbits.isco_radius(1.0, a))
        r = r0 * (1 + 1e-9) * (300.0 / r0) ** jnp.linspace(0.0, 1.0, 4096)
        flux = np.asarray(orbits.page_thorne_flux(r, params))
        r_np = np.asarray(r)
        x = np.sqrt(r_np)
        x0 = np.sqrt(r0)
        th = np.arccos(a)
        x1 = 2 * np.cos(th / 3 - np.pi / 3)
        x2 = 2 * np.cos(th / 3 + np.pi / 3)
        x3 = -2 * np.cos(th / 3)

        def coef(xi, xj, xk):
            return 3 * (xi - a) ** 2 / (xi * (xi - xj) * (xi - xk))

        f = (3 / (2 * x ** 2 * (x ** 3 - 3 * x + 2 * a))) * (
            x - x0 - 1.5 * a * np.log(x / x0)
            - coef(x1, x2, x3) * np.log((x - x1) / (x0 - x1))
            - coef(x2, x1, x3) * np.log((x - x2) / (x0 - x2))
            - coef(x3, x1, x2) * np.log((x - x3) / (x0 - x3)))
        closed = f / (4 * np.pi * r_np)
        sl = slice(64, None)  # skip the near-ISCO zero (relative tol blows)
        np.testing.assert_allclose(flux[sl], closed[sl], rtol=5e-5)


def test_page_thorne_flux_newtonian_limit_is_shakura_sunyaev():
    """As r -> inf the PT flux must approach the Newtonian Shakura-Sunyaev
    profile with the same inner edge — absolute normalization included
    (this pins the 4 pi sqrt(-g3) measure, which the closed-form
    comparison alone would not)."""
    params = jnp.array([1.0, 0.0, 0.0])
    r0 = 6.0 * (1 + 1e-9)
    r = r0 * (2e5 / r0) ** jnp.linspace(0.0, 1.0, 8192)
    flux = np.asarray(orbits.page_thorne_flux(r, params))
    r_np = np.asarray(r)
    f_ss = 3.0 / (8 * np.pi * r_np ** 3) * (1 - np.sqrt(6.0 / r_np))
    ratio = flux / np.where(f_ss > 0, f_ss, 1.0)
    i3 = np.argmin(np.abs(r_np - 1e3))
    i4 = np.argmin(np.abs(r_np - 1e4))
    assert abs(ratio[i4] - 1.0) < 0.02
    assert abs(ratio[i4] - 1.0) < abs(ratio[i3] - 1.0)  # converging
    # structural facts of the relativistic profile
    assert flux[0] == 0.0                              # zero torque at ISCO
    r_peak = r_np[np.argmax(flux)]
    assert 9.0 < r_peak < 10.0                         # NT peak ~ 9.55 M
    # vs the Newtonian peak at 49/36 * 6 = 8.17 M


def test_circular_e_lz_against_schwarzschild_closed_form():
    """E = (1 - 2M/r)/sqrt(1 - 3M/r), L = sqrt(M r)/sqrt(1 - 3M/r)."""
    params = jnp.array([1.0, 0.0, 0.0])
    for r in (4.0, 6.0, 12.0, 40.0):
        e, l = orbits.circular_e_lz(jnp.asarray(r, jnp.float64), params)
        assert float(e) == pytest.approx(
            (1 - 2 / r) / np.sqrt(1 - 3 / r), rel=1e-12)
        assert float(l) == pytest.approx(
            np.sqrt(r) / np.sqrt(1 - 3 / r), rel=1e-12)


def test_render_disk_novikov_profile():
    """profile='novikov' leaves the redshift physics untouched (bit-level
    same g map) but rescales the emission: the near-ISCO annulus goes
    dark (T -> 0 at the inner edge with zero slope under PT, much faster
    than SS's fourth-root vanish)."""
    scene = SceneConfig(size=40, metric="kerr", spin=0.0, n_samples=0,
                        integrator=IntegratorConfig(steps=2500, delta=0.06,
                                                    dtype="float64"))
    res_ss = render_disk(scene, DiskConfig(elevation_deg=89.9,
                                           show_background=False))
    res_nt = render_disk(scene, DiskConfig(elevation_deg=89.9,
                                           show_background=False,
                                           profile="novikov"))
    dm = res_ss.cls == 5
    assert (res_nt.cls == 5).sum() == dm.sum()
    np.testing.assert_allclose(np.asarray(res_nt.device("redshift"))[dm],
                               np.asarray(res_ss.device("redshift"))[dm],
                               rtol=1e-12)
    hq = np.asarray(res_ss.device("hit_q"))[dm]
    r_em = np.sqrt((hq[:, 1:] ** 2).sum(axis=-1))
    lum_ss = res_ss.image[dm].astype(np.float64).sum(axis=-1)
    lum_nt = res_nt.image[dm].astype(np.float64).sum(axis=-1)
    inner = r_em < 6.8
    assert inner.sum() > 3
    # the innermost ring is strictly dimmer under the relativistic profile
    assert lum_nt[inner].mean() < 0.7 * lum_ss[inner].mean()
    # but the peak region is comparably bright (both are peak-normalized)
    mid = (r_em > 8.0) & (r_em < 11.0)
    assert lum_nt[mid].mean() > 0.7 * lum_ss[mid].mean()


def test_disk_config_rejects_unknown_profile():
    with pytest.raises(ValueError):
        DiskConfig(profile="page")


def test_line_profile_emissivity_index(tmp_path):
    """The q knob reshapes the line profile: steeper emissivity weights
    the inner disk, where — at this near-edge-on inclination — Doppler
    beaming of the approaching limb (the g^4 blue horn) outweighs the
    gravitational red wing, pushing the flux centroid blueward."""
    from grtrace.engine.disk import save_disk_maps
    scene = SceneConfig(size=40, metric="kerr", spin=0.9, n_samples=0,
                        integrator=IntegratorConfig(steps=2500, delta=0.06,
                                                    dtype="float64"))
    res = render_disk(scene, DiskConfig(show_background=False))
    out3 = tmp_path / "q3"
    out5 = tmp_path / "q5"
    out3.mkdir()
    out5.mkdir()
    save_disk_maps(res, str(out3), emissivity_index=3.0, spin=0.9)
    save_disk_maps(res, str(out5), emissivity_index=5.0, spin=0.9)
    p3 = np.loadtxt(out3 / "line_profile.csv", delimiter=",", skiprows=1)
    p5 = np.loadtxt(out5 / "line_profile.csv", delimiter=",", skiprows=1)
    assert p3[:, 1].max() == pytest.approx(1.0)
    assert p5[:, 1].max() == pytest.approx(1.0)
    # the q=5 centroid sits blueward of the q=3 one (inner-disk beaming)
    c3 = (p3[:, 0] * p3[:, 1]).sum() / p3[:, 1].sum()
    c5 = (p5[:, 0] * p5[:, 1]).sum() / p5[:, 1].sum()
    assert c5 > c3 + 0.02
    # r_emission is the BL radius (ks_radius with the scene's spin):
    # it must respect the annulus; the Euclidean norm regression would
    # overshoot r_out by ~a^2/2r (14.029 at a = 0.9, r_out = 14)
    rows = np.loadtxt(out3 / "redshift_map.csv", delimiter=",",
                      skiprows=1)
    assert rows[:, 3].max() <= 14.0 + 1e-9
    assert rows[:, 3].min() >= float(orbits.isco_radius(1.0, 0.9,
                                                        True)) - 1e-9

def test_render_disk_retrograde():
    """A counter-rotating disk around a = 0.9: the inner edge moves out to
    the retrograde ISCO (~8.7 M) and the Doppler horns swap sides — the
    approaching limb (g > 1) flips to the opposite half of the image."""
    mk = lambda pro: render_disk(
        SceneConfig(size=40, metric="kerr", spin=0.9, n_samples=0,
                    integrator=IntegratorConfig(steps=2500, delta=0.06,
                                                dtype="float64")),
        DiskConfig(show_background=False, prograde=pro, r_out=16.0))
    res_p, res_r = mk(True), mk(False)
    from grtrace.physics.orbits import isco_radius
    r_isco_retro = float(isco_radius(1.0, 0.9, prograde=False))
    assert r_isco_retro == pytest.approx(8.717, abs=2e-3)
    dm_r = res_r.cls == 5
    assert dm_r.sum() > 10
    hq = np.asarray(res_r.device("hit_q"))[dm_r]
    r_em = np.sqrt((hq[:, 1:] ** 2).sum(axis=-1))
    assert r_em.min() >= r_isco_retro - 1e-6
    # horn swap: the column-mean blueshift flips side between the runs
    g_p = np.ma.masked_where(res_p.cls != 5,
                             np.asarray(res_p.device("redshift")))
    g_r = np.ma.masked_where(~dm_r, np.asarray(res_r.device("redshift")))
    left_p, right_p = g_p[:, :20].max(), g_p[:, 20:].max()
    left_r, right_r = g_r[:, :20].max(), g_r[:, 20:].max()
    assert (left_p - right_p) * (left_r - right_r) < 0  # opposite sides

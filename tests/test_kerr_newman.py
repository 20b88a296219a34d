"""Kerr-Newman / Reissner-Nordstrom support (charge slot of the generic
engines and the Kerr-Schild Pallas kernel).

Beyond-reference capability (the reference is Schwarzschild-only,
simulation/cuda_geodesic.py:432-447); the oracle here is closed-form
physics: the Reissner-Nordstrom photon sphere r_ph = (3M + sqrt(9M^2 -
8Q^2))/2 and critical impact parameter b_crit = r_ph / sqrt(f(r_ph)).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from grtrace.engine.integrate import STATUS_CAPTURED, STATUS_ESCAPED
from grtrace.engine.integrate_generic import integrate_batch_generic
from grtrace.engine.render import render
from grtrace.io.scene import IntegratorConfig, PatchConfig, SceneConfig
from grtrace.physics.spacetime import build_null_4momentum, kerr_g_inv

M = 1.0


def _rn_b_crit(qc):
    r_ph = 0.5 * (3.0 * M + np.sqrt(9.0 * M * M - 8.0 * qc * qc))
    f = 1.0 - 2.0 * M / r_ph + qc * qc / (r_ph * r_ph)
    return r_ph / np.sqrt(f)


def _rn_ray(b, qc, r0=30.0, ingoing=True):
    """Equatorial null ray at r0 with impact parameter b = L/E (E = 1 by
    construction: p_r = sqrt(1 - f b^2/r0^2)/f, L = b closes p_t^2 = 1)."""
    f = 1.0 - 2.0 * M / r0 + qc * qc / (r0 * r0)
    p_r = np.sqrt(max(1.0 - f * b * b / (r0 * r0), 0.0)) / f
    if ingoing:
        p_r = -p_r
    pos = jnp.array([r0, np.pi / 2, 0.0])
    p_sph = jnp.array([p_r, 0.0, b])
    params = jnp.array([M, 0.0, qc])
    p4 = build_null_4momentum(p_sph, pos, params, kerr_g_inv, future=True)
    q4 = jnp.concatenate([jnp.zeros((1,)), pos])
    return q4[None], p4[None], params


@pytest.mark.parametrize("qc", [0.0, 0.6, 0.9])
def test_rn_critical_impact_parameter(qc):
    """Rays 3% inside/outside the closed-form RN b_crit must be captured/
    escape (at qc = 0 this is the Schwarzschild 3 sqrt(3) M)."""
    b_crit = _rn_b_crit(qc)
    if qc == 0.0:
        np.testing.assert_allclose(b_crit, 3.0 * np.sqrt(3.0) * M,
                                   rtol=1e-12)
    for fac, want in ((0.97, STATUS_CAPTURED), (1.03, STATUS_ESCAPED)):
        q0, p0, params = _rn_ray(fac * b_crit, qc)
        _, _, status, _ = integrate_batch_generic(
            q0, p0, 60_000, 0.02, params, 31.0, 1.0, metric="Kerr")
        assert int(status[0]) == want, (qc, fac)


def test_rn_charge_shrinks_shadow():
    """b_crit decreases with Q, so the rendered shadow must shrink."""
    def scene(qc):
        return SceneConfig(
            size=24, fov_deg=80.0, observer_distance=30.0,
            boundary_radius=31.0, charge=qc,
            integrator=IntegratorConfig(steps=8000, delta=0.02, omega=1.0,
                                        backend="xla", dtype="float64"),
            patch=PatchConfig(), n_samples=0)

    r0 = render(scene(0.0))
    r9 = render(scene(0.9))
    assert r9.counts["captured"] < r0.counts["captured"]
    assert r9.counts["numerical_error"] == 0
    # charge != 0 with the default metric routes to the generic KS engine;
    # its a=0 captured set must still match the fast path's radius capture
    assert r0.counts["captured"] > 0


def test_kn_cross_chart_agreement():
    """Kerr-Newman shadow counts agree between the Boyer-Lindquist and
    Kerr-Schild charts (independent formulations of the same physics)."""
    def scene(metric):
        return SceneConfig(
            size=20, fov_deg=80.0, observer_distance=30.0,
            boundary_radius=31.0, metric=metric, spin=0.6, charge=0.5,
            integrator=IntegratorConfig(steps=8000, delta=0.02, omega=1.0,
                                        backend="xla", dtype="float64"),
            patch=PatchConfig(), n_samples=0)

    r_bl = render(scene("kerr-bl"))
    r_ks = render(scene("KerrSchild"))
    cap_bl = np.asarray(r_bl.cls) == 0
    cap_ks = np.asarray(r_ks.cls) == 0
    # identical up to edge pixels (different capture shells, 1.1 vs 1.05,
    # shave the shadow rim differently)
    assert np.abs(cap_bl.sum() - cap_ks.sum()) <= 3
    assert (cap_bl & cap_ks).sum() >= min(cap_bl.sum(), cap_ks.sum()) - 1


def test_ksc_kerr_newman_matches_generic():
    """The compensated KS integrator's charge slot == XLA generic."""
    from grtrace.engine.integrate_ks import integrate_batch_ksc
    from grtrace.physics.camera import camera_rays_cartesian
    from grtrace.physics.spacetime import METRICS

    params = jnp.array([M, 0.7, 0.5])
    q0, p0, _ = camera_rays_cartesian(
        jnp.array([30.0, 0.0, 0.0]), jnp.radians(80.0), 10, 10,
        params=params, g_inv_fn=METRICS["KerrSchild"], dtype=jnp.float64)
    q0, p0 = q0.reshape(-1, 4), p0.reshape(-1, 4)

    fq_x, _, st_x, ns_x = integrate_batch_generic(
        q0, p0, 1200, 0.05, params, 31.0, 1.0, metric="KerrSchild")
    fq_p, _, st_p, ns_p = integrate_batch_ksc(
        q0, p0, 1200, 0.05, params, 31.0, 1.0)
    assert (np.asarray(st_x) == np.asarray(st_p)).all()
    # exit steps exact except captured plungers, where the staggered
    # composition can move the blow-up guard trip by +-1 step (chaotic
    # amplification of last-ulp rounding; see test_pallas_ks)
    ns_x, ns_p = np.asarray(ns_x), np.asarray(ns_p)
    cap = np.asarray(st_x) == 1
    assert (ns_x[~cap] == ns_p[~cap]).all()
    assert np.abs(ns_x[cap] - ns_p[cap]).max() <= 2
    esc = np.asarray(st_x) == STATUS_ESCAPED
    np.testing.assert_allclose(np.asarray(fq_x)[esc], np.asarray(fq_p)[esc],
                               atol=1e-8)


def test_compat_nulllike_kerr_newman():
    """Nulllike(metric='KerrNewman', metric_params=(a, Q)): EinsteinPy's
    exact signature; Q = 0 must coincide with metric='Kerr'."""
    from grtrace.compat.einsteinpy import Nulllike

    kn = Nulllike(metric="KerrNewman", metric_params=(0.5, 0.4),
                  position=(8.0, np.pi / 2, 0.0), momentum=(0.0, 0.0, 3.0),
                  steps=400, delta=0.01, omega=1.0)
    _, data = kn.trajectory
    assert data.shape == (400, 8)
    assert np.isfinite(data).all()

    k0 = Nulllike(metric="Kerr", metric_params=(0.5,),
                  position=(8.0, np.pi / 2, 0.0), momentum=(0.0, 0.0, 3.0),
                  steps=100, delta=0.01, omega=1.0)
    kn0 = Nulllike(metric="KerrNewman", metric_params=(0.5, 0.0),
                   position=(8.0, np.pi / 2, 0.0), momentum=(0.0, 0.0, 3.0),
                   steps=100, delta=0.01, omega=1.0)
    np.testing.assert_allclose(k0.trajectory[1], kn0.trajectory[1],
                               rtol=0, atol=1e-13)


def test_cli_charge():
    from grtrace.cli.args import parse_args, scene_from_args

    sc = scene_from_args(parse_args(["--charge", "0.6"]))
    assert sc.charge == 0.6 and sc.metric == "Schwarzschild"
    sc = scene_from_args(parse_args(
        ["--metric", "kerr", "--spin", "0.5", "--charge", "0.5"]))
    assert sc.spin == 0.5 and sc.charge == 0.5
    with pytest.raises(SystemExit):
        scene_from_args(parse_args(
            ["--metric", "kerr", "--spin", "0.8", "--charge", "0.8"]))

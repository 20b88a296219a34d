"""Derivative-free Kerr oracle vs both JAX gradient derivations.

grtrace ships two Kerr gradient derivations — jax.grad of the chart
Hamiltonian (physics.spacetime) and hand-derived closed forms
(physics.kerr_schild) — pinned against each other.  oracle.kerr_fd removes
the derivation entirely (central finite differences of the scalar
Hamiltonian in plain NumPy), so three-way agreement validates the gradient
algebra itself.  Comparisons run on weak-field arcs (periapsis > 8) where
finite precision is not chaotically amplified.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from grtrace.engine.integrate_generic import integrate_batch_generic
from grtrace.oracle import kerr_fd
from grtrace.physics.camera import camera_rays_cartesian
from grtrace.physics.spacetime import METRICS

STEPS, DELTA, OMEGA = 400, 0.05, 1.0
R_MAX = 1e9  # nobody escapes: equal budgets everywhere


def _weak_rays(spin, charge, n=4):
    """Edge-of-image camera rays: impact parameters ~17-19 M, periapsis
    far outside the photon shell."""
    params = jnp.array([1.0, spin, charge])
    q0, p0, _ = camera_rays_cartesian(
        jnp.array([30.0, 0.0, 0.0]), jnp.radians(60.0), 8, 8,
        params=params, g_inv_fn=METRICS["KerrSchild"], dtype=jnp.float64)
    q0 = np.asarray(q0).reshape(-1, 4)
    p0 = np.asarray(p0).reshape(-1, 4)
    # corner pixels have the largest angle off axis
    idx = [0, 7, 56, 63][:n]
    return q0[idx], p0[idx], params


@pytest.mark.parametrize("spin,charge", [(0.9, 0.0), (0.6, 0.5)])
def test_generic_engine_matches_fd_oracle(spin, charge):
    q0, p0, params = _weak_rays(spin, charge)
    fq, fp, st, ns = integrate_batch_generic(
        jnp.asarray(q0), jnp.asarray(p0), STEPS, DELTA, params, R_MAX,
        OMEGA, metric="KerrSchild")
    for k in range(q0.shape[0]):
        oq, op, on, bad = kerr_fd.integrate(q0[k], p0[k], STEPS, DELTA,
                                            1.0, spin, charge, R_MAX, OMEGA)
        assert not bad
        assert on == int(ns[k]) == STEPS
        np.testing.assert_allclose(np.asarray(fq)[k], oq, rtol=0, atol=1e-7)
        np.testing.assert_allclose(np.asarray(fp)[k], op, rtol=0, atol=1e-7)


def test_ksc_f32_matches_fd_oracle():
    """The compensated float32 flows against the derivative-free NumPy
    oracle: agreement bounded by the FD oracle's own differencing error
    (~1e-7), i.e. the f32 compensated path is as close to the float64
    truth as an independent float64 implementation can verify."""
    from grtrace.engine.integrate_ks import integrate_batch_ksc
    spin, charge = 0.9, 0.3
    q0, p0, params = _weak_rays(spin, charge)
    f32 = jnp.float32
    fq, fp, st, ns = integrate_batch_ksc(
        jnp.asarray(q0, f32), jnp.asarray(p0, f32), STEPS, f32(DELTA),
        jnp.asarray(params, f32), f32(R_MAX), f32(OMEGA))
    for k in range(q0.shape[0]):
        oq, op, on, bad = kerr_fd.integrate(q0[k], p0[k], STEPS, DELTA,
                                            1.0, spin, charge, R_MAX, OMEGA)
        assert not bad
        assert on == int(ns[k]) == STEPS
        np.testing.assert_allclose(np.asarray(fq)[k], oq, rtol=0, atol=2e-6)
        np.testing.assert_allclose(np.asarray(fp)[k], op, rtol=0, atol=2e-6)


def test_ksc_f64_matches_fd_oracle():
    """The compensated hand-derived flows in float64 against the
    derivative-free NumPy oracle, to the oracle's own differencing error."""
    from grtrace.engine.integrate_ks import integrate_batch_ksc
    spin, charge = 0.9, 0.0
    q0, p0, params = _weak_rays(spin, charge)
    fq, fp, st, ns = integrate_batch_ksc(
        jnp.asarray(q0), jnp.asarray(p0), STEPS, DELTA, params, R_MAX,
        OMEGA)
    for k in range(q0.shape[0]):
        oq, op, on, bad = kerr_fd.integrate(q0[k], p0[k], STEPS, DELTA,
                                            1.0, spin, charge, R_MAX, OMEGA)
        assert not bad
        assert on == int(ns[k]) == STEPS
        np.testing.assert_allclose(np.asarray(fq)[k], oq, rtol=0, atol=1e-7)
        np.testing.assert_allclose(np.asarray(fp)[k], op, rtol=0, atol=1e-7)


def test_fd_oracle_capture_semantics():
    """A central (b ~ 0) ray plunges: the oracle must stop on the
    null-invariant violation at the horizon, and the engine must park the
    same ray as captured."""
    spin = 0.9
    params = jnp.array([1.0, spin, 0.0])
    q0, p0, _ = camera_rays_cartesian(
        jnp.array([30.0, 0.0, 0.0]), jnp.radians(60.0), 3, 3,
        params=params, g_inv_fn=METRICS["KerrSchild"], dtype=jnp.float64)
    q0 = np.asarray(q0).reshape(-1, 4)[4]   # center pixel
    p0 = np.asarray(p0).reshape(-1, 4)[4]
    oq, op, on, bad = kerr_fd.integrate(q0, p0, 30_000, 0.02, 1.0, spin,
                                        0.0, 31.0, OMEGA)
    # a backward-traced plunger blueshifts on the past horizon until the
    # fixed step under-resolves the kick: the oracle must stop on the
    # invariant violation well before the budget, at a last resolved
    # state deep inside the plunge region
    assert bad and on < 30_000
    r_end = kerr_fd.ks_radius(oq[1], oq[2], oq[3], spin)
    assert r_end < 3.0
    fq, fp, st, ns = integrate_batch_generic(
        jnp.asarray(q0)[None], jnp.asarray(p0)[None], 30_000, 0.02, params,
        31.0, OMEGA, metric="KerrSchild")
    assert int(st[0]) == 1  # the engine parks the same failure as captured

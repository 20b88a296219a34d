"""Float32 production-path accuracy at the HEADLINE budget (400x400, 200k
steps, delta 0.01) against the committed float64-oracle golden.

The north-star target (BASELINE.md) is escape directions within 1e-5 of the
CPU float64 reference.  The golden file tests/golden/oracle_escape_headline.npz
(generated by tools/gen_oracle_golden.py) holds the oracle's final states for
186 probe pixels stratified over the real 400x400 camera grid, excluding the
chaotic near-photon-sphere band (min r < 3.5) where no two finite-precision
implementations can agree.

These tests exercise the EXACT compensated step functions the Pallas GPU
kernel compiles (physics.hamiltonian.staggered_eqc) via its XLA twin at the
full 200k budget (interpret-mode Pallas at 200k steps is infeasible on CPU);
chip_smoke.py re-measures the production path on the GPU against the same
golden.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest

from grtrace.engine.integrate import (STATUS_ESCAPED, integrate_batch,
                                      integrate_batch_compensated)
from grtrace.engine.integrate_pallas import integrate_batch_pallas
from grtrace.physics.camera import camera_rays

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "oracle_escape_headline.npz")


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def probe_ics_f32(golden):
    """Production-identical float32 camera ICs for the probe pixels."""
    g = golden
    q0, p0, a0, hd, beta = camera_rays(
        np.array([float(g["obs_x"]), 0.0, 0.0], np.float32),
        np.float32(g["fov"]), int(g["size"]), int(g["size"]),
        mass_bh=float(g["mass"]), dtype=jnp.float32)
    idx = g["flat_idx"]
    return (np.asarray(q0).reshape(-1, 4)[idx],
            np.asarray(p0).reshape(-1, 4)[idx])


def _escape_errors(fq, ns, golden):
    oq = golden["final_q"]
    dth = np.abs(fq[:, 2] - oq[:, 2])
    dph = np.abs((fq[:, 3] - oq[:, 3] + np.pi) % (2 * np.pi) - np.pi)
    dstep = np.asarray(ns) - golden["n_steps"]
    return dth, dph, dstep


def test_compensated_f32_meets_1e5_at_headline_budget(golden, probe_ics_f32):
    """The compensated float32 step (the production kernel's math) hits
    the 1e-5 escape-direction target at the full 200k-step budget — this
    test pins the bound for the shared step function through XLA on the
    CPU; chip_smoke.py asserts it for the GPU kernel."""
    g = golden
    q0, p0 = probe_ics_f32
    fq, fp, st, ns = integrate_batch_compensated(
        jnp.asarray(q0, jnp.float32), jnp.asarray(p0, jnp.float32),
        int(g["steps"]), float(g["delta"]), 2.0 * float(g["mass"]),
        float(g["rmax"]), float(g["omega"]))
    fq = np.asarray(fq)
    assert (np.asarray(st) == STATUS_ESCAPED).all()
    dth, dph, dstep = _escape_errors(fq, ns, g)
    assert (dstep == 0).all(), f"exit-step flips: {np.abs(dstep).max()}"
    assert dph.max() < 1e-5, f"max dphi {dph.max():.2e}"
    assert dth.max() < 1e-6
    # the bound is not just barely met — median is ~50x inside it
    assert np.median(dph) < 2e-6


def test_plain_f32_documented_tail(golden, probe_ics_f32):
    """Documents WHY compensation is the default: the plain float32 path's
    escape error has a tail well above 1e-5 at this budget (~2e-4, from
    exit-step quantization + sqrt(n) accumulation drift).  If this
    test ever fails because plain f32 got BETTER than 1e-5, compensation can
    be retired — that's a feature, not a bug."""
    g = golden
    q0, p0 = probe_ics_f32
    fq, fp, st, ns = integrate_batch(
        jnp.asarray(q0, jnp.float32), jnp.asarray(p0, jnp.float32),
        int(g["steps"]), float(g["delta"]), 2.0 * float(g["mass"]),
        float(g["rmax"]), float(g["omega"]))
    dth, dph, dstep = _escape_errors(np.asarray(fq), ns, g)
    assert dph.max() > 1e-5  # plain f32 misses the target...
    assert dph.max() < 1e-2  # ...but is still visually fine (pixel ~1.6e-2)


def test_pallas_compensated_matches_xla_twin(golden, probe_ics_f32):
    """The compensated Pallas kernel (interpret mode) and its XLA twin run
    the same step function — results must agree to float32 roundoff over a
    short budget.  Parity of the compiled kernel is asserted on the GPU by
    chip_smoke.py and tests/test_gpu_kernel.py."""
    g = golden
    q0, p0 = probe_ics_f32
    q0 = jnp.asarray(q0[:24], jnp.float32)
    p0 = jnp.asarray(p0[:24], jnp.float32)
    steps = 512  # multiple of UNROLL: no static-remainder compile blowup
    args = (steps, float(g["delta"]), 2.0 * float(g["mass"]),
            float(g["rmax"]), float(g["omega"]))
    fq_x, fp_x, st_x, ns_x = integrate_batch_compensated(q0, p0, *args)
    fq_p, fp_p, st_p, ns_p = integrate_batch_pallas(
        q0, p0, *args, interpret=True, equatorial=True, compensated=True)
    np.testing.assert_array_equal(np.asarray(ns_x), np.asarray(ns_p))
    np.testing.assert_allclose(np.asarray(fq_p), np.asarray(fq_x),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(fp_p), np.asarray(fp_x),
                               rtol=0, atol=1e-6)


def test_compensated_f64_matches_plain_f64():
    """In float64 the compensated step must agree with the plain step to
    tight tolerance on weak-field arcs — compensation changes rounding, not
    physics.  Rays are built directly as weak-field planar ICs (impact
    parameter b in ~[9, 14], periapsis > 8): near the photon sphere ANY
    last-ulp rounding change is chaotically amplified, so agreement is only
    a meaningful invariant outside that band."""
    from grtrace.physics.camera import angles_to_p_sph
    from grtrace.physics.nullcond import null_p_t

    r0 = 30.0
    alpha = np.linspace(0.3, 0.5, 16)
    p_sp = np.asarray(angles_to_p_sph(jnp.asarray(alpha, jnp.float64), 0.0,
                                      r0, mass_bh=1.0))
    p_t = np.asarray(null_p_t(jnp.asarray(p_sp), r0, np.pi / 2,
                              mass_bh=1.0, future=True))
    q0 = jnp.asarray(np.tile([0.0, r0, np.pi / 2, 0.0], (16, 1)))
    p0 = jnp.asarray(np.concatenate([p_t[:, None], p_sp], axis=-1))
    args = (4000, 0.05, 2.0, 31.0, 1.0)
    fq_c, _, st_c, ns_c = integrate_batch_compensated(q0, p0, *args)
    fq_p, _, st_p, ns_p = integrate_batch(q0, p0, *args)
    np.testing.assert_array_equal(np.asarray(st_c), np.asarray(st_p))
    np.testing.assert_allclose(np.asarray(fq_c), np.asarray(fq_p),
                               rtol=1e-12, atol=1e-12)

"""Pallas GPU kernel (interpret mode on CPU) vs the XLA backend.

On the GPU the same kernel compiles through Triton; interpret mode checks
that the layout/padding/masking/early-exit logic is equivalent to the XLA
reference backend.  The wrapper's choices (backend resolution, refusal
without a GPU, compensated dispatch) are pinned here too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from grtrace.engine import integrate as integ
from grtrace.engine.integrate import integrate_batch
from grtrace.engine.integrate_pallas import BLOCK, integrate_batch_pallas
from grtrace.physics.camera import camera_rays

ARGS = (2000, 0.05, 2.0, 31.0, 1.0)


def _ics(n, fov=80.0):
    q0, p0, *_ = camera_rays(np.array([30.0, 0.0, 0.0]), np.radians(fov),
                             n, n, dtype=jnp.float64)
    return (jnp.asarray(q0).reshape(-1, 4), jnp.asarray(p0).reshape(-1, 4))


def test_matches_xla_backend():
    q0, p0 = _ics(16)
    fq1, fp1, st1, ns1 = integrate_batch(q0, p0, *ARGS)
    fq2, fp2, st2, ns2 = integrate_batch_pallas(q0, p0, *ARGS,
                                                interpret=True)
    assert bool((st1 == st2).all())
    assert bool((ns1 == ns2).all())
    # identical math modulo mixing-rotation cos/sin evaluation; rays that
    # dip into the strong field chaotically amplify that last-ulp noise
    d = np.abs(np.asarray(fq1) - np.asarray(fq2)).max(axis=1)
    rfin = np.asarray(fq1)[:, 1]
    weak = rfin > 3.0
    assert d[weak].max() < 1e-8


def test_padding_rays_inert():
    """Non-multiple-of-TILE batches pad with parked rays that must not
    affect outputs or step counts."""
    q0, p0 = _ics(5)  # 25 rays << TILE
    assert q0.shape[0] < BLOCK
    fq, fp, st, ns = integrate_batch_pallas(q0, p0, *ARGS, interpret=True)
    assert fq.shape == (25, 4)
    assert ns.shape == (25,)
    fq_x, _, st_x, ns_x = integrate_batch(q0, p0, *ARGS)
    assert bool((st == st_x).all())
    assert bool((ns == ns_x).all())


def test_multi_tile():
    q0, p0 = _ics(40)  # 1600 rays -> 2 tiles
    fq, _, st, ns = integrate_batch_pallas(q0, p0, *ARGS, interpret=True)
    _, _, st_x, ns_x = integrate_batch(q0, p0, *ARGS)
    assert bool((st == st_x).all())
    assert bool((ns == ns_x).all())


def test_equatorial_kernel_matches_generic():
    """The trig-free 12-row kernel must track the generic one for
    equatorial rays (which all camera rays are)."""
    q0, p0 = _ics(16)
    fq1, fp1, st1, ns1 = integrate_batch_pallas(q0, p0, *ARGS,
                                                interpret=True)
    fq2, fp2, st2, ns2 = integrate_batch_pallas(q0, p0, *ARGS,
                                                interpret=True,
                                                equatorial=True)
    assert bool((st1 == st2).all())
    # theta slots are exactly preserved
    np.testing.assert_array_equal(np.asarray(fq2)[:, 2],
                                  np.asarray(q0)[:, 2])
    np.testing.assert_array_equal(np.asarray(fp2)[:, 2], 0.0)
    # weak-field agreement (float64 here, so only roundoff-level diff)
    d = np.abs(np.asarray(fq1) - np.asarray(fq2)).max(axis=1)
    weak = np.asarray(fq1)[:, 1] > 3.0
    assert d[weak].max() < 1e-8


def test_equatorial_sorting_unsorts_correctly():
    """sort_rays must return outputs in the caller's ray order."""
    q0, p0 = _ics(10)
    a = integrate_batch_pallas(q0, p0, *ARGS, interpret=True,
                               sort_rays=True)
    b = integrate_batch_pallas(q0, p0, *ARGS, interpret=True,
                               sort_rays=False)
    assert bool((a[2] == b[2]).all())
    assert bool((a[3] == b[3]).all())
    np.testing.assert_allclose(np.asarray(a[0]), np.asarray(b[0]),
                               rtol=0, atol=0)


def test_step_budget_exact():
    """With a budget that is not a multiple of UNROLL, the remainder steps
    must still be applied (reference semantics: exactly `steps` sweeps)."""
    q0, p0 = _ics(4)
    steps = 1003  # 1003 % UNROLL(4) == 3
    fq, _, _, ns = integrate_batch_pallas(q0, p0, steps, 0.05, 2.0, 1e6,
                                          1.0, interpret=True)
    _, _, _, ns_x = integrate_batch(q0, p0, steps, 0.05, 2.0, 1e6, 1.0)
    # r_max=1e6: nothing escapes, every ray runs the full budget
    assert int(np.asarray(ns).max()) == steps
    assert bool((ns == ns_x).all())


def test_unroll_invariance():
    """Unroll only changes the early-exit check cadence, never the per-ray
    masked-step sequence — this is what licenses engine.validate's
    small-unroll probe kernels.  The exact contract (measured, x64 env):

      * status and n_steps are invariant at ANY unroll (classification is
        all the boundary-bisection probes consume);
      * at a DIVISOR unroll (steps %% unroll == 0) the plain layout is
        byte-identical;
      * at a non-divisor unroll the remainder steps compile in a different
        fusion context — ulp-level state noise, nothing more.
    """
    q0, p0 = _ics(12)  # mixed fates: escapes, captures, budget survivors
    base = integrate_batch_pallas(q0, p0, 1000, 0.05, 2.0, 31.0, 1.0,
                                  interpret=True, unroll=1)
    # divisor unroll: byte-identical
    out = integrate_batch_pallas(q0, p0, 1000, 0.05, 2.0, 31.0, 1.0,
                                 interpret=True, unroll=8)
    for a, b in zip(base, out):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # non-divisor unroll: classification invariant, state to ulp noise
    out = integrate_batch_pallas(q0, p0, 1000, 0.05, 2.0, 31.0, 1.0,
                                 interpret=True, unroll=3)
    assert bool((base[2] == out[2]).all())
    assert bool((base[3] == out[3]).all())
    assert np.abs(np.asarray(base[0]) - np.asarray(out[0])).max() < 1e-12


def test_unroll_invariance_compensated_equatorial():
    """Production (Kahan f32 staggered) layout: status and n_steps are
    exactly unroll-invariant.  Positions are NOT pinned byte-exact here:
    different unrolled bodies fuse the Kahan ops differently and chaotic
    near-capture rays amplify that compile-level ulp noise to ~1e-3
    (same class of effect the kernel-vs-XLA parity budgets already
    cover); the validate probes only read statuses."""
    q0, p0 = _ics(12)
    q0 = q0.astype(jnp.float32)
    p0 = p0.astype(jnp.float32)
    kw = dict(equatorial=True, compensated=True, interpret=True)
    base = integrate_batch_pallas(q0, p0, 1000, 0.05, 2.0, 31.0, 1.0,
                                  unroll=1, **kw)
    out = integrate_batch_pallas(q0, p0, 1000, 0.05, 2.0, 31.0, 1.0,
                                 unroll=8, **kw)
    assert bool((base[2] == out[2]).all())
    assert bool((base[3] == out[3]).all())


def test_padding_one_past_block():
    """N = BLOCK + 1: two programs, the second holding one real ray and
    BLOCK - 1 parked padding rays; outputs are unpadded to N and match
    the XLA backend ray for ray."""
    q0, p0 = _ics(12)  # 144 rays
    q0, p0 = q0[:BLOCK + 1], p0[:BLOCK + 1]
    fq, fp, st, ns = integrate_batch_pallas(q0, p0, *ARGS, interpret=True)
    assert fq.shape == (BLOCK + 1, 4) and ns.shape == (BLOCK + 1,)
    _, _, st_x, ns_x = integrate_batch(q0, p0, *ARGS)
    assert bool((st == st_x).all())
    assert bool((ns == ns_x).all())


def test_resolve_backend_choice(monkeypatch):
    """'auto' picks the kernel on a GPU and the XLA path elsewhere; an
    explicit choice is kept; anything else is refused."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert integ.resolve_backend("auto") == "pallas"
    assert integ.resolve_backend("xla") == "xla"
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert integ.resolve_backend("auto") == "xla"
    assert integ.resolve_backend("pallas") == "pallas"
    with pytest.raises(ValueError):
        integ.resolve_backend("cuda")


def test_explicit_kernel_without_gpu_raises():
    """backend='pallas' on a machine with no GPU fails loudly: no
    fallback to interpret mode or to the XLA path."""
    q0, p0 = _ics(4)
    with pytest.raises(RuntimeError, match="needs a GPU"):
        integ.integrate_dispatch(q0, p0, *ARGS, backend="pallas",
                                 equatorial=True)


def test_dispatch_f32_equatorial_is_compensated():
    """Off the GPU the production float32 path is still the compensated
    integrator (the kernel's XLA twin), never the plain f32 step whose
    escape-direction tail misses the 1e-5 contract."""
    q0, p0 = _ics(6)
    q0, p0 = q0.astype(jnp.float32), p0.astype(jnp.float32)
    out = integ.integrate_dispatch(q0, p0, *ARGS, backend="auto",
                                   equatorial=True)
    ref = integ.integrate_batch_compensated(q0, p0, *ARGS)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

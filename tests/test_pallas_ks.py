"""Kerr-Schild integrators: hand-derived flows, the compensated
integrate_batch_ksc and the chart router.

The compensated integrator must reproduce the generic autodiff engine's
statuses, step counts and finals on float64, where op-reordering noise
cannot be chaotically amplified; in float32 it must beat the plain flows
against the float64 truth.  The analytic flows themselves are pinned to
the autodiff flows at roundoff.
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from grtrace.engine.integrate_generic import integrate_batch_generic
from grtrace.engine.integrate_ks import integrate_batch_ksc
from grtrace.physics.camera import camera_rays_cartesian
from grtrace.physics.spacetime import METRICS, kerr_schild_g_inv, make_step
from grtrace.physics.kerr_schild import (fantasy_step_ord2_ks,
                                         hamiltonian_ks)
from grtrace.physics.spacetime import hamiltonian as spacetime_hamiltonian

SPIN = 0.9
PARAMS = jnp.array([1.0, SPIN])


def _camera_batch(size=12, dist=30.0, params=PARAMS):
    q0, p0, _ = camera_rays_cartesian(
        jnp.array([dist, 0.0, 0.0]), jnp.radians(80.0), size, size,
        params=params, g_inv_fn=METRICS["KerrSchild"], dtype=jnp.float64)
    return q0.reshape(-1, 4), p0.reshape(-1, 4)


def test_kerr_schild_flows_match_autodiff():
    """Hand-derived KS flows == jax.grad flows to float64 roundoff."""
    rng = np.random.default_rng(0)
    n = 64
    pos = rng.normal(size=(n, 3))
    pos = pos / np.linalg.norm(pos, axis=1, keepdims=True) \
        * rng.uniform(3, 25, (n, 1))
    q = np.zeros((n, 4))
    q[:, 1:] = pos
    p = rng.normal(size=(n, 4))
    q, p = jnp.asarray(q), jnp.asarray(p)

    delta, omega = 0.01, 1.0
    cw = jnp.cos(2 * omega * delta)
    sw = jnp.sin(2 * omega * delta)
    step_auto = make_step(kerr_schild_g_inv)
    subs = ((jnp.float64(delta), cw, sw),)
    qa, pa, _, _ = jax.vmap(
        lambda q1, p1, q2, p2: step_auto(q1, p1, q2, p2, PARAMS, subs)
    )(q, p, q, p)

    comps = tuple([q[:, i] for i in range(4)]
                  + [p[:, i] for i in range(4)]) * 2
    out = fantasy_step_ord2_ks(comps, delta, 1.0, SPIN, cw, sw)
    qb = jnp.stack(out[0:4], -1)
    pb = jnp.stack(out[4:8], -1)
    np.testing.assert_allclose(np.asarray(qa), np.asarray(qb), atol=1e-13)
    np.testing.assert_allclose(np.asarray(pa), np.asarray(pb), atol=1e-13)

    h_auto = jax.vmap(lambda q1, p1: spacetime_hamiltonian(
        q1, p1, PARAMS, kerr_schild_g_inv))(q, p)
    h_an = hamiltonian_ks(q[:, 1], q[:, 2], q[:, 3], p[:, 0], p[:, 1],
                          p[:, 2], p[:, 3], 1.0, SPIN)
    np.testing.assert_allclose(np.asarray(h_auto), np.asarray(h_an),
                               atol=1e-12)


def _assert_matches_generic(fq_x, st_x, ns_x, fq_c, st_c, ns_c):
    """Statuses exact; exit steps exact except captured plungers, where
    the staggered composition can move the blow-up guard trip by a step or
    two (chaotic amplification of last-ulp rounding at the horizon, even
    in f64); escaped finals to f64 op-reordering noise."""
    assert (np.asarray(st_x) == np.asarray(st_c)).all()
    ns_x, ns_c = np.asarray(ns_x), np.asarray(ns_c)
    cap = np.asarray(st_x) == 1
    assert (ns_x[~cap] == ns_c[~cap]).all()
    if cap.any():
        assert np.abs(ns_x[cap] - ns_c[cap]).max() <= 2
    assert (ns_x == ns_c).mean() > 0.9
    esc = np.asarray(st_x) == 2
    assert esc.any()
    np.testing.assert_allclose(np.asarray(fq_x)[esc], np.asarray(fq_c)[esc],
                               atol=1e-8)


@pytest.mark.parametrize("order", [2, 4])
def test_ksc_matches_generic(order):
    """float64 compensated staggered flows == the XLA generic engine."""
    q0, p0 = _camera_batch(size=10)
    args = (1200, 0.05, PARAMS, 31.0, 1.0)
    out_x = integrate_batch_generic(q0, p0, *args, order=order,
                                    metric="KerrSchild")
    out_c = integrate_batch_ksc(q0, p0, *args, order=order)
    _assert_matches_generic(out_x[0], out_x[2], out_x[3],
                            out_c[0], out_c[2], out_c[3])


def test_ksc_zero_steps_noop():
    """steps == 0 neither opens nor closes the staggered state: the
    inputs come back bit-for-bit and nobody took a step."""
    q0, p0 = _camera_batch(size=6)
    fq, fp, st, ns = integrate_batch_ksc(q0, p0, 0, 0.05, PARAMS, 31.0, 1.0)
    np.testing.assert_array_equal(np.asarray(fq), np.asarray(q0))
    np.testing.assert_array_equal(np.asarray(fp), np.asarray(p0))
    assert (np.asarray(ns) == 0).all()


@pytest.mark.parametrize("order,charge", [(2, 0.0), (4, 0.3)])
def test_ksc_charge_slot_matches_generic(order, charge):
    """The third params slot (Kerr-Newman charge) threads through the
    compensated flows, the guard and the Bardeen rescue exactly as through
    the autodiff engine, across orders."""
    params = jnp.array([1.0, SPIN, charge])
    q0, p0 = _camera_batch(size=10, params=params)
    args = (1200, 0.05, params, 31.0, 1.0)
    out_x = integrate_batch_generic(q0, p0, *args, order=order,
                                    metric="KerrSchild")
    out_c = integrate_batch_ksc(q0, p0, *args, order=order)
    _assert_matches_generic(out_x[0], out_x[2], out_x[3],
                            out_c[0], out_c[2], out_c[3])


def test_ksc_f32_accuracy_vs_f64_oracle():
    """The point of the compensated KS flows: float32 escaped finals stay
    within ~1e-5 of the float64 generic engine where the plain f32 flows
    drift far more already at this short budget (the gap widens as
    sqrt(steps); at the 30k-step production budget the plain drift is the
    measured ~3 px prograde shadow-edge error)."""
    q0, p0 = _camera_batch(size=10)
    steps, delta, omega = 1500, 0.05, 1.0
    fq64, _, st64, _ = integrate_batch_generic(
        q0, p0, steps, delta, PARAMS, 31.0, omega, metric="KerrSchild")

    f32 = jnp.float32
    q32, p32 = q0.astype(f32), p0.astype(f32)
    p3 = jnp.array([1.0, SPIN, 0.0], f32)
    qc, _, sc, _ = integrate_batch_ksc(q32, p32, steps, f32(delta), p3,
                                       f32(31.0), f32(omega))
    qp, _, sp, _ = integrate_batch_generic(q32, p32, steps, f32(delta), p3,
                                           f32(31.0), f32(omega),
                                           metric="KerrSchild")
    st64 = np.asarray(st64)
    assert (np.asarray(sc) == st64).all()
    esc = (st64 == 2) & (np.asarray(sp) == 2)
    assert esc.sum() > 20
    err_comp = np.abs(np.asarray(qc)[esc, 1:]
                      - np.asarray(fq64)[esc, 1:]).max()
    err_plain = np.abs(np.asarray(qp)[esc, 1:]
                       - np.asarray(fq64)[esc, 1:]).max()
    assert err_comp < 1e-5, f"compensated f32 drift {err_comp:.2e}"
    assert err_comp < err_plain / 5.0, (
        f"compensation gain lost: comp {err_comp:.2e} vs plain "
        f"{err_plain:.2e}")


def _render_kw(dtype, size):
    return dict(
        bg_array=jnp.zeros((1, 1, 3), dtype=jnp.uint8),
        obs_x=dtype(30.0), fov=dtype(np.radians(80.0)), mass=dtype(1.0),
        spin=dtype(SPIN), boundary_radius=dtype(31.0), steps=800,
        delta=dtype(0.05), omega=dtype(1.0),
        patch_center_theta=dtype(np.pi / 2), patch_center_phi=dtype(np.pi),
        patch_size_theta=dtype(np.pi), patch_size_phi=dtype(2 * np.pi),
        height=size, width=size, has_background=False, dtype=dtype,
        metric="KerrSchild")


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def wrapped(*a, **k):
        calls.append(name)
        return real(*a, **k)
    monkeypatch.setattr(module, name, wrapped)
    return calls


def test_render_generic_backend_arg(monkeypatch):
    """render_pixels_generic takes no backend: the chart and dtype pick the
    integrator.  float64 Kerr-Schild rides the autodiff engine (already at
    roundoff), and the frame has a shadow."""
    import grtrace.engine.integrate_generic as ig
    import grtrace.engine.integrate_ks as iks
    from grtrace.engine.render_generic import render_pixels_generic

    ksc = _spy(monkeypatch, iks, "integrate_batch_ksc")
    gen = _spy(monkeypatch, ig, "integrate_batch_generic")
    jax.clear_caches()
    out = render_pixels_generic(**_render_kw(jnp.float64, 9))
    assert int(np.asarray(out["count_vec"])[0]) > 0  # some capture
    assert gen and not ksc


def test_f32_kerr_schild_render_routes_to_ksc(monkeypatch):
    """float32 Kerr-Schild frames take the compensated flows, never the
    uncompensated autodiff engine (which drifts ~3 px at the prograde
    shadow edge), and classify exactly as integrate_batch_ksc does."""
    import grtrace.engine.integrate_generic as ig
    import grtrace.engine.integrate_ks as iks
    from grtrace.engine.render_generic import render_pixels_generic

    ksc = _spy(monkeypatch, iks, "integrate_batch_ksc")
    gen = _spy(monkeypatch, ig, "integrate_batch_generic")
    jax.clear_caches()
    out = render_pixels_generic(**_render_kw(jnp.float32, 7))
    assert ksc and not gen
    q0 = jnp.asarray(out["q0"]).reshape(-1, 4)
    p0 = jnp.asarray(out["p0"]).reshape(-1, 4)
    f32 = jnp.float32
    _, _, st, _ = integrate_batch_ksc(q0, p0, 800, f32(0.05),
                                      jnp.array([1.0, SPIN, 0.0], f32),
                                      f32(31.0), f32(1.0))
    np.testing.assert_array_equal(np.asarray(out["status"]).reshape(-1),
                                  np.asarray(st))


def test_no_kerr_schild_kernel_module_left():
    """The Kerr-Schild Pallas kernels were removed with their call sites:
    the module is gone and no source file names it or the Pallas API of
    the machine this code was first written for."""
    assert importlib.util.find_spec(
        "grtrace.engine.integrate_pallas_ks") is None
    root = pathlib.Path(__file__).resolve().parents[1]
    gone = ("integrate_pallas_ks", "pallas." + "tp" + "u", "plt" + "pu")
    for path in sorted(root.glob("grtrace/**/*.py")) + [root / "bench.py"]:
        text = path.read_text()
        for word in gone:
            assert word not in text, f"{path.name} mentions {word}"

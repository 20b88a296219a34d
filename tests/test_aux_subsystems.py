"""Checkpoint/resume, metrics, NaN guard, orbit CLI."""
import jax.numpy as jnp
import numpy as np
import pytest

from grtrace.engine import checkpoint as ckpt
from grtrace.engine.integrate import integrate_batch
from grtrace.engine.metrics import RenderMetrics, nan_guard
from grtrace.physics.camera import camera_rays

ARGS = dict(steps=2500, delta=0.05, rs=2.0, r_max=31.0, omega=1.0)


def _ics(n=6):
    q0, p0, *_ = camera_rays(np.array([30.0, 0.0, 0.0]), np.radians(70.0),
                             n, n, dtype=jnp.float64)
    return (jnp.asarray(q0).reshape(-1, 4), jnp.asarray(p0).reshape(-1, 4))


def test_chunked_equals_monolithic():
    """Chunked/resumable integration must produce the same trajectory as
    the single while_loop (identical masked-step semantics)."""
    q0, p0 = _ics()
    st = ckpt.integrate_chunked(q0, p0, ARGS["steps"], ARGS["delta"],
                                ARGS["rs"], ARGS["r_max"], ARGS["omega"],
                                chunk_steps=700)
    fq, fp, status, ns = integrate_batch(q0, p0, ARGS["steps"],
                                         ARGS["delta"], ARGS["rs"],
                                         ARGS["r_max"], ARGS["omega"])
    np.testing.assert_array_equal(st.n_steps, np.asarray(ns))
    np.testing.assert_array_equal(st.status, np.asarray(status))
    np.testing.assert_allclose(st.final_q, np.asarray(fq), rtol=0, atol=0)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_save_load_resume(tmp_path, backend):
    """Both backends are resumable — including the production fast path
    (the Pallas kernel, interpret mode here; chunked advance must equal a
    monolithic run of the same backend bit-for-bit)."""
    interp = backend == "pallas"
    q0, p0 = _ics()
    path = str(tmp_path / "ck.npz")
    st = ckpt.start(q0, p0, **ARGS)
    st = ckpt.advance(st, 500, backend=backend, interpret=interp)
    st.save(path)

    # "crash" and resume from disk
    st2 = ckpt.IntegrationState.load(path)
    assert st2.steps_done == 500
    while not st2.done:
        st2 = ckpt.advance(st2, 1000, backend=backend, interpret=interp)

    ref = ckpt.integrate_chunked(q0, p0, **ARGS, chunk_steps=10**9,
                                 backend=backend, interpret=interp)
    np.testing.assert_allclose(st2.final_q, ref.final_q, rtol=0, atol=0)
    np.testing.assert_array_equal(st2.n_steps, ref.n_steps)
    # cross-backend: same step counts and statuses (math identical modulo
    # last-ulp cos/sin evaluation in the mixing rotation)
    ref_x = ckpt.integrate_chunked(q0, p0, **ARGS, chunk_steps=10**9)
    np.testing.assert_array_equal(st2.status, ref_x.status)
    np.testing.assert_array_equal(st2.n_steps, ref_x.n_steps)


def _ics_f32(n=12):
    q0, p0, *_ = camera_rays(np.array([30.0, 0.0, 0.0], np.float32),
                             np.float32(np.radians(70.0)), n, n,
                             dtype=jnp.float32)
    return (jnp.asarray(q0).reshape(-1, 4), jnp.asarray(p0).reshape(-1, 4))


def test_compensated_chunked_equals_monolithic(tmp_path):
    """The PRODUCTION fast path — the Kahan-compensated staggered float32
    numerics the headline render runs — is resumable at full fidelity:
    chunked advance (with a mid-job save/load) equals the monolithic
    integrate_batch_compensated bit-for-bit in final_q, status and
    n_steps, and to a few ulps in final_p (the closing half-A compiles in
    a separate XLA program whose FMA contraction can round the increment
    and the Kahan accumulate differently; see
    checkpoint._finalize_eqc — measured <= 2 ulps, p_r only)."""
    from grtrace.engine.integrate import integrate_batch_compensated
    q0, p0 = _ics_f32()
    f32 = jnp.float32
    steps = 1800
    qm, pm, sm, nm = integrate_batch_compensated(
        q0, p0, steps, f32(ARGS["delta"]), f32(ARGS["rs"]),
        f32(ARGS["r_max"]), f32(ARGS["omega"]))

    # float32 -> the eqc layout is auto-selected (the production numerics)
    st = ckpt.start(q0, p0, steps, ARGS["delta"], ARGS["rs"],
                    ARGS["r_max"], ARGS["omega"], compensated=True)
    assert st.layout == "eqc"
    st = ckpt.advance(st, 800, backend="xla")
    path = str(tmp_path / "eqc.npz")
    st.save(path)
    st = ckpt.IntegrationState.load(path)        # crash + resume
    assert st.layout == "eqc" and st.opened is not None
    while not st.done:
        st = ckpt.advance(st, 900, backend="xla")

    np.testing.assert_array_equal(st.final_q, np.asarray(qm))
    np.testing.assert_array_equal(st.status, np.asarray(sm))
    np.testing.assert_array_equal(st.n_steps, np.asarray(nm))
    ulps = np.abs(st.final_p.astype(np.float32).view(np.int32)
                  - np.asarray(pm, np.float32).view(np.int32))
    assert ulps.max() <= 4, f"final_p off by {ulps.max()} ulps"

    # the Pallas chunk kernel (interpret mode) applies the identical core
    # steps: bit-equal to the XLA-chunked state INCLUDING deficit rows
    st2 = ckpt.start(q0, p0, steps, ARGS["delta"], ARGS["rs"],
                     ARGS["r_max"], ARGS["omega"], compensated=True)
    while not st2.done:
        st2 = ckpt.advance(st2, 1100, backend="pallas", interpret=True)
    np.testing.assert_array_equal(st2.final_q, np.asarray(qm))
    np.testing.assert_array_equal(st2.n_steps, np.asarray(nm))

    # integrate_chunked auto-selects by dtype: f32 -> eqc, f64 -> generic
    st3 = ckpt.integrate_chunked(q0, p0, 200, ARGS["delta"], ARGS["rs"],
                                 ARGS["r_max"], ARGS["omega"],
                                 chunk_steps=100)
    assert st3.layout == "eqc"
    q064, p064 = _ics(4)
    st4 = ckpt.integrate_chunked(q064, p064, 200, ARGS["delta"], ARGS["rs"],
                                 ARGS["r_max"], ARGS["omega"],
                                 chunk_steps=100)
    assert st4.layout == "generic"


def test_save_load_orbax_directory_format(tmp_path):
    """Non-.npz checkpoint paths use the orbax directory format (the
    multi-frame-job checkpointing SURVEY section 5 names) — round trip
    must be bit-exact and interoperate with further advancing."""
    q0, p0 = _ics()
    st = ckpt.start(q0, p0, **ARGS)
    st = ckpt.advance(st, 500)
    path = str(tmp_path / "ck_orbax")
    st.save(path)
    st2 = ckpt.IntegrationState.load(path)
    assert st2.steps_done == 500
    np.testing.assert_allclose(st2.state, st.state, rtol=0, atol=0)
    np.testing.assert_array_equal(st2.n_steps, st.n_steps)
    while not st2.done:
        st2 = ckpt.advance(st2, 1000)
    ref = ckpt.integrate_chunked(q0, p0, **ARGS, chunk_steps=10**9)
    np.testing.assert_allclose(st2.final_q, ref.final_q, rtol=0, atol=0)
    np.testing.assert_array_equal(st2.status, ref.status)


def test_integrate_chunked_resume_flag(tmp_path):
    q0, p0 = _ics(4)
    path = str(tmp_path / "c2.npz")
    # run partially by limiting total steps, checkpointing
    st = ckpt.integrate_chunked(q0, p0, 300, ARGS["delta"], ARGS["rs"],
                                ARGS["r_max"], ARGS["omega"],
                                chunk_steps=100, checkpoint_path=path)
    assert st.steps_done == 300
    # resume with a larger budget from the same file: continues, not restarts
    st3 = ckpt.IntegrationState.load(path)
    assert st3.steps_done == 300


def test_metrics_stages_and_throughput():
    from grtrace import IntegratorConfig, SceneConfig, render
    m = RenderMetrics()
    scene = SceneConfig(size=12, background=None,
                        integrator=IntegratorConfig(steps=1500, delta=0.1,
                                                    dtype="float64"),
                        n_samples=2)
    render(scene, bg_array=None, metrics=m)
    assert "device_pipeline" in m.stages
    assert "sample_trajectories" in m.stages
    assert m.rays == 144
    assert m.geodesic_steps > 0
    s = m.summary()
    assert s["rays_per_s"] > 0 and s["geodesic_steps_per_s"] > 0


def test_nan_guard():
    nan_guard("ok", np.ones(4))
    with pytest.raises(FloatingPointError):
        nan_guard("bad", np.array([1.0, np.nan]))
    with pytest.raises(FloatingPointError):
        nan_guard("bad", np.ones(3), np.array([np.inf]))


def test_orbit_cli_and_resume(tmp_path):
    from grtrace.cli.orbit import main
    out = tmp_path / "orbit"
    main(["--frames", "4", "--size", "16", "--steps", "1200",
          "--delta", "0.1", "--out-dir", str(out), "--backend", "xla"])
    import os
    pngs = sorted(os.listdir(out / "frames"))
    assert pngs == [f"frame_{k:04d}.png" for k in range(4)]
    # resume is a no-op when all frames exist
    import time
    mtimes = {p: os.path.getmtime(out / "frames" / p) for p in pngs}
    main(["--frames", "4", "--size", "16", "--steps", "1200",
          "--delta", "0.1", "--out-dir", str(out), "--backend", "xla"])
    for p in pngs:
        assert os.path.getmtime(out / "frames" / p) == mtimes[p]


def test_orbit_cli_kerr(tmp_path):
    """Kerr(-Newman) camera orbits over the mesh: equatorial orbits about
    the spin axis stay exact by axisymmetry."""
    from grtrace.cli.orbit import main
    out = tmp_path / "orbit_kerr"
    main(["--frames", "2", "--size", "16", "--steps", "1200",
          "--delta", "0.05", "--out-dir", str(out), "--backend", "xla",
          "--metric", "kerr", "--spin", "0.8", "--charge", "0.3"])
    import os
    pngs = sorted(os.listdir(out / "frames"))
    assert pngs == [f"frame_{k:04d}.png" for k in range(2)]


def test_orbit_cli_disk(tmp_path):
    """Disk orbit animation: the axisymmetric disk scene over the mesh,
    inclined camera, patch-rotation trick."""
    from grtrace.cli.orbit import main
    out = tmp_path / "orbit_disk"
    main(["--frames", "2", "--size", "16", "--steps", "1200",
          "--delta", "0.05", "--out-dir", str(out), "--backend", "xla",
          "--metric", "kerr", "--spin", "0.8", "--disk"])
    import os
    pngs = sorted(os.listdir(out / "frames"))
    assert pngs == [f"frame_{k:04d}.png" for k in range(2)]


def test_orbit_cli_disk_camera_omega(tmp_path, capsys):
    """Orbit --camera-omega resolves the worldline in the SCENE's
    spacetime: zamo at a = 0.9 is nonzero (regression: orbit's
    SceneConfig omits spin, so a naive resolve gave the Schwarzschild
    zamo = 0 and silently rendered a static camera)."""
    import re

    from grtrace.cli.orbit import main
    out = tmp_path / "orbit_cam"
    main(["--frames", "2", "--size", "12", "--steps", "1000",
          "--delta", "0.1", "--out-dir", str(out), "--backend", "xla",
          "--metric", "kerr", "--spin", "0.9", "--disk",
          "--camera-omega", "zamo"])
    text = capsys.readouterr().out
    m = re.search(r"camera worldline: omega = ([-\d.e]+)", text)
    assert m, text
    assert abs(float(m.group(1))) > 1e-5
    import os
    assert len(os.listdir(out / "frames")) == 2


def test_scene_boundary_validation():
    """boundary_radius >= 100 collides with the reference's r >= 100
    numerical-error sentinel (raytracing.py:213-215) and must be rejected
    at construction, not silently misclassified (ADVICE.md round 1)."""
    import pytest
    from grtrace.io.scene import SceneConfig
    with pytest.raises(ValueError, match="boundary_radius"):
        SceneConfig(boundary_radius=120.0)
    with pytest.raises(ValueError, match="observer_distance"):
        SceneConfig(boundary_radius=31.0, observer_distance=40.0)
    SceneConfig(boundary_radius=31.0, observer_distance=30.0)  # default: ok


def test_compile_cache_off_on_cpu_without_env(monkeypatch):
    """On the CPU the persistent cache stays off unless
    JAX_COMPILATION_CACHE_DIR asks for it (XLA:CPU executable
    serialization has crashed long-lived processes), and the call undoes a
    directory set earlier in the process."""
    import jax

    import grtrace

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir",
                          grtrace.default_cache_dir())
        grtrace.enable_compilation_cache(allow_backend_init=True)
        assert jax.config.jax_compilation_cache_dir is None
    finally:
        jax.config.update("jax_compilation_cache_dir", old)

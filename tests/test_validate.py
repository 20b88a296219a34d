"""engine.validate — the on-device validation harness, exercised on CPU.

The module's real job is running in chip_smoke.py on the GPU; these tests
pin its logic on CPU so a harness bug can't silently produce green-looking
validation numbers: the Schwarzschild boundary check must reproduce the
arcsin formula through the XLA backend, the Bardeen predicate must flip
exactly once across the shadow edge, the Kerr check must land sub-pixel,
and the kernel parity check must report zero mismatches for the
interpret-mode kernel against its XLA twin.
"""
import jax.numpy as jnp
import numpy as np

from grtrace.engine import validate as val


def test_schwarzschild_shadow_error_cpu():
    out = val.schwarzschild_shadow_error(steps=8000, delta=0.03,
                                         backend="xla")
    # delta=0.03 truncation + f32 rounding stays well inside a pixel
    assert out["px_err"] < 1.0, out
    assert out["bracket_px"] < 0.3
    # rho_analytic is rounded to 3 decimals for the JSON artifact
    assert abs(out["rho_analytic"] - val.schwarzschild_analytic_rho()) < 1e-3


def test_bardeen_predicate_monotone_across_edge():
    """Deep inside the shadow: captured; far outside: escapes — at every
    azimuth, including the prograde extremity."""
    rhos = np.stack([np.full(val.N_PSI, 10.0),
                     np.full(val.N_PSI, 34.0)], axis=-1)
    esc = val.bardeen_escapes(rhos, spin=0.9)
    assert not esc[:, 0].any()
    assert esc[:, 1].all()


def test_kernel_parity_zero_mismatch_interpret():
    """Interpret-mode kernel vs the XLA twin on the headline camera's
    float32 rays (a small frame): both run the same step functions."""
    out = val.kernel_parity(size=8, steps=512, interpret=True)
    assert out["rays"] == 64
    assert out["status_mismatch"] == 0
    assert out["status_mismatch_outside_band"] == 0
    assert out["exit_step_mismatch"] == 0
    assert out["max_escape_angle_delta"] <= 1e-6


def test_kerr_shadow_errors_cpu():
    """The compensated f32 Kerr-Schild boundary at a = 0.9 lands sub-pixel
    against Bardeen at every azimuth, through the same code chip_smoke.py
    runs on the GPU (a coarser step here)."""
    out = val.kerr_shadow_errors(steps=3000, delta=0.05, order=2)
    assert len(out["px_err"]) == val.N_PSI
    assert out["px_err_max"] < 1.0, out

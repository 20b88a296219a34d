"""Shadow-analysis tool (engine/shadow.py + cli/shadow.py).

The critical curve and the real integrator must agree sub-pixel at every
azimuth (the predicate evaluates the SAME camera the renderer shoots);
the shape metrics must reproduce the textbook Kerr phenomenology
(perfect circle at a = 0, frame-dragging displacement and the flattened
prograde D-edge at high spin, shrinking shadow with charge).
"""
import json
import os

import numpy as np

import jax.numpy as jnp

from grtrace.engine.shadow import (analytic_boundary, numeric_boundary,
                                   shadow_metrics)


def test_schwarzschild_circle():
    psis, rho = analytic_boundary(0.0, n_psi=16)
    m = shadow_metrics(psis, rho)
    assert np.ptp(rho) < 5e-3                      # exact circle
    assert m["circularity_deviation"] < 1e-4
    assert abs(m["centroid_shift_px"][0]) < 1e-3
    assert m["radius_vs_schwarzschild"] == 1.0 or \
        abs(m["radius_vs_schwarzschild"] - 1.0) < 1e-4


def test_numeric_matches_analytic_subpixel():
    """The real integrator boundary vs the closed-form curve, spin 0 and
    0.9 — the user-facing version of the bench's on-chip validation.

    float32 deliberately: the production dtype's null-invariant guard
    trips on near-critical winders and the analytic Bardeen rescue then
    classifies them EXACTLY, so f32+rescue resolves a finer boundary
    than f64 (whose clean winders just exhaust the step budget)."""
    for spin in (0.0, 0.9):
        psis_n, rho_n, _ = numeric_boundary(spin, n_psi=4, steps=12_000,
                                            delta=0.02,
                                            dtype=jnp.float32, rounds=4)
        _, rho_a = analytic_boundary(spin, n_psi=4)
        assert np.abs(rho_n - rho_a).max() < 0.05, spin


def test_kerr_phenomenology():
    """a = 0.9: the shadow slides toward the approaching side and the
    prograde edge flattens (D-shape); a modest charge shrinks it."""
    psis, rho9 = analytic_boundary(0.9, n_psi=32)
    m9 = shadow_metrics(psis, rho9)
    _, rho0 = analytic_boundary(0.0, n_psi=32)

    assert abs(m9["centroid_shift_px"][0]) > 2.0   # frame-dragging shift
    assert abs(m9["centroid_shift_px"][1]) < 0.05  # equatorial camera
    assert m9["circularity_deviation"] > 0.05      # D-shape
    # Bardeen D-shape: the flat (min-radius-from-centroid) edge is the
    # PROGRADE side, and the centroid displaces toward the opposite
    # (retrograde) side — flat edge and shift point opposite ways
    cy = m9["centroid_shift_px"][0]
    y = rho9 * np.cos(psis) - cy
    z = rho9 * np.sin(psis)
    r_c = np.hypot(y, z)
    psi_flat = psis[np.argmin(r_c)]
    assert np.cos(psi_flat) * np.sign(cy) < -0.5

    _, rho_q = analytic_boundary(0.0, charge=0.6, n_psi=32)
    assert rho_q.mean() < rho0.mean()              # charge shrinks it


def test_cli_artifacts(tmp_path):
    from grtrace.cli import shadow as cli

    out = str(tmp_path)
    m = cli.main(["--spin", "0.9", "--azimuths", "24", "--numeric",
                  "--numeric-azimuths", "4", "--steps", "12000",
                  "--backend", "xla", "--out-dir", out])
    assert m["numeric_px_err_max"] < 0.3
    csv = np.genfromtxt(os.path.join(out, "shadow_boundary.csv"),
                        delimiter=",", names=True)
    assert csv.size == 24
    assert np.isfinite(csv["rho_px"]).all()
    with open(os.path.join(out, "shadow_metrics.json")) as f:
        saved = json.load(f)
    assert saved["spin"] == 0.9
    assert saved["mean_diameter_px"] == m["mean_diameter_px"]

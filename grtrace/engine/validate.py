"""On-device float32 validation against closed-form GR.

The CPU test suite pins the physics in float64 (tests/test_shadow_analytic)
and pins the Pallas kernel to its XLA twin in interpret mode — but neither
sees what the COMPILED float32 production path computes on the GPU.  These
checks close that gap, cheap enough to run in chip_smoke.py and bench.py:

  * `schwarzschild_shadow_error` — the f32 production Schwarzschild path's
    shadow boundary vs the exact arcsin formula (sin(alpha) =
    b_crit sqrt(f)/r0, b_crit = 3 sqrt(3) M), sub-pixel bisection along
    image azimuths.
  * `kerr_shadow_errors` — the compensated f32 Kerr-Schild path
    (engine.integrate_ks.integrate_batch_ksc) vs the Bardeen (1973)
    radial-potential construction, per azimuth; the prograde extremity is
    the hardest accuracy regime in the framework (plain f32 drifts ~3 px
    there).
  * `kernel_parity` — the compiled Pallas kernel vs its XLA twin
    (engine.integrate.integrate_batch_compensated) on the same rays and
    device: both run the same step functions, so a disagreement is a
    compiler difference (FMA contraction, operation order), the blind spot
    of interpret-mode CPU tests.

Everything here also runs on the CPU (backend='xla' / interpret=True), so
the module itself is covered by the ordinary test suite.  Failures raise.

Boundary positions are quoted in 256x256-image pixels regardless of probe
resolution (matching tests/test_shadow_analytic and the README numbers).
Scene: observer at r0 = 30 M on +x, fov 80 deg, boundary sphere 31 M —
the headline configuration.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

R0 = 30.0
FOV = np.radians(80.0)
SIZE = 256                      # pixel scale the errors are quoted at
BOUNDARY = 31.0
PLANE_D = 0.2 * R0              # image plane distance (raytracing.py:60-88)
PLANE_W = 2.0 * PLANE_D * np.tan(FOV / 2.0)
N_PSI = 8
PSIS = np.linspace(0.0, 2 * np.pi, N_PSI, endpoint=False)

def _pixel_positions(rho_px, psi):
    """Continuous pixel radius (256-image units) + azimuth -> image-plane
    points (same plane geometry as physics.camera.pixel_grid)."""
    off = np.asarray(rho_px) / SIZE * PLANE_W
    y = off * np.cos(psi)
    z = off * np.sin(psi)
    x = np.full_like(y, R0 - PLANE_D)
    return np.stack([x, y, z], axis=-1)


def bisect_boundary(escape_fn, lo, hi, rounds=3, k=17, n_psi=N_PSI):
    """Per-azimuth radial bisection of the capture->escape transition.

    escape_fn((P, K) pixel radii) -> (P, K) bool.  Returns (midpoints (P,),
    max bracket width) — sub-pixel boundary positions, far sharper than
    counting mask pixels.
    """
    lo = np.full(n_psi, float(lo))
    hi = np.full(n_psi, float(hi))
    for _ in range(rounds):
        rhos = np.linspace(lo, hi, k, axis=-1)           # (P, K)
        esc = np.asarray(escape_fn(rhos))
        if esc[:, 0].any() or not esc[:, -1].all():
            raise ValueError("bisection bracket does not straddle the "
                             "shadow boundary")
        first = esc.argmax(axis=1)                       # first escaped idx
        idx = np.arange(n_psi)
        lo = rhos[idx, first - 1]
        hi = rhos[idx, first]
    return 0.5 * (lo + hi), float((hi - lo).max())


def schwarzschild_analytic_rho(mass=1.0):
    """Closed-form shadow pixel radius: sin(alpha_phys) = b_crit sqrt(f)/r0
    (exact for a static observer at finite r0), tan(alpha_cam) =
    f tan(alpha_phys) (the reference camera scales the radial covector by
    sqrt(f), utils.py:179-186), pinhole tan mapping to the plane."""
    f = 1.0 - 2.0 * mass / R0
    b_crit = 3.0 * np.sqrt(3.0) * mass
    alpha_phys = np.arcsin(b_crit * np.sqrt(f) / R0)
    tan_cam = f * np.tan(alpha_phys)
    return tan_cam * PLANE_D / PLANE_W * SIZE


def bardeen_escapes(rhos, spin, charge=0.0, psis=None):
    """Analytic escape predicate for camera rays at the given pixel radii:
    each ray's conserved (xi, eta) = (L_z/E, Q/E^2) follows in closed form
    from its initial covector; the backward ray escapes iff the Bardeen
    radial potential R(r) = [E(r^2+a^2) - a L]^2 - Delta [(L-aE)^2 + Q]
    has a real root in (r_+, r0) (quartic root test, Bardeen 1973).  Host
    float64 math via the actual Cartesian-chart camera, so the predicate
    sees exactly the rays the renderer shoots."""
    from ..physics.camera import cartesian_ics_from_pixels
    from ..physics.spacetime import kerr_schild_g_inv
    if psis is None:
        psis = PSIS
    params = jnp.asarray([1.0, spin, charge])
    pix = jnp.asarray(_pixel_positions(rhos, np.asarray(psis)[:, None]))
    _, p0, _ = cartesian_ics_from_pixels(
        jnp.asarray([R0, 0.0, 0.0]), pix, params=params,
        g_inv_fn=kerr_schild_g_inv)
    p0 = np.asarray(p0, np.float64)
    E = -p0[..., 0]
    L = R0 * p0[..., 2]                      # x p_y - y p_x at (R0, 0, 0)
    r_bl_obs = np.sqrt(R0 ** 2 - spin ** 2)  # spheroidal radius at z=0
    p_th = -r_bl_obs * p0[..., 3]            # dz/dtheta = -r at equator
    xi = L / E
    eta = (p_th / E) ** 2

    r_plus = 1.0 + np.sqrt(max(1.0 - spin ** 2 - charge ** 2, 0.0))
    out = np.zeros(xi.shape, dtype=bool)
    for idx in np.ndindex(xi.shape):
        c = (xi[idx] - spin) ** 2 + eta[idx]
        p1 = np.poly1d([1.0, 0.0, spin ** 2 - spin * xi[idx]]) ** 2
        p2 = np.poly1d([1.0, -2.0, spin ** 2 + charge ** 2]) * c
        roots = (p1 - p2).roots
        real = roots[np.abs(roots.imag) < 1e-9].real
        out[idx] = bool(((real > r_plus + 1e-9) & (real < r_bl_obs)).any())
    return out


def schwarzschild_shadow_error(steps=19_968, delta=0.01, omega=1.0,
                               backend="auto", dtype=jnp.float32):
    """{'px_err': max |boundary - analytic| in 256^2 pixels, 'bracket',
    'rho_num': per-azimuth, 'rho_analytic'} for the production float32
    Schwarzschild path (integrate_dispatch: the compensated integrator)."""
    from ..physics.camera import initial_conditions
    from .integrate import STATUS_ESCAPED, integrate_dispatch

    def escape(rhos):
        pix = jnp.asarray(_pixel_positions(rhos, PSIS[:, None]), dtype)
        q0, p0, *_ = initial_conditions(
            jnp.asarray([R0, 0.0, 0.0], dtype), pix, mass_bh=1.0)
        _, _, status, _ = integrate_dispatch(
            q0.reshape(-1, 4), p0.reshape(-1, 4), steps,
            jnp.asarray(delta, dtype), jnp.asarray(2.0, dtype),
            jnp.asarray(BOUNDARY, dtype), jnp.asarray(omega, dtype),
            backend=backend, equatorial=True)
        return np.asarray(status).reshape(rhos.shape) == STATUS_ESCAPED

    rho_num, bracket = bisect_boundary(escape, 15.0, 32.0)
    rho_ana = schwarzschild_analytic_rho()
    return {
        "px_err": float(np.abs(rho_num - rho_ana).max()),
        "bracket_px": round(bracket, 4),
        "rho_num": [round(float(r), 3) for r in rho_num],
        "rho_analytic": round(float(rho_ana), 3),
    }


def kerr_shadow_errors(spin=0.9, charge=0.0, steps=8_000, delta=0.02,
                       order=4, dtype=jnp.float32):
    """{'px_err': per-azimuth |boundary - Bardeen| in 256^2 pixels, ...}
    for the compensated float32 Kerr-Schild path (+ analytic rescue).

    Budget: escapers travel ~3,800 composed steps at delta = 0.02;
    near-critical winders are settled exactly by the analytic rescue long
    before that, so 8k steps classifies every ray.  Expected errors are
    deep sub-pixel (measured 0.0002-0.016 px on CPU)."""
    from ..physics.camera import cartesian_ics_from_pixels
    from ..physics.spacetime import kerr_schild_g_inv
    from .integrate import STATUS_ESCAPED
    from .integrate_ks import integrate_batch_ksc

    params = jnp.asarray([1.0, spin, charge], dtype)

    def escape(rhos):
        pix = jnp.asarray(_pixel_positions(rhos, PSIS[:, None]), dtype)
        q0, p0, _ = cartesian_ics_from_pixels(
            jnp.asarray([R0, 0.0, 0.0], dtype), pix, params=params,
            g_inv_fn=kerr_schild_g_inv)
        _, _, status, _ = integrate_batch_ksc(
            q0.reshape(-1, 4), p0.reshape(-1, 4), steps,
            jnp.asarray(delta, dtype), params, jnp.asarray(BOUNDARY, dtype),
            jnp.asarray(1.0, dtype), order=order)
        return np.asarray(status).reshape(rhos.shape) == STATUS_ESCAPED

    rho_ana, br_a = bisect_boundary(
        lambda r: bardeen_escapes(r, spin, charge), 10.0, 34.0, rounds=4)
    rho_num, br_n = bisect_boundary(escape, 10.0, 34.0, rounds=3, k=9)
    err = np.abs(rho_num - rho_ana)
    return {
        "spin": spin,
        "charge": charge,
        "px_err": [round(float(e), 3) for e in err],
        "px_err_max": float(err.max()),
        "bracket_px": round(br_n, 4),
        "rho_num": [round(float(r), 3) for r in rho_num],
        "rho_bardeen": [round(float(r), 3) for r in rho_ana],
    }


def kernel_parity(size=400, steps=200_000, delta=0.01, omega=1.0,
                  interpret=False):
    """The compiled Pallas kernel vs its XLA twin on the headline camera's
    float32 rays: status mismatches (all, and outside the near-critical
    band the exact rescue settles), exit-step mismatches, and the max /
    median escape-angle delta over rays both call escaped.

    Bit-exactness is not expected on a GPU: Triton and XLA may contract
    multiplies and adds into FMAs differently, and near-critical rays
    amplify any last-ulp difference.  The near-critical band is
    |b - b_crit| / b_crit < 5e-3 (the integrator's truncation band at
    delta = 0.01, see integrate.schw_escape_rescue)."""
    from ..physics.camera import camera_rays
    from .integrate import (STATUS_ESCAPED, impact_parameter,
                            integrate_batch_compensated)
    from .integrate_pallas import integrate_batch_pallas

    f32 = jnp.float32
    q0, p0, *_ = camera_rays(jnp.asarray([R0, 0.0, 0.0], f32),
                             jnp.asarray(FOV, f32), size, size,
                             mass_bh=1.0, dtype=f32)
    q0 = q0.reshape(-1, 4)
    p0 = p0.reshape(-1, 4)
    args = (steps, f32(delta), f32(2.0), f32(BOUNDARY), f32(omega))
    qk, _, sk, nk = integrate_batch_pallas(
        q0, p0, *args, equatorial=True, compensated=True,
        interpret=interpret)
    qx, _, sx, nx = integrate_batch_compensated(q0, p0, *args)
    sk, sx = np.asarray(sk), np.asarray(sx)
    b = np.asarray(impact_parameter(p0), np.float64)
    b_crit = 3.0 * np.sqrt(3.0)
    band = np.abs(b - b_crit) / b_crit < 5e-3
    esc = (sk == STATUS_ESCAPED) & (sx == STATUS_ESCAPED)
    # escape direction: rays are folded to the equator, so the angle is
    # the wrapped phi difference
    dphi = np.abs(np.asarray(qk)[:, 3] - np.asarray(qx)[:, 3])
    dphi = dphi % (2 * np.pi)
    dphi = np.minimum(dphi, 2 * np.pi - dphi)

    def stat(f, mask):
        return float(f(dphi[mask])) if mask.any() else 0.0
    return {
        "rays": int(q0.shape[0]),
        "steps": steps,
        "status_mismatch": int((sk != sx).sum()),
        "status_mismatch_outside_band": int(((sk != sx) & ~band).sum()),
        "exit_step_mismatch": int((np.asarray(nk) != np.asarray(nx)).sum()),
        "max_escape_angle_delta": stat(np.max, esc),
        "median_escape_angle_delta": stat(np.median, esc),
        "max_escape_angle_delta_outside_band": stat(np.max, esc & ~band),
    }

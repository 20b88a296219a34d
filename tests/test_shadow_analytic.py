"""Shadow boundary vs closed-form GR truth — external validation.

Round 1 only checked Kerr renders for self-consistency (the shadow changes
with spin, is left-right asymmetric); a systematic error shared by all
three internal engines would pass those.  These tests pin the *integrated*
capture boundary against analytic results that never touch the integrator:

  * Schwarzschild: the critical impact parameter b_crit = 3*sqrt(3)*M
    (textbook; the reference's classification shortcut uses 3*sqrt(3)*rs
    with a compensating /2 — raytracing.py:205-211 — which the integrator
    itself does not), mapped to a pixel radius through the exact camera
    convention (sin(alpha_phys) = b*sqrt(f)/r0 for a static observer at
    r0, with the pinhole tan mapping).
  * Kerr / Kerr-Newman: the Bardeen construction.  Each camera ray's
    conserved (xi, eta) = (L_z/E, Q/E^2) follows in closed form from its
    initial covector; the ray escapes iff the radial potential
    R(r) = [E(r^2+a^2) - a L]^2 - Delta(r) [(L - aE)^2 + Q]
    has a turning point in (r_+, r0) (quartic root test, Bardeen 1973).
    The spherical-photon-orbit parametrization
    xi(rt) = (rt^2 (3M - rt) - a^2 (rt + M)) / (a (rt - M)),
    eta(rt) = 4 rt^2 Delta(rt)/(rt - M)^2 - (xi - a)^2
    cross-checks the in-code potential construction against the
    literature curve.

Boundary positions are measured by batched radial bisection along image
azimuths (sub-pixel, far sharper than counting mask pixels) and quoted in
256x256-image pixels; everything must agree to well under the 1.5 px
target.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from grtrace.engine.integrate import STATUS_ESCAPED, integrate_batch
from grtrace.engine.integrate_generic import integrate_batch_generic
from grtrace.physics.camera import cartesian_ics_from_pixels, initial_conditions
from grtrace.physics.spacetime import horizon_radius, kerr_schild_g_inv

R0 = 30.0
FOV = np.radians(80.0)
SIZE = 256                      # pixel scale the tolerances are quoted at
PLANE_D = 0.2 * R0              # image plane distance (raytracing.py:60-88)
PLANE_W = 2.0 * PLANE_D * np.tan(FOV / 2.0)
N_PSI = 8
PSIS = np.linspace(0.0, 2 * np.pi, N_PSI, endpoint=False)


# plane geometry and the per-azimuth bisection are the library's own
# (engine.validate — the on-chip validation harness); reusing them keeps
# the two in lockstep.  The scene constants above are asserted equal so a
# drift in either module is caught here.
from grtrace.engine import validate as _val

assert (_val.R0, _val.SIZE, _val.N_PSI) == (R0, SIZE, N_PSI)
assert abs(_val.FOV - FOV) < 1e-12 and abs(_val.PLANE_W - PLANE_W) < 1e-12

_pixel_positions = _val._pixel_positions
_bisect_boundary = _val.bisect_boundary


# ----------------------------------------------------------------------
# Schwarzschild
# ----------------------------------------------------------------------

def _schw_escape(rhos):
    pix = jnp.asarray(_pixel_positions(rhos, PSIS[:, None]), jnp.float64)
    q0, p0, *_ = initial_conditions(
        jnp.asarray([R0, 0.0, 0.0], jnp.float64), pix, mass_bh=1.0)
    _, _, status, _ = integrate_batch(
        q0.reshape(-1, 4), p0.reshape(-1, 4), 30_000, 0.02, 2.0, 31.0, 1.0)
    return np.asarray(status).reshape(rhos.shape) == STATUS_ESCAPED


def _schw_analytic_rho():
    """Closed-form shadow pixel radius: sin(alpha_phys) = b_crit sqrt(f)/r0
    (exact for a static observer at finite r0), tan(alpha_cam) =
    f tan(alpha_phys) (the reference camera scales the radial covector by
    sqrt(f), utils.py:179-186), pinhole tan mapping to the plane."""
    f = 1.0 - 2.0 / R0
    b_crit = 3.0 * np.sqrt(3.0)
    alpha_phys = np.arcsin(b_crit * np.sqrt(f) / R0)
    tan_cam = f * np.tan(alpha_phys)
    return tan_cam * PLANE_D / PLANE_W * SIZE


def test_schwarzschild_shadow_matches_arcsin_formula():
    rho_num, bracket = _bisect_boundary(_schw_escape, 15.0, 32.0)
    rho_ana = _schw_analytic_rho()
    err = np.abs(rho_num - rho_ana).max()
    assert bracket < 0.3
    assert err < 0.75, (
        f"shadow edge off analytic by {err:.3f}px at 256^2 "
        f"(num {rho_num}, analytic {rho_ana:.3f})")
    # and the shadow is round: all azimuths agree
    assert np.ptp(rho_num) < 0.3


# ----------------------------------------------------------------------
# Kerr / Kerr-Newman (Bardeen)
# ----------------------------------------------------------------------

def _conserved(rhos, spin, charge=0.0):
    """(xi, eta) for camera rays at the given pixel radii (host math via
    the actual Cartesian-chart camera, so the test sees exactly the rays
    the renderer shoots)."""
    params = jnp.asarray([1.0, spin, charge], jnp.float64)
    pix = jnp.asarray(_pixel_positions(rhos, PSIS[:, None]), jnp.float64)
    q0, p0, _ = cartesian_ics_from_pixels(
        jnp.asarray([R0, 0.0, 0.0], jnp.float64), pix, params=params,
        g_inv_fn=kerr_schild_g_inv)
    p0 = np.asarray(p0)
    E = -p0[..., 0]
    L = R0 * p0[..., 2]                      # x p_y - y p_x at (R0, 0, 0)
    r_bl = np.sqrt(R0 ** 2 - spin ** 2)      # spheroidal radius at z=0
    p_th = -r_bl * p0[..., 3]                # dz/dtheta = -r at equator
    return L / E, (p_th / E) ** 2, q0, p0


def _escapes_analytic(xi, eta, spin, charge=0.0):
    """Bardeen radial-potential test: the backward ray (moving inward from
    r0) escapes iff R(r) has a real root in (r_+, r0_bl).  E normalized
    to 1; R is a quartic in r."""
    r_plus = 1.0 + np.sqrt(max(1.0 - spin ** 2 - charge ** 2, 0.0))
    r_bl = np.sqrt(R0 ** 2 - spin ** 2)
    out = np.zeros(xi.shape, dtype=bool)
    for idx in np.ndindex(xi.shape):
        c = (xi[idx] - spin) ** 2 + eta[idx]
        p1 = np.poly1d([1.0, 0.0, spin ** 2 - spin * xi[idx]]) ** 2
        p2 = np.poly1d([1.0, -2.0, spin ** 2 + charge ** 2]) * c
        roots = (p1 - p2).roots
        real = roots[np.abs(roots.imag) < 1e-9].real
        out[idx] = bool(((real > r_plus + 1e-9) & (real < r_bl)).any())
    return out


def _kerr_escape_integrated(rhos, spin, charge=0.0, steps=8_000,
                            delta=0.02, order=4):
    """Budget note: escapers travel ~3,800 composed steps (r0 -> shell ->
    boundary at delta = 0.02); near-critical winders trip the blow-up
    guard and are settled exactly by the analytic rescue well before
    that, so 8k steps classifies every ray — no ray is left ALIVE.
    Order 4 measures bit-identical boundary positions to order 6 at 1/3
    the substeps (the rescue, not truncation, sets the boundary)."""
    params = jnp.asarray([1.0, spin, charge], jnp.float64)
    pix = jnp.asarray(_pixel_positions(rhos, PSIS[:, None]), jnp.float64)
    q0, p0, _ = cartesian_ics_from_pixels(
        jnp.asarray([R0, 0.0, 0.0], jnp.float64), pix, params=params,
        g_inv_fn=kerr_schild_g_inv)
    _, _, status, _ = integrate_batch_generic(
        q0.reshape(-1, 4), p0.reshape(-1, 4), steps, delta, params, 31.0,
        1.0, metric="KerrSchild", order=order)
    return np.asarray(status).reshape(rhos.shape) == STATUS_ESCAPED


def _bardeen_curve_check(xi, eta, spin, charge=0.0, tol=2e-3):
    """Assert (xi, eta) sits on the spherical-photon-orbit curve:
    parametrize by rt, match xi (monotone across the shell), compare eta.
    tol covers the boundary-bisection resolution (bracket ~4e-4 px ->
    d(eta) ~ 1e-3) plus the rt-grid quantization."""
    rt = np.linspace(1.0 + 1e-6, 4.2, 3_000_001)
    delta_t = rt ** 2 - 2.0 * rt + spin ** 2 + charge ** 2
    with np.errstate(divide="ignore", invalid="ignore"):
        xi_c = (rt ** 2 + spin ** 2 - 2.0 * rt * delta_t / (rt - 1.0)) / spin
        eta_c = 4.0 * rt ** 2 * delta_t / (rt - 1.0) ** 2 - (xi_c - spin) ** 2
    ok = np.isfinite(xi_c) & np.isfinite(eta_c) & (eta_c > -1e-2)
    j = np.abs(xi_c[ok] - xi).argmin()
    return abs(xi_c[ok][j] - xi) < 1e-3 and abs(eta_c[ok][j] - eta) < 5e-3


def _kerr_escape_ksc_f32(rhos, spin, charge=0.0, steps=8_000,
                         delta=0.02, order=2):
    # order 2 — the production default — measures the identical boundary
    # (0.0156 px max err, same bracket) as order 4/6: the analytic rescue,
    # not truncation, sets it.  One substep per step also compiles a third
    # of the order-4 loop body, which dominated this test's wall time.
    """Same rays as _kerr_escape_integrated, but integrated in FLOAT32
    through the compensated Kerr-Schild path (the production f32 numerics;
    XLA twin of the Pallas kernel — bit-exact pair, test_pallas_ks)."""
    from grtrace.engine.integrate_ks import integrate_batch_ksc
    f32 = jnp.float32
    params = jnp.asarray([1.0, spin, charge], jnp.float64)
    pix = jnp.asarray(_pixel_positions(rhos, PSIS[:, None]), jnp.float64)
    q0, p0, _ = cartesian_ics_from_pixels(
        jnp.asarray([R0, 0.0, 0.0], jnp.float64), pix, params=params,
        g_inv_fn=kerr_schild_g_inv)
    _, _, status, _ = integrate_batch_ksc(
        q0.reshape(-1, 4).astype(f32), p0.reshape(-1, 4).astype(f32),
        steps, f32(delta), params.astype(f32), f32(31.0), f32(1.0),
        order=order)
    return np.asarray(status).reshape(rhos.shape) == STATUS_ESCAPED


def test_kerr_shadow_f32_compensated_subpixel():
    """The production float32 Kerr path (Kahan-compensated KS flows +
    analytic Bardeen rescue for guard-parked winders) must hold the
    shadow boundary at DEEP sub-pixel accuracy at EVERY azimuth for
    a = 0.9 — including the prograde extremity where the round-2 plain
    f32 flows drifted ~3 px.  Rays the float precision cannot integrate
    through the shell passage are classified by their conserved
    quantities (integrate_ks.bardeen_escape_pred — exact for the
    integrable Kerr family), so the residual error is just the resolved
    rays' truncation: measured 0.0002-0.016 px across azimuths."""
    spin = 0.9

    def ana(rhos):
        xi, eta, _, _ = _conserved(rhos, spin)
        return _escapes_analytic(xi, eta, spin)

    rho_ana, br_a = _bisect_boundary(ana, 10.0, 34.0, rounds=4)
    rho_f32, br_n = _bisect_boundary(
        lambda r: _kerr_escape_ksc_f32(r, spin), 10.0, 34.0,
        rounds=3, k=9)
    err = np.abs(rho_f32 - rho_ana)
    assert br_a < 0.05 and br_n < 0.3
    assert (err < 0.1).all(), (
        f"f32-compensated shadow edge off Bardeen by {err.round(3)}px at "
        f"256^2 (tol 0.1)\n num {rho_f32}\n ana {rho_ana}")


@pytest.mark.parametrize("spin,charge", [(0.9, 0.0), (0.6, 0.5)])
def test_kerr_shadow_matches_bardeen(spin, charge):
    # analytic boundary along each azimuth (quartic-root predicate)
    def ana(rhos):
        xi, eta, _, _ = _conserved(rhos, spin, charge)
        return _escapes_analytic(xi, eta, spin, charge)

    rho_ana, br_a = _bisect_boundary(ana, 10.0, 34.0, rounds=4)
    rho_num, br_n = _bisect_boundary(
        lambda r: _kerr_escape_integrated(r, spin, charge), 10.0, 34.0,
        rounds=3, k=9)
    err = np.abs(rho_num - rho_ana)
    assert br_a < 0.05 and br_n < 0.3
    # Deep sub-pixel at every azimuth (measured <= 0.016 px), including
    # the prograde extremity (psi = pi for a > 0) — the hardest regime in
    # relativistic ray tracing, where rays log-wind on a photon shell ~5%
    # above the horizon.  Before the analytic Bardeen rescue the guard
    # retired those winders early and the boundary sat 0.45-2.84 px off
    # (order/delta-dependent); the rescue classifies them by their
    # conserved quantities, which is exact for the integrable family, so
    # the residual is the resolved rays' truncation only.
    assert (err < 0.1).all(), (
        f"a={spin} Q={charge}: integrated shadow edge off Bardeen by "
        f"{err.round(3)}px at 256^2 (tol 0.1)\n num {rho_num}\n "
        f"ana {rho_ana}")
    # spin asymmetry is real: the shadow is displaced along the spin-
    # perpendicular axis (psi=0 is +y = prograde side for a > 0)
    assert abs(rho_ana[0] - rho_ana[N_PSI // 2]) > 1.0

    # the boundary rays' (xi, eta) must lie ON the literature curve
    xi, eta, _, _ = _conserved(rho_ana[:, None], spin, charge)
    for p in range(N_PSI):
        assert _bardeen_curve_check(xi[p, 0], eta[p, 0], spin, charge), (
            f"psi={PSIS[p]:.2f}: (xi, eta)=({xi[p,0]:.4f}, {eta[p,0]:.4f}) "
            f"not on the Bardeen curve")

"""Equatorial circular orbits in the Kerr-Newman family.

Everything a thin accretion disk needs to shade itself: the Keplerian
angular velocity of a circular equatorial geodesic, the emitter
4-velocity normalization, the ISCO radius (inner disk edge), and the
combined gravitational + Doppler redshift factor of a photon received
from such an orbiting emitter.

All quantities are chart-invariant scalars (Omega = dphi/dt, u^t, the
redshift g = nu_obs/nu_em), evaluated from the Boyer-Lindquist equatorial
metric — rays traced on the Cartesian Kerr-Schild chart can be shaded
with these directly because E = -p_t and L_z = x p_y - y p_x are the same
Killing conserved quantities in both charts.

This capability has no reference counterpart (the reference renders
background lensing only); it exists because a GR ray tracer without a
disk mode leaves the framework's showcase regime — the photon ring and
the Doppler-boosted approaching limb — unexercised.  Geometrized units
G = c = 1 throughout, matching the rest of grtrace (reference
main.py:14-18).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .spacetime import kerr_g_inv


def isco_radius(mass, a, prograde=True):
    """ISCO radius of a Kerr hole (Bardeen-Press-Teukolsky 1972).

    Z1 = 1 + (1-chi^2)^(1/3) [(1+chi)^(1/3) + (1-chi)^(1/3)],
    Z2 = sqrt(3 chi^2 + Z1^2),
    r_isco = M (3 + Z2 -+ sqrt((3-Z1)(3+Z1+2Z2)))   (- prograde, + retro)

    chi = a/M.  a = 0 gives the Schwarzschild 6M.  (Charge shifts the
    ISCO slightly; no closed form exists for Kerr-Newman — the Kerr value
    is used as the default disk inner edge, override via DiskConfig.r_in.)
    """
    chi = jnp.clip(a / mass, -1.0, 1.0)
    one = jnp.ones_like(chi)
    z1 = 1.0 + jnp.cbrt(1.0 - chi * chi) * (jnp.cbrt(1.0 + chi)
                                            + jnp.cbrt(1.0 - chi))
    z2 = jnp.sqrt(3.0 * chi * chi + z1 * z1)
    root = jnp.sqrt(jnp.maximum((3.0 - z1) * (3.0 + z1 + 2.0 * z2), 0.0))
    sign = jnp.where(jnp.asarray(prograde), -one, one)
    return mass * (3.0 + z2 + sign * root)


def keplerian_omega(r, mass, a, charge=0.0, prograde=True):
    """Angular velocity Omega = dphi/dt of an equatorial circular geodesic.

    Kerr-Newman: Omega = +- sqrt(M r - Q^2) / (r^2 +- a sqrt(M r - Q^2));
    Q = 0 reduces to the Kerr sqrt(M)/(r^(3/2) +- a sqrt(M)).  Verified
    against the raw geodesic condition d/dr (g^{ab} u_a u_b) = 0 via
    autodiff in tests/test_disk.py (no hand algebra trusted).
    """
    s = jnp.sqrt(jnp.maximum(mass * r - charge * charge, 0.0))
    sign = jnp.where(jnp.asarray(prograde), 1.0, -1.0)
    return sign * s / (r * r + sign * a * s)


def _invert_bl_metric(g_inv):
    """Invert a Boyer-Lindquist-structured 4x4 metric analytically.

    BL metrics of the Kerr-Newman family couple only (t, phi); (r, theta)
    are diagonal.  The block inverse — reciprocal diagonals plus the 2x2
    (t, phi) inverse — avoids jnp.linalg.inv's LU path, which is slower
    than the closed form for 4x4.
    """
    det2 = g_inv[0, 0] * g_inv[3, 3] - g_inv[0, 3] * g_inv[3, 0]
    z = jnp.zeros_like(det2)
    row_t = jnp.stack([g_inv[3, 3] / det2, z, z, -g_inv[0, 3] / det2])
    row_r = jnp.stack([z, 1.0 / g_inv[1, 1], z, z])
    row_h = jnp.stack([z, z, 1.0 / g_inv[2, 2], z])
    row_p = jnp.stack([-g_inv[3, 0] / det2, z, z, g_inv[0, 0] / det2])
    return jnp.stack([row_t, row_r, row_h, row_p])


def equatorial_g_cov(r, params):
    """Covariant Boyer-Lindquist metric at (r, theta = pi/2).

    Inverts the tested contravariant kerr_g_inv rather than restating the
    covariant components by hand — one metric implementation, everywhere.
    """
    zero = jnp.zeros_like(r)
    q = jnp.stack([zero, r, jnp.full_like(r, jnp.pi / 2), zero])
    return _invert_bl_metric(kerr_g_inv(q, params))


def circular_u_t(r, params, prograde=True):
    """(u^t, Omega) of the circular equatorial emitter at BL radius r.

    u = u^t (partial_t + Omega partial_phi), normalized u.u = -1:
    u^t = 1 / sqrt(-(g_tt + 2 Omega g_tph + Omega^2 g_phph)).
    """
    from .spacetime import _charge
    omega = keplerian_omega(r, params[0], params[1], _charge(params),
                            prograde)
    g = equatorial_g_cov(r, params)
    denom = -(g[0, 0] + 2.0 * omega * g[0, 3] + omega * omega * g[3, 3])
    return 1.0 / jnp.sqrt(jnp.maximum(denom, 1e-30)), omega


def static_u_t(r, params, theta=jnp.pi / 2):
    """u^t of a static observer at BL (r, theta): 1/sqrt(-g_tt)."""
    zero = jnp.zeros_like(r)
    q = jnp.stack([zero, r, jnp.broadcast_to(theta, jnp.shape(r)), zero])
    g = _invert_bl_metric(kerr_g_inv(q, params))
    return 1.0 / jnp.sqrt(jnp.maximum(-g[0, 0], 1e-30))


def rotating_u_t(r, params, theta=jnp.pi / 2, omega=0.0):
    """u^t of the rotating observer u = u^t (partial_t + omega partial_phi)
    at BL (r, theta) — a static observer when omega = 0, a circular-orbit
    camera at any omega for which the worldline stays timelike
    (-(g_tt + 2 omega g_tph + omega^2 g_phph) > 0; the sqrt is clamped,
    callers validate the regime)."""
    zero = jnp.zeros_like(r)
    q = jnp.stack([zero, r, jnp.broadcast_to(theta, jnp.shape(r)), zero])
    g = _invert_bl_metric(kerr_g_inv(q, params))
    denom = -(g[0, 0] + 2.0 * omega * g[0, 3] + omega * omega * g[3, 3])
    return 1.0 / jnp.sqrt(jnp.maximum(denom, 1e-30))


def zamo_omega(r, params, theta=jnp.pi / 2):
    """Angular velocity omega = -g_tph / g_phph of the zero-angular-
    momentum observer (ZAMO) at BL (r, theta) — the locally nonrotating
    frame dragged by the hole; the physically preferred 'hovering' camera
    in Kerr (reduces to static in Schwarzschild where g_tph = 0)."""
    zero = jnp.zeros_like(r)
    q = jnp.stack([zero, r, jnp.broadcast_to(theta, jnp.shape(r)), zero])
    g = _invert_bl_metric(kerr_g_inv(q, params))
    return -g[0, 3] / g[3, 3]


def circular_e_lz(r, params, prograde=True):
    """Specific energy E = -u_t and axial angular momentum L = u_phi of
    the circular equatorial geodesic at BL radius r — the covariant
    Killing charges, lowered through the tested metric rather than
    restated from the textbook closed forms."""
    u_t, omega = circular_u_t(r, params, prograde)
    g = equatorial_g_cov(r, params)
    energy = -u_t * (g[0, 0] + omega * g[0, 3])
    l_z = u_t * (g[0, 3] + omega * g[3, 3])
    return energy, l_z


def _sqrt_g3_equatorial(r, params):
    """sqrt(-det g3) of the equatorial (t, r, phi) metric block — the
    proper-area measure in the Page-Thorne flux (equals r for Kerr; kept
    general so charge flows through the determinant, not a memory of it)."""
    g = equatorial_g_cov(r, params)
    idx = jnp.array([0, 1, 3])
    g3 = g[idx][:, idx]
    return jnp.sqrt(jnp.maximum(-jnp.linalg.det(g3), 1e-30))


def page_thorne_flux(r_grid, params, prograde=True):
    """Time-averaged radiative flux F(r) of the relativistic thin disk
    (Novikov-Thorne), from the Page & Thorne (1974) angular-momentum
    conservation law, eq. (11b):

        F(r) = -(Mdot / (4 pi sqrt(-g3))) * dOmega/dr * (E - Omega L)^-2
               * int_{r0}^{r} (E - Omega L) dL/dr dr'

    with E(r), L(r), Omega(r) the circular-geodesic quantities above, the
    radial derivatives by autodiff, and the integral by trapezoid on
    `r_grid` (r_grid[0] = the torque-free inner boundary).  No closed form
    is trusted — none exists for charge != 0 anyway; the Kerr closed form
    (PT eq. 15n) and the Newtonian Shakura-Sunyaev limit are used as
    *checks* in tests/test_disk.py, not as the implementation.  Mdot = 1
    (callers normalize the profile to its peak).  Returns F on r_grid.
    """
    from .spacetime import _charge

    mass, a, q = params[0], params[1], _charge(params)

    def eol(r):
        e, l = circular_e_lz(r, params, prograde)
        return e, l, keplerian_omega(r, mass, a, q, prograde)

    e, l, omega = jax.vmap(eol)(r_grid)
    dl_dr = jax.vmap(jax.grad(
        lambda r: circular_e_lz(r, params, prograde)[1]))(r_grid)
    domega_dr = jax.vmap(jax.grad(
        lambda r: keplerian_omega(r, mass, a, q, prograde)))(r_grid)

    integrand = (e - omega * l) * dl_dr
    dr = jnp.diff(r_grid)
    segments = 0.5 * (integrand[1:] + integrand[:-1]) * dr
    cumulative = jnp.concatenate([jnp.zeros((1,), r_grid.dtype),
                                  jnp.cumsum(segments)])
    sqrt_g3 = jax.vmap(lambda r: _sqrt_g3_equatorial(r, params))(r_grid)
    flux = (-domega_dr * cumulative
            / ((e - omega * l) ** 2 * 4.0 * jnp.pi * sqrt_g3))
    return jnp.maximum(flux, 0.0)


def redshift_factor(energy, l_z, r_em, r_obs, params, prograde=True,
                    theta_obs=jnp.pi / 2, omega_obs=0.0):
    """g = nu_obs / nu_em for a photon with conserved (E = -p_t, L_z)
    emitted by a circular equatorial geodesic at r_em and received by the
    observer u_obs = u^t (partial_t + omega_obs partial_phi) at
    (r_obs, theta_obs) — static by default (omega_obs = 0), a rotating /
    orbiting camera otherwise.

    nu ~ -p.u with the Killing charges only:  emitter
    -p.u_em = u^t (E - Omega L_z);  observer
    -p.u_obs = u_obs^t (E - omega_obs L_z).  Both Doppler beaming
    (through the Omega L_z terms) and gravitational redshift (through
    the u^t factors) are in here — no separate treatment needed.  The
    expression is homogeneous of degree zero in (E, L_z), so the
    past-directed tracing convention cancels.
    """
    u_t_em, omega = circular_u_t(r_em, params, prograde)
    u_t_obs = rotating_u_t(r_obs, params, theta_obs, omega_obs)
    return ((energy - omega_obs * l_z) * u_t_obs) / (
        u_t_em * (energy - omega * l_z))

"""Polarized ray tracing: exact Walker-Penrose transport in Kerr.

Kerr is Petrov type D, so along every null geodesic the complex
Walker-Penrose constant

    kappa = (A - iB) (r - i a cos(theta))                      [BL chart]
    A = (k^t f^r - k^r f^t) + a sin^2(theta) (k^r f^phi - k^phi f^r)
    B = [(r^2 + a^2)(k^phi f^theta - k^theta f^phi)
         - a (k^t f^theta - k^theta f^t)] sin(theta)

is conserved for any vector f parallel-transported along the photon
momentum k (Walker & Penrose 1970).  That turns polarization transport —
an extra ODE per ray in a naive design — into pure algebra: evaluate
kappa once at the emission event, reconstruct the polarization direction
at the camera from the conserved value.  No per-step state, no extra
kernel rows, zero cost in the integration loop: the array-program way to
polarize a ray tracer.

The rays themselves live on the Cartesian Kerr-Schild chart (the
horizon-regular production chart, physics/kerr_schild.py), so this module
carries the exact KS -> Boyer-Lindquist phase-space map.  Covariant
components transform with the forward Jacobian d(x_KS)/d(x_BL) — no
matrix inversion anywhere — and indices are raised with the closed-form
BL inverse metric (spacetime.kerr_g_inv).  The chart map is pinned by
Hamiltonian invariance and the whole pipeline by a numerical
parallel-transport oracle (autodiff Christoffels, RK4) in
tests/test_polarization.py — per this repo's rule, no hand algebra is
trusted with another hand formula.

No reference counterpart: the reference (and EinsteinPy) trace intensity
only.  The gauge freedom f -> f + lambda k leaves kappa unchanged, which
is what makes the camera-side reconstruction a 2x2 linear solve on the
observer's screen basis.
"""
from __future__ import annotations

import jax.numpy as jnp

from .spacetime import _charge, kerr_g_inv, ks_radius


# ---------------------------------------------------------------------------
# Kerr-Schild <-> Boyer-Lindquist phase-space map
# ---------------------------------------------------------------------------

def _ks_chart_geometry(q_ks, params):
    """Shared pieces of the KS->BL Jacobian at one event.

    The repo's KS Cartesian chart (spacetime.kerr_schild_g_inv,
    l_x = (rx+ay)/w convention) corresponds to

        x + i y = sin(theta) (r + i a) e^{i phit},   z = r cos(theta)
        t_ks = t_bl + T(r),   T' = (2 M r - Q^2) / Delta
        phit = phi_bl + Phi(r),  Phi' = a / Delta

    (signs fixed numerically: Hamiltonian invariance to 7e-16 across
    random phase points, see tests/test_polarization.py).
    """
    mass, a = params[0], params[1]
    qc = _charge(params)
    t, x, y, z = q_ks[0], q_ks[1], q_ks[2], q_ks[3]
    r = ks_radius(x, y, z, a)
    w = r * r + a * a
    cth = jnp.clip(z / jnp.maximum(r, 1e-30), -1.0, 1.0)
    sth = jnp.sqrt(jnp.maximum(1.0 - cth * cth, 1e-30))
    cph = (x * r + y * a) / (sth * w)
    sph = (y * r - x * a) / (sth * w)
    delta = r * r - 2.0 * mass * r + a * a + qc * qc
    t_prime = (2.0 * mass * r - qc * qc) / delta
    phi_prime = a / delta
    return r, cth, sth, cph, sph, t_prime, phi_prime


def bl_cov_from_ks_cov(q_ks, w_cov, params):
    """Transform a COVARIANT 4-vector from the KS Cartesian chart to BL.

    w_bl_mu = (d x_ks^nu / d x_bl^mu) w_ks_nu — the forward Jacobian,
    so no inversion is needed (momenta are covariant; anything
    contravariant is lowered first with `ks_lower`).
    """
    x, y = q_ks[1], q_ks[2]
    r, cth, sth, cph, sph, t_prime, phi_prime = _ks_chart_geometry(q_ks,
                                                                   params)
    wt, wx, wy, wz = w_cov[0], w_cov[1], w_cov[2], w_cov[3]
    dxdr = sth * cph - y * phi_prime
    dydr = sth * sph + x * phi_prime
    w_t = wt
    w_r = t_prime * wt + dxdr * wx + dydr * wy + cth * wz
    w_th = (cth / sth) * (x * wx + y * wy) - r * sth * wz
    w_ph = x * wy - y * wx
    return jnp.stack([w_t, w_r, w_th, w_ph])


def bl_from_ks(q_ks, p_ks, params):
    """(q, covariant p) on the KS Cartesian chart -> the BL chart.

    The BL azimuth is the KS azimuth (they differ by a pure function of
    r, which nothing axisymmetric ever reads); theta = arccos(z/r).
    """
    r, cth, sth, cph, sph, _, _ = _ks_chart_geometry(q_ks, params)
    q_bl = jnp.stack([q_ks[0], r, jnp.arccos(cth), jnp.arctan2(sph, cph)])
    return q_bl, bl_cov_from_ks_cov(q_ks, p_ks, params)


def raise_bl(q_bl, w_cov, params):
    """Covariant -> contravariant in BL via the closed-form inverse
    metric (no LU; block-sparse contraction)."""
    return kerr_g_inv(q_bl, params) @ w_cov


def ks_lower(q_ks, v_up, params):
    """Lower a contravariant KS-chart vector with the closed-form
    covariant metric g = eta + 2 H l l (l_mu = (1, lx, ly, lz))."""
    mass, a = params[0], params[1]
    qc = _charge(params)
    x, y, z = q_ks[1], q_ks[2], q_ks[3]
    r = ks_radius(x, y, z, a)
    r2 = r * r
    w = r2 + a * a
    big_d = r2 + (a * z / r) * (a * z / r)
    h = (mass * r - 0.5 * qc * qc) / big_d
    lx = (r * x + a * y) / w
    ly = (r * y - a * x) / w
    lz = z / r
    l_dot_v = v_up[0] + lx * v_up[1] + ly * v_up[2] + lz * v_up[3]
    eta_v = jnp.stack([-v_up[0], v_up[1], v_up[2], v_up[3]])
    return eta_v + 2.0 * h * l_dot_v * jnp.stack(
        [jnp.ones_like(lx), lx, ly, lz])


def ks_dot(q_ks, a_up, b_up, params):
    """Metric inner product of two contravariant vectors, KS chart."""
    return jnp.sum(ks_lower(q_ks, a_up, params) * b_up)


# ---------------------------------------------------------------------------
# The Walker-Penrose constant
# ---------------------------------------------------------------------------

def walker_penrose(q_bl, k_up, f_up, a):
    """(kappa1, kappa2) = Re, Im of the WP constant for contravariant
    BL-chart k (photon momentum) and f (any transported vector).

    Linear in f and invariant under f -> f + lambda k — both facts the
    camera-side reconstruction relies on.
    """
    r, th = q_bl[1], q_bl[2]
    sth, cth = jnp.sin(th), jnp.cos(th)
    kt, kr, kth, kph = k_up[0], k_up[1], k_up[2], k_up[3]
    ft, fr, fth, fph = f_up[0], f_up[1], f_up[2], f_up[3]
    a_term = (kt * fr - kr * ft) + a * sth * sth * (kr * fph - kph * fr)
    b_term = ((r * r + a * a) * (kph * fth - kth * fph)
              - a * (kt * fth - kth * ft)) * sth
    # (A - iB)(r - i a cos th)
    kappa1 = r * a_term - a * cth * b_term
    kappa2 = -(r * b_term + a * cth * a_term)
    return kappa1, kappa2


def _sqrt_neg_det_bl(q_bl, params):
    """sqrt(-det g_cov) in BL from the block-sparse inverse metric:
    det g_inv = g^rr g^thth (g^tt g^phph - (g^tph)^2)."""
    g = kerr_g_inv(q_bl, params)
    det_inv = g[1, 1] * g[2, 2] * (g[0, 0] * g[3, 3] - g[0, 3] * g[3, 0])
    return 1.0 / jnp.sqrt(jnp.maximum(-det_inv, 1e-30))


def _eps_contract(q_bl, u_cov, k_cov, b_cov, params):
    """f^mu = eps^{mu nu rho sigma} u_nu k_rho b_sigma — the generalized
    cross product, via cofactor 3x3 determinants over the stacked
    covariant rows, divided by sqrt(-g).  Overall orientation sign is a
    convention; everything downstream is quadratic in f or mod-pi."""
    rows = jnp.stack([u_cov, k_cov, b_cov])          # (3, 4)

    def det3(c0, c1, c2):
        m = rows[:, jnp.array([c0, c1, c2])]
        return (m[0, 0] * (m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1])
                - m[0, 1] * (m[1, 0] * m[2, 2] - m[1, 2] * m[2, 0])
                + m[0, 2] * (m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]))

    f_up = jnp.stack([-det3(1, 2, 3), det3(0, 2, 3),
                      -det3(0, 1, 3), det3(0, 1, 2)])
    return f_up / _sqrt_neg_det_bl(q_bl, params)


# ---------------------------------------------------------------------------
# Emission: synchrotron polarization of a Keplerian disk element
# ---------------------------------------------------------------------------

def disk_field_b(q_bl, u_up, params, bfield):
    """Unit magnetic-field 4-vector in the emitter frame (b.u = 0,
    b.b = 1), for the standard axisymmetric disk-field geometries:
    'vertical' (poloidal, along the disk normal), 'toroidal' (along the
    flow), 'radial'.  Built by projecting the coordinate direction
    orthogonal to u with the metric — valid at any theta, exact at the
    equator where disk emission happens."""
    g = kerr_g_inv(q_bl, params)
    if bfield == "vertical":
        # -partial_theta / r is the +z direction at the equator
        v_cov = jnp.array([0.0, 0.0, -1.0, 0.0])
    elif bfield == "radial":
        v_cov = jnp.array([0.0, 1.0, 0.0, 0.0])
    elif bfield == "toroidal":
        v_cov = jnp.array([0.0, 0.0, 0.0, 1.0])
    else:
        raise ValueError(f"unknown bfield {bfield!r}")
    v_up = g @ v_cov
    # project out the u component:  v -> v + (v.u) u   (u.u = -1)
    g_cov = _bl_lower_matrix(q_bl, params)
    u_cov = g_cov @ u_up
    v_up = v_up + jnp.sum(u_cov * v_up) * u_up
    norm = jnp.sqrt(jnp.maximum(jnp.sum((g_cov @ v_up) * v_up), 1e-30))
    return v_up / norm


def _bl_lower_matrix(q_bl, params):
    """Covariant BL metric via the analytic block inverse of kerr_g_inv
    (shared with physics.orbits._invert_bl_metric semantics)."""
    from .orbits import _invert_bl_metric
    return _invert_bl_metric(kerr_g_inv(q_bl, params))


def emission_polarization(q_bl, p_bl, params, prograde=True,
                          bfield="vertical"):
    """Walker-Penrose constant + fractional-polarization weight of a
    photon (covariant BL momentum p_bl) leaving a circular Keplerian
    emitter at the equatorial event q_bl.

    Synchrotron geometry: the emitted E-vector lies along
    f ~ eps(u, k, b) (perpendicular to both the photon and the field in
    the emitter frame), with polarized weight sin^2(theta_B) — the pitch
    angle between photon direction and field in that frame.

    Returns (kappa1, kappa2, sin2_theta_b).
    """
    from .orbits import circular_u_t

    r = q_bl[1]
    u_t, omega = circular_u_t(r, params, prograde)
    u_up = u_t * jnp.array([1.0, 0.0, 0.0, 0.0]) + \
        (u_t * omega) * jnp.array([0.0, 0.0, 0.0, 1.0])
    b_up = disk_field_b(q_bl, u_up, params, bfield)

    g_cov = _bl_lower_matrix(q_bl, params)
    k_up = kerr_g_inv(q_bl, params) @ p_bl
    u_cov = g_cov @ u_up
    b_cov = g_cov @ b_up
    f_raw = _eps_contract(q_bl, u_cov, p_bl, b_cov, params)

    f_norm2 = jnp.sum((g_cov @ f_raw) * f_raw)
    nu_em = -jnp.sum(p_bl * u_up)            # photon frequency in frame
    sin2_theta_b = f_norm2 / jnp.maximum(nu_em * nu_em, 1e-30)
    f_up = f_raw / jnp.sqrt(jnp.maximum(f_norm2, 1e-30))
    kappa1, kappa2 = walker_penrose(q_bl, k_up, f_up, params[1])
    return kappa1, kappa2, sin2_theta_b


# ---------------------------------------------------------------------------
# Camera: reconstruct the screen EVPA from the conserved constant
# ---------------------------------------------------------------------------

def observer_evpa(kappa1, kappa2, q0_ks, p0_ks, up3, right3, params,
                  omega_obs=0.0):
    """Electric-vector position angle on the camera screen, from the
    conserved WP constant of the ray whose camera-end phase point is
    (q0_ks, p0_ks) on the KS chart.

    up3/right3: the camera's (contravariant, spatial) basis directions
    in KS Cartesian coordinates.  omega_obs: the camera worldline's
    coordinate angular velocity — 0 for the static observer, nonzero for
    a circular camera u = u^t (partial_t + omega partial_phi), the SAME
    worldline physics.camera.boosted_ics_from_pixels shoots rays from.
    Procedure: build the OBSERVER's orthonormal screen {e1 (up),
    e2 (right)} orthogonal to u_obs and to the photon's spatial direction
    in the observer's rest space (for a moving camera this is exactly the
    boosted-tetrad screen: same Gram-Schmidt of the look-at coordinate
    directions against the same u, plus the transversality projection);
    kappa is linear in f and k-gauge-invariant, so the physical
    f = c1 e1 + c2 e2 (mod k, u) and (c1, c2) solve the 2x2 real system
    kappa(f) = kappa_target.

    EVPA = atan2(c2, c1), measured from camera-up toward camera-right,
    defined mod pi.  Also returns the reconstruction residual
    |c| (should be ~1 for a unit f: a built-in consistency diagnostic —
    large deviations flag rays whose screen basis degenerated).
    """
    zero = jnp.zeros_like(q0_ks[0])
    one = jnp.ones_like(zero)

    def dot(a_up, b_up):
        return ks_dot(q0_ks, a_up, b_up, params)

    # circular-worldline 4-velocity direction (1, -w y, w x, 0): the
    # Cartesian form of partial_t + w partial_phi (reduces to the static
    # observer at w = 0)
    w = jnp.asarray(omega_obs, q0_ks.dtype)
    u_obs = jnp.stack([one, -w * q0_ks[2], w * q0_ks[1], zero])
    u_obs = u_obs / jnp.sqrt(jnp.maximum(-dot(u_obs, u_obs), 1e-30))

    # contravariant photon vector at the camera
    g_inv_ks = _ks_raise_matrix(q0_ks, params)
    k_up = g_inv_ks @ p0_ks
    n_hat = k_up + dot(k_up, u_obs) * u_obs        # spatial part
    n_hat = n_hat / jnp.sqrt(jnp.maximum(dot(n_hat, n_hat), 1e-30))

    def screen_vec(v3):
        e = jnp.stack([zero, v3[0], v3[1], v3[2]])
        e = e + dot(e, u_obs) * u_obs
        e = e - dot(e, n_hat) * n_hat
        return e

    e1 = screen_vec(up3)
    e1 = e1 / jnp.sqrt(jnp.maximum(dot(e1, e1), 1e-30))
    e2 = screen_vec(right3)
    e2 = e2 - dot(e2, e1) * e1
    e2 = e2 / jnp.sqrt(jnp.maximum(dot(e2, e2), 1e-30))

    q_bl, p_bl = bl_from_ks(q0_ks, p0_ks, params)
    k_bl_up = raise_bl(q_bl, p_bl, params)

    def kappa_of(e_up):
        e_cov_ks = ks_lower(q0_ks, e_up, params)
        e_bl_up = raise_bl(q_bl, bl_cov_from_ks_cov(q0_ks, e_cov_ks,
                                                    params), params)
        return walker_penrose(q_bl, k_bl_up, e_bl_up, params[1])

    k11, k12 = kappa_of(e1)
    k21, k22 = kappa_of(e2)
    # solve [[k11, k21], [k12, k22]] @ (c1, c2) = (kappa1, kappa2)
    det = k11 * k22 - k21 * k12
    inv_det = jnp.where(jnp.abs(det) > 1e-30, 1.0 / det, 0.0)
    c1 = (k22 * kappa1 - k21 * kappa2) * inv_det
    c2 = (k11 * kappa2 - k12 * kappa1) * inv_det
    evpa = jnp.mod(jnp.arctan2(c2, c1), jnp.pi)
    return evpa, jnp.sqrt(c1 * c1 + c2 * c2)


def _ks_raise_matrix(q_ks, params):
    """Contravariant KS metric as a matrix (spacetime.kerr_schild_g_inv
    exists; re-derived here row-free from the same closed form to keep
    this module self-contained for single events)."""
    from .spacetime import kerr_schild_g_inv
    return kerr_schild_g_inv(q_ks, params)

"""Rotating regular black holes: Kerr-Schild metrics with a mass function.

The static regular families (physics/static_metrics.py) generalize to
rotation through the Newman-Janis / Kerr-Schild construction (Bambi &
Modesto 2013): keep the Kerr-Schild form

    g^{mu nu} = eta^{mu nu} - 2 H l^mu l^nu,
    H = m(r) r^3 / (r^4 + a^2 z^2),

and replace the constant Kerr mass by the family's MASS FUNCTION m(r):

    Kerr            m(r) = M                       (consistency limit)
    Kerr-Newman     m(r) = M - Q^2 / (2 r)         (EXACT — the tested
                    kerr_schild_g_inv already writes H this way,
                    spacetime.py:132, so this factory reproduces the
                    whole Kerr-Newman family as an algebra check)
    rot. Bardeen    m(r) = M r^3 / (r^2 + g^2)^{3/2}
    rot. Hayward    m(r) = M r^3 / (r^3 + 2 M l^2)

with r the KERR-SCHILD radius ks_radius(x, y, z, a) (the positive root
of r^4 - (rho^2 - a^2) r^2 = a^2 z^2 — the mass function never enters
the chart).  At a = 0 these reduce exactly to the static families; at
g = l = 0 exactly to Kerr.

Consequence: because the deformation lives entirely inside the
scalar H, the rotating regular families inherit the full Cartesian
Kerr-Schild machinery — horizon-regular (no 1/Delta stiffness), no polar
axis, the same camera (camera_rays_cartesian), the same guards (the
Hamiltonian-invariant explosion detector of engine.integrate_generic is
metric-generic) — and render through the generic autodiff engine with
ONE new g_inv function and zero new kernels.

Horizons solve Delta(r) = r^2 - 2 m(r) r + a^2 = 0 — no closed form for
the regular families, so `rotating_horizon` scans + bisects exactly like
static_metrics.outer_horizon.  Spin AND regular charge both shrink the
parameter space: horizons exist only below a joint critical curve
(e.g. Bardeen a = 0.9 tolerates only g <~ 0.28 M).

No reference counterpart (the reference is Schwarzschild-only,
simulation/cuda_geodesic.py:432-447); no EinsteinPy counterpart either.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def bardeen_mass(r, params):
    """Bardeen mass function; params[2] = g (magnetic charge).
    m -> M as r -> inf; m ~ M r^3/g^3 at the core (de Sitter-like)."""
    mass, g = params[0], params[2]
    r2 = r * r
    return mass * r2 * r / jnp.power(r2 + g * g, 1.5)


def hayward_mass(r, params):
    """Hayward mass function; params[2] = l (core length)."""
    mass, ell = params[0], params[2]
    r3 = r * r * r
    return mass * r3 / (r3 + 2.0 * mass * ell * ell)


MASS_FN = {
    "RotatingBardeen": bardeen_mass,
    "RotatingHayward": hayward_mass,
}


def make_rotating_ks_g_inv(m_fn):
    """Contravariant Kerr-Schild metric with mass function `m_fn(r,
    params)`: g^{mu nu} = eta - 2 H l l with H = m(r) r^3/(r^4 + a^2 z^2).
    Mirrors spacetime.kerr_schild_g_inv (which is this factory with
    m(r) = M - Q^2/2r hand-inlined); q = (t, x, y, z),
    params = (M, a, family-parameter)."""
    from .spacetime import ks_radius

    def g_inv(q, params):
        a = params[1]
        x, y, z = q[1], q[2], q[3]
        r = ks_radius(x, y, z, a)
        r2 = r * r
        r2a2 = r2 + a * a
        H = m_fn(r, params) * r * r2 / (r2 * r2 + a * a * z * z)
        lx = (r * x + a * y) / r2a2
        ly = (r * y - a * x) / r2a2
        lz = z / r
        l_up = jnp.stack([-1.0 * jnp.ones_like(r), lx, ly, lz])
        eta = jnp.diag(jnp.array([-1.0, 1.0, 1.0, 1.0], dtype=l_up.dtype))
        return eta - 2.0 * H * jnp.outer(l_up, l_up)

    return g_inv


rotating_bardeen_g_inv = make_rotating_ks_g_inv(bardeen_mass)
rotating_hayward_g_inv = make_rotating_ks_g_inv(hayward_mass)


def delta_bl(r, m_fn, params):
    """The Boyer-Lindquist horizon function Delta(r) = r^2 - 2 m(r) r +
    a^2 — its positive roots are the horizons (the KS chart shares BL's
    r, so the capture surface lives at the same radius)."""
    a = params[1]
    return r * r - 2.0 * m_fn(r, params) * r + a * a


def rotating_horizon(metric, params, n_scan=512, iters=60):
    """Outer event horizon of a rotating regular family: the largest root
    of Delta on (0, 2M], by scan + fixed-count bisection (the same robust
    pattern as static_metrics.outer_horizon).  NaN when Delta never goes
    negative — the horizonless super-critical region of the (a, g/l)
    plane, where the render captures nothing (rays traverse the regular
    core; a small floor guards the coordinate center)."""
    m_fn = MASS_FN[metric]
    mass = params[0]
    # Delta > 0 at both ends (r -> 0+: a^2 >= 0 with m r -> 0; r = 2.2M:
    # above the Kerr r_+ <= 2M for every m(r) <= M); scan INWARD from the
    # top so argmax finds the first entry into Delta < 0 — whose outer
    # bracket neighbours the outer horizon
    rs = jnp.linspace(2.2 * mass, 1e-3 * mass, n_scan)
    dv = jax.vmap(lambda r: delta_bl(r, m_fn, params))(rs)
    neg = dv < 0.0
    has = jnp.any(neg)
    idx = jnp.argmax(neg)                      # first scan point inside
    lo = rs[idx]                               # Delta(lo) < 0 (inner)
    hi = rs[jnp.maximum(idx - 1, 0)]           # Delta(hi) > 0 (outer)

    def bisect(_, lohi):
        lo, hi = lohi
        mid = 0.5 * (lo + hi)
        inside = delta_bl(mid, m_fn, params) < 0.0
        return jnp.where(inside, mid, lo), jnp.where(inside, hi, mid)

    lo, hi = jax.lax.fori_loop(0, iters, bisect, (lo, hi))
    return jnp.where(has, 0.5 * (lo + hi), jnp.nan)


def rotating_capture_radius(metric, params):
    """Capture-shell radius for the generic integrator: the Kerr-Schild
    chart's thin 1.05 shell over the bisected horizon (cf.
    integrate_generic._capture_radius for 'KerrSchild'), or the small
    horizonless floor of the static families."""
    r_h = rotating_horizon(metric, params)
    return jnp.where(jnp.isnan(r_h), 1e-2 * params[0], 1.05 * r_h)


def escape_pred_rotating(metric, q0s, p0s, params, n_grid=192, iters=30):
    """Exact conserved-quantity escape predicate for mass-function
    Kerr-Schild metrics — the generalization of the Kerr-Newman Bardeen
    rescue (engine/integrate_ks.bardeen_escape_pred).

    The Hamilton-Jacobi equation of a Kerr-like metric separates for ANY
    radial mass function: m(r) enters only through Delta(r), which lives
    entirely in the r-equation, so the Carter constant survives and each
    ray's (E, L_z, Q) decides its fate exactly.  The radial potential is

        R(r) = [E (r^2 + a^2) - a L]^2 - Delta(r) [(L - aE)^2 + Q],
        Delta(r) = r^2 - 2 m(r) r + a^2,

    and a backward camera ray escapes iff R has a turning point (R <= 0)
    in (r_+, r0).  R is no longer a quartic, so the Kerr rescue's
    Newton-on-cubic polish is replaced by a golden-section refinement of
    the coarse-grid argmin — derivative-free and monotonically
    convergent for the locally-unimodal dip around the photon region.

    Horizonless (super-critical) parameters return False everywhere: with
    no horizon there is no capture, but a ray that reaches the core
    crosses the r = 0 disc where the fixed-step chart cannot follow it —
    the guard's captured-at-the-floor verdict ("unresolved core transit")
    is the honest answer, so no rescue is attempted.
    """
    from .spacetime import ks_radius

    m_fn = MASS_FN[metric]
    a = params[1]
    x, y, z = q0s[:, 1], q0s[:, 2], q0s[:, 3]
    E = -p0s[:, 0]
    L = x * p0s[:, 2] - y * p0s[:, 1]
    r0_bl = ks_radius(x, y, z, a)
    cos_th = z / r0_bl
    sin2 = jnp.maximum(1.0 - cos_th * cos_th, 1e-30)
    sin_th = jnp.sqrt(sin2)
    p_th = (cos_th / sin_th) * (x * p0s[:, 1] + y * p0s[:, 2]) \
        - r0_bl * sin_th * p0s[:, 3]
    Q = p_th * p_th + cos_th * cos_th * (L * L / sin2 - a * a * E * E)

    c1 = (L - a * E) ** 2 + Q
    B = E * a * a - a * L
    r_h = rotating_horizon(metric, params)
    has_horizon = jnp.isfinite(r_h)
    r_lo = jnp.where(has_horizon, r_h, 0.5 * params[0]) + 1e-3

    E_, B_, c1_ = E[:, None], B[:, None], c1[:, None]

    def R(r):
        quad = E_ * r * r + B_
        # delta_bl is elementwise in r (the mass functions are plain
        # jnp arithmetic), so it broadcasts over the (N, K) grid directly
        return quad * quad - delta_bl(r, m_fn, params) * c1_

    lo = (r_lo + jnp.zeros_like(r0_bl))[:, None]
    hi = r0_bl[:, None]
    ts = jnp.linspace(0.0, 1.0, n_grid, dtype=E.dtype)
    grid = lo + (hi - lo) * ts[None, :]
    Rg = R(grid)
    jmin = jnp.argmin(Rg, axis=1)
    R_grid_min = jnp.take_along_axis(Rg, jmin[:, None], axis=1)[:, 0]
    # golden-section refinement inside the bracketing grid cells
    j_lo = jnp.maximum(jmin - 1, 0)
    j_hi = jnp.minimum(jmin + 1, n_grid - 1)
    gl = jnp.take_along_axis(grid, j_lo[:, None], axis=1)
    gh = jnp.take_along_axis(grid, j_hi[:, None], axis=1)
    inv_phi = 0.6180339887498949

    def golden(_, lohi):
        gl, gh = lohi
        x1 = gh - inv_phi * (gh - gl)
        x2 = gl + inv_phi * (gh - gl)
        keep_lo = R(x1)[:, 0] < R(x2)[:, 0]
        return (jnp.where(keep_lo[:, None], gl, x1),
                jnp.where(keep_lo[:, None], x2, gh))

    gl, gh = jax.lax.fori_loop(0, iters, golden, (gl, gh))
    R_min = jnp.minimum(R_grid_min, R(0.5 * (gl + gh))[:, 0])
    return has_horizon & (R_min <= 0.0)


def critical_parameter(metric, spin, mass=1.0, iters=48):
    """Largest family parameter (g or l) that still has a horizon at the
    given spin — the joint criticality curve of the (a, parameter)
    plane, by bisection on horizon existence.  (a = 0 reproduces the
    static sqrt(16/27) M ~ 0.7698 M for Bardeen and Hayward.)"""
    lo, hi = 0.0, 1.5 * mass

    def has_horizon(p1):
        r = rotating_horizon(metric, jnp.array([mass, spin, p1]))
        return jnp.isfinite(r)

    def bisect(_, lohi):
        lo, hi = lohi
        mid = 0.5 * (lo + hi)
        ok = has_horizon(mid)
        return jnp.where(ok, mid, lo), jnp.where(ok, hi, mid)

    lo, hi = jax.lax.fori_loop(0, iters, bisect, (lo, hi))
    return 0.5 * (lo + hi)

"""Generic stationary spacetimes via autodiff Hamiltonian flows.

The reference's ground-truth library (EinsteinPy `Nulllike`) is
metric-generic — its FANTASY integrator takes any contravariant metric and
differentiates it numerically (reference usage:
tests/einsteinpy-geodesic-test/main.py:145-155 passes `metric_params=(a,)`).
The reference GPU path hand-codes Schwarzschild only
(simulation/cuda_geodesic.py:432-474).

This module is the array-program generalization: a spacetime is just a pure
function ``g_inv(q, params) -> (4, 4)`` and the FANTASY flow kicks/drifts are
obtained with `jax.grad` of the scalar Hamiltonian — exact derivatives of
whatever metric is plugged in, no hand-derived formulas and no finite
differences (EinsteinPy uses central differences with a fixed 1e-8 step; here
autodiff is exact to roundoff).  Everything is vmapped over the ray batch and
compiled by XLA, so a new metric costs one function, not a new kernel.

Schwarzschild keeps its specialized fast paths (physics.metric,
physics.hamiltonian — diagonal metric, hoisted trig); this module is the
correctness-first generic engine used for Kerr and any future metric.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Metric library: q = (t, r, theta, phi), params = (mass, spin a[, charge Q])
# The charge slot is optional (len(params) is static under jit): the Kerr
# metrics below are really Kerr-Newman with Q defaulting to 0, so the whole
# black-hole family {Schwarzschild, Reissner-Nordstrom, Kerr, Kerr-Newman}
# rides the same two charts and the same engines.
# ---------------------------------------------------------------------------

def _charge(params):
    """Q from an optional third params slot (static-shape dispatch)."""
    return params[2] if params.shape[0] > 2 else jnp.zeros_like(params[0])


def schwarzschild_g_inv(q, params):
    """Contravariant Schwarzschild metric at q; params = (M,) or (M, 0.0)."""
    mass = params[0]
    r, th = q[1], q[2]
    f = 1.0 - 2.0 * mass / r
    sin_th = jnp.sin(th)
    return jnp.array([
        [-1.0 / f, 0.0, 0.0, 0.0],
        [0.0, f, 0.0, 0.0],
        [0.0, 0.0, 1.0 / (r * r), 0.0],
        [0.0, 0.0, 0.0, 1.0 / (r * r * sin_th * sin_th)],
    ])


def kerr_g_inv(q, params):
    """Contravariant Kerr(-Newman) metric, Boyer-Lindquist, geometrized
    units.

    params = (M, a) or (M, a, Q) with a^2 + Q^2 <= M^2.  Nonzero g^{t phi}
    encodes frame dragging; the charge enters only through
    Delta = r^2 - 2 M r + a^2 + Q^2 and the exact identity
    r^2 + a^2 - Delta = 2 M r - Q^2 in the t-phi cross term.  Reduces
    exactly to schwarzschild_g_inv at a = Q = 0.
    """
    mass, a = params[0], params[1]
    qc = _charge(params)
    r, th = q[1], q[2]
    sin_th = jnp.sin(th)
    cos_th = jnp.cos(th)
    sin2 = sin_th * sin_th
    sigma = r * r + a * a * cos_th * cos_th
    delta = r * r - 2.0 * mass * r + a * a + qc * qc
    r2a2 = r * r + a * a

    inv_sd = 1.0 / (sigma * delta)
    g_tt = -(r2a2 * r2a2 - a * a * delta * sin2) * inv_sd
    g_tp = -(r2a2 - delta) * a * inv_sd
    g_rr = delta / sigma
    g_thth = 1.0 / sigma
    g_pp = (delta - a * a * sin2) * inv_sd / sin2

    return jnp.array([
        [g_tt, 0.0, 0.0, g_tp],
        [0.0, g_rr, 0.0, 0.0],
        [0.0, 0.0, g_thth, 0.0],
        [g_tp, 0.0, 0.0, g_pp],
    ])


def ks_radius(x, y, z, a):
    """Boyer-Lindquist radius from Kerr-Schild Cartesian coordinates:
    the positive root of r^4 - (rho^2 - a^2) r^2 - a^2 z^2 = 0."""
    rho2 = x * x + y * y + z * z
    b = rho2 - a * a
    r2 = 0.5 * (b + jnp.sqrt(b * b + 4.0 * a * a * z * z))
    return jnp.sqrt(r2)


def kerr_schild_g_inv(q, params):
    """Contravariant Kerr metric in (ingoing) Kerr-Schild CARTESIAN
    coordinates.

    q = (t, x, y, z), params = (M, a).  g^{mu nu} = eta^{mu nu}
    - 2H l^mu l^nu with H = M r^3 / (r^4 + a^2 z^2),
    l_mu = (1, (rx+ay)/(r^2+a^2), (ry-ax)/(r^2+a^2), z/r), l^mu = eta l.

    Why this chart exists here (not in the reference or EinsteinPy): it is regular at the horizon (no 1/Delta blow-up — the
    stiff kicks that force the Boyer-Lindquist blow-up guard simply don't
    exist) and Cartesian (no polar 1/sin(theta) singularity), so fixed-step
    float32 integration — the production precision — stays
    well-conditioned everywhere outside the ring singularity.

    Capture semantics: the *backward*-traced camera ray that "came from the
    hole" asymptotes to the PAST horizon, which no future-regular chart
    covers at finite affine parameter — it freezes exponentially at r_+ in
    this chart exactly as in BL.  The capture surface is therefore
    (1+eps) r_+ with eps = 0.05 (engine.integrate_generic), tighter than
    the reference's BL 1.1 factor and numerically benign here because
    nothing diverges at r_+.  At a = 0 the spatial coordinates coincide
    with Schwarzschild's (only t is sheared), so escape directions agree
    exactly.
    """
    mass, a = params[0], params[1]
    qc = _charge(params)
    t, x, y, z = q[0], q[1], q[2], q[3]
    r = ks_radius(x, y, z, a)
    r2 = r * r
    r2a2 = r2 + a * a
    # Kerr-Newman Kerr-Schild scalar (Debney-Kerr-Schild): the charge only
    # shifts M r -> M r - Q^2/2 in the numerator of H.
    H = (mass * r - 0.5 * qc * qc) * r2 / (r2 * r2 + a * a * z * z)
    lx = (r * x + a * y) / r2a2
    ly = (r * y - a * x) / r2a2
    lz = z / r
    # l^mu = eta^{mu nu} l_nu with eta = diag(-1, 1, 1, 1)
    l_up = jnp.stack([-1.0 * jnp.ones_like(r), lx, ly, lz])
    eta = jnp.diag(jnp.array([-1.0, 1.0, 1.0, 1.0], dtype=l_up.dtype))
    return eta - 2.0 * H * jnp.outer(l_up, l_up)


from .kerr_de_sitter import (kds_outer_horizon,  # noqa: E402
                             kerr_de_sitter_g_inv)
from .rotating_regular import (rotating_bardeen_g_inv,  # noqa: E402
                               rotating_hayward_g_inv, rotating_horizon)
from .static_metrics import (STATIC_F, bardeen_g_inv,  # noqa: E402
                             hayward_g_inv, kottler_g_inv, outer_horizon)

METRICS = {
    "Schwarzschild": schwarzschild_g_inv,
    "Kerr": kerr_g_inv,
    "KerrSchild": kerr_schild_g_inv,
    # beyond-Kerr static families (physics/static_metrics.py): the second
    # params slot carries the family's own parameter (Lambda, g, or l)
    "Kottler": kottler_g_inv,
    "Bardeen": bardeen_g_inv,
    "Hayward": hayward_g_inv,
    # rotating regular families (physics/rotating_regular.py): Kerr-Schild
    # with a mass function; params = (M, a, g-or-l)
    "RotatingBardeen": rotating_bardeen_g_inv,
    "RotatingHayward": rotating_hayward_g_inv,
    # Kerr-de Sitter (physics/kerr_de_sitter.py): spin + cosmological
    # constant; params = (M, a, Lambda)
    "KerrDS": kerr_de_sitter_g_inv,
}

# coordinate chart per metric: 'spherical' q = (t, r, th, ph),
# 'cartesian' q = (t, x, y, z)
COORDS = {
    "Schwarzschild": "spherical",
    "Kerr": "spherical",
    "KerrSchild": "cartesian",
    "Kottler": "spherical",
    "Bardeen": "spherical",
    "Hayward": "spherical",
    "RotatingBardeen": "cartesian",
    "RotatingHayward": "cartesian",
    "KerrDS": "spherical",
}


def horizon_radius(metric: str, mass, a=0.0, q=0.0):
    """Outer event-horizon radius r_+ (capture surface for classification).

    Kerr-Newman family: r_+ = M + sqrt(M^2 - a^2 - Q^2); a = Q = 0 gives
    the Schwarzschild 2M.  Static beyond-Kerr families (Kottler/Bardeen/
    Hayward): the largest root of f below the photon sphere, by autodiff
    bisection (static_metrics.outer_horizon) — `a` carries the family
    parameter there; NaN when no horizon exists (super-critical regular
    holes)."""
    if metric == "Schwarzschild":
        return 2.0 * mass
    if metric in ("Kerr", "KerrSchild"):
        return mass + jnp.sqrt(
            jnp.maximum(mass * mass - a * a - q * q, 0.0))
    if metric in STATIC_F:
        return outer_horizon(STATIC_F[metric],
                             (jnp.asarray(mass), jnp.asarray(a)))
    if metric in ("RotatingBardeen", "RotatingHayward"):
        # a = spin, q = the family parameter (g or l); NaN when the
        # (a, q) point is super-critical (no horizon)
        return rotating_horizon(
            metric, jnp.stack([jnp.asarray(mass), jnp.asarray(a),
                               jnp.asarray(q)]))
    if metric == "KerrDS":
        # a = spin, q = Lambda
        return kds_outer_horizon(
            jnp.stack([jnp.asarray(mass), jnp.asarray(a),
                       jnp.asarray(q)]))
    raise KeyError(metric)


# ---------------------------------------------------------------------------
# Hamiltonian + null condition
# ---------------------------------------------------------------------------

def hamiltonian(q, p, params, g_inv_fn):
    """H = 0.5 g^{ab}(q) p_a p_b for one ray; vmap for batches."""
    g = g_inv_fn(q, params)
    return 0.5 * p @ g @ p


def null_p_t(p_sph, q, params, g_inv_fn, future=True):
    """Solve g^{ab} p_a p_b = 0 for p_t, general cross terms.

    p_sph: (3,) spatial covector components in the metric's own chart.
    Quadratic A p_t^2 + B p_t + C = 0 with A = g^tt,
    B = 2 g^{t i} p_i, C = g^{i j} p_i p_j.  future=True picks the root that
    reduces to the reference's positive root in the Schwarzschild limit
    (B = 0: p_t = +sqrt(-C/A); reference simulation/utils.py:84-88).
    """
    q4 = jnp.asarray(q)
    g = g_inv_fn(q4, params)
    A = g[0, 0]
    B = 2.0 * g[0, 1:] @ p_sph
    C = p_sph @ g[1:, 1:] @ p_sph
    disc = jnp.sqrt(jnp.maximum(B * B - 4.0 * A * C, 0.0))
    # A < 0 outside the ergosphere: (-B - disc)/(2A) is the positive branch
    root = (-B - disc) / (2.0 * A) if future else (-B + disc) / (2.0 * A)
    return root


def build_null_4momentum(p_sph, pos_sph, params, g_inv_fn, future=True):
    """(3,) spatial momentum + (r, th, ph) position -> (4,) null covector."""
    q4 = jnp.concatenate([jnp.zeros((1,), dtype=jnp.asarray(pos_sph).dtype),
                          jnp.asarray(pos_sph)])
    p_t = null_p_t(jnp.asarray(p_sph), q4, params, g_inv_fn, future=future)
    return jnp.concatenate([p_t[None], jnp.asarray(p_sph)])


# ---------------------------------------------------------------------------
# FANTASY flows for any metric (autodiff kicks and drifts)
# ---------------------------------------------------------------------------

def make_flows(g_inv_fn):
    """Build (flow_a, flow_b, flow_mixed) for a metric function.

    Per-ray state is (q1, p1, q2, p2), each (4,).  The kick -dH/dq and drift
    +dH/dp come from jax.grad of the scalar Hamiltonian — exact derivatives
    of the plugged-in metric (vs EinsteinPy's 1e-8 central differences).
    """
    dq = jax.grad(hamiltonian, argnums=0)
    dp = jax.grad(hamiltonian, argnums=1)

    def flow_a(q1, p1, q2, p2, dt, params):
        p1 = p1 - dt * dq(q1, p2, params, g_inv_fn)
        q2 = q2 + dt * dp(q1, p2, params, g_inv_fn)
        return q1, p1, q2, p2

    def flow_b(q1, p1, q2, p2, dt, params):
        p2 = p2 - dt * dq(q2, p1, params, g_inv_fn)
        q1 = q1 + dt * dp(q2, p1, params, g_inv_fn)
        return q1, p1, q2, p2

    def flow_mixed(q1, p1, q2, p2, cos_w, sin_w):
        q_sum, q_dif = q1 + q2, q1 - q2
        p_sum, p_dif = p1 + p2, p1 - p2
        return (0.5 * (q_sum + q_dif * cos_w + p_dif * sin_w),
                0.5 * (p_sum + p_dif * cos_w - q_dif * sin_w),
                0.5 * (q_sum - q_dif * cos_w - p_dif * sin_w),
                0.5 * (p_sum - p_dif * cos_w + q_dif * sin_w))

    return flow_a, flow_b, flow_mixed


def make_step(g_inv_fn):
    """Per-ray composed FANTASY step for the metric; vmap over batches.

    Returns step(q1, p1, q2, p2, params, subs) where subs is the
    (delta_i, cos_i, sin_i) schedule from hamiltonian.substep_schedule.
    """
    flow_a, flow_b, flow_mixed = make_flows(g_inv_fn)

    def step(q1, p1, q2, p2, params, subs):
        for d_i, cos_i, sin_i in subs:
            half = 0.5 * d_i
            q1, p1, q2, p2 = flow_a(q1, p1, q2, p2, half, params)
            q1, p1, q2, p2 = flow_b(q1, p1, q2, p2, half, params)
            q1, p1, q2, p2 = flow_mixed(q1, p1, q2, p2, cos_i, sin_i)
            q1, p1, q2, p2 = flow_b(q1, p1, q2, p2, half, params)
            q1, p1, q2, p2 = flow_a(q1, p1, q2, p2, half, params)
        return q1, p1, q2, p2

    return step

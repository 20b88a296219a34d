"""Analytic FANTASY flows for Kerr in Cartesian Kerr-Schild coordinates.

Component-tuple twin of physics.hamiltonian (Schwarzschild) for the
Kerr-Schild chart of physics.spacetime.kerr_schild_g_inv: the same flow
algebra the generic autodiff engine derives with `jax.grad`, here written
out by hand as pure elementwise array ops, one (N,) array per component
(autodiff-built per-ray flows force a (N, 4, 4) metric layout) — the form a
one-ray-per-thread GPU kernel can take over unchanged.

The reference has no Kerr support at all — its GPU kernel hand-codes
Schwarzschild only (reference: simulation/cuda_geodesic.py:432-474); the
generic engine (grtrace.physics.spacetime) is the capability superset and
this module is its speed-of-light specialization.  Tests pin these formulas
against the autodiff flows to float64 roundoff.

Geometry (all elementwise; q = (t, x, y, z), params M, a):
    rho^2 = x^2 + y^2 + z^2,  b = rho^2 - a^2
    s = sqrt(b^2 + 4 a^2 z^2),  r^2 = (b + s)/2          (BL radius)
    D == s = 2 r^2 - b = r^2 + a^2 z^2 / r^2
    w = r^2 + a^2,   H = M r^3 / (r^4 + a^2 z^2) = M r / D
    l_x = (r x + a y)/w,  l_y = (r y - a x)/w,  l_z = z/r,  l^t = -1
    S = l^a p_a = -p_t + l_x p_x + l_y p_y + l_z p_z
    Ham = 1/2 eta^{ab} p_a p_b - H S^2

Hand-derived gradients (the simplifications below use D = 2 r^2 - b):
    dr/dx = x r / D,  dr/dy = y r / D,  dr/dz = z w / (r D)
    dD/dx = 2 x b / D,  dD/dy = 2 y b / D,  dD/dz = 2 z (b + 2 a^2) / D
    dH/dx_i = H (r_i / r - D_i / D)
    dS/dx_i = r_i G + chart term,  with
    G = (x p_x + y p_y - 2 r (l_x p_x + l_y p_y))/w - z p_z / r^2
    chart terms: (r p_x - a p_y)/w, (a p_x + r p_y)/w, p_z / r
    dHam/dx_i = -H_i S^2 - 2 H S S_i          (dHam/dt = 0: stationary)
    dHam/dp_a = eta^{ab} p_b - 2 H S l^a
"""
from __future__ import annotations

import jax.numpy as jnp

from .hamiltonian import _flow_mixed, _kahan_add

N_STATE = 16


def _geom(x, y, z, mass, a, charge=0.0):
    """Shared Kerr-Schild geometry at one spatial point (elementwise).

    charge generalizes to Kerr-Newman: H = (M r - Q^2/2)/D (Debney-Kerr-
    Schild form) — the l vector and every other quantity are unchanged."""
    rho2 = x * x + y * y + z * z
    b = rho2 - a * a
    az = a * z
    s = jnp.sqrt(b * b + 4.0 * az * az)
    r2 = 0.5 * (b + s)
    r = jnp.sqrt(r2)
    inv_r = 1.0 / r
    inv_D = 1.0 / s
    w = r2 + a * a
    inv_w = 1.0 / w
    H = (mass * r - 0.5 * charge * charge) * inv_D
    lx = (r * x + a * y) * inv_w
    ly = (r * y - a * x) * inv_w
    lz = z * inv_r
    return r, inv_r, inv_D, b, w, inv_w, H, lx, ly, lz


def _kick_drift(x, y, z, pt, px, py, pz, mass, a, charge=0.0):
    """dHam/dq (x, y, z slots) and dHam/dp (all 4) at one phase point.

    Returns (kx, ky, kz, dt_, dx_, dy_, dz_): the kick covector components
    (dHam/dx_i, to be SUBTRACTED scaled by dt) and the drift vector
    (dHam/dp_a, to be ADDED scaled by dt).
    """
    r, inv_r, inv_D, b, w, inv_w, H, lx, ly, lz = _geom(x, y, z, mass, a,
                                                        charge)

    S = -pt + lx * px + ly * py + lz * pz
    HS2 = 2.0 * H * S

    # drifts: eta^{ab} p_b - 2 H S l^a  (l^t = -1)
    dt_ = -pt + HS2
    dx_ = px - HS2 * lx
    dy_ = py - HS2 * ly
    dz_ = pz - HS2 * lz

    # dr/dx_i and dD/dx_i (see module docstring)
    r_x = x * r * inv_D
    r_y = y * r * inv_D
    r_z = z * w * inv_r * inv_D
    D_x = 2.0 * x * b * inv_D
    D_y = 2.0 * y * b * inv_D
    D_z = 2.0 * z * (b + 2.0 * a * a) * inv_D

    # dH/dx_i = (M r_i - H D_i)/D  (Kerr-Newman general; at Q = 0 this is
    # the Kerr H (r_i/r - D_i/D) since there H = M r / D)
    H_x = (mass * r_x - H * D_x) * inv_D
    H_y = (mass * r_y - H * D_y) * inv_D
    H_z = (mass * r_z - H * D_z) * inv_D

    # dS/dx_i = r_i * G + chart term
    inv_r2 = inv_r * inv_r
    G = (x * px + y * py - 2.0 * r * (lx * px + ly * py)) * inv_w \
        - z * pz * inv_r2
    S_x = r_x * G + (r * px - a * py) * inv_w
    S_y = r_y * G + (a * px + r * py) * inv_w
    S_z = r_z * G + pz * inv_r

    S2 = S * S
    kx = -H_x * S2 - HS2 * S_x
    ky = -H_y * S2 - HS2 * S_y
    kz = -H_z * S2 - HS2 * S_z
    return kx, ky, kz, dt_, dx_, dy_, dz_


def _flow_a_ks(state, dt, mass, a, charge=0.0):
    """Flow A: metric at q1, kick p1 spatial slots, drift q2 (all 4).

    Same split as the Schwarzschild _flow_a (p_t is an exact invariant of
    A and B: the chart is stationary)."""
    (q1t, q1x, q1y, q1z, p1t, p1x, p1y, p1z,
     q2t, q2x, q2y, q2z, p2t, p2x, p2y, p2z) = state
    kx, ky, kz, dt_, dx_, dy_, dz_ = _kick_drift(
        q1x, q1y, q1z, p2t, p2x, p2y, p2z, mass, a, charge)
    p1x = p1x - dt * kx
    p1y = p1y - dt * ky
    p1z = p1z - dt * kz
    q2t = q2t + dt * dt_
    q2x = q2x + dt * dx_
    q2y = q2y + dt * dy_
    q2z = q2z + dt * dz_
    return (q1t, q1x, q1y, q1z, p1t, p1x, p1y, p1z,
            q2t, q2x, q2y, q2z, p2t, p2x, p2y, p2z)


def _flow_b_ks(state, dt, mass, a, charge=0.0):
    """Flow B: metric at q2, kick p2 spatial slots, drift q1 (all 4)."""
    (q1t, q1x, q1y, q1z, p1t, p1x, p1y, p1z,
     q2t, q2x, q2y, q2z, p2t, p2x, p2y, p2z) = state
    kx, ky, kz, dt_, dx_, dy_, dz_ = _kick_drift(
        q2x, q2y, q2z, p1t, p1x, p1y, p1z, mass, a, charge)
    p2x = p2x - dt * kx
    p2y = p2y - dt * ky
    p2z = p2z - dt * kz
    q1t = q1t + dt * dt_
    q1x = q1x + dt * dx_
    q1y = q1y + dt * dy_
    q1z = q1z + dt * dz_
    return (q1t, q1x, q1y, q1z, p1t, p1x, p1y, p1z,
            q2t, q2x, q2y, q2z, p2t, p2x, p2y, p2z)


def fantasy_step_ord2_ks(state, delta, mass, a, cos_w, sin_w, charge=0.0):
    """One order-2 FANTASY step in the Kerr-Schild chart:
    A(d/2) B(d/2) M(d) B(d/2) A(d/2), mixing rotation shared with the
    Schwarzschild path (physics.hamiltonian._flow_mixed)."""
    half = 0.5 * delta
    state = _flow_a_ks(state, half, mass, a, charge)
    state = _flow_b_ks(state, half, mass, a, charge)
    state = _flow_mixed(state, cos_w, sin_w)
    state = _flow_b_ks(state, half, mass, a, charge)
    state = _flow_a_ks(state, half, mass, a, charge)
    return state


# --- staggered (half-A-fused) step forms -----------------------------------
# Same algebra as physics.hamiltonian.make_staggered_flows: flow A reads
# only q1 and p2 and writes only p1 and q2, so the trailing and leading
# half-A of consecutive (sub)steps fuse into one A(bridge).  A further
# KS-specific consequence used by the kernel's blow-up guard: in the
# staggered state the (q1, p2) rows hold the EXACT plain-composition
# boundary values (A never writes them), so the null-invariant test runs
# on true values with no extra work.


def open_ks(state, d0, mass, a, charge=0.0):
    """s -> w: apply the pending opening half-A of the first substep."""
    return _flow_a_ks(state, 0.5 * d0, mass, a, charge)


def core_ks(state, delta, mass, a, cos_w, sin_w, bridge, charge=0.0):
    """One staggered (sub)step: B(d/2) M B(d/2) A(bridge)."""
    half = 0.5 * delta
    state = _flow_b_ks(state, half, mass, a, charge)
    state = _flow_mixed(state, cos_w, sin_w)
    state = _flow_b_ks(state, half, mass, a, charge)
    return _flow_a_ks(state, bridge, mass, a, charge)


def close_ks(state, d0, mass, a, charge=0.0):
    """w -> s: undo the pending half-A.  Numerically safe even on parked
    rays (the park points are regular chart points, and A cannot move q1)."""
    return _flow_a_ks(state, -0.5 * d0, mass, a, charge)


# ---------------------------------------------------------------------------
# Compensated (Kahan double-float32) Kerr-Schild flows
# ---------------------------------------------------------------------------
# Same construction as the Schwarzschild compensated equatorial family
# (physics.hamiltonian compensated section, which documents the error model
# and the increment-form mixing rotation): every state component carries a
# Kahan deficit row and each flow accumulates its increments through
# _kahan_add, so the O(sqrt(n) * eps * |state|) float32 rounding drift of
# the plain flows (eps * |x| ~ 2e-6 per step at the camera radius, which
# random-walks to the ~3 px prograde-shadow-edge error measured on chip at
# 256^2/30k steps) collapses to per-increment rounding (~1e-8 over the
# budget).  The KS chart has no equatorial reduction — rays wind in all
# three Cartesian coordinates — so ALL 16 rows are compensated.
#
# Compensated state layout: a 32-tuple — the 16-row layout followed by its
# 16 deficit rows (deficit of row i at 16 + i), so the row machinery
# (packing, masking, early exit) is shared with the plain layout.
#
# The geometry (_kick_drift) is evaluated on the raw accumulator rows s,
# not the best estimate s - c: the deficit is <= 1 ulp of s, far below the
# truncation error of the flow itself, and folding it would cost 16 extra
# subtractions per flow for nothing.

N_STATE_KSC = 32


def pack_state_ksc(q0, p0):
    """(N,4) q0/p0 -> 32-tuple: KS 16-tuple + zero deficit rows."""
    comps = [q0[..., a] for a in range(4)] + [p0[..., a] for a in range(4)]
    hi = tuple(comps + comps)
    zero = jnp.zeros_like(hi[0])
    return hi + tuple(zero for _ in range(N_STATE))


def unpack_ksc(state):
    """Best-estimate 16-tuple from a compensated 32-tuple (s - c)."""
    return tuple(state[i] - state[N_STATE + i] for i in range(N_STATE))


def _flow_a_ksc(state, dt, mass, a, charge=0.0):
    """Increment-form flow A with Kahan accumulation (metric at q1,
    kick p1 spatial slots, drift q2) — same physics as _flow_a_ks."""
    (q1t, q1x, q1y, q1z, p1t, p1x, p1y, p1z,
     q2t, q2x, q2y, q2z, p2t, p2x, p2y, p2z) = state[:16]
    c = list(state[16:])
    kx, ky, kz, dt_, dx_, dy_, dz_ = _kick_drift(
        q1x, q1y, q1z, p2t, p2x, p2y, p2z, mass, a, charge)
    p1x, c[5] = _kahan_add(p1x, c[5], -dt * kx)
    p1y, c[6] = _kahan_add(p1y, c[6], -dt * ky)
    p1z, c[7] = _kahan_add(p1z, c[7], -dt * kz)
    q2t, c[8] = _kahan_add(q2t, c[8], dt * dt_)
    q2x, c[9] = _kahan_add(q2x, c[9], dt * dx_)
    q2y, c[10] = _kahan_add(q2y, c[10], dt * dy_)
    q2z, c[11] = _kahan_add(q2z, c[11], dt * dz_)
    return (q1t, q1x, q1y, q1z, p1t, p1x, p1y, p1z,
            q2t, q2x, q2y, q2z, p2t, p2x, p2y, p2z) + tuple(c)


def _flow_b_ksc(state, dt, mass, a, charge=0.0):
    """Increment-form flow B with Kahan accumulation (metric at q2,
    kick p2 spatial slots, drift q1)."""
    (q1t, q1x, q1y, q1z, p1t, p1x, p1y, p1z,
     q2t, q2x, q2y, q2z, p2t, p2x, p2y, p2z) = state[:16]
    c = list(state[16:])
    kx, ky, kz, dt_, dx_, dy_, dz_ = _kick_drift(
        q2x, q2y, q2z, p1t, p1x, p1y, p1z, mass, a, charge)
    p2x, c[13] = _kahan_add(p2x, c[13], -dt * kx)
    p2y, c[14] = _kahan_add(p2y, c[14], -dt * ky)
    p2z, c[15] = _kahan_add(p2z, c[15], -dt * kz)
    q1t, c[0] = _kahan_add(q1t, c[0], dt * dt_)
    q1x, c[1] = _kahan_add(q1x, c[1], dt * dx_)
    q1y, c[2] = _kahan_add(q1y, c[2], dt * dy_)
    q1z, c[3] = _kahan_add(q1z, c[3], dt * dz_)
    return (q1t, q1x, q1y, q1z, p1t, p1x, p1y, p1z,
            q2t, q2x, q2y, q2z, p2t, p2x, p2y, p2z) + tuple(c)


def _flow_mixed_ksc(state, omc_w, sin_w):
    """Mixing rotation in increment form: omc_w = 1 - cos(2*omega*delta).

    Increment-form twin of hamiltonian._flow_mixed over all four
    components; the true copy difference folds in the deficits (true value
    = s - c), exactly as hamiltonian._flow_mixed_eqc does — the mixing flow
    is where sub-ulp copy separation is physically meaningful."""
    hi = state[:16]
    c = list(state[16:])
    q1, p1 = hi[0:4], hi[4:8]
    q2, p2 = hi[8:12], hi[12:16]
    new = list(hi)
    for i in range(4):
        q_dif = (q1[i] - q2[i]) - (c[i] - c[8 + i])
        p_dif = (p1[i] - p2[i]) - (c[4 + i] - c[12 + i])
        dq1 = 0.5 * (sin_w * p_dif - omc_w * q_dif)
        dp1 = 0.5 * (-sin_w * q_dif - omc_w * p_dif)
        new[i], c[i] = _kahan_add(q1[i], c[i], dq1)
        new[4 + i], c[4 + i] = _kahan_add(p1[i], c[4 + i], dp1)
        new[8 + i], c[8 + i] = _kahan_add(q2[i], c[8 + i], -dq1)
        new[12 + i], c[12 + i] = _kahan_add(p2[i], c[12 + i], -dp1)
    return tuple(new) + tuple(c)


def open_ksc(state, d0, mass, a, charge=0.0):
    """s -> w: apply the pending opening half-A (compensated layout)."""
    return _flow_a_ksc(state, 0.5 * d0, mass, a, charge)


def core_ksc(state, delta, mass, a, omc_w, sin_w, bridge, charge=0.0):
    """One compensated staggered (sub)step: B(d/2) M B(d/2) A(bridge).

    NOTE the mixing argument is ONE-MINUS-COS of the mixing angle, not cos
    as in core_ks (the increment-form rotation needs it)."""
    half = 0.5 * delta
    state = _flow_b_ksc(state, half, mass, a, charge)
    state = _flow_mixed_ksc(state, omc_w, sin_w)
    state = _flow_b_ksc(state, half, mass, a, charge)
    return _flow_a_ksc(state, bridge, mass, a, charge)


def close_ksc(state, d0, mass, a, charge=0.0):
    """w -> s: undo the pending half-A (compensated layout)."""
    return _flow_a_ksc(state, -0.5 * d0, mass, a, charge)


def hamiltonian_ks(x, y, z, pt, px, py, pz, mass, a, charge=0.0):
    """Ham = 1/2 eta^{ab} p_a p_b - H S^2, elementwise — the null invariant
    used by the blow-up guard (0 at the camera, destroyed immediately by an
    under-resolved kick; see engine.integrate_generic.guard_cartesian)."""
    _, _, _, _, _, _, H, lx, ly, lz = _geom(x, y, z, mass, a, charge)
    S = -pt + lx * px + ly * py + lz * pz
    return 0.5 * (-pt * pt + px * px + py * py + pz * pz) - H * S * S


def ks_radius_c(x, y, z, a):
    """BL radius from KS Cartesian coords, elementwise (component twin of
    physics.spacetime.ks_radius)."""
    rho2 = x * x + y * y + z * z
    b = rho2 - a * a
    return jnp.sqrt(0.5 * (b + jnp.sqrt(b * b + 4.0 * a * a * z * z)))

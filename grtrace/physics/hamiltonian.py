"""FANTASY order-2 symplectic flows for Schwarzschild null geodesics.

Phase-space-doubled Hamiltonian integrator (Christian & Chan 2021,
arXiv:2010.02237) specialized to the analytic Schwarzschild metric — the
array-program counterpart of the reference's Numba-CUDA device functions
(reference: simulation/cuda_geodesic.py:476-575).

Design notes:
  * State is a tuple of 16 component arrays (4 components x {q1, p1, q2, p2})
    instead of per-thread 4-vectors.  Each component array can be any shape —
    (N,) in the XLA `vmap`-free batched path, or one (BLOCK,) slice per
    program inside the Pallas GPU kernel — so the *same* flow code serves
    both backends and the float64 oracle.
  * Because the metric is diagonal, static and axisymmetric, dH/dq is non-zero
    only for the r and theta slots; p_t and p_phi are exact invariants of
    flows A and B and are left untouched (the reference computes and subtracts
    an explicit 0.0 for them, cuda_geodesic.py:500-525).
  * The mixed-flow rotation angle 2*omega*delta is constant across steps, so
    its sin/cos are hoisted out of the integration loop (the reference
    recomputes them every step, cuda_geodesic.py:545-546).

State layout convention used throughout the engine:
    state = (q1t, q1r, q1th, q1ph,
             p1t, p1r, p1th, p1ph,
             q2t, q2r, q2th, q2ph,
             p2t, p2r, p2th, p2ph)
"""
from __future__ import annotations

import jax.numpy as jnp

from .metric import contravariant_diag, dcontravariant_dr, dcontravariant_dth

N_STATE = 16


def pack_state(q0, p0):
    """(N,4) q0/p0 -> 16-tuple of (N,) component arrays with q2=q1, p2=p1.

    The phase-space doubling initializes both copies identically
    (reference: simulation/cuda_geodesic.py:590-594).
    """
    comps = [q0[..., a] for a in range(4)] + [p0[..., a] for a in range(4)]
    return tuple(comps + comps)


def unpack_q1(state):
    """First copy's position as (..., 4) — the integrator's output
    (reference: simulation/cuda_geodesic.py:601-602 returns q1)."""
    return jnp.stack(state[0:4], axis=-1)


def unpack_p1(state):
    return jnp.stack(state[4:8], axis=-1)


def _flow_a(state, dt, rs):
    """Flow A: update p1 (r,theta slots) and drift q2, using metric at q1.

    Mirrors reference _flow_A_dev (simulation/cuda_geodesic.py:500-513):
        p1_i <- p1_i - dt * 0.5 * (d_i g^{ab}(q1)) p2_a p2_b
        q2^a <- q2^a + dt * g^{ab}(q1) p2_b
    """
    (q1t, q1r, q1th, q1ph,
     p1t, p1r, p1th, p1ph,
     q2t, q2r, q2th, q2ph,
     p2t, p2r, p2th, p2ph) = state

    d_tt, d_rr, d_thth, d_phph = dcontravariant_dr(q1r, q1th, rs)
    dH_r = 0.5 * (d_tt * p2t * p2t + d_rr * p2r * p2r
                  + d_thth * p2th * p2th + d_phph * p2ph * p2ph)
    dH_th = 0.5 * dcontravariant_dth(q1r, q1th, rs) * p2ph * p2ph

    p1r = p1r - dt * dH_r
    p1th = p1th - dt * dH_th

    g_tt, g_rr, g_thth, g_phph = contravariant_diag(q1r, q1th, rs)
    q2t = q2t + dt * g_tt * p2t
    q2r = q2r + dt * g_rr * p2r
    q2th = q2th + dt * g_thth * p2th
    q2ph = q2ph + dt * g_phph * p2ph

    return (q1t, q1r, q1th, q1ph, p1t, p1r, p1th, p1ph,
            q2t, q2r, q2th, q2ph, p2t, p2r, p2th, p2ph)


def _flow_b(state, dt, rs):
    """Flow B: update p2 (r,theta slots) and drift q1, using metric at q2.

    Mirrors reference _flow_B_dev (simulation/cuda_geodesic.py:515-525).
    """
    (q1t, q1r, q1th, q1ph,
     p1t, p1r, p1th, p1ph,
     q2t, q2r, q2th, q2ph,
     p2t, p2r, p2th, p2ph) = state

    d_tt, d_rr, d_thth, d_phph = dcontravariant_dr(q2r, q2th, rs)
    dH_r = 0.5 * (d_tt * p1t * p1t + d_rr * p1r * p1r
                  + d_thth * p1th * p1th + d_phph * p1ph * p1ph)
    dH_th = 0.5 * dcontravariant_dth(q2r, q2th, rs) * p1ph * p1ph

    p2r = p2r - dt * dH_r
    p2th = p2th - dt * dH_th

    g_tt, g_rr, g_thth, g_phph = contravariant_diag(q2r, q2th, rs)
    q1t = q1t + dt * g_tt * p1t
    q1r = q1r + dt * g_rr * p1r
    q1th = q1th + dt * g_thth * p1th
    q1ph = q1ph + dt * g_phph * p1ph

    return (q1t, q1r, q1th, q1ph, p1t, p1r, p1th, p1ph,
            q2t, q2r, q2th, q2ph, p2t, p2r, p2th, p2ph)


def _flow_mixed(state, cos_w, sin_w):
    """Mixing rotation between the two phase-space copies.

    Mirrors reference _flow_mixed_dev (simulation/cuda_geodesic.py:527-566)
    with the rotation sin/cos precomputed once (they depend only on
    2*omega*delta, which is constant for fixed-step integration).
    """
    q1 = state[0:4]
    p1 = state[4:8]
    q2 = state[8:12]
    p2 = state[12:16]

    new = [None] * N_STATE
    for a in range(4):
        q_sum = q1[a] + q2[a]
        q_dif = q1[a] - q2[a]
        p_sum = p1[a] + p2[a]
        p_dif = p1[a] - p2[a]
        new[a] = 0.5 * (q_sum + q_dif * cos_w + p_dif * sin_w)        # q1'
        new[4 + a] = 0.5 * (p_sum + p_dif * cos_w - q_dif * sin_w)    # p1'
        new[8 + a] = 0.5 * (q_sum - q_dif * cos_w - p_dif * sin_w)    # q2'
        new[12 + a] = 0.5 * (p_sum - p_dif * cos_w + q_dif * sin_w)   # p2'
    return tuple(new)


def fantasy_step_ord2(state, delta, rs, cos_w, sin_w):
    """One order-2 step: A(d/2) B(d/2) M(d) B(d/2) A(d/2).

    Mirrors reference _fantasy_step_ord2 (simulation/cuda_geodesic.py:568-575).
    cos_w/sin_w are cos/sin(2*omega*delta), precomputed by the caller.
    """
    half = 0.5 * delta
    state = _flow_a(state, half, rs)
    state = _flow_b(state, half, rs)
    state = _flow_mixed(state, cos_w, sin_w)
    state = _flow_b(state, half, rs)
    state = _flow_a(state, half, rs)
    return state


def _flow_a_fused(state, dt, rs):
    """flow A with shared reciprocals/trig — identical formulas to _flow_a
    with subexpressions factored: 3 divisions + 1 sin + 1 cos
    per flow instead of ~10 divisions (the reference recomputes every metric
    entry from scratch per flow, cuda_geodesic.py:432-474)."""
    (q1t, q1r, q1th, q1ph,
     p1t, p1r, p1th, p1ph,
     q2t, q2r, q2th, q2ph,
     p2t, p2r, p2th, p2ph) = state

    r = q1r
    inv_r = 1.0 / r
    inv_r2 = inv_r * inv_r
    inv_r3 = inv_r2 * inv_r
    inv_rms = 1.0 / (r - rs)
    sin_th = jnp.sin(q1th)
    cos_th = jnp.cos(q1th)
    inv_sin = 1.0 / sin_th
    inv_sin2 = inv_sin * inv_sin

    pt2 = p2t * p2t
    pr2 = p2r * p2r
    pth2 = p2th * p2th
    pph2_s = p2ph * p2ph * inv_sin2

    dH_r = (0.5 * rs) * (inv_rms * inv_rms * pt2 + inv_r2 * pr2) \
        - inv_r3 * (pth2 + pph2_s)
    dH_th = -cos_th * inv_sin * inv_r2 * pph2_s

    p1r = p1r - dt * dH_r
    p1th = p1th - dt * dH_th

    q2t = q2t - (dt * r * inv_rms) * p2t          # g^tt = -r/(r-rs)
    q2r = q2r + dt * (1.0 - rs * inv_r) * p2r     # g^rr = 1 - rs/r
    q2th = q2th + (dt * inv_r2) * p2th
    q2ph = q2ph + (dt * inv_r2 * inv_sin2) * p2ph

    return (q1t, q1r, q1th, q1ph, p1t, p1r, p1th, p1ph,
            q2t, q2r, q2th, q2ph, p2t, p2r, p2th, p2ph)


def _flow_b_fused(state, dt, rs):
    """flow B twin of _flow_a_fused (metric at q2, drift q1, kick p2)."""
    (q1t, q1r, q1th, q1ph,
     p1t, p1r, p1th, p1ph,
     q2t, q2r, q2th, q2ph,
     p2t, p2r, p2th, p2ph) = state

    r = q2r
    inv_r = 1.0 / r
    inv_r2 = inv_r * inv_r
    inv_r3 = inv_r2 * inv_r
    inv_rms = 1.0 / (r - rs)
    sin_th = jnp.sin(q2th)
    cos_th = jnp.cos(q2th)
    inv_sin = 1.0 / sin_th
    inv_sin2 = inv_sin * inv_sin

    pt2 = p1t * p1t
    pr2 = p1r * p1r
    pth2 = p1th * p1th
    pph2_s = p1ph * p1ph * inv_sin2

    dH_r = (0.5 * rs) * (inv_rms * inv_rms * pt2 + inv_r2 * pr2) \
        - inv_r3 * (pth2 + pph2_s)
    dH_th = -cos_th * inv_sin * inv_r2 * pph2_s

    p2r = p2r - dt * dH_r
    p2th = p2th - dt * dH_th

    q1t = q1t - (dt * r * inv_rms) * p1t
    q1r = q1r + dt * (1.0 - rs * inv_r) * p1r
    q1th = q1th + (dt * inv_r2) * p1th
    q1ph = q1ph + (dt * inv_r2 * inv_sin2) * p1ph

    return (q1t, q1r, q1th, q1ph, p1t, p1r, p1th, p1ph,
            q2t, q2r, q2th, q2ph, p2t, p2r, p2th, p2ph)


def fantasy_step_ord2_fused(state, delta, rs, cos_w, sin_w):
    """Fused-flow variant of fantasy_step_ord2 (same algorithm, fewer
    divisions).  Bit-for-bit identical to the unfused step is NOT guaranteed
    (different op ordering -> last-ulp differences), but tests pin agreement
    to float32 roundoff on weak-field arcs."""
    half = 0.5 * delta
    state = _flow_a_fused(state, half, rs)
    state = _flow_b_fused(state, half, rs)
    state = _flow_mixed(state, cos_w, sin_w)
    state = _flow_b_fused(state, half, rs)
    state = _flow_a_fused(state, half, rs)
    return state


# ---------------------------------------------------------------------------
# Equatorial specialization
# ---------------------------------------------------------------------------
# The camera folds every pixel ray into the equatorial plane before
# integration (the beta-rotation trick, reference utils.py:103-113), so the
# *entire render pipeline* integrates rays with theta == pi/2 and p_theta == 0
# exactly.  Those are invariants of all three flows (dH/dtheta has a cos(th)
# factor, the theta drift is g^{thth} p_th, and the mixing rotation preserves
# equal components), so the hot kernel can drop the theta degrees of freedom
# entirely: 12 state rows instead of 16, TWO divisions per flow and ZERO
# transcendentals in the loop body.  Exactness caveat: the generic path
# evaluates sin/cos at fl(pi/2) (=1-eps / ~6e-17) so the two paths differ at
# roundoff level — same equivalence class as op reordering.
#
# Equatorial state layout:
#     (q1t, q1r, q1ph, p1t, p1r, p1ph, q2t, q2r, q2ph, p2t, p2r, p2ph)

N_STATE_EQ = 12


def pack_state_eq(q0, p0):
    """(N,4) q0/p0 (theta slots dropped) -> 12-tuple with q2=q1, p2=p1."""
    comps = [q0[..., 0], q0[..., 1], q0[..., 3],
             p0[..., 0], p0[..., 1], p0[..., 3]]
    return tuple(comps + comps)


def _flow_a_eq(state, dt, rs):
    (q1t, q1r, q1ph, p1t, p1r, p1ph,
     q2t, q2r, q2ph, p2t, p2r, p2ph) = state
    r = q1r
    inv_r = 1.0 / r
    inv_r2 = inv_r * inv_r
    inv_rms = 1.0 / (r - rs)
    pph2 = p2ph * p2ph
    dH_r = (0.5 * rs) * (inv_rms * inv_rms * p2t * p2t
                         + inv_r2 * p2r * p2r) - inv_r2 * inv_r * pph2
    p1r = p1r - dt * dH_r
    q2t = q2t - (dt * r * inv_rms) * p2t
    q2r = q2r + dt * (1.0 - rs * inv_r) * p2r
    q2ph = q2ph + (dt * inv_r2) * p2ph
    return (q1t, q1r, q1ph, p1t, p1r, p1ph,
            q2t, q2r, q2ph, p2t, p2r, p2ph)


def _flow_b_eq(state, dt, rs):
    (q1t, q1r, q1ph, p1t, p1r, p1ph,
     q2t, q2r, q2ph, p2t, p2r, p2ph) = state
    r = q2r
    inv_r = 1.0 / r
    inv_r2 = inv_r * inv_r
    inv_rms = 1.0 / (r - rs)
    pph2 = p1ph * p1ph
    dH_r = (0.5 * rs) * (inv_rms * inv_rms * p1t * p1t
                         + inv_r2 * p1r * p1r) - inv_r2 * inv_r * pph2
    p2r = p2r - dt * dH_r
    q1t = q1t - (dt * r * inv_rms) * p1t
    q1r = q1r + dt * (1.0 - rs * inv_r) * p1r
    q1ph = q1ph + (dt * inv_r2) * p1ph
    return (q1t, q1r, q1ph, p1t, p1r, p1ph,
            q2t, q2r, q2ph, p2t, p2r, p2ph)


def _flow_mixed_eq(state, cos_w, sin_w):
    q1 = state[0:3]
    p1 = state[3:6]
    q2 = state[6:9]
    p2 = state[9:12]
    new = [None] * N_STATE_EQ
    for a in range(3):
        q_sum = q1[a] + q2[a]
        q_dif = q1[a] - q2[a]
        p_sum = p1[a] + p2[a]
        p_dif = p1[a] - p2[a]
        new[a] = 0.5 * (q_sum + q_dif * cos_w + p_dif * sin_w)
        new[3 + a] = 0.5 * (p_sum + p_dif * cos_w - q_dif * sin_w)
        new[6 + a] = 0.5 * (q_sum - q_dif * cos_w - p_dif * sin_w)
        new[9 + a] = 0.5 * (p_sum - p_dif * cos_w + q_dif * sin_w)
    return tuple(new)


def fantasy_step_ord2_eq(state, delta, rs, cos_w, sin_w):
    """Equatorial order-2 step: trig-free, 2 divisions per flow."""
    half = 0.5 * delta
    state = _flow_a_eq(state, half, rs)
    state = _flow_b_eq(state, half, rs)
    state = _flow_mixed_eq(state, cos_w, sin_w)
    state = _flow_b_eq(state, half, rs)
    state = _flow_a_eq(state, half, rs)
    return state


# ---------------------------------------------------------------------------
# Compensated (Kahan double-float32) equatorial specialization
# ---------------------------------------------------------------------------
# Plain float32 integration accumulates O(sqrt(n) * eps * |state|) rounding
# drift: adding a ~1e-4 step increment to a ~3-radian phi rounds at
# eps*|phi| ~ 2e-7 per step, which random-walks to ~1.5e-5 over the ~10^4
# steps of an escaping headline ray — right at the 1e-5 escape-direction
# target (BASELINE.md), measured on chip against the float64 oracle.  The
# fix is classic compensated summation with FEEDBACK (Kahan): every state
# component carries a deficit row c, and each flow is rewritten in
# *increment form* so its contribution is added via
#     y = inc - c;  t = s + y;  c = (t - s) - y;  s = t
# The dynamics read s, which now stays within ~1 ulp of the true sum instead
# of drifting, so the remaining error is the per-step increment rounding
# (~eps * |inc|), which random-walks to ~1e-8 — two orders of magnitude
# inside the target.  Cost: 4 extra ops per accumulated component
# (~1.5x the flow flops), no extra divisions, no transcendentals.
#
# The mixing rotation is reformulated with one_minus_cos = 2*sin^2(omega*d)
# (computed ONCE per trace, outside the loop) so that its increments
#     dq1 = 0.5*(sin_w*p_dif - omc*q_dif) = -dq2
#     dp1 = 0.5*(-sin_w*q_dif - omc*p_dif) = -dp2
# are small quantities: the catastrophic 1-ulp loss of computing
# 0.5*(q_sum + q_dif*cos + ...) at |q| magnitude never happens.
#
# Compensated state layout: a 24-tuple — the 12-row equatorial layout
# followed by its 12 deficit rows, so the kernel's row machinery (packing,
# masking, early exit) is shared with the uncompensated layouts.
#
# EVERY row's compensation is load-bearing — including the t rows, whose
# coordinate value never reaches any output.  The copies' q_t difference
# feeds p_t through the mixing rotation (dp_t = -0.5(sin*qt_dif +
# omc*pt_dif)) and p_t feeds dH_r quadratically, so uncompensated q_t
# rounding (eps*|t| with |t| growing to ~10^3) random-walks the dynamics.
# Measured on chip at the 200k-step headline budget vs the f64 oracle:
# plain-t variant max escape error 1.6e-5 (BREAKS the 1e-5 target),
# full compensation 2.8e-6.  Do not "optimize" the t rows away.

N_STATE_EQC = 24


def _kahan_add(s, c, inc):
    """One compensated accumulate: returns (s', c') with s' ~ s + inc and
    the rounding deficit carried in c' (subtract c' to recover the true
    sum).  MUST stay exactly this op sequence — do not 'simplify'."""
    y = inc - c
    t = s + y
    c_new = (t - s) - y
    return t, c_new


def pack_state_eqc(q0, p0):
    """(N,4) q0/p0 -> 24-tuple: equatorial 12-tuple + zero deficit rows."""
    hi = pack_state_eq(q0, p0)
    zero = jnp.zeros_like(hi[0])
    return hi + tuple(zero for _ in range(N_STATE_EQ))


def unpack_eqc(state):
    """Best-estimate 12-tuple from a compensated 24-tuple (s - c)."""
    return tuple(state[i] - state[N_STATE_EQ + i] for i in range(N_STATE_EQ))


def _flow_a_eqc(state, dt, rs):
    """Increment-form flow A with Kahan accumulation (metric at q1,
    kick p1r, drift q2) — same physics as _flow_a_eq."""
    (q1t, q1r, q1ph, p1t, p1r, p1ph,
     q2t, q2r, q2ph, p2t, p2r, p2ph) = state[:12]
    c = list(state[12:])

    r = q1r
    inv_r = 1.0 / r
    inv_r2 = inv_r * inv_r
    inv_rms = 1.0 / (r - rs)
    dH_r = (0.5 * rs) * (inv_rms * inv_rms * p2t * p2t
                         + inv_r2 * p2r * p2r) - inv_r2 * inv_r * (p2ph * p2ph)

    p1r, c[4] = _kahan_add(p1r, c[4], -dt * dH_r)
    q2t, c[6] = _kahan_add(q2t, c[6], -(dt * r * inv_rms) * p2t)
    q2r, c[7] = _kahan_add(q2r, c[7], dt * (1.0 - rs * inv_r) * p2r)
    q2ph, c[8] = _kahan_add(q2ph, c[8], (dt * inv_r2) * p2ph)

    return (q1t, q1r, q1ph, p1t, p1r, p1ph,
            q2t, q2r, q2ph, p2t, p2r, p2ph) + tuple(c)


def _flow_b_eqc(state, dt, rs):
    """Increment-form flow B with Kahan accumulation (metric at q2,
    kick p2r, drift q1)."""
    (q1t, q1r, q1ph, p1t, p1r, p1ph,
     q2t, q2r, q2ph, p2t, p2r, p2ph) = state[:12]
    c = list(state[12:])

    r = q2r
    inv_r = 1.0 / r
    inv_r2 = inv_r * inv_r
    inv_rms = 1.0 / (r - rs)
    dH_r = (0.5 * rs) * (inv_rms * inv_rms * p1t * p1t
                         + inv_r2 * p1r * p1r) - inv_r2 * inv_r * (p1ph * p1ph)

    p2r, c[10] = _kahan_add(p2r, c[10], -dt * dH_r)
    q1t, c[0] = _kahan_add(q1t, c[0], -(dt * r * inv_rms) * p1t)
    q1r, c[1] = _kahan_add(q1r, c[1], dt * (1.0 - rs * inv_r) * p1r)
    q1ph, c[2] = _kahan_add(q1ph, c[2], (dt * inv_r2) * p1ph)

    return (q1t, q1r, q1ph, p1t, p1r, p1ph,
            q2t, q2r, q2ph, p2t, p2r, p2ph) + tuple(c)


def _flow_mixed_eqc(state, omc_w, sin_w):
    """Mixing rotation in increment form: omc_w = 1 - cos(2*omega*delta).

    The true copy difference includes the deficits (true value = s - c), so
    the dif terms fold them in — the mixing flow is exactly the place where
    sub-ulp copy separation is physically meaningful.
    """
    hi = state[:12]
    c = list(state[12:])
    q1, p1 = hi[0:3], hi[3:6]
    q2, p2 = hi[6:9], hi[9:12]
    new = list(hi)
    for a in range(3):
        q_dif = (q1[a] - q2[a]) - (c[a] - c[6 + a])
        p_dif = (p1[a] - p2[a]) - (c[3 + a] - c[9 + a])
        dq1 = 0.5 * (sin_w * p_dif - omc_w * q_dif)
        dp1 = 0.5 * (-sin_w * q_dif - omc_w * p_dif)
        new[a], c[a] = _kahan_add(q1[a], c[a], dq1)
        new[3 + a], c[3 + a] = _kahan_add(p1[a], c[3 + a], dp1)
        new[6 + a], c[6 + a] = _kahan_add(q2[a], c[6 + a], -dq1)
        new[9 + a], c[9 + a] = _kahan_add(p2[a], c[9 + a], -dp1)
    return tuple(new) + tuple(c)


def fantasy_step_ord2_eqc(state, delta, rs, omc_w, sin_w):
    """Compensated equatorial order-2 step: A(d/2) B(d/2) M(d) B(d/2) A(d/2).

    NOTE the third trig argument is ONE-MINUS-COS of the mixing angle (use
    substep_schedule(..., omc=True)), not cos as in the uncompensated steps.
    """
    half = 0.5 * delta
    state = _flow_a_eqc(state, half, rs)
    state = _flow_b_eqc(state, half, rs)
    state = _flow_mixed_eqc(state, omc_w, sin_w)
    state = _flow_b_eqc(state, half, rs)
    state = _flow_a_eqc(state, half, rs)
    return state


# ---------------------------------------------------------------------------
# Staggered (half-A-fused) step forms
# ---------------------------------------------------------------------------
# The composed sequence  A(d/2) B(d/2) M B(d/2) A(d/2) | A(d/2) B ...  has
# adjacent A flows at every (sub)step boundary.  Flow A reads only q1 and p2
# and writes only p1 and q2, so two back-to-back A flows see identical
# inputs and  A(x) . A(y) == A(x+y)  exactly (in exact arithmetic; in
# floating point the difference is one rounding of the increment).  The hot
# integrators therefore evolve the STAGGERED state  w = A(d0/2)(s):
#
#     opening:   w_0 = A(d0/2)(s_0)                      (once, masked)
#     core step: w   -> B(d_j/2) M_j B(d_j/2) A(bridge_j)(w)
#                with bridge_j = (d_j + d_{(j+1) mod n})/2
#     closing:   s_K = A(-d0/2)(w_K)                     (once, masked)
#
# which runs ONE A flow per substep instead of two — ~13% fewer ops for
# the equatorial layouts.  Every interior state coincides with the plain
# composition in exact arithmetic, and because A never writes q1, the
# capture/escape/guard tests (all functions of q1_r) see the same values at
# every step boundary.  A kernel and its XLA twin built from the same
# (open, core, close) functions remain bit-identical to each other.


def make_staggered_flows(flow_a, flow_b, flow_m):
    """(open, core, close) staggered-step functions for a flow family."""

    def open_fn(state, d0, rs):
        """s -> w: apply the pending opening half-A of the first substep."""
        return flow_a(state, 0.5 * d0, rs)

    def core_fn(state, delta, rs, cw, sw, bridge):
        """One staggered (sub)step: B(d/2) M B(d/2) A(bridge).

        cw is cos(2 omega d) for the plain families and one_minus_cos for
        the compensated one — whatever the family's mixing flow expects."""
        half = 0.5 * delta
        state = flow_b(state, half, rs)
        state = flow_m(state, cw, sw)
        state = flow_b(state, half, rs)
        return flow_a(state, bridge, rs)

    def close_fn(state, d0, rs):
        """w -> s: undo the pending half-A.  MUST be masked off for rays
        parked at exactly r == rs (the guard's capture sentinel): flow A
        divides by r - rs there."""
        return flow_a(state, -0.5 * d0, rs)

    return open_fn, core_fn, close_fn


staggered_eq = make_staggered_flows(_flow_a_eq, _flow_b_eq, _flow_mixed_eq)
staggered_eqc = make_staggered_flows(_flow_a_eqc, _flow_b_eqc,
                                     _flow_mixed_eqc)


def bridge_sizes(deltas):
    """Trailing-A sizes for the staggered schedule: bridge_j spans this
    substep's closing half and the NEXT substep's opening half (cyclically —
    the last substep bridges into the next composed step's first)."""
    n = len(deltas)
    return tuple(0.5 * (deltas[j] + deltas[(j + 1) % n]) for j in range(n))


# ---------------------------------------------------------------------------
# Higher-order composition (orders 4, 6, 8)
# ---------------------------------------------------------------------------
# The reference CLI accepts --order {2,4,6,8} (reference config.py:14) but
# only order 2 exists on its GPU (cuda_geodesic.py:569).  Here the higher
# orders are implemented for real, by the triple-jump (Yoshida/Suzuki)
# composition the FANTASY paper itself prescribes (Christian & Chan 2021,
# arXiv:2010.02237 section 2.3): an order-(n+2) step is three order-n steps
# with substep sizes (z1*d, z0*d, z1*d), z1 = 1/(2 - 2^(1/(n+1))),
# z0 = -2^(1/(n+1)) * z1.  Order 4 = 3 base steps, 6 = 9, 8 = 27.

_VALID_ORDERS = (2, 4, 6, 8)


def yoshida_gammas(order: int):
    """Static substep-size fractions for the composed order-n step.

    Returns a tuple of python floats summing to 1.0; length 3^((order-2)/2).
    """
    if order not in _VALID_ORDERS:
        raise ValueError(f"order must be one of {_VALID_ORDERS}, got {order}")
    gammas = [1.0]
    for k in range(1, (order - 2) // 2 + 1):
        z = 2.0 ** (1.0 / (2 * k + 1))
        z1 = 1.0 / (2.0 - z)
        z0 = -z * z1
        gammas = ([g * z1 for g in gammas] + [g * z0 for g in gammas]
                  + [g * z1 for g in gammas])
    return tuple(gammas)


def substep_schedule(delta, omega, order: int, omc=False):
    """Per-substep (delta_i, cos_i, sin_i) triples for a composed step.

    delta/omega may be traced scalars; the gammas are static.  cos/sin of
    the mixing angle 2*omega*delta_i are hoisted here, once per trace, so
    the integration loop body stays transcendental-free for any order.

    omc=True replaces cos_i with one_minus_cos_i = 2*sin^2(omega*delta_i)
    (computed without the catastrophic 1-cos cancellation) — the form the
    compensated steps (fantasy_step_ord2_eqc) need.
    """
    subs = []
    for g in yoshida_gammas(order):
        d_i = g * delta
        if omc:
            sh = jnp.sin(omega * d_i)
            subs.append((d_i, 2.0 * sh * sh, jnp.sin(2.0 * omega * d_i)))
        else:
            angle = 2.0 * omega * d_i
            subs.append((d_i, jnp.cos(angle), jnp.sin(angle)))
    return tuple(subs)


def fantasy_step(state, subs, rs, step2_fn=fantasy_step_ord2):
    """One composed step of any order: apply step2_fn per substep schedule.

    `subs` comes from substep_schedule; with order=2 this is exactly one
    fantasy_step_ord2.  step2_fn selects the flow variant (generic, fused,
    or equatorial via the matching 12-row step).
    """
    for d_i, cos_i, sin_i in subs:
        state = step2_fn(state, d_i, rs, cos_i, sin_i)
    return state


def hamiltonian(q, p, rs):
    """H = 0.5 g^{ab}(q) p_a p_b — a conserved diagnostic (0 for null rays).

    q, p: (..., 4).  Used by tests and the NaN/drift sanitizer.
    """
    g_tt, g_rr, g_thth, g_phph = contravariant_diag(q[..., 1], q[..., 2], rs)
    return 0.5 * (g_tt * p[..., 0] ** 2 + g_rr * p[..., 1] ** 2
                  + g_thth * p[..., 2] ** 2 + g_phph * p[..., 3] ** 2)

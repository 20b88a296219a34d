"""Batched geodesic integration for any metric (Kerr, ...).

Generic-metric twin of engine.integrate: the same masked `lax.while_loop`
early-exit semantics (reference simulation/cuda_geodesic.py:579-602), but the
step comes from physics.spacetime's autodiff flows, vmapped over the ray
batch.  Used for Kerr rays, the EinsteinPy-compat `Nulllike(metric="Kerr")`
path, and as the engine for any future metric — one function per spacetime,
no new kernels.

The Schwarzschild render pipeline stays on the specialized fast paths
(engine.integrate / integrate_pallas); this engine trades their hand-tuned
layouts for generality.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..physics.hamiltonian import substep_schedule
from ..physics.spacetime import (COORDS, METRICS, horizon_radius, ks_radius,
                                 make_step)
from ..physics.spacetime import hamiltonian as _spacetime_hamiltonian
from .integrate import STATUS_ALIVE, STATUS_CAPTURED, STATUS_ESCAPED


def _capture_radius(metric, params):
    """Capture surface.  Spherical charts: the reference's 1.1 x horizon
    (cuda_geodesic.py:598) — BL coordinates go stiff at Delta -> 0 so one
    must stop short.  Kerr-Schild is regular at r_+, but backward-traced
    rays freeze exponentially toward the PAST horizon in any future chart,
    so capture at a thin 1.05 shell (see kerr_schild_g_inv docstring).
    The optional third params slot is the Kerr-Newman charge."""
    from ..physics.spacetime import _charge
    if metric == "KerrSchild":
        return 1.05 * horizon_radius("Kerr", params[0], params[1],
                                     _charge(params))
    if metric == "Kerr":
        return 1.1 * horizon_radius("Kerr", params[0], params[1],
                                    _charge(params))
    from ..physics.static_metrics import STATIC_F, static_capture_radius
    if metric in STATIC_F:
        # 1.1 x the bisected outer horizon; horizonless super-critical
        # regular holes get a small floor around the coordinate center
        # (nothing is captured — rays traverse the core and escape)
        return static_capture_radius(metric, params)
    if metric in ("RotatingBardeen", "RotatingHayward"):
        # Kerr-Schild chart: the thin 1.05 shell over the bisected
        # Delta-root, or the horizonless floor (rotating_regular)
        from ..physics.rotating_regular import rotating_capture_radius
        return rotating_capture_radius(metric, params)
    if metric == "KerrDS":
        # BL-like chart: 1.1 over the bisected Delta_r root
        from ..physics.kerr_de_sitter import kds_capture_radius
        return kds_capture_radius(params)
    return 1.1 * horizon_radius("Schwarzschild", params[0])


def _domain_tools(metric, params, delta, r_max, dtype, g_inv_fn):
    """Chart-dependent domain tests and the blow-up guard, shared by the
    render integrator and the trajectory sampler (so diagnostics see
    exactly the rays the image sees).

    Returns (cap_radius, esc_radius, active_mask, guard, r_cap); all
    functions take/return (N, ...) batches.
    """
    cartesian = COORDS[metric] == "cartesian"
    # cast to the ray dtype: the bisected capture radii (static/rotating
    # families) compute in result_type(float), which is float64 whenever
    # x64 is enabled even for an f32 render — left uncast it promotes the
    # guard's park scatter and trips the dtype-promotion FutureWarning
    r_cap = jnp.asarray(_capture_radius(metric, params), dtype)

    def cap_radius(q1):
        """Chart radius used for the capture test."""
        if cartesian:
            return ks_radius(q1[:, 1], q1[:, 2], q1[:, 3], params[1])
        return q1[:, 1]

    def esc_radius(q1):
        """Chart radius used for the escape test (flat embedding radius
        in the Cartesian chart — the boundary sphere of the scene)."""
        if cartesian:
            return jnp.linalg.norm(q1[:, 1:], axis=1)
        return q1[:, 1]

    def active_mask(q1):
        return (cap_radius(q1) > r_cap) & (esc_radius(q1) < r_max)

    # Blow-up guard (fixed-step stiffness near Delta -> 0 and the BL poles).
    # Three terminal conditions a step can produce:
    #   * horizon crossing (r' < r_+): the capture check only runs between
    #     steps, so a fast plunge can overshoot straight through the
    #     capture shell into the interior where the metric signs flip and
    #     the state turns to garbage -> terminate as CAPTURED.
    #   * explosion (non-finite, |dr| > jump cap, |dtheta| > 1.5): the
    #     stiff kick ~1/Delta^2 (horizon) or ~1/sin^3(theta) (BL pole)
    #     overwhelmed the step; revert the ray and terminate it — as
    #     captured if it stood in the stiff horizon zone (it was plunging),
    #     else flagged with the reference's own numerical-error sentinel
    #     r >= 100 (raytracing.py:213-215).
    # Legitimate steps move r by ~g^rr p_r delta (<~ E*delta) and theta by
    # ~p_th delta / r^2 — both far below the caps.
    r_plus = r_cap / 1.05 if cartesian else r_cap / 1.1
    # Legitimate per-step radius motion is ~|p| * delta.  The spherical
    # camera's covector scale is O(r_obs) (reference utils.py:179-186), the
    # Cartesian camera's is O(1), hence the different jump caps.
    if cartesian:
        # Cartesian-chart plunge zone = the photon region's outer edge (the
        # retrograde circular photon orbit, Bardeen 1973: r_ph- =
        # 2M(1 + cos((2/3) arccos(+|a|/M))), 3.91 M at a = 0.9): a ray the
        # fixed step fails to resolve INSIDE the photon region is a
        # horizon accumulator whose state has blueshifted past float
        # precision — overwhelmingly a plunger.  (BL keeps the tighter
        # shell: its explosions also happen spuriously at larger radii.)
        # (Charge shrinks the photon region, so the uncharged-Kerr radius
        # is a safe upper bound for the Kerr-Newman family — the zone only
        # arbitrates captured-vs-numerical for already-terminated rays.)
        mass_, a_ = params[0], params[1]
        plunge_zone = 2.0 * mass_ * (1.0 + jnp.cos(
            (2.0 / 3.0) * jnp.arccos(jnp.abs(a_) / mass_)))
    else:
        jump_cap = jnp.maximum(jnp.asarray(5.0, dtype), 20.0 * delta)
        plunge_zone = r_cap + 0.5 * params[0]

    # Numerical-error park radius: outside the active domain (so the ray
    # terminates even when r_max > 150 — direct API calls; scenes validate
    # boundary_radius < 100) and past the reference's r >= 100 sentinel
    # (raytracing.py:213-215) so classification flags it.
    err_park = jnp.maximum(jnp.asarray(150.0, dtype), 2.0 * r_max)

    def guard_spherical(q_old, p_old, nq1, np1):
        r_b = q_old[:, 1]
        finite = (jnp.isfinite(nq1).all(axis=1) & jnp.isfinite(np1).all(axis=1))
        exploded = ((~finite)
                    | (jnp.abs(nq1[:, 1] - r_b) > jump_cap)
                    | (jnp.abs(nq1[:, 2] - q_old[:, 2]) > 1.5))
        crossed = finite & (nq1[:, 1] < r_plus) & ~exploded
        # pre-step radial coordinate velocity dr/dlambda = g^rr p_r; the
        # pre-step state is still sane, so its sign is the ray's true
        # heading at the moment the step failed (g^rr > 0 outside r_+,
        # so sign(p_r) suffices)
        inward = p_old[:, 1] < 0.0
        capture = crossed | (exploded & (inward | (r_b < plunge_zone)))
        fix_r = jnp.where(capture, 0.99 * r_cap, err_park)
        bad = exploded | crossed
        fixed_q = q_old.at[:, 1].set(fix_r)
        nq1 = jnp.where(bad[:, None], fixed_q, nq1)
        return bad, nq1

    def guard_cartesian(q_old, p_old, nq1, np1):
        """Kerr-Schild kills the BL polar singularity and the 1/Delta
        metric blow-up, but one stiffness is chart-independent: a
        *backward*-traced ray accumulating on the past horizon blueshifts
        exponentially (p ~ e^{kappa lambda}), so any fixed step eventually
        under-resolves the kick and the ray is ejected unphysically — the
        same failure the spherical guard handles.  Detect it the same way
        (non-finite state or an impossible radius jump) and terminate the
        ray: captured if it crossed r_+ or was heading inward / standing in
        the stiff shell (a plunge), else the r >= 100 numerical sentinel."""
        r_b = cap_radius(q_old)
        finite = (jnp.isfinite(nq1).all(axis=1) & jnp.isfinite(np1).all(axis=1))
        nq1_safe = jnp.where(finite[:, None], nq1, q_old)
        np1_safe = jnp.where(finite[:, None], np1, p_old)
        # The detector is the null condition itself: H = 0.5 g^{ab} p_a p_b
        # is 0 by construction at the camera and drifts only at float
        # roundoff along resolved rays; an unresolved kick destroys it
        # immediately (relative violation O(1) within a step — the horizon
        # kick doubles every step).  Geometry-based jump caps misfire on
        # legitimately blueshifted winders — this invariant cannot.
        # Threshold: along a photon-shell winder the roundoff violation
        # grows like eps * e^(lambda n), so the band of camera rays the
        # guard retires before their capture/escape resolves has width
        # ~ eps/threshold.  3e-2 keeps that band at ~0.1 px (256^2 image,
        # f32) at the a=0.9 prograde shadow extremity — the hardest regime
        # — while a real under-resolved kick still blows through it in the
        # same step it first trips 3e-3 (measured: raising the threshold
        # 10x moved the f32 prograde boundary error from 1.35 px to
        # sub-pixel without admitting a single garbage escape).
        h = jax.vmap(lambda q, p: _spacetime_hamiltonian(
            q, p, params, g_inv_fn))(nq1_safe, np1_safe)
        p2 = jnp.sum(np1_safe[:, 1:] ** 2, axis=1) + 1.0
        exploded = (~finite) | (jnp.abs(h) > 3e-2 * p2)
        crossed = finite & (cap_radius(nq1_safe) < r_plus) & ~exploded
        # pre-step radial heading: d(rho^2)/dlambda ~ x.p (eta-leading term)
        inward = jnp.sum(q_old[:, 1:] * p_old[:, 1:], axis=1) < 0.0
        capture = crossed | (exploded & (inward | (r_b < plunge_zone)))
        bad = exploded | crossed
        # on-axis point (0, 0, z): ks_radius == |z|, so this parks the ray
        # at cap radius 0.5*r_cap (captured) / esc radius 150 (numerical)
        park_cap = jnp.stack([q_old[:, 0], jnp.zeros_like(q_old[:, 0]),
                              jnp.zeros_like(q_old[:, 0]),
                              jnp.full_like(q_old[:, 0], 0.5 * r_cap)],
                             axis=1)
        park_err = jnp.stack([q_old[:, 0],
                              jnp.full_like(q_old[:, 0], err_park),
                              jnp.zeros_like(q_old[:, 0]),
                              jnp.zeros_like(q_old[:, 0])], axis=1)
        park = jnp.where(capture[:, None], park_cap, park_err)
        nq1 = jnp.where(bad[:, None], park, nq1)
        return bad, nq1

    guard = guard_cartesian if cartesian else guard_spherical
    return cap_radius, esc_radius, active_mask, guard, r_cap


@partial(jax.jit, static_argnames=("steps", "order", "metric"))
def integrate_batch_generic(q0s, p0s, steps, delta, params, r_max, omega,
                            order=2, metric="Kerr"):
    """Integrate an (N, 4) batch in the named metric to completion.

    params: tuple/array of metric parameters — (M,) for Schwarzschild,
    (M, a) for Kerr, (M, a, Q) for Kerr-Newman.  Returns (final_q, final_p,
    status, n_steps) with the same status codes and early-exit semantics as
    engine.integrate.
    """
    g_inv_fn = METRICS[metric]
    step1 = make_step(g_inv_fn)

    dtype = q0s.dtype
    delta = jnp.asarray(delta, dtype)
    params = jnp.asarray(params, dtype)
    r_max = jnp.asarray(r_max, dtype)
    subs = substep_schedule(delta, jnp.asarray(omega, dtype), order)

    vstep = jax.vmap(lambda q1, p1, q2, p2: step1(q1, p1, q2, p2, params,
                                                  subs))
    cap_radius, esc_radius, active_mask, guard, r_cap = _domain_tools(
        metric, params, delta, r_max, dtype, g_inv_fn)

    def masked(new, old, act):
        return jnp.where(act[:, None], new, old)

    n_steps0 = jnp.zeros(q0s.shape[0], dtype=jnp.int32)
    carry0 = (q0s, p0s, q0s, p0s, n_steps0, jnp.int32(0))

    def cond(c):
        q1, _, _, _, _, k = c
        return (k < steps) & jnp.any(active_mask(q1))

    def body(c):
        q1, p1, q2, p2, ns, k = c
        act = active_mask(q1)
        nq1, np1, nq2, np2 = vstep(q1, p1, q2, p2)
        bad, nq1 = guard(q1, p1, nq1, np1)
        np1 = jnp.where(bad[:, None], p1, np1)
        nq2 = jnp.where(bad[:, None], q2, nq2)
        np2 = jnp.where(bad[:, None], p2, np2)
        # guard-park flag rides in the sign of the step counter (parked
        # rays go inactive, freezing the count) — decoded below and by
        # the KS analytic rescue
        ns_new = ns + act.astype(jnp.int32)
        ns_new = jnp.where(act & bad, -ns_new, ns_new)
        return (masked(nq1, q1, act), masked(np1, p1, act),
                masked(nq2, q2, act), masked(np2, p2, act),
                ns_new, k + 1)

    q1, p1, q2, _, ns, _ = jax.lax.while_loop(cond, body, carry0)

    if metric == "KerrSchild":
        # integrable family: guard-parked rays are reclassified by their
        # conserved quantities (exact), identically to the KS kernels
        from ..physics.spacetime import _charge
        from .integrate_ks import apply_bardeen_rescue
        return apply_bardeen_rescue(
            q1, p1, ns, q2[:, 1:], q0s, p0s, params[0], params[1],
            _charge(params), r_cap, r_max)
    if metric == "Kerr":
        # same exact rescue on the Boyer-Lindquist chart — this also
        # settles the BL polar-stripe explosions that previously surfaced
        # as 'numerical error' pixels
        from ..physics.spacetime import _charge
        from .integrate_ks import apply_bardeen_rescue_bl
        return apply_bardeen_rescue_bl(
            q1, p1, ns, q2, q0s, p0s, params[0], params[1],
            _charge(params), r_cap, r_max)
    if metric in ("RotatingBardeen", "RotatingHayward"):
        # mass-function families keep the Carter constant (m(r) lives
        # entirely inside Delta), so guard-parked photon-shell winders
        # get the same exact conserved-quantity reclassification as
        # Kerr-Newman — without it they all default to captured and the
        # shadow limb overshoots the true critical curve (the bisection
        # test in tests/test_rotating_regular.py pins this)
        from ..physics.rotating_regular import escape_pred_rotating
        from ..physics.spacetime import _charge
        from .integrate_ks import apply_bardeen_rescue
        pred = escape_pred_rotating(metric, q0s, p0s, params)
        return apply_bardeen_rescue(
            q1, p1, ns, q2[:, 1:], q0s, p0s, params[0], params[1],
            _charge(params), r_cap, r_max, pred=pred)
    if metric == "KerrDS":
        # Kerr-de Sitter separates too: exact rescue on the BL-like
        # chart (settles the polar-stripe explosions identically to
        # kerr-bl; reduces to the quartic predicate at Lambda = 0)
        from ..physics.kerr_de_sitter import kds_escape_pred
        from ..physics.spacetime import _charge
        from .integrate_ks import apply_bardeen_rescue_bl
        pred = kds_escape_pred(q0s, p0s, params)
        return apply_bardeen_rescue_bl(
            q1, p1, ns, q2, q0s, p0s, params[0], params[1],
            _charge(params), r_cap, r_max, pred=pred)

    ns = jnp.abs(ns)
    status = jnp.where(cap_radius(q1) <= r_cap, STATUS_CAPTURED,
                       jnp.where(esc_radius(q1) >= r_max, STATUS_ESCAPED,
                                 STATUS_ALIVE))
    return q1, p1, status, ns


@partial(jax.jit, static_argnames=("steps", "order", "metric", "n_keep"))
def trajectory_batch_decimated(q0s, p0s, steps, delta, params, r_max, omega,
                               order=2, metric="Kerr", n_keep=1000):
    """(K, 4) batch trajectories decimated on the fly to <= n_keep points.

    Generic-metric twin of engine.integrate.integrate_batch_full: positions
    are stored every `stride` steps, rays freeze at capture/escape (masked
    stepping) and rows after a ray's exit stay zero, matching the reference
    trajectory-buffer semantics (cuda_geodesic.py:604-625).  Used for the
    sampled-ray diagnostics of Kerr renders.

    Applies the same blow-up guard as integrate_batch_generic, so a ray the
    image flags as 'numerical error' freezes at the failure point in the
    diagnostic too (instead of recording its unphysical ejection), and the
    step budget is exact (a global step counter gates the stride blocks).
    """
    g_inv_fn = METRICS[metric]
    step1 = make_step(g_inv_fn)

    dtype = q0s.dtype
    delta = jnp.asarray(delta, dtype)
    params = jnp.asarray(params, dtype)
    r_max = jnp.asarray(r_max, dtype)
    subs = substep_schedule(delta, jnp.asarray(omega, dtype), order)

    stride = -(-steps // n_keep) if steps > n_keep else 1
    blocks = -(-steps // stride)

    vstep = jax.vmap(lambda q1, p1, q2, p2: step1(q1, p1, q2, p2, params,
                                                  subs))
    _, _, active_mask, guard, _ = _domain_tools(
        metric, params, delta, r_max, dtype, g_inv_fn)

    def one(c, _):
        q1, p1, q2, p2, alive, k = c
        act = active_mask(q1) & (k < steps)
        nq1, np1, nq2, np2 = vstep(q1, p1, q2, p2)
        bad, nq1 = guard(q1, p1, nq1, np1)
        np1 = jnp.where(bad[:, None], p1, np1)
        nq2 = jnp.where(bad[:, None], q2, nq2)
        np2 = jnp.where(bad[:, None], p2, np2)
        m = act[:, None]
        return (jnp.where(m, nq1, q1), jnp.where(m, np1, p1),
                jnp.where(m, nq2, q2), jnp.where(m, np2, p2),
                alive & act, k + 1), None

    def block(c, _):
        q1_pre = jnp.where(c[4][:, None], c[0], 0.0)  # zero rows after exit
        c, _ = jax.lax.scan(one, c, None, length=stride)
        return c, q1_pre

    alive0 = jnp.ones(q0s.shape[0], dtype=bool)
    _, qs = jax.lax.scan(block, (q0s, p0s, q0s, p0s, alive0, jnp.int32(0)),
                         None, length=blocks)
    return jnp.swapaxes(qs, 0, 1)          # (K, blocks, 4)


@partial(jax.jit, static_argnames=("steps", "order", "metric"))
def trajectory_generic(q0, p0, steps, delta, params, omega, order=2,
                       metric="Kerr"):
    """Single-ray unmasked trajectory: (steps, 4) q and p after each step.

    No early exit — EinsteinPy `Nulllike` semantics (it integrates the full
    budget regardless of horizon proximity), for the compat layer.
    """
    g_inv_fn = METRICS[metric]
    step1 = make_step(g_inv_fn)

    dtype = q0.dtype
    delta = jnp.asarray(delta, dtype)
    params = jnp.asarray(params, dtype)
    subs = substep_schedule(delta, jnp.asarray(omega, dtype), order)

    def scan_step(carry, _):
        q1, p1, q2, p2 = carry
        q1, p1, q2, p2 = step1(q1, p1, q2, p2, params, subs)
        return (q1, p1, q2, p2), (q1, p1)

    _, (qs, ps) = jax.lax.scan(scan_step, (q0, p0, q0, p0), None,
                               length=steps)
    return qs, ps


def integrate_batch_chart(q0s, p0s, steps, delta, params, r_max, omega, *,
                          order, metric, dtype):
    """The production integrator for a generic-metric batch: float32
    Kerr-Schild rays take the Kahan-compensated hand-derived flows
    (engine.integrate_ks.integrate_batch_ksc), which pin the high-spin
    shadow boundary at sub-pixel vs the f64 oracle where the plain f32
    flows drift ~3 px at the prograde edge (physics.kerr_schild
    compensated section); everything else rides the autodiff engine
    (float64 is already at roundoff there)."""
    if metric == "KerrSchild" and dtype == jnp.float32:
        from .integrate_ks import integrate_batch_ksc
        return integrate_batch_ksc(q0s, p0s, steps, delta, params, r_max,
                                   omega, order=order)
    return integrate_batch_generic(q0s, p0s, steps, delta, params, r_max,
                                   omega, order=order, metric=metric)

"""Shared Kerr-Schild step machinery and the compensated KS integrators.

The loop bodies are built from the functions in this module — one source
of truth for the staggered core composition, the null-invariant blow-up
guard and the parking semantics — and run through a lax.while_loop
(integrate_batch_ksc, integrate_batch_subrings_ksc).  A hand-written GPU
kernel for the same bodies would take them over unchanged, as the
Schwarzschild kernel (engine.integrate_pallas) does with its XLA twin.

All functions operate on component tuples of same-shape (N,) arrays.
Layouts: 16-tuple plain (physics.kerr_schild, rows q1/p1/q2/p2 x t,x,y,z)
or 32-tuple Kahan-compensated (rows + deficit rows, kerr_schild
compensated section).

The reference has no Kerr support at all (its GPU kernel hand-codes
Schwarzschild only, simulation/cuda_geodesic.py:432-474); the guard
semantics here mirror the generic autodiff engine's guard_cartesian
(engine.integrate_generic) so every KS backend classifies identically.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..physics.hamiltonian import bridge_sizes, yoshida_gammas
from ..physics.kerr_schild import (close_ks, close_ksc, core_ks, core_ksc,
                                   hamiltonian_ks, ks_radius_c, open_ks,
                                   open_ksc, pack_state_ksc, unpack_ksc)
from ..physics.spacetime import horizon_radius
from .integrate import STATUS_ALIVE, STATUS_CAPTURED, STATUS_ESCAPED


def ks_scene_scalars(params, dtype):
    """(mass, a, charge, r_cap, plunge_zone) traced scalars from a (2,) or
    (3,) params array — computed ONCE here so every KS integrator agrees
    bit-for-bit.

    r_cap: Kerr-Schild is regular at r_+, but backward-traced rays freeze
    exponentially toward the PAST horizon in any future chart, so capture
    at a thin 1.05 shell (physics.spacetime.kerr_schild_g_inv docstring).
    plunge_zone: outer edge of the photon region (retrograde circular
    photon orbit r_ph- = 2M(1 + cos((2/3) arccos(+|a|/M))), Bardeen 1973;
    3.91 M at a = 0.9) — the guard's captured-vs-numerical arbiter, same
    as integrate_generic.guard_cartesian (uncharged-Kerr radius: a safe
    upper bound for Kerr-Newman, see there).
    """
    params = jnp.asarray(params, dtype)
    mass, a = params[0], params[1]
    charge = params[2] if params.shape[0] > 2 else jnp.zeros((), dtype)
    r_cap = 1.05 * horizon_radius("Kerr", mass, a, charge)
    plunge_zone = 2.0 * mass * (1.0 + jnp.cos(
        (2.0 / 3.0) * jnp.arccos(jnp.abs(a) / mass)))
    return mass, a, charge, r_cap, plunge_zone


def ks_substeps(delta, omega, order, compensated=False):
    """Per-substep (d_j, cw_j, sw_j, bridge_j) quadruples for the staggered
    schedule.  cw is cos(2 omega d) for the plain flows and one-minus-cos
    (computed cancellation-free as 2 sin^2(omega d)) for the compensated
    ones — whatever the layout's mixing flow expects."""
    gammas = yoshida_gammas(order)
    deltas = [g * delta for g in gammas]
    bridges = bridge_sizes(deltas)
    subs = []
    for j, d_j in enumerate(deltas):
        if compensated:
            sh = jnp.sin(omega * d_j)
            subs.append((d_j, 2.0 * sh * sh, jnp.sin(2.0 * omega * d_j),
                         bridges[j]))
        else:
            angle = 2.0 * omega * d_j
            subs.append((d_j, jnp.cos(angle), jnp.sin(angle), bridges[j]))
    return tuple(subs)


def make_ks_step(subs, mass, a, charge, r_cap, r_max, plunge_zone,
                 compensated=False, disk=None, subrings=None):
    """(active, masked_step, open_fn, close_fn) for one KS integration.

    active(comps) -> bool mask; masked_step(comps, ns) -> (comps, ns)
    applies one full staggered composed step to active rays, with the
    in-loop null-invariant blow-up guard and parking.  open_fn/close_fn
    are the staggered boundary half-A flows (caller masks them by the
    initially-active set; see integrate_batch_ksc for the masking rules).

    disk=(r_in, r_out) swaps masked_step for the disk-crossing variant
    masked_step(comps, ns, hit, hq, hp) -> same: rays whose q1 z row
    changes sign within the annulus freeze with hit=True and the
    within-step lerped crossing recorded in hq (q1 rows) / hp (p2 rows —
    like q1, the p2 rows hold EXACT plain-composition step-boundary
    values in the staggered state, and the unstaggered engine.disk XLA
    recorder deliberately records the same p2 copy, so the two backends
    agree to fusion rounding rather than the FANTASY copy-split).  The
    caller's early-exit test must become active(comps) & ~hit.

    subrings=n_orders instead swaps in the TRANSPARENT-disk variant
    masked_step(comps, ns, cnt, hq, hp) (engine/subring.py semantics:
    count every plane crossing, record the first n_orders anywhere on
    the plane, never freeze); the early-exit test stays the plain
    active(comps).
    """
    core = core_ksc if compensated else core_ks
    open_raw = open_ksc if compensated else open_ks
    close_raw = close_ksc if compensated else close_ks
    r_plus = r_cap / 1.05

    def open_fn(comps, d0):
        return open_raw(comps, d0, mass, a, charge)

    def close_fn(comps, d0):
        return close_raw(comps, d0, mass, a, charge)

    def active(comps):
        r_bl = ks_radius_c(comps[1], comps[2], comps[3], a)
        rho2 = comps[1] * comps[1] + comps[2] * comps[2] + comps[3] * comps[3]
        return (r_bl > r_cap) & (rho2 < r_max * r_max)

    def _advance(comps, ns, frozen=None):
        # inline `active` so r_old is computed once per step (reused by the
        # plunge-zone test below)
        r_old = ks_radius_c(comps[1], comps[2], comps[3], a)
        rho2 = (comps[1] * comps[1] + comps[2] * comps[2]
                + comps[3] * comps[3])
        act = (r_old > r_cap) & (rho2 < r_max * r_max)
        if frozen is not None:
            act = act & ~frozen
        new = comps
        for d_j, cw_j, sw_j, bridge_j in subs:
            new = core(new, d_j, mass, a, cw_j, sw_j, bridge_j, charge)

        # --- null-invariant blow-up guard (== guard_cartesian) ---
        # The invariant |h| test runs on the (q1, p2) rows: in the
        # staggered state those hold the EXACT plain-composition boundary
        # values (flow A never writes them), so the test keeps its
        # original sensitivity/threshold.  (Compensated layout: the raw
        # accumulator rows are within 1 ulp of the best estimate — noise
        # against the threshold.)  Threshold 3e-2: see
        # integrate_generic.guard_cartesian — the retired-too-early band
        # of near-critical winders has width ~ eps/threshold, and a real
        # under-resolved kick blows through any threshold in one step.
        # Finiteness covers ALL rows the flows write via one aggregate
        # sum: any NaN/Inf component makes the sum non-finite (finite
        # overflow to Inf only happens for ~1e38 garbage, which must trip
        # the guard anyway).  The |h| test is in negated-<= form so a NaN
        # Hamiltonian also registers.
        agg = new[0]
        for i in range(1, 16):
            agg = agg + new[i]
        finite = jnp.isfinite(agg)
        h = hamiltonian_ks(new[1], new[2], new[3], new[12], new[13],
                           new[14], new[15], mass, a, charge)
        p2n = new[13] * new[13] + new[14] * new[14] \
            + new[15] * new[15] + 1.0
        exploded = ~(finite & (jnp.abs(h) <= 3e-2 * p2n))
        r_new = ks_radius_c(new[1], new[2], new[3], a)
        crossed = finite & (r_new < r_plus) & ~exploded
        # pre-step radial heading, p1 copy — same heuristic and copy
        # as integrate_generic.guard_cartesian (q_old . p_old)
        inward = (comps[1] * comps[5] + comps[2] * comps[6]
                  + comps[3] * comps[7]) < 0.0
        capture = crossed | (exploded & (inward | (r_old < plunge_zone)))
        bad = exploded | crossed
        # fused guard + activity select chain (one pass over the rows;
        # bad rays keep old values except the parked q1 coordinates):
        # parked q1: captured -> (t, 0, 0, 0.5 r_cap) on-axis point
        # (ks_radius == |z|); numerical -> (t, 150, 0, 0) sentinel
        ok = act & ~bad
        park = act & bad
        out = [jnp.where(ok, n, o) for n, o in zip(new, comps)]
        park_x = jnp.where(capture, 0.0, 150.0)
        park_z = jnp.where(capture, 0.5 * r_cap, 0.0)
        out[1] = jnp.where(park, park_x, out[1])
        out[2] = jnp.where(park, 0.0, out[2])
        out[3] = jnp.where(park, park_z, out[3])
        if compensated:
            # parked coordinates are fresh exact values: zero their deficits
            for row in (17, 18, 19):
                out[row] = jnp.where(park, 0.0, out[row])
        # guard-park flag rides in the SIGN of the step counter (parked
        # rays are inactive forever after, so the count freezes): the
        # wrappers decode parked = ns < 0, n_steps = |ns|, and hand parked
        # rays to the analytic Bardeen rescue (apply_bardeen_rescue)
        ns_new = ns + act.astype(jnp.int32)
        ns_new = jnp.where(park, -ns_new, ns_new)
        return tuple(out), ns_new, new, ok

    def masked_step(comps, ns):
        out, ns_new, _, _ = _advance(comps, ns)
        return out, ns_new

    # crossing-event reads fold the Kahan deficits (true = s - c): the
    # deficit of a 3,000-step f32 trajectory reaches ~1e-3 in the
    # coordinates, and recording raw accumulator rows was exactly the
    # source of an 8.4e-3 subring event drift.  Folding costs one
    # subtract per read.
    if compensated:
        def best(state, i):
            return state[i] - state[16 + i]
    else:
        def best(state, i):
            return state[i]

    if subrings is None and disk is None:
        return active, masked_step, open_fn, close_fn

    if subrings is not None:
        # subring mode, subrings=n_orders: record the first n_orders
        # plane crossings (ANY radius — image order counts half-orbits,
        # not disk hits; engine/subring.py applies the annulus at
        # shading) and never freeze — the thin disk is transparent.
        # `cnt` rides the carry as int32, hq/hp as n_orders nested
        # 4-tuples of (N,) arrays.
        n_orders = int(subrings)

        def masked_step_subrings(comps, ns, cnt, hq, hp):
            out, ns_new, new, ok = _advance(comps, ns)
            z0, z1 = best(comps, 3), best(new, 3)
            crossed = ok & (z0 * z1 < 0.0)
            t = jnp.where(crossed, z0 / (z0 - z1), 0.0)
            cq = tuple(best(comps, i) + t * (best(new, i) - best(comps, i))
                       for i in range(4))
            cp = tuple(best(comps, 12 + i)
                       + t * (best(new, 12 + i) - best(comps, 12 + i))
                       for i in range(4))
            hq_new, hp_new = [], []
            for s in range(n_orders):
                take = crossed & (cnt == s)
                hq_new.append(tuple(jnp.where(take, c, h)
                                    for c, h in zip(cq, hq[s])))
                hp_new.append(tuple(jnp.where(take, c, h)
                                    for c, h in zip(cp, hp[s])))
            cnt = cnt + crossed.astype(cnt.dtype)
            return out, ns_new, cnt, tuple(hq_new), tuple(hp_new)

        return active, masked_step_subrings, open_fn, close_fn

    r_in, r_out = disk

    def masked_step_disk(comps, ns, hit, hq, hp):
        out, ns_new, new, ok = _advance(comps, ns, frozen=hit)
        # first equatorial crossing inside the annulus, lerped within the
        # step on the exact-boundary (q1, p2) rows (engine.disk semantics:
        # the first crossing along the backward ray is the opaque disk's
        # visible surface).  ok excludes guard-parked rays — a ray cannot
        # hit the disk on the step its state blew up, matching
        # integrate_batch_disk's `act & ~bad` condition.
        z0, z1 = best(comps, 3), best(new, 3)
        crossed = ok & (z0 * z1 < 0.0)
        t = jnp.where(crossed, z0 / (z0 - z1), 0.0)
        cq = tuple(best(comps, i) + t * (best(new, i) - best(comps, i))
                   for i in range(4))
        cp = tuple(best(comps, 12 + i)
                   + t * (best(new, 12 + i) - best(comps, 12 + i))
                   for i in range(4))
        r_hit = ks_radius_c(cq[1], cq[2], cq[3], a)
        new_hit = crossed & (r_hit >= r_in) & (r_hit <= r_out)
        hq = tuple(jnp.where(new_hit, c, h) for c, h in zip(cq, hq))
        hp = tuple(jnp.where(new_hit, c, h) for c, h in zip(cp, hp))
        return out, ns_new, hit | new_hit, hq, hp

    return active, masked_step_disk, open_fn, close_fn


def bardeen_escape_pred(q0s, p0s, mass, a, charge):
    """Closed-form capture/escape predicate per ray (Bardeen 1973).

    Kerr-Newman geodesics are INTEGRABLE: each ray's conserved
    (E, L_z, Q_carter) fixes its fate exactly, computed from the initial
    covector in the KS Cartesian chart at any launch point:

        E = -p_t,   L_z = x p_y - y p_x,
        p_theta = (cos th/sin th)(x p_x + y p_y) - r sin th p_z
        (from the oblate map x^2+y^2 = (r^2+a^2) sin^2 th, z = r cos th),
        Q = p_theta^2 + cos^2 th (L^2/sin^2 th - a^2 E^2).

    At the equatorial camera point this reduces to p_theta = -r p_z and
    Q = p_theta^2.

    The backward ray, moving inward from r0, escapes iff the radial
    potential  R(r) = [E(r^2+a^2) - a L]^2 - Delta(r) [(L-aE)^2 + Q]
    (Delta = r^2 - 2Mr + a^2 + Q_c^2) has a turning point in (r_+, r0):
    R(r_+) >= 0 and R(r0) > 0 always, so escape <=> min R over the
    interval <= 0.  R' is a DEPRESSED cubic (no r^2 term), so the min is
    found by a coarse grid argmin polished with Newton on R' — fully
    vectorized, ~100 flops/ray, evaluated once per batch.

    This predicate is the analytic-rescue oracle for rays the float
    precision cannot integrate through the photon-shell passage (their
    Lyapunov horizon is shorter than the winding time — near the shadow
    boundary the f32 trajectory reaches O(1) error and NaNs before the
    capture/escape decision resolves; no guard threshold fixes that).
    Because the system is integrable, classifying those rays by their
    conserved quantities is not an approximation but the exact answer.
    """
    x, y, z = q0s[:, 1], q0s[:, 2], q0s[:, 3]
    E = -p0s[:, 0]
    L = x * p0s[:, 2] - y * p0s[:, 1]
    r0_bl = ks_radius_c(x, y, z, a)
    cos_th = z / r0_bl
    sin2 = jnp.maximum(1.0 - cos_th * cos_th, 1e-30)
    sin_th = jnp.sqrt(sin2)
    p_th = (cos_th / sin_th) * (x * p0s[:, 1] + y * p0s[:, 2]) \
        - r0_bl * sin_th * p0s[:, 3]
    Q = p_th * p_th + cos_th * cos_th * (L * L / sin2 - a * a * E * E)
    return _bardeen_min_R(E, L, Q, r0_bl, mass, a, charge)


def bardeen_escape_pred_bl(q0s, p0s, mass, a, charge):
    """Boyer-Lindquist front-end of the Bardeen predicate: conserved
    quantities read directly off the spherical-chart initial covector
    (E = -p_t, L = p_phi, Carter Q = p_th^2 + cos^2(th)(L^2/sin^2(th)
    - a^2 E^2); the overall sign of the covector — the BL camera stores
    backward rays with p_t > 0 — cancels in the radial potential, which
    is invariant under (E, L) -> (-E, -L))."""
    E = -p0s[:, 0]
    L = p0s[:, 3]
    th = q0s[:, 2]
    sin2 = jnp.sin(th) ** 2
    cos2 = jnp.cos(th) ** 2
    Q = p0s[:, 2] ** 2 + cos2 * (L * L / jnp.maximum(sin2, 1e-30)
                                 - a * a * E * E)
    return _bardeen_min_R(E, L, Q, q0s[:, 1], mass, a, charge)


def _bardeen_min_R(E, L, Q, r0_bl, mass, a, charge):
    """Escape test shared by the chart front-ends: does the radial
    potential R(r) have a turning point in (r_+, r0)?"""
    c1 = (L - a * E) ** 2 + Q                    # >= 0
    B = E * a * a - a * L
    aq = a * a + charge * charge
    r_plus = mass + jnp.sqrt(jnp.maximum(
        mass * mass - aq, jnp.zeros_like(mass)))

    # per-ray constants as (N, 1) columns so the same closures evaluate
    # both the (N, K) grid and the (N, 1) Newton iterate
    E_, B_, c1_ = E[:, None], B[:, None], c1[:, None]
    lin = 4.0 * E_ * B_ - 2.0 * c1_

    def R(r):
        quad = E_ * r * r + B_
        delta = r * r - 2.0 * mass * r + aq
        return quad * quad - delta * c1_

    def dR(r):
        return 4.0 * E_ * E_ * r ** 3 + lin * r + 2.0 * mass * c1_

    def ddR(r):
        return 12.0 * E_ * E_ * r * r + lin

    lo = ((r_plus + 1e-3) + jnp.zeros_like(r0_bl))[:, None]
    hi = r0_bl[:, None]
    # coarse grid argmin (64 points spans the interval at ~0.5 M steps)
    ts = jnp.linspace(0.0, 1.0, 64, dtype=E.dtype)
    grid = lo + (hi - lo) * ts[None, :]
    Rg = R(grid)
    jmin = jnp.argmin(Rg, axis=1)
    r_n = jnp.take_along_axis(grid, jmin[:, None], axis=1)
    R_grid_min = jnp.take_along_axis(Rg, jmin[:, None], axis=1)[:, 0]
    # Newton polish on R' (quartic min is quadratic around the critical
    # point; 8 iterations are far past convergence), clamped to the
    # interval
    for _ in range(8):
        r_n = r_n - dR(r_n) / jnp.where(jnp.abs(ddR(r_n)) > 1e-30,
                                        ddR(r_n), 1e-30)
        r_n = jnp.clip(r_n, lo, hi)
    R_min = jnp.minimum(R_grid_min, R(r_n)[:, 0])
    return R_min <= 0.0


def apply_bardeen_rescue_bl(final_q, final_p, n_steps_signed, q2,
                            q0s, p0s, mass, a, charge, r_cap, r_max,
                            pred=None):
    """Boyer-Lindquist-chart twin of apply_bardeen_rescue: same exact
    reclassification of guard-parked rays (incl. the BL polar-stripe
    explosions, which previously surfaced as 'numerical error' pixels),
    with spherical-chart park geometry — a rescued escape keeps the
    last-resolved direction (theta, phi from the reverted second copy)
    at radius 1.001 r_max; a rescued capture parks at 0.99 r_cap."""
    parked = n_steps_signed < 0
    n_steps = jnp.abs(n_steps_signed)
    if pred is None:
        pred = bardeen_escape_pred_bl(q0s, p0s, mass, a, charge)
    # else: caller-supplied exact predicate (Kerr-de Sitter passes
    # physics.kerr_de_sitter.kds_escape_pred — same park semantics)

    esc_r = parked & pred
    cap_r = parked & ~pred

    r_out = jnp.where(esc_r, 1.001 * r_max,
                      jnp.where(cap_r, 0.99 * r_cap, final_q[:, 1]))
    th_out = jnp.where(esc_r, q2[:, 2], final_q[:, 2])
    ph_out = jnp.where(esc_r, q2[:, 3], final_q[:, 3])
    final_q = jnp.stack([final_q[:, 0], r_out, th_out, ph_out], axis=1)
    status = jnp.where(final_q[:, 1] <= r_cap, STATUS_CAPTURED,
                       jnp.where(final_q[:, 1] >= r_max, STATUS_ESCAPED,
                                 STATUS_ALIVE))
    return final_q, final_p, status, n_steps


def apply_bardeen_rescue(final_q, final_p, n_steps_signed, q2_spatial,
                         q0s, p0s, mass, a, charge, r_cap, r_max,
                         pred=None):
    """Reclassify guard-parked rays by the exact Bardeen predicate.

    n_steps_signed: per-ray step counts with guard-parked rays encoded as
    negative values (see make_ks_step).  For parked rays the predicate
    decides:

      * escape -> status ESCAPED, parked at the boundary sphere along the
        last-resolved direction (q2_spatial: the reverted second-copy
        position, still on the photon shell when the guard fired — the
        escape direction of a shell winder samples the sky quasi-randomly,
        so the last resolved heading is as faithful as any integrator
        could be);
      * capture -> status CAPTURED, parked at the standard captured park
        point (incl. rays the guard had flagged with the r=150 numerical
        sentinel: for the integrable Kerr-Newman family every ray's fate
        is decidable, so the KS chart never needs to report 'numerical
        error' — the sentinel remains for non-integrable/generic charts).

    Unparked rays pass through untouched.  Returns (final_q, final_p,
    status, n_steps).
    """
    parked = n_steps_signed < 0
    n_steps = jnp.abs(n_steps_signed)
    if pred is None:
        pred = bardeen_escape_pred(q0s, p0s, mass, a, charge)
    # else: a caller-supplied exact predicate — the mass-function families
    # pass physics.rotating_regular.escape_pred_rotating (same park
    # semantics, generalized Delta(r) in the radial potential)

    esc_r = parked & pred
    cap_r = parked & ~pred

    norm = jnp.linalg.norm(q2_spatial, axis=1, keepdims=True)
    # 1.001 r_max so the rescued radius stays >= r_max after f32 rounding
    # (matches a real escaper, which overshoots the boundary by one step)
    esc_pos = q2_spatial / jnp.maximum(norm, 1e-30) * (1.001 * r_max)
    zero = jnp.zeros_like(final_q[:, 0])
    cap_pos = jnp.stack([zero, zero, zero + 0.5 * r_cap], axis=1)

    new_sp = jnp.where(esc_r[:, None], esc_pos,
                       jnp.where(cap_r[:, None], cap_pos, final_q[:, 1:]))
    final_q = jnp.concatenate([final_q[:, :1], new_sp], axis=1)
    return final_q, final_p, ks_status(final_q, a, r_cap, r_max), n_steps


def ks_status(final_q, a, r_cap, r_max):
    """(N, 4) final positions -> status codes (shared by every KS backend)."""
    r_bl = ks_radius_c(final_q[:, 1], final_q[:, 2], final_q[:, 3], a)
    rho = jnp.linalg.norm(final_q[:, 1:], axis=1)
    return jnp.where(r_bl <= r_cap, STATUS_CAPTURED,
                     jnp.where(rho >= r_max, STATUS_ESCAPED, STATUS_ALIVE))


@partial(jax.jit, static_argnames=("steps", "order"))
def integrate_batch_ksc(q0s, p0s, steps, delta, params, r_max, omega,
                        order=2):
    """The compensated (Kahan double-float32) Kerr-Schild integrator: the
    production path for float32 Kerr-Schild renders.

    Runs the step/guard construction of make_ks_step (compensated=True)
    through a lax.while_loop.  Same contract as
    integrate_batch_generic(metric='KerrSchild'): params = (M, a[, Q]),
    returns (final_q, final_p, status, n_steps).
    """
    dtype = q0s.dtype
    delta = jnp.asarray(delta, dtype)
    r_max = jnp.asarray(r_max, dtype)
    omega = jnp.asarray(omega, dtype)
    mass, a, charge, r_cap, plunge_zone = ks_scene_scalars(params, dtype)
    subs = ks_substeps(delta, omega, order, compensated=True)
    active, masked_step, open_fn, close_fn = make_ks_step(
        subs, mass, a, charge, r_cap, r_max, plunge_zone, compensated=True)
    d0 = subs[0][0]

    state0 = pack_state_ksc(q0s, p0s)
    ns0 = jnp.zeros(q0s.shape[:-1], dtype=jnp.int32)

    act0 = active(state0)
    if steps > 0:  # steps == 0 must be an exact no-op
        opened = open_fn(state0, d0)
        state0 = tuple(jnp.where(act0, o, s) for o, s in zip(opened, state0))

    def cond(carry):
        comps, _, k = carry
        return (k < steps) & jnp.any(active(comps))

    def body(carry):
        comps, ns, k = carry
        comps, ns = masked_step(comps, ns)
        return comps, ns, k + 1

    comps, ns, _ = jax.lax.while_loop(cond, body, (state0, ns0, jnp.int32(0)))

    # undo the pending half-A for every opened ray.  Unlike the
    # Schwarzschild pair, no park exclusion is needed: the park points are
    # regular chart points, flow A cannot move q1, and a parked ray's
    # (p1, q2) are reverted bookkeeping values anyway.
    if steps > 0:
        closed = close_fn(comps, d0)
        comps = tuple(jnp.where(act0, cl, c) for cl, c in zip(closed, comps))

    best = unpack_ksc(comps)
    final_q = jnp.stack(best[0:4], axis=-1)
    final_p = jnp.stack(best[4:8], axis=-1)
    q2_spatial = jnp.stack(best[9:12], axis=-1)
    final_q, final_p, status, n_steps = apply_bardeen_rescue(
        final_q, final_p, ns, q2_spatial, q0s, p0s, mass, a, charge,
        r_cap, r_max)
    return final_q, final_p, status, n_steps


@partial(jax.jit, static_argnames=("steps", "order", "n_orders"))
def integrate_batch_subrings_ksc(q0s, p0s, steps, delta, params, r_max,
                                 omega, n_orders=3, order=2):
    """The compensated SUBRING integrator: the step/guard/crossing-recorder
    construction of make_ks_step (compensated=True, subrings=n_orders)
    through a lax.while_loop — the subring analog of integrate_batch_ksc.
    Same contract as subring.integrate_batch_subrings: returns (final_q,
    final_p, status, n_steps, hits_q (n_orders, N, 4), hits_p, count).
    """
    dtype = q0s.dtype
    delta = jnp.asarray(delta, dtype)
    r_max = jnp.asarray(r_max, dtype)
    omega = jnp.asarray(omega, dtype)
    mass, a, charge, r_cap, plunge_zone = ks_scene_scalars(params, dtype)
    subs = ks_substeps(delta, omega, order, compensated=True)
    active, masked_step, open_fn, close_fn = make_ks_step(
        subs, mass, a, charge, r_cap, r_max, plunge_zone,
        compensated=True, subrings=n_orders)
    d0 = subs[0][0]

    n = q0s.shape[0]
    state0 = pack_state_ksc(q0s, p0s)
    ns0 = jnp.zeros((n,), dtype=jnp.int32)
    cnt0 = jnp.zeros((n,), dtype=jnp.int32)
    zeros = jnp.zeros((n,), dtype)
    hq0 = tuple(tuple(zeros for _ in range(4)) for _ in range(n_orders))
    hp0 = tuple(tuple(zeros for _ in range(4)) for _ in range(n_orders))

    act0 = active(state0)
    if steps > 0:  # steps == 0 must be an exact no-op
        opened = open_fn(state0, d0)
        state0 = tuple(jnp.where(act0, o, s) for o, s in zip(opened, state0))

    def cond(carry):
        comps, _, k, _, _, _ = carry
        return (k < steps) & jnp.any(active(comps))

    def body(carry):
        comps, ns, k, cnt, hq, hp = carry
        comps, ns, cnt, hq, hp = masked_step(comps, ns, cnt, hq, hp)
        return comps, ns, k + 1, cnt, hq, hp

    comps, ns, _, cnt, hq, hp = jax.lax.while_loop(
        cond, body, (state0, ns0, jnp.int32(0), cnt0, hq0, hp0))

    if steps > 0:
        closed = close_fn(comps, d0)
        comps = tuple(jnp.where(act0, cl, c) for cl, c in zip(closed, comps))

    best = unpack_ksc(comps)
    final_q = jnp.stack(best[0:4], axis=-1)
    final_p = jnp.stack(best[4:8], axis=-1)
    q2_spatial = jnp.stack(best[9:12], axis=-1)
    final_q, final_p, status, n_steps = apply_bardeen_rescue(
        final_q, final_p, ns, q2_spatial, q0s, p0s, mass, a, charge,
        r_cap, r_max)
    hits_q = jnp.stack([jnp.stack(hq[s], axis=-1) for s in range(n_orders)])
    hits_p = jnp.stack([jnp.stack(hp[s], axis=-1) for s in range(n_orders)])
    return final_q, final_p, status, n_steps, hits_q, hits_p, cnt

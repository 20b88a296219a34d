"""Batched geodesic integration as a single XLA array program.

Array-program counterpart of the reference's CUDA kernels
`fantasy_integrate_batch_ord2[_full]` (reference:
simulation/cuda_geodesic.py:579-625) and the `CUDASchwarzschildIntegrator`
wrapper (cuda_geodesic.py:629-653).  Instead of one CUDA thread per ray with a
`break`, the whole (N,) ray batch advances inside one `lax.while_loop` whose
body applies a masked FANTASY step to every ray; the loop terminates as soon
as *all* rays have been captured/escaped or the step budget is exhausted.
This is the portable backend (CPU, sharded meshes); the Pallas GPU kernel in
integrate_pallas.py is the one-launch fast path with per-block early exit,
the reference kernel's own form.

Status codes are first-class device-side masks (SURVEY.md section 5,
failure-detection row):
    ALIVE (0)    still inside the domain when the budget ran out
    CAPTURED (1) r <= 1.1 * rs    (cuda_geodesic.py:598)
    ESCAPED (2)  r >= r_max       (cuda_geodesic.py:599)
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..physics.hamiltonian import (bridge_sizes, fantasy_step, pack_state,
                                   pack_state_eqc, staggered_eqc,
                                   substep_schedule, unpack_p1, unpack_q1)

STATUS_ALIVE = 0
STATUS_CAPTURED = 1
STATUS_ESCAPED = 2


BACKENDS = ("auto", "xla", "pallas")


def resolve_backend(backend: str) -> str:
    """'auto' -> 'pallas' (the Pallas GPU kernel, integrate_pallas) on a
    GPU, 'xla' elsewhere.  An explicit 'pallas' is kept as asked: without a
    GPU the kernel raises instead of falling back."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend != "auto":
        return backend
    return "pallas" if jax.default_backend() == "gpu" else "xla"


def integrate_dispatch(q0s, p0s, steps, delta, rs, r_max, omega,
                       backend="auto", equatorial=False, order=2):
    """Backend-dispatching integrate: same signature/returns for both.

    equatorial=True is a static promise that every ray has theta == pi/2
    and p_theta == 0 (true for all camera rays after the beta fold).
    order in {2,4,6,8} selects the Yoshida-composed step
    (physics.hamiltonian); `steps` counts composed steps, like EinsteinPy's
    GeodesicIntegrator.

    float32 equatorial rays always get the Kahan-compensated integrator —
    the kernel's compensated layout, or its XLA twin
    integrate_batch_compensated: it pins the 200k-step escape-direction
    error inside the 1e-5 target that plain float32 misses (tail ~2e-4,
    tests/test_f32_accuracy.py).  float64 inputs keep the plain step (the
    kernel's equatorial layout, or the generic XLA reference path).
    """
    compensated = bool(equatorial) and q0s.dtype == jnp.float32
    if resolve_backend(backend) == "pallas":
        from .integrate_pallas import integrate_batch_pallas
        return integrate_batch_pallas(q0s, p0s, steps, delta, rs, r_max,
                                      omega, equatorial=equatorial,
                                      order=order, compensated=compensated)
    if compensated:
        return integrate_batch_compensated(q0s, p0s, steps, delta, rs,
                                           r_max, omega, order=order)
    return integrate_batch(q0s, p0s, steps, delta, rs, r_max, omega,
                           order=order)


def _active_mask(q1r, rs, r_max):
    """Reference pre-step domain check (cuda_geodesic.py:598-599)."""
    return (q1r > 1.1 * rs) & (q1r < r_max)


# Blow-up guard row indices per state layout: (q1_r, q2_r, *kahan_deficits).
_R_ROWS = {16: (1, 9), 12: (1, 7), 24: (1, 7, 13, 19)}


def jump_cap(delta, dtype):
    """Max legitimate per-step |dr|.  Resolved rays move r by
    ~(1 - rs/r) p_r delta <~ E delta per composed step (E ~ 1 in the
    camera normalization); an unresolved horizon kick jumps by 10..10^4.
    Same detector the generic engine uses (integrate_generic)."""
    return jnp.maximum(jnp.asarray(5.0, dtype), 20.0 * jnp.abs(delta))


def guard_state(old, new, rs, cap):
    """Horizon blow-up guard for the Schwarzschild fast engines.

    The capture check runs BETWEEN steps (reference cuda_geodesic.py:
    598-599), so a fast plunge can overshoot the 1.1*rs shell into the
    stiff zone where the 1/(r - rs)^2 kick overwhelms the fixed step and
    ejects the ray to a garbage radius — the reference kernel has exactly
    this failure mode and masks it downstream with the alpha0 capture
    shortcut (raytracing.py:205-211).  Detect it by the radius jump
    (non-finite or |dr| > cap: only possible for a ray standing in the
    stiff horizon zone, i.e. a plunger), revert the ray to its last
    resolved state and park it at r = rs, below the capture threshold —
    so status/photon_data report CAPTURED with sane values instead of a
    spurious escape.  Works on any of the three state layouts (16-row
    generic, 12-row equatorial, 24-row Kahan-compensated).
    """
    rows = _R_ROWS[len(old)]
    r_old = old[rows[0]]
    r_new = new[rows[0]]
    bad = ~jnp.isfinite(r_new) | (jnp.abs(r_new - r_old) > cap)
    out = [jnp.where(bad, o, nw) for o, nw in zip(old, new)]
    park = jnp.full_like(r_new, 1.0) * rs
    for row in rows[:2]:
        out[row] = jnp.where(bad, park, out[row])
    for row in rows[2:]:  # compensated layout: zero the parked deficits
        out[row] = jnp.where(bad, jnp.zeros_like(r_new), out[row])
    return tuple(out)


def _masked_step(state, active, subs, rs, cap):
    new_state = guard_state(state, fantasy_step(state, subs, rs), rs, cap)
    return tuple(jnp.where(active, n, o) for n, o in zip(new_state, state))


def impact_parameter(p0s):
    """Exact per-ray impact parameter b = |L/E| = |p_phi / p_t| from the
    initial covector (the camera's EinsteinPy `_P()` root makes p_t
    POSITIVE — backward rays — so take magnitudes).  Both p_t and p_phi
    are exact invariants of the static axisymmetric flows, so this is
    conserved along the TRUE ray regardless of what the float trajectory
    does — the analytic-rescue oracle for Schwarzschild (the
    integrable-family twin of integrate_ks.bardeen_escape_pred; here the
    radial-potential test collapses to one comparison, b vs
    b_crit = 3 sqrt(3) M — the critical camera pixel maps to b_crit to
    float roundoff, verified against the arcsin formula)."""
    return jnp.abs(p0s[..., 3]) / jnp.maximum(jnp.abs(p0s[..., 0]), 1e-30)


def schw_true_escape_pred(q0s, p0s, rs):
    """Exact capture/escape predicate per ray, from the LAUNCH state.

    Schwarzschild null geodesics are integrable: each ray's fate follows
    in closed form from its conserved impact parameter b = |L/E| (exact
    invariants of the flows, see impact_parameter) and its initial radial
    heading — the Schwarzschild collapse of the Kerr Bardeen predicate
    (integrate_ks.bardeen_escape_pred), where the quartic turning-point
    test reduces to one comparison against b_crit = 3 sqrt(3) M because
    the radial potential has its single barrier peak at r = 3M:

      * r0 >= 3M:  outward rays always escape; inward rays escape iff
        b > b_crit (they turn at the outer root of  b = r/sqrt(f));
      * r0 <  3M (inside the barrier): only outward rays with b <= b_crit
        clear the peak; everything else falls in.

    The covariant p_r sign IS the integration radial heading (dr/dlambda
    = g^rr p_r with g^rr = f > 0), and the overall covector sign (the
    camera's backward-ray p_t > 0 root) cancels in b.
    """
    dtype = q0s.dtype
    m = 0.5 * jnp.asarray(rs, dtype)
    b = impact_parameter(p0s)
    b_crit = 3.0 * jnp.sqrt(jnp.asarray(3.0, dtype)) * m
    outward = p0s[..., 1] >= 0.0
    far = q0s[..., 1] >= 3.0 * m
    return jnp.where(far, outward | (b > b_crit),
                     outward & (b <= b_crit))


def schw_escape_rescue(final_q, final_p, status, esc_pred, rs, r_max):
    """Reconcile the integrator's classification with the exact one.

    esc_pred: per-ray analytic escape predicate (schw_true_escape_pred,
    evaluated at launch — resumable jobs store it in their carry).

    Two float-integration failure modes produce misclassifications, and
    because the system is integrable both have exact corrections:

      * fake ESCAPES — a fast plunge blows up in the stiff horizon zone
        and coasts to the boundary with garbage state.  pred says capture
        -> park at r = rs, CAPTURED.
      * fake CAPTURES — near-critical rays (|b - b_crit|/b_crit within
        the integrator's truncation band, ~5e-3 at delta = 0.01) spiral
        at the photon sphere until O(delta^2) error pushes them across;
        the side they fall off is then decided by noise, biasing the
        numerical shadow boundary outward by ~0.1 px (round-3 verdict
        item 3).  pred says escape -> park at 1.001 r_max along the
        last-resolved (theta, phi), ESCAPED — the same semantics as the
        Kerr analytic rescue (integrate_ks.apply_bardeen_rescue): a
        photon-sphere winder's escape direction samples the sky
        quasi-randomly, so the last resolved heading is as faithful as
        any integrator could be.

    Rays the predicate agrees with — everything except a vanishing
    near-critical band — pass through bit-untouched, and ALIVE rays are
    never touched (the budget genuinely ran out).  Applied identically by
    every Schwarzschild batch integrator (both backends and the resumable
    read-out), so kernel/twin/chunked parity is preserved.
    """
    esc_pred = jnp.asarray(esc_pred)
    dtype = final_q.dtype
    to_cap = (status == STATUS_ESCAPED) & ~esc_pred
    to_esc = (status == STATUS_CAPTURED) & esc_pred
    status = jnp.where(to_cap, STATUS_CAPTURED,
                       jnp.where(to_esc, STATUS_ESCAPED, status))
    r_new = jnp.where(to_cap, jnp.asarray(rs, dtype),
                      jnp.where(to_esc, 1.001 * jnp.asarray(r_max, dtype),
                                final_q[..., 1]))
    final_q = final_q.at[..., 1].set(r_new)
    return final_q, status


@partial(jax.jit, static_argnames=("steps", "order"))
def integrate_batch(q0s, p0s, steps, delta, rs, r_max, omega, order=2):
    """Integrate a flat (N, 4) batch to completion.

    Returns (final_q, final_p, status, n_steps) — final_q matches the
    reference kernel's out_qs (first copy's position, cuda_geodesic.py:601).
    n_steps is the per-ray count of steps actually applied (a free
    observability win over the reference, which discards it).
    """
    dtype = q0s.dtype
    delta = jnp.asarray(delta, dtype)
    rs = jnp.asarray(rs, dtype)
    r_max = jnp.asarray(r_max, dtype)
    subs = substep_schedule(delta, jnp.asarray(omega, dtype), order)
    cap = jump_cap(delta, dtype)

    state0 = pack_state(q0s, p0s)
    n_steps0 = jnp.zeros(q0s.shape[:-1], dtype=jnp.int32)

    def cond(carry):
        state, n_steps, k = carry
        return (k < steps) & jnp.any(_active_mask(state[1], rs, r_max))

    def body(carry):
        state, n_steps, k = carry
        active = _active_mask(state[1], rs, r_max)
        state = _masked_step(state, active, subs, rs, cap)
        return state, n_steps + active.astype(jnp.int32), k + 1

    state, n_steps, _ = jax.lax.while_loop(cond, body, (state0, n_steps0, jnp.int32(0)))

    q1r = state[1]
    status = jnp.where(q1r <= 1.1 * rs, STATUS_CAPTURED,
                       jnp.where(q1r >= r_max, STATUS_ESCAPED, STATUS_ALIVE))
    final_q, final_p = unpack_q1(state), unpack_p1(state)
    final_q, status = schw_escape_rescue(final_q, final_p, status,
                                         schw_true_escape_pred(q0s, p0s,
                                                               rs),
                                         rs, r_max)
    return final_q, final_p, status, n_steps


@partial(jax.jit, static_argnames=("steps", "order"))
def integrate_batch_compensated(q0s, p0s, steps, delta, rs, r_max, omega,
                                order=2):
    """XLA twin of the compensated Pallas kernel (equatorial rays only).

    Runs the EXACT staggered step functions the kernel compiles
    (physics.hamiltonian.staggered_eqc) through a lax.while_loop: the
    production float32 path wherever the kernel does not run, the oracle
    of kernel-vs-XLA parity checks, and the way CPU tests validate the
    compensated math at the full headline step budget.  Requires theta == pi/2, p_theta == 0 for
    every ray (the camera beta-fold guarantees this).
    """
    dtype = q0s.dtype
    delta = jnp.asarray(delta, dtype)
    rs = jnp.asarray(rs, dtype)
    r_max = jnp.asarray(r_max, dtype)
    subs = substep_schedule(delta, jnp.asarray(omega, dtype), order, omc=True)
    bridges = bridge_sizes([s[0] for s in subs])
    cap = jump_cap(delta, dtype)
    open_fn, core_fn, close_fn = staggered_eqc
    d0 = subs[0][0]

    state0 = pack_state_eqc(q0s, p0s)
    n_steps0 = jnp.zeros(q0s.shape[:-1], dtype=jnp.int32)

    act0 = _active_mask(state0[1], rs, r_max)
    if steps > 0:  # steps == 0 must be an exact no-op (matches the kernel)
        opened = open_fn(state0, d0, rs)
        state0 = tuple(jnp.where(act0, o, s)
                       for o, s in zip(opened, state0))

    def step_all(state):
        for (d_i, omc_i, sin_i), br_i in zip(subs, bridges):
            state = core_fn(state, d_i, rs, omc_i, sin_i, br_i)
        return state

    def cond(carry):
        state, n_steps, k = carry
        return (k < steps) & jnp.any(_active_mask(state[1], rs, r_max))

    def body(carry):
        state, n_steps, k = carry
        active = _active_mask(state[1], rs, r_max)
        new = guard_state(state, step_all(state), rs, cap)
        state = tuple(jnp.where(active, nw, o) for nw, o in zip(new, state))
        return state, n_steps + active.astype(jnp.int32), k + 1

    state, n_steps, _ = jax.lax.while_loop(cond, body,
                                           (state0, n_steps0, jnp.int32(0)))

    # undo the pending half-A (skip rays the guard parked at exactly r==rs)
    if steps > 0:
        closed = close_fn(state, d0, rs)
        close_mask = act0 & (state[1] != rs)
        state = tuple(jnp.where(close_mask, c, s)
                      for c, s in zip(closed, state))

    # fold deficits (true = s - c), rebuild 4-component q/p with the
    # invariant theta slots
    best = tuple(state[i] - state[12 + i] for i in range(12))
    th = jnp.full_like(best[1], jnp.pi / 2)
    zero = jnp.zeros_like(best[1])
    final_q = jnp.stack([best[0], best[1], th, best[2]], axis=-1)
    final_p = jnp.stack([best[3], best[4], zero, best[5]], axis=-1)
    q1r = best[1]
    status = jnp.where(q1r <= 1.1 * rs, STATUS_CAPTURED,
                       jnp.where(q1r >= r_max, STATUS_ESCAPED, STATUS_ALIVE))
    final_q, status = schw_escape_rescue(final_q, final_p, status,
                                         schw_true_escape_pred(q0s, p0s,
                                                               rs),
                                         rs, r_max)
    return final_q, final_p, status, n_steps


@partial(jax.jit, static_argnames=("steps", "n_keep", "order"))
def integrate_batch_full(q0s, p0s, steps, delta, rs, r_max, omega, n_keep=None,
                         order=2):
    """Trajectory-capturing variant: returns (N, n_keep, 4) positions.

    The reference stores *every* step into an (N, steps, 4) buffer and the
    caller decimates to <= 1000 points afterwards
    (cuda_geodesic.py:604-625, raytracing.py:138-143).  Storing 200k steps per
    ray is memory-hostile, so this design decimates on the fly: q1 is written
    every `stride` steps so that at most n_keep samples exist, reproducing the
    caller-side `linspace` decimation.  Rows after a ray's exit stay zero,
    matching the reference buffer semantics (main.py:107-114 filters zeros).

    With the default n_keep=None the full `steps` buffer is kept
    (stride == 1), bit-matching the reference layout for small diagnostics.
    """
    if n_keep is None or n_keep >= steps:
        n_keep_eff = steps
        stride = 1
    else:
        # ceil so that stride * n_keep covers the budget
        stride = -(-steps // n_keep)
        n_keep_eff = -(-steps // stride)

    dtype = q0s.dtype
    delta = jnp.asarray(delta, dtype)
    rs = jnp.asarray(rs, dtype)
    r_max = jnp.asarray(r_max, dtype)
    subs = substep_schedule(delta, jnp.asarray(omega, dtype), order)
    cap = jump_cap(delta, dtype)

    n = q0s.shape[0]
    traj0 = jnp.zeros((n, n_keep_eff, 4), dtype=dtype)
    state0 = pack_state(q0s, p0s)
    # "Stored" mask: the reference stores q1 each iteration *including* the
    # iteration on which it exits (store happens before the break,
    # cuda_geodesic.py:619-624), then leaves zeros.
    alive0 = jnp.ones((n,), dtype=bool)

    def body(k, carry):
        state, alive, traj = carry
        active = _active_mask(state[1], rs, r_max)
        store_now = (k % stride == 0)
        q1 = unpack_q1(state) * alive[:, None]

        def do_store(tr):
            return jax.lax.dynamic_update_slice(tr, q1[:, None, :],
                                                (0, k // stride, 0))

        traj = jax.lax.cond(store_now, do_store, lambda tr: tr, traj)
        # After the first inactive observation the ray is dead for storage too.
        alive_next = alive & active
        state = _masked_step(state, active, subs, rs, cap)
        return state, alive_next, traj

    _, _, traj = jax.lax.fori_loop(0, steps, body, (state0, alive0, traj0))
    return traj


class SchwarzschildIntegrator:
    """Drop-in analog of the reference CUDASchwarzschildIntegrator
    (cuda_geodesic.py:629-653) with the same constructor signature.

    `backend` selects 'xla' (this module) or 'pallas' (the GPU kernel,
    grtrace.engine.integrate_pallas) for `integrate_batch`.
    """

    def __init__(self, steps=500, delta=0.2, mass=1.0, omega=1.0, r_max=1e6,
                 backend="xla", dtype=jnp.float32, order=2):
        self.steps = int(steps)
        self.delta = float(delta)
        self.rs = 2.0 * float(mass)
        self.omega = float(omega)
        self.r_max = float(r_max)
        self.backend = backend
        self.dtype = dtype
        self.order = int(order)

    def integrate_batch(self, q0s, p0s):
        q0s = jnp.asarray(q0s, self.dtype)
        p0s = jnp.asarray(p0s, self.dtype)
        if self.backend == "pallas":
            from .integrate_pallas import integrate_batch_pallas
            q, p, status, n_steps = integrate_batch_pallas(
                q0s, p0s, self.steps, self.delta, self.rs, self.r_max,
                self.omega, order=self.order)
        else:
            q, p, status, n_steps = integrate_batch(
                q0s, p0s, self.steps, self.delta, self.rs, self.r_max,
                self.omega, order=self.order)
        return q, p, status, n_steps

    def integrate_batch_full(self, q0s, p0s, n_keep=None):
        q0s = jnp.asarray(q0s, self.dtype)
        p0s = jnp.asarray(p0s, self.dtype)
        return integrate_batch_full(q0s, p0s, self.steps, self.delta, self.rs,
                                    self.r_max, self.omega, n_keep,
                                    order=self.order)

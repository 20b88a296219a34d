"""Pallas GPU kernel (Triton route) for batched FANTASY geodesic integration.

The hot loop of the whole framework, in the card-native form of the
reference's `fantasy_integrate_batch_ord2` CUDA kernel (reference:
simulation/cuda_geodesic.py:579-602: one thread per ray, the whole step loop
inside one launch, a per-thread `break`).

Design:
  * One ray per thread.  A program (CUDA block) owns BLOCK rays and
    NUM_WARPS * 32 threads, so with BLOCK == NUM_WARPS * 32 every thread
    carries one ray's state rows in registers for the whole integration.
    The state lives in device memory as one (n_rows, N) array — one row
    per phase-space component — and each program loads its (BLOCK,) slice
    of every row once and stores it once.
  * Each program runs its own `lax.while_loop` that ends as soon as every
    ray of the block has been captured or escaped: the reference's
    per-thread `break` at block granularity.  Rays are sorted by the
    predicted cost |b - b_crit| first, so a block holds rays of similar
    lifetime and little masked work is wasted.
  * The physics is the same component-tuple flow code the XLA backend runs
    (grtrace.physics.hamiltonian) — the kernel only adds layout, masking
    and the early-exit loop, so the XLA twins stay its oracle.
  * Steps are applied in masked groups of UNROLL between exit checks to
    amortize the block-wide reduction; a statically-unrolled remainder
    preserves the exact `steps` budget.
  * The scalar parameters (rs, r_max, the jump cap and the substep
    schedule) are an ordinary (P,) kernel input, so one compilation serves
    every scene with the same ray count and step budget.

The kernel has no CPU lowering: off the GPU it runs only with
interpret=True (the CPU tests), and an explicit request without a GPU
raises instead of falling back.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..physics.hamiltonian import (bridge_sizes, fantasy_step_ord2_eq,
                                   fantasy_step_ord2_eqc,
                                   fantasy_step_ord2_fused, staggered_eq,
                                   staggered_eqc, yoshida_gammas)
from .integrate import (STATUS_ALIVE, STATUS_CAPTURED, STATUS_ESCAPED,
                        jump_cap, schw_escape_rescue, schw_true_escape_pred)

# Rays per program; one per thread at NUM_WARPS warps of 32.  A power of two
# (Triton block shapes must be).
BLOCK = 128
NUM_WARPS = 4
# Masked steps between early-exit checks.
UNROLL = 4

# Row count -> (plain order-2 step, staggered flows or None).  24 is the
# production Kahan-compensated equatorial layout, 12 the plain equatorial
# one, 16 the generic (theta-carrying) one.
_STEP2 = {16: fantasy_step_ord2_fused, 12: fantasy_step_ord2_eq,
          24: fantasy_step_ord2_eqc}
_STAGGERED = {12: staggered_eq, 24: staggered_eqc}
# blow-up guard rows (see engine.integrate.guard_state): q1_r is row 1 in
# every layout; q2_r and the Kahan deficit rows depend on it
_R2_ROW = {16: 9, 12: 7, 24: 7}


def require_gpu():
    """Raise unless JAX's default backend is a GPU: the compiled kernel has
    no other target, and nothing here falls back quietly."""
    if jax.default_backend() != "gpu":
        raise RuntimeError(
            "the Pallas integration kernel needs a GPU (JAX default backend "
            f"is {jax.default_backend()!r}); use backend='xla', or "
            "interpret=True in tests")


def _active(q1r, rs, r_max):
    return (q1r > 1.1 * rs) & (q1r < r_max)


def _make_kernel(n_rows, steps, n_sub, unroll, staggered, open_close):
    """Build the block kernel for any layout (16/12/24 rows) and composed
    order (n_sub = 3^((order-2)/2) substeps).  The substep schedule is
    read from the parameter vector; the per-substep loop is a static
    python unroll so the loop body stays branch-free.

    staggered=True runs the half-A-fused staggered form (see
    hamiltonian.make_staggered_flows): one masked opening half-A, cores of
    B M B A(bridge) in the loop, one masked closing half-A.  Used for the
    equatorial layouts; requires quadruple parameters per substep.

    open_close=False runs the staggered CORE loop only, on a state that is
    already in staggered form — the resumable-chunk mode (the checkpoint
    layer opens once at job start and closes once at finalize).
    """
    step2_fn = _STEP2[n_rows]
    flows = _STAGGERED[n_rows] if staggered else None
    r2_row = _R2_ROW[n_rows]
    deficit_rows = (13, 19) if n_rows == 24 else ()
    w = 4 if staggered else 3
    # steps == 0 must be an exact no-op: no opening, no closing half-A
    open_close = staggered and open_close and steps > 0

    def kernel(params_ref, state_ref, out_state_ref, ns_ref):
        rs = params_ref[0]
        r_max = params_ref[1]
        # blow-up jump cap, computed host-side from the COMPOSED step delta
        # (integrate.jump_cap) so the kernel guard matches the XLA twin's
        cap = params_ref[2]
        subs = tuple(tuple(params_ref[3 + w * j + k] for k in range(w))
                     for j in range(n_sub))

        comps = tuple(state_ref[i, :] for i in range(n_rows))
        ns0 = jnp.zeros(comps[0].shape, jnp.int32)

        if open_close:
            act0 = _active(comps[1], rs, r_max)
            d0 = subs[0][0]
            opened = flows[0](comps, d0, rs)
            comps = tuple(jnp.where(act0, o, c)
                          for o, c in zip(opened, comps))

        def masked_step(comps, ns):
            act = _active(comps[1], rs, r_max)
            new = comps
            if flows is not None:
                for d_i, cw_i, sw_i, bridge_i in subs:
                    new = flows[1](new, d_i, rs, cw_i, sw_i, bridge_i)
            else:
                for d_i, cos_i, sin_i in subs:
                    new = step2_fn(new, d_i, rs, cos_i, sin_i)
            # horizon blow-up guard: an unresolved plunge kick jumps r by
            # 10..10^4 in one step — revert the ray and park it at r = rs
            # (captured).  The negated <= form makes NaN/Inf register as bad
            # without a separate isfinite, and guard + activity masks share
            # one select chain.
            bad = ~(jnp.abs(new[1] - comps[1]) <= cap)
            ok = act & ~bad
            out = [jnp.where(ok, n, o) for n, o in zip(new, comps)]
            park = act & bad
            for row in (1, r2_row):
                out[row] = jnp.where(park, rs, out[row])
            for row in deficit_rows:
                out[row] = jnp.where(park, 0.0, out[row])
            return tuple(out), ns + act.astype(jnp.int32)

        main_iters = steps // unroll

        def cond(carry):
            k, comps, _ = carry
            # block-wide any(): Triton has no boolean reduction
            live = jnp.max(_active(comps[1], rs, r_max).astype(jnp.int32))
            return (k < main_iters) & (live > 0)

        def body(carry):
            k, comps, ns = carry
            for _ in range(unroll):
                comps, ns = masked_step(comps, ns)
            return k + 1, comps, ns

        _, comps, ns = jax.lax.while_loop(cond, body,
                                          (jnp.int32(0), comps, ns0))
        for _ in range(steps % unroll):  # static remainder, preserves budget
            comps, ns = masked_step(comps, ns)

        if open_close:
            # undo the pending half-A for every ray that was opened, except
            # those the guard parked at exactly r == rs (flow A divides by
            # r - rs there; their p/q2 are reverted garbage anyway)
            closed = flows[2](comps, d0, rs)
            close_mask = act0 & (comps[1] != rs)
            comps = tuple(jnp.where(close_mask, cl, c)
                          for cl, c in zip(closed, comps))

        for i in range(n_rows):
            out_state_ref[i, :] = comps[i]
        ns_ref[...] = ns

    return kernel


@partial(jax.jit, static_argnames=("steps", "interpret", "n_sub", "unroll",
                                   "staggered", "open_close"))
def _integrate_rows(state, params, steps, interpret=False, n_sub=1,
                    unroll=None, staggered=False, open_close=True):
    """state: (n_rows, N) with N a multiple of BLOCK; params: (P,) scalars
    [rs, r_max, cap, (d_j, c_j, s_j[, bridge_j]) x n_sub] (_substep_params).

    unroll=None keeps roughly UNROLL base steps between exit checks;
    interpret-mode callers pass 1 (same masked-step sequence, a much
    smaller trace)."""
    if not interpret:
        require_gpu()
    n_rows, n = state.shape
    if unroll is None:
        unroll = max(1, UNROLL // n_sub)
    kernel = _make_kernel(n_rows, steps, n_sub, unroll, staggered,
                          open_close)
    return pl.pallas_call(
        kernel,
        grid=(n // BLOCK,),
        in_specs=[pl.BlockSpec(params.shape, lambda i: (0,)),
                  pl.BlockSpec((n_rows, BLOCK), lambda i: (0, i))],
        out_specs=(pl.BlockSpec((n_rows, BLOCK), lambda i: (0, i)),
                   pl.BlockSpec((BLOCK,), lambda i: (i,))),
        out_shape=(jax.ShapeDtypeStruct(state.shape, state.dtype),
                   jax.ShapeDtypeStruct((n,), jnp.int32)),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="fantasy_schw",
    )(params, state)


def _pad_rows(comp, pad_col):
    """(n_rows, N) -> (n_rows, N_pad) with N_pad the next multiple of BLOCK;
    padding rays take pad_col (parked outside the domain, born inactive)."""
    n = comp.shape[1]
    n_pad = -(-n // BLOCK) * BLOCK
    pad = jnp.broadcast_to(pad_col[:, None], (comp.shape[0], n_pad - n))
    return jnp.concatenate([comp, pad], axis=1)


def _pad_col(n_rows, r_max, dtype):
    """Padding ray: r = 2 r_max in both copies (inactive from the start),
    theta = pi/2 in the generic layout."""
    col = jnp.zeros((n_rows,), dtype)
    for row in (1, _R2_ROW[n_rows]):
        col = col.at[row].set(2.0 * r_max)
    if n_rows == 16:
        col = col.at[2].set(jnp.pi / 2).at[10].set(jnp.pi / 2)
    return col


def _pack_rows(q0s, p0s, equatorial=False, compensated=False):
    """(N, 4) q/p -> (n_rows, N) component rows.

    equatorial=True drops the theta rows (12-row layout, see hamiltonian
    equatorial section); compensated=True appends 12 zero Kahan-deficit
    rows (24-row layout)."""
    if not equatorial:
        if compensated:
            raise ValueError("compensated=True requires equatorial=True")
        return jnp.concatenate([q0s.T, p0s.T, q0s.T, p0s.T], axis=0)
    half = jnp.stack([q0s[:, 0], q0s[:, 1], q0s[:, 3],
                      p0s[:, 0], p0s[:, 1], p0s[:, 3]], axis=0)  # (6, N)
    comp = jnp.concatenate([half, half], axis=0)                 # (12, N)
    if compensated:
        comp = jnp.concatenate([comp, jnp.zeros_like(comp)], axis=0)
    return comp


def _unpack_rows(comp, q0s, p0s):
    """(n_rows, N) -> final_q (N,4), final_p (N,4).

    For the equatorial layouts the theta slots are reconstructed from the
    (invariant) inputs: q_theta keeps its initial value, p_theta stays 0."""
    if comp.shape[0] == 24:  # compensated: fold the Kahan deficits (s - c)
        comp = comp[:12] - comp[12:]
    if comp.shape[0] == 12:
        final_q = jnp.stack([comp[0], comp[1], q0s[:, 2], comp[2]], axis=-1)
        final_p = jnp.stack([comp[3], comp[4], p0s[:, 2], comp[5]], axis=-1)
        return final_q, final_p
    return comp[0:4].T, comp[4:8].T


def _cost_sort_key(q0s, p0s, rs):
    """Predicted integration cost key: |b - b_crit| ascending.

    A block's runtime is the max step count over its rays; grouping rays by
    expected cost keeps blocks homogeneous.  The impact parameter follows
    from the camera momentum convention: cos(alpha) = -p_r / sqrt(f),
    b = r0 sin(alpha) / sqrt(f)  (viz.plots.alpha_from_b inverse); rays
    near the critical b_crit = 3*sqrt(3)*rs orbit longest.
    """
    r0 = q0s[:, 1]
    f = 1.0 - rs / r0
    cos_a = -p0s[:, 1] / jnp.sqrt(f)
    sin_a = jnp.sqrt(jnp.maximum(1.0 - cos_a * cos_a, 0.0))
    b = r0 * sin_a / jnp.sqrt(f)
    b_crit = 3.0 * jnp.sqrt(3.0) * rs
    return jnp.abs(b - b_crit)


def _substep_params(delta, rs, r_max, omega, order, compensated=False,
                    staggered=False):
    """Parameter vector [rs, r_max, cap, (d_i, cos_i|omc_i, sin_i
    [, bridge_i])...].  staggered=True appends the trailing-A bridge size
    0.5*(d_i + d_{(i+1) mod n}) to each substep (hamiltonian.bridge_sizes
    — computed identically here and in the XLA twin)."""
    gammas = yoshida_gammas(order)
    deltas = [g * delta for g in gammas]
    bridges = bridge_sizes(deltas)
    scal = [rs, r_max, jump_cap(delta, delta.dtype)]
    for j, d_i in enumerate(deltas):
        if compensated:
            sh = jnp.sin(omega * d_i)
            trip = [d_i, 2.0 * sh * sh, jnp.sin(2.0 * omega * d_i)]
        else:
            angle = 2.0 * omega * d_i
            trip = [d_i, jnp.cos(angle), jnp.sin(angle)]
        if staggered:
            trip.append(bridges[j])
        scal += trip
    return jnp.stack(scal), len(gammas)


def _advance_rows(state, steps, delta, rs, r_max, omega, order, interpret,
                  compensated):
    """Shared body of the resumable-chunk entry points: pad, run the
    kernel without cost sorting (the caller owns ray order across chunks),
    unpad."""
    dtype = state.dtype
    delta = jnp.asarray(delta, dtype)
    rs = jnp.asarray(rs, dtype)
    r_max = jnp.asarray(r_max, dtype)
    params, n_sub = _substep_params(delta, rs, r_max, omega, order,
                                    compensated=compensated,
                                    staggered=compensated)
    n_rows, n = state.shape
    padded = _pad_rows(state, _pad_col(n_rows, r_max, dtype))
    out, ns = _integrate_rows(padded, params, steps, interpret=interpret,
                              n_sub=n_sub, unroll=1 if interpret else None,
                              staggered=compensated, open_close=False)
    return out[:, :n], ns[:n]


@partial(jax.jit, static_argnames=("steps", "order", "interpret"))
def advance_state_pallas(state16, steps, delta, rs, r_max, omega, order=2,
                         interpret=False):
    """Advance a (16, N) phase-space-doubled state by at most `steps` masked
    steps through the kernel — the resumable-checkpoint twin of
    integrate_batch_pallas on the generic layout (engine.checkpoint's
    carry), identical masked-step semantics to checkpoint._advance.

    Returns (state16, n_steps_applied) with n_steps_applied (N,) int32.
    """
    return _advance_rows(state16, steps, delta, rs, r_max, omega, order,
                         interpret, compensated=False)


@partial(jax.jit, static_argnames=("steps", "order", "interpret"))
def advance_state_pallas_eqc(state24, steps, delta, rs, r_max, omega,
                             order=2, interpret=False):
    """Advance a (24, N) STAGGERED compensated equatorial state by at most
    `steps` masked CORE steps through the production (Kahan double-float32)
    kernel.  The carry is already opened by checkpoint.start and closed at
    checkpoint finalization, so a chunked job applies the same core-step
    sequence as the monolithic kernel.

    Returns (state24, n_steps_applied) with n_steps_applied (N,) int32.
    """
    return _advance_rows(state24, steps, delta, rs, r_max, omega, order,
                         interpret, compensated=True)


@partial(jax.jit, static_argnames=("steps", "interpret", "sort_rays",
                                   "equatorial", "order", "compensated",
                                   "unroll"))
def integrate_batch_pallas(q0s, p0s, steps, delta, rs, r_max, omega,
                           interpret=False, sort_rays=True,
                           equatorial=False, order=2, compensated=False,
                           unroll=None):
    """Kernel counterpart of engine.integrate.integrate_batch.

    Returns (final_q, final_p, status, n_steps), identical semantics to the
    XLA backend (masked stepping == per-ray break) but with per-block early
    exit inside one launch.  delta/rs/r_max/omega may be traced values.
    order in {2,4,6,8} selects the Yoshida-composed step.

    compensated=True (equatorial only) runs the Kahan double-float32 layout
    (hamiltonian compensated section) — the XLA twin is
    integrate.integrate_batch_compensated.

    The result is unroll-INVARIANT (identical masked-step sequence per ray;
    only the early-exit check cadence changes — pinned by
    tests/test_pallas_kernel.py test_unroll_invariance).
    """
    dtype = q0s.dtype
    delta = jnp.asarray(delta, dtype)
    rs = jnp.asarray(rs, dtype)
    r_max = jnp.asarray(r_max, dtype)
    omega = jnp.asarray(omega, dtype)
    # the equatorial layouts run the staggered (half-A-fused) loop; the
    # 16-row generic layout stays plain so it remains the twin of the XLA
    # integrate_batch / checkpoint advance paths
    staggered = bool(equatorial)
    params, n_sub = _substep_params(delta, rs, r_max, omega, order,
                                    compensated, staggered=staggered)
    q0s_orig, p0s_orig = q0s, p0s
    if sort_rays:
        sort_idx = jnp.argsort(_cost_sort_key(q0s, p0s, rs))
        q0s = q0s[sort_idx]
        p0s = p0s[sort_idx]
    comp = _pack_rows(q0s, p0s, equatorial=equatorial,
                      compensated=compensated)
    n_rows, n = comp.shape
    padded = _pad_rows(comp, _pad_col(n_rows, r_max, dtype))
    if unroll is None and interpret:
        unroll = 1  # explicit unroll still wins (unroll-invariance tests)
    out, ns = _integrate_rows(padded, params, steps, interpret=interpret,
                              n_sub=n_sub, unroll=unroll,
                              staggered=staggered)
    final_q, final_p = _unpack_rows(out[:, :n], q0s, p0s)
    n_steps = ns[:n]
    if sort_rays:
        # scatter back to caller order (an argsort of sort_idx would be a
        # second sort, and XLA:GPU rejects that inverse-permutation pattern
        # with 64-bit indices)
        final_q = final_q.at[sort_idx].set(final_q)
        final_p = final_p.at[sort_idx].set(final_p)
        n_steps = n_steps.at[sort_idx].set(n_steps)
    q1r = final_q[:, 1]
    status = jnp.where(q1r <= 1.1 * rs, STATUS_CAPTURED,
                       jnp.where(q1r >= r_max, STATUS_ESCAPED, STATUS_ALIVE))
    # exact-predicate classification rescue — the same deterministic
    # post-pass as the XLA backend, from the ORIGINAL-order initial phase
    # points, so backend parity is preserved
    final_q, status = schw_escape_rescue(
        final_q, final_p, status,
        schw_true_escape_pred(q0s_orig, p0s_orig, rs), rs, r_max)
    return final_q, final_p, status, n_steps

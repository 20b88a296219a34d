"""Checkpoint / resume for long integrations and multi-frame jobs.

The reference has no resume story — all state is dumped as artifacts at the
end (SURVEY.md section 5, checkpoint row).  Here the integrator state is a
first-class value: `integrate_chunked` advances the phase-space-doubled
state by bounded chunks, returning an `IntegrationState` that can be saved
(single-file np.savez for '.npz' paths, an orbax checkpoint directory
otherwise) and fed back in — resume is literally re-entering the while loop
with the loaded carry.  Both backends are resumable: `advance` routes
through the XLA masked while_loop or the Pallas kernel with identical
masked-step semantics, so exactly the long renders that need resume —
200k-step Pallas jobs — can use it.  Multi-frame orbit jobs resume at
frame granularity via their on-disk frame artifacts (grtrace.cli.orbit).

Two state layouts:

  * 'generic' — (16, N) phase-space-doubled rows, the plain flows
    (integrate.integrate_batch / integrate_pallas.advance_state_pallas).
  * 'eqc' — (24, N) Kahan-compensated staggered equatorial rows (the
    PRODUCTION fast path: the same kernel the headline render runs).  The
    carry is kept in staggered (opened) form across chunks: `start`
    applies the opening half-A once, chunks run core steps only, and the
    closing half-A happens once at read-out (final_q/final_p) — so a
    chunked job applies exactly the same step sequence as the monolithic
    kernel and the results are bit-identical (asserted by
    tests/test_aux_subsystems).  Requires equatorial rays (theta == pi/2,
    p_theta == 0 — every camera ray after the beta fold).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..physics.hamiltonian import (N_STATE, N_STATE_EQC, bridge_sizes,
                                   pack_state, pack_state_eqc,
                                   staggered_eqc, substep_schedule)
from .integrate import (STATUS_ALIVE, STATUS_CAPTURED, STATUS_ESCAPED,
                        _active_mask, _masked_step, guard_state, jump_cap)


def _abs(path) -> str:
    import os
    return os.path.abspath(str(path))


def _orbax_checkpointer():
    """Lazy orbax PyTreeCheckpointer (imported only for directory-format
    checkpoints, so the npz path has zero extra dependencies)."""
    import orbax.checkpoint as ocp
    return ocp.PyTreeCheckpointer()


@dataclasses.dataclass
class IntegrationState:
    """Resumable integrator carry.

    state: (16, N) phase-space components (q1,p1,q2,p2 x 4) for the
        'generic' layout, or (24, N) staggered compensated equatorial rows
        (12 state + 12 Kahan deficits, hamiltonian compensated section)
        for 'eqc'
    n_steps: (N,) steps applied so far
    steps_total / steps_done: budget bookkeeping
    params: (delta, rs, r_max, omega, order)
    opened: ('eqc' only) (N,) bool — rays carrying a pending opening
        half-A that the read-out must close (the initially-active set,
        exactly the monolithic kernel's act0 mask)
    """
    state: np.ndarray
    n_steps: np.ndarray
    steps_total: int
    steps_done: int
    delta: float
    rs: float
    r_max: float
    omega: float
    order: int = 2
    layout: str = "generic"
    opened: Optional[np.ndarray] = None
    esc_pred: Optional[np.ndarray] = None  # exact escape predicate (rescue)

    def _closed_best(self):
        """('eqc') closed best-estimate 12 rows (s - c after the pending
        half-A is undone) — the same read-out the monolithic
        integrate_batch_compensated performs."""
        out = _finalize_eqc(jnp.asarray(self.state), jnp.asarray(self.opened),
                            self.delta, self.rs, self.order)
        return np.asarray(out)

    def _raw_qp(self):
        if self.layout == "eqc":
            c = self._closed_best()
            th = np.full_like(c[1], np.pi / 2)
            zero = np.zeros_like(c[3])
            return (np.stack([c[0], c[1], th, c[2]], axis=-1),
                    np.stack([c[3], c[4], zero, c[5]], axis=-1))
        return np.asarray(self.state[0:4]).T, np.asarray(self.state[4:8]).T

    def _resolve(self):
        """(final_q, final_p, status) with the fake-escape rescue applied
        — the same integrate.schw_escape_rescue post-pass the monolithic
        integrators run, using the conserved impact parameters stored at
        start (so chunked and monolithic classifications agree).

        Cached per state array (the read-out runs an eqc close + rescue
        jit): reading final_q/final_p/status/done repeatedly — including
        integrate_chunked's per-chunk `done` poll — computes it once per
        advance."""
        from .integrate import schw_escape_rescue
        import jax.numpy as jnp
        cached = getattr(self, "_resolved", None)
        if cached is not None and cached[0] is self.state:
            return cached[1]
        q, p = self._raw_qp()
        r = q[:, 1]
        status = np.where(r <= 1.1 * self.rs, STATUS_CAPTURED,
                          np.where(r >= self.r_max, STATUS_ESCAPED,
                                   STATUS_ALIVE))
        if self.esc_pred is None:
            out = (q, p, status)
        else:
            fq, st = schw_escape_rescue(jnp.asarray(q), jnp.asarray(p),
                                        jnp.asarray(status),
                                        jnp.asarray(self.esc_pred, bool),
                                        self.rs, self.r_max)
            out = (np.asarray(fq), p, np.asarray(st))
        self._resolved = (self.state, out)
        return out

    @property
    def final_q(self):
        return self._resolve()[0]

    @property
    def final_p(self):
        return self._resolve()[1]

    @property
    def status(self):
        return self._resolve()[2]

    @property
    def done(self) -> bool:
        return (self.steps_done >= self.steps_total
                or not bool((self.status == STATUS_ALIVE).any()))

    def _tree(self) -> dict:
        # layout rides in meta as an int code (0 generic / 1 eqc) so the
        # tree stays pure-ndarray for both the npz and orbax formats
        code = {"generic": 0, "eqc": 1}[self.layout]
        tree = dict(state=np.asarray(self.state),
                    n_steps=np.asarray(self.n_steps),
                    meta=np.array([self.steps_total, self.steps_done, code]),
                    params=np.array([self.delta, self.rs, self.r_max,
                                     self.omega, float(self.order)]))
        if self.layout != "generic":
            tree["opened"] = np.asarray(self.opened, dtype=np.uint8)
        if self.esc_pred is not None:
            tree["esc"] = np.asarray(self.esc_pred, dtype=np.uint8)
        return tree

    def save(self, path: str) -> None:
        """Persist the carry.  A '.npz' path saves a single compressed file;
        any other path saves an orbax checkpoint directory (the multi-frame
        job format of SURVEY section 5 — async-friendly,
        per-array files, safe atomic finalization)."""
        if str(path).endswith(".npz"):
            np.savez_compressed(path, **self._tree())
        else:
            _orbax_checkpointer().save(_abs(path), self._tree(), force=True)

    @staticmethod
    def load(path: str) -> "IntegrationState":
        if str(path).endswith(".npz"):
            z = np.load(path)
        else:
            z = _orbax_checkpointer().restore(_abs(path))
        meta = np.asarray(z["meta"])
        p = z["params"]
        layout = ({0: "generic", 1: "eqc"}[int(meta[2])]
                  if meta.shape[0] > 2 else "generic")
        return IntegrationState(
            state=z["state"], n_steps=z["n_steps"],
            steps_total=int(meta[0]), steps_done=int(meta[1]),
            delta=float(p[0]), rs=float(p[1]), r_max=float(p[2]),
            omega=float(p[3]),
            order=int(p[4]) if p.shape[0] > 4 else 2,
            layout=layout,
            opened=(np.asarray(z["opened"]).astype(bool)
                    if "opened" in z else None),
            esc_pred=_load_esc_pred(z, float(p[1])))


def _load_esc_pred(z, rs):
    """Rescue predicate from a saved carry.  New carries store the exact
    predicate under 'esc'; pre-round-4 carries stored the raw impact
    parameters under 'b' — convert with the inward-ray reduction
    (b > b_crit), which is exact for every camera-launched ray (the
    pinhole grid never launches outward)."""
    if "esc" in z:
        return np.asarray(z["esc"]).astype(bool)
    if "b" in z:
        b_crit = 3.0 * np.sqrt(3.0) * (0.5 * rs)
        return np.asarray(z["b"]) > b_crit
    return None


@partial(jax.jit, static_argnames=("max_steps", "order"))
def _advance(state16, n_steps, max_steps, delta, rs, r_max, omega, order=2):
    """Advance a (16, N) state by at most max_steps masked steps."""
    dtype = state16.dtype
    delta = jnp.asarray(delta, dtype)
    rs = jnp.asarray(rs, dtype)
    r_max = jnp.asarray(r_max, dtype)
    subs = substep_schedule(delta, jnp.asarray(omega, dtype), order)
    cap = jump_cap(delta, dtype)

    comps = tuple(state16[i] for i in range(N_STATE))

    def cond(carry):
        comps, _, k = carry
        return (k < max_steps) & jnp.any(_active_mask(comps[1], rs, r_max))

    def body(carry):
        comps, ns, k = carry
        active = _active_mask(comps[1], rs, r_max)
        comps = _masked_step(comps, active, subs, rs, cap)
        return comps, ns + active.astype(jnp.int32), k + 1

    comps, n_steps, _ = jax.lax.while_loop(cond, body,
                                           (comps, n_steps, jnp.int32(0)))
    return jnp.stack(comps), n_steps


@partial(jax.jit, static_argnames=("order", "max_steps"))
def _advance_eqc(state24, n_steps, max_steps, delta, rs, r_max, omega,
                 order=2):
    """Advance a (24, N) staggered compensated state by at most max_steps
    masked CORE steps — the XLA twin of
    integrate_pallas.advance_state_pallas_eqc, body identical to
    integrate.integrate_batch_compensated's loop."""
    dtype = state24.dtype
    delta = jnp.asarray(delta, dtype)
    rs = jnp.asarray(rs, dtype)
    r_max = jnp.asarray(r_max, dtype)
    subs = substep_schedule(delta, jnp.asarray(omega, dtype), order, omc=True)
    bridges = bridge_sizes([s[0] for s in subs])
    cap = jump_cap(delta, dtype)
    _, core_fn, _ = staggered_eqc

    comps = tuple(state24[i] for i in range(N_STATE_EQC))

    def step_all(state):
        for (d_i, omc_i, sin_i), br_i in zip(subs, bridges):
            state = core_fn(state, d_i, rs, omc_i, sin_i, br_i)
        return state

    def cond(carry):
        comps, _, k = carry
        return (k < max_steps) & jnp.any(_active_mask(comps[1], rs, r_max))

    def body(carry):
        comps, ns, k = carry
        active = _active_mask(comps[1], rs, r_max)
        new = guard_state(comps, step_all(comps), rs, cap)
        comps = tuple(jnp.where(active, nw, o) for nw, o in zip(new, comps))
        return comps, ns + active.astype(jnp.int32), k + 1

    comps, n_steps, _ = jax.lax.while_loop(cond, body,
                                           (comps, n_steps, jnp.int32(0)))
    return jnp.stack(comps), n_steps


@partial(jax.jit, static_argnames=("order",))
def _finalize_eqc(state24, opened, delta, rs, order=2):
    """Undo the pending opening half-A and fold the Kahan deficits: the
    monolithic kernel's read-out (integrate.integrate_batch_compensated
    close + unpack), applied to the resumable carry.  Pure — the carry
    itself is not modified, so a job can keep advancing after a read.

    Exactness: q rows are bit-identical to the monolithic read-out (flow A
    never writes q1, so the close cannot move them); p rows can differ by
    a few ulps because this close compiles in a separate XLA program whose
    FMA contraction may round the increment and the Kahan accumulate
    differently than the close fused into the monolithic render program
    (measured: p_r only, <= 2 ulps, on a minority of rays)."""
    dtype = state24.dtype
    delta = jnp.asarray(delta, dtype)
    rs = jnp.asarray(rs, dtype)
    subs = substep_schedule(delta, jnp.zeros((), dtype), order, omc=True)
    d0 = subs[0][0]
    _, _, close_fn = staggered_eqc
    comps = tuple(state24[i] for i in range(N_STATE_EQC))
    closed = close_fn(comps, d0, rs)
    # skip rays the guard parked at exactly r == rs (flow A divides by
    # r - rs there) — identical mask to the monolithic close
    mask = opened & (comps[1] != rs)
    comps = tuple(jnp.where(mask, c, s) for c, s in zip(closed, comps))
    return jnp.stack([comps[i] - comps[12 + i] for i in range(12)])


def start(q0s, p0s, steps, delta, rs, r_max, omega,
          order=2, compensated=False) -> IntegrationState:
    """Fresh resumable integration state from (N, 4) initial conditions.

    compensated=True uses the Kahan-compensated staggered equatorial
    layout — the production fast path's numerics (requires equatorial
    rays: theta == pi/2, p_theta == 0).  The opening half-A of the
    staggered schedule is applied here, once, to the initially-active
    rays (== the monolithic kernel's masked open).
    """
    from .integrate import schw_true_escape_pred
    q0s = jnp.asarray(q0s)
    p0s = jnp.asarray(p0s)
    esc_pred = np.asarray(schw_true_escape_pred(q0s, p0s, rs))
    if compensated:
        dtype = q0s.dtype
        comps = pack_state_eqc(q0s, p0s)
        act0 = _active_mask(comps[1], jnp.asarray(rs, dtype),
                            jnp.asarray(r_max, dtype))
        if int(steps) > 0:  # steps == 0 must be an exact no-op
            subs = substep_schedule(jnp.asarray(delta, dtype),
                                    jnp.zeros((), dtype), order, omc=True)
            opened = staggered_eqc[0](comps, subs[0][0],
                                      jnp.asarray(rs, dtype))
            comps = tuple(jnp.where(act0, o, s)
                          for o, s in zip(opened, comps))
        # steps == 0 never applies the open, so nothing may be closed at
        # read-out either (exact-no-op contract)
        opened = np.asarray(act0) if int(steps) > 0 else np.zeros(
            q0s.shape[0], dtype=bool)
        return IntegrationState(
            state=np.asarray(jnp.stack(comps)),
            n_steps=np.zeros(q0s.shape[0], dtype=np.int32),
            steps_total=int(steps), steps_done=0,
            delta=float(delta), rs=float(rs), r_max=float(r_max),
            omega=float(omega), order=int(order), layout="eqc",
            opened=opened, esc_pred=esc_pred)
    comps = pack_state(q0s, p0s)
    return IntegrationState(
        state=np.asarray(jnp.stack(comps)),
        n_steps=np.zeros(q0s.shape[0], dtype=np.int32),
        steps_total=int(steps), steps_done=0,
        delta=float(delta), rs=float(rs), r_max=float(r_max),
        omega=float(omega), order=int(order), esc_pred=esc_pred)


def advance(st: IntegrationState, chunk_steps: int, backend: str = "xla",
            interpret: bool = False) -> IntegrationState:
    """Advance by at most chunk_steps (bounded wall-time per call).

    backend 'xla' runs the masked while_loop; 'pallas' the GPU kernel —
    identical semantics (bit-identical for the 'eqc' layout, whose kernel
    and XLA twin compile the same step functions), so a job may even
    switch backends between chunks.  'auto' resolves by platform.
    interpret only applies to the Pallas path (CPU tests).
    """
    from .integrate import resolve_backend
    budget = min(chunk_steps, st.steps_total - st.steps_done)
    if budget <= 0:
        return st
    use_pallas = resolve_backend(backend) == "pallas"
    if st.layout == "eqc":
        if use_pallas:
            from .integrate_pallas import advance_state_pallas_eqc
            state, applied = advance_state_pallas_eqc(
                jnp.asarray(st.state), budget, st.delta, st.rs, st.r_max,
                st.omega, order=st.order, interpret=interpret)
        else:
            state, applied = _advance_eqc(
                jnp.asarray(st.state), jnp.zeros_like(
                    jnp.asarray(st.n_steps)), budget,
                st.delta, st.rs, st.r_max, st.omega, order=st.order)
        n_steps = jnp.asarray(st.n_steps) + applied
    elif use_pallas:
        from .integrate_pallas import advance_state_pallas
        state, applied = advance_state_pallas(
            jnp.asarray(st.state), budget, st.delta, st.rs, st.r_max,
            st.omega, order=st.order, interpret=interpret)
        n_steps = jnp.asarray(st.n_steps) + applied
    else:
        state, n_steps = _advance(
            jnp.asarray(st.state), jnp.asarray(st.n_steps), budget,
            st.delta, st.rs, st.r_max, st.omega, order=st.order)
    return dataclasses.replace(
        st, state=np.asarray(state), n_steps=np.asarray(n_steps),
        steps_done=st.steps_done + budget)


def integrate_chunked(q0s, p0s, steps, delta, rs, r_max, omega,
                      chunk_steps=10_000,
                      checkpoint_path: Optional[str] = None,
                      resume: bool = False, order: int = 2,
                      backend: str = "xla", interpret: bool = False,
                      compensated: Optional[bool] = None):
    """Chunked integration with optional on-disk checkpointing.

    Equivalent to engine.integrate.integrate_batch (identical masked-step
    semantics, so the result is the same trajectory), but interruptible:
    with checkpoint_path set, the state is saved after every chunk and a
    killed job resumes from the last chunk with resume=True.  backend
    'pallas' runs the chunks through the GPU kernel.

    compensated=None auto-selects the production numerics the render
    pipeline would use (engine.integrate.integrate_dispatch): float32
    inputs get the Kahan-compensated staggered layout — so exactly the
    long renders that need resume, 200k-step float32 Pallas jobs, are
    resumable at full production fidelity (equivalent then to
    integrate_batch_compensated, bit-identically).  float64 keeps the
    plain generic layout.
    """
    import os
    if compensated is None:
        compensated = jnp.asarray(q0s).dtype == jnp.float32
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        st = IntegrationState.load(checkpoint_path)
    else:
        st = start(q0s, p0s, steps, delta, rs, r_max, omega, order=order,
                   compensated=compensated)
    while not st.done:
        st = advance(st, chunk_steps, backend=backend, interpret=interpret)
        if checkpoint_path:
            st.save(checkpoint_path)
    return st

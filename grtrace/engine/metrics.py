"""First-class observability: per-stage timers, throughput counters,
profiler hooks.

The reference's only instrumentation is tqdm progress bars and one ad-hoc
time.time() pair (SURVEY.md section 5, tracing row).  Here every render can
carry a `RenderMetrics` that records stage wall-times and derived
throughput (rays/s, geodesic steps/s), and `trace()` wraps a block in a
jax.profiler trace for TensorBoard-grade inspection on the device.
"""
from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class RenderMetrics:
    """Stage timings + throughput for one render."""
    stages: Dict[str, float] = field(default_factory=dict)
    rays: int = 0
    geodesic_steps: int = 0

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + (
                time.perf_counter() - t0)

    @property
    def total_s(self) -> float:
        return sum(self.stages.values())

    @property
    def rays_per_s(self) -> float:
        t = self.stages.get("device_pipeline", self.total_s)
        return self.rays / t if t > 0 else 0.0

    @property
    def steps_per_s(self) -> float:
        t = self.stages.get("device_pipeline", self.total_s)
        return self.geodesic_steps / t if t > 0 else 0.0

    def summary(self) -> dict:
        return {
            "stages_s": {k: round(v, 4) for k, v in self.stages.items()},
            "total_s": round(self.total_s, 4),
            "rays": self.rays,
            "geodesic_steps": self.geodesic_steps,
            "rays_per_s": round(self.rays_per_s),
            "geodesic_steps_per_s": round(self.steps_per_s),
        }

    def __str__(self) -> str:
        return json.dumps(self.summary())


# ---------------------------------------------------------------------------
# Roofline: give steps/s a denominator
# ---------------------------------------------------------------------------

# Per-primitive weights for the op count: 1 for an elementwise arithmetic,
# select or compare; more for divides, roots and transcendentals, which
# lower to several instructions on any device.  The count depends only on
# the jaxpr, not on the machine; turning it into a share of a device's peak
# is the benchmark's job.
_OP_WEIGHTS = {
    "add": 1, "sub": 1, "mul": 1, "neg": 1, "max": 1, "min": 1,
    "select_n": 1, "and": 1, "or": 1, "not": 1, "xor": 1,
    "eq": 1, "ne": 1, "lt": 1, "le": 1, "gt": 1, "ge": 1, "abs": 1,
    "sign": 1, "floor": 1, "ceil": 1, "round": 1, "clamp": 2,
    "is_finite": 1, "integer_pow": 2, "square": 1,
    "div": 4, "rem": 4, "sqrt": 4, "rsqrt": 4, "cbrt": 8,
    "exp": 8, "log": 8, "sin": 8, "cos": 8, "tan": 12, "tanh": 8,
    "atan2": 12, "asin": 12, "acos": 12, "pow": 16, "logistic": 8,
    "erf": 12, "expm1": 8, "log1p": 8,
}


def _count_jaxpr_flops(jaxpr) -> float:
    """Weighted elementwise op count of a closed jaxpr, PER ELEMENT of
    the vector shape (recurses into sub-jaxprs)."""
    total = 0.0
    for eqn in jaxpr.eqns:
        for sub in getattr(eqn, "params", {}).values():
            if hasattr(sub, "jaxpr"):
                inner = sub.jaxpr if hasattr(sub.jaxpr, "eqns") else sub
                total += _count_jaxpr_flops(inner)
        w = _OP_WEIGHTS.get(eqn.primitive.name)
        if w:
            total += w
    return total


def flops_per_ray_step(order: int = 2, compensated: bool = True) -> float:
    """Weighted ops one ray costs per COMPOSED integration step in the
    production integrator (the staggered equatorial core, the body of
    engine.integrate_pallas._make_kernel and its XLA twin), counted from
    the actual jaxpr of the step function — so the number tracks the code
    instead of a hand count going stale."""
    import jax
    import jax.numpy as jnp

    from ..physics.hamiltonian import (bridge_sizes, staggered_eq,
                                       staggered_eqc, substep_schedule)

    core = (staggered_eqc if compensated else staggered_eq)[1]
    n_rows = 24 if compensated else 12
    subs = substep_schedule(jnp.float32(0.01), jnp.float32(1.0), order,
                            omc=compensated)
    bridges = bridge_sizes([s[0] for s in subs])

    def one_step(comps):
        for (d_i, omc_i, sin_i), br_i in zip(subs, bridges):
            comps = core(comps, d_i, jnp.float32(2.0), omc_i, sin_i, br_i)
        return comps

    comps0 = tuple(jnp.zeros((), jnp.float32) for _ in range(n_rows))
    jaxpr = jax.make_jaxpr(one_step)(comps0)
    return _count_jaxpr_flops(jaxpr.jaxpr)


def roofline_report(steps_per_s: float, order: int = 2,
                    compensated: bool = True) -> dict:
    """The weighted op count per ray-step and the sustained op rate a
    measured geodesic-steps/s figure implies."""
    fps = flops_per_ray_step(order, compensated)
    return {
        "flops_per_ray_step": round(fps, 1),
        "sustained_flops": round(steps_per_s * fps),
    }


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """jax.profiler trace context (no-op when log_dir is None).

    View with TensorBoard or xprof against the produced trace directory.
    """
    if log_dir is None:
        yield
        return
    import jax
    with jax.profiler.trace(log_dir):
        yield


def nan_guard(name: str, *arrays) -> None:
    """Numeric sanitizer: raise if any array contains NaN/Inf.

    The reference's closest analog is the r >= 100 'numerical error' pixel
    class (raytracing.py:213-215); this catches non-finite state directly.
    Cheap enough to call on final (not per-step) arrays.
    """
    import numpy as np
    for k, a in enumerate(arrays):
        a = np.asarray(a)
        if not np.isfinite(a).all():
            bad = int((~np.isfinite(a)).sum())
            raise FloatingPointError(
                f"{name}: array {k} has {bad} non-finite values")

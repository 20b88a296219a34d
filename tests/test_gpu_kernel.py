"""The compiled Pallas kernel on the GPU (marker `gpu`: skips on the CPU).

Interpret mode (tests/test_pallas_kernel.py) checks the kernel's logic;
these tests check what Triton compiles from it, against the XLA twins on
the same card.  Bit-exactness is not required: Triton and XLA may contract
multiplies and adds into FMAs differently, so positions are compared to
float32 (or float64) rounding on weak-field rays and statuses exactly.
Run on the card: `python chip_smoke.py` (its last phase).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from grtrace.engine import checkpoint as ckpt
from grtrace.engine.integrate import (integrate_batch,
                                      integrate_batch_compensated)
from grtrace.engine.integrate_pallas import integrate_batch_pallas
from grtrace.physics.camera import camera_rays

pytestmark = pytest.mark.gpu

ARGS = (4000, 0.05, 2.0, 31.0, 1.0)


def _ics(n, dtype):
    q0, p0, *_ = camera_rays(jnp.asarray([30.0, 0.0, 0.0], dtype),
                             jnp.asarray(np.radians(80.0), dtype), n, n,
                             mass_bh=1.0, dtype=dtype)
    return q0.reshape(-1, 4), p0.reshape(-1, 4)


def test_compiled_compensated_kernel_matches_twin():
    q0, p0 = _ics(48, jnp.float32)
    args = tuple(jnp.float32(a) if isinstance(a, float) else a
                 for a in ARGS)
    fq_k, _, st_k, ns_k = integrate_batch_pallas(
        q0, p0, *args, equatorial=True, compensated=True)
    fq_x, _, st_x, ns_x = integrate_batch_compensated(q0, p0, *args)
    np.testing.assert_array_equal(np.asarray(st_k), np.asarray(st_x))
    np.testing.assert_array_equal(np.asarray(ns_k), np.asarray(ns_x))
    weak = np.asarray(fq_x)[:, 1] > 3.0
    d = np.abs(np.asarray(fq_k) - np.asarray(fq_x))[weak, 3]
    assert d.max() <= 1e-5


@pytest.mark.parametrize("equatorial", [False, True])
def test_compiled_plain_layouts_match_xla(equatorial):
    """The float64 16-row generic and 12-row equatorial layouts."""
    q0, p0 = _ics(24, jnp.float64)
    fq_k, _, st_k, ns_k = integrate_batch_pallas(q0, p0, *ARGS,
                                                 equatorial=equatorial)
    fq_x, _, st_x, ns_x = integrate_batch(q0, p0, *ARGS)
    np.testing.assert_array_equal(np.asarray(st_k), np.asarray(st_x))
    np.testing.assert_array_equal(np.asarray(ns_k), np.asarray(ns_x))
    weak = np.asarray(fq_x)[:, 1] > 3.0
    d = np.abs(np.asarray(fq_k) - np.asarray(fq_x)).max(axis=1)
    assert d[weak].max() < 1e-8


def test_compiled_chunk_kernel_resumes_like_monolithic():
    """Chunks through the compiled compensated chunk kernel classify
    exactly like one monolithic kernel launch."""
    q0, p0 = _ics(16, jnp.float32)
    steps = 3000
    st = ckpt.start(q0, p0, steps, 0.05, 2.0, 31.0, 1.0, compensated=True)
    while not st.done:
        st = ckpt.advance(st, 700, backend="pallas")
    f32 = jnp.float32
    _, _, status, ns = integrate_batch_pallas(
        q0, p0, steps, f32(0.05), f32(2.0), f32(31.0), f32(1.0),
        equatorial=True, compensated=True)
    np.testing.assert_array_equal(st.status, np.asarray(status))
    np.testing.assert_array_equal(st.n_steps, np.asarray(ns))

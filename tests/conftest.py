"""Test harness config: CPU backend with 8 virtual devices + float64.

Multi-device sharding tests run against a virtual 8-device CPU mesh.
float64 is enabled so oracle comparisons are meaningful.  The platform is
forced through jax.config *before* any backend is initialized, so the suite
runs on the CPU even on a machine with a GPU.  Tests marked `gpu` need the
card and skip on the CPU; chip_smoke.py runs them on the GPU in its own
process, with GRTRACE_TEST_ON_DEVICE=1 keeping the platform it already
initialized.
"""
import os

import jax

if not os.environ.get("GRTRACE_TEST_ON_DEVICE"):
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

# Persistent compile cache: off for the suite on the CPU unless
# JAX_COMPILATION_CACHE_DIR asks for it (see grtrace.enable_compilation_cache
# for why XLA:CPU executables are not cached by default).
import grtrace  # noqa: E402

grtrace.enable_compilation_cache()  # no-op on CPU unless env opt-in

# Asset resolution is env-driven (io.artifacts.resolve_background); this
# build environment mounts the reference repo's panoramas at /root/reference.
os.environ.setdefault("GRTRACE_ASSET_PATH", "/root/reference")

import pytest  # noqa: E402

# ---------------------------------------------------------------------------
# Test tiers.  The default gate (`pytest tests -q`) deselects tests marked
# `slow` — the long interpret-mode kernel runs, property-fuzz sweeps and big
# sharded grids — so it finishes in minutes and actually gets run.  The full
# suite remains one flag away:
#
#     pytest tests --runslow          # everything
#     pytest tests -m slow            # only the slow tier
#     pytest tests -n 8 --runslow     # full suite, parallel (pytest-xdist)
#
# Tier assignment lives next to the tests (pytestmark / @pytest.mark.slow),
# chosen from measured --durations on an 8-vCPU box: everything over ~20 s
# single-process is slow-tier unless it is the only coverage of a
# correctness contract (those stay in the gate regardless of cost).
# ---------------------------------------------------------------------------


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Tests marked `gpu` run only where JAX's backend is a GPU — decided
    here, per test, never while a module is imported (every xdist worker
    must collect the same tests)."""
    if request.node.get_closest_marker("gpu") and \
            jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: chip_smoke.py runs it on the card")


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (deselected by default)")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow") or config.getoption("-m"):
        return  # explicit marker expressions override the default tiering
    skip = pytest.mark.skip(reason="slow tier: pass --runslow (or -m slow)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)

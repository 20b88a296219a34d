"""Compile-cache gate: platform decisions must survive the cache setup.

The gate must not call jax.default_backend() early: that initializes the
JAX backends as a side effect, so grtrace.cli's import-time cache call
would freeze jax_platforms before CPU drivers (cli/single_ray.py,
cli/images.py, cli/exact.py) could set it, silently pinning their
documented CPU default to the accelerator.  The cache directory is
JAX_COMPILATION_CACHE_DIR when set (and then nothing is configured in
code), otherwise one fixed directory inside the checkout.

These tests run in SUBPROCESSES because the fix is precisely about what
happens before backend initialization — the suite's own process has
long since initialized the CPU backend (tests/conftest.py).
"""
import os
import subprocess
import sys

import pytest


def _run(code, env=None):
    e = dict(os.environ)
    e.pop("JAX_PLATFORMS", None)
    e.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env:
        e.update(env)
    return subprocess.run([sys.executable, "-c", code], env=e,
                          capture_output=True, text=True, timeout=300)


def test_cli_import_does_not_initialize_backend():
    r = _run(
        "import grtrace.cli\n"
        "from jax._src import xla_bridge\n"
        "assert not getattr(xla_bridge, '_backends', None), "
        "'cli import initialized a backend'\n"
        "print('OK')\n")
    assert r.returncode == 0, r.stderr
    assert "OK" in r.stdout


def test_cpu_driver_platform_decision_respected():
    """The driver flow the gate must respect: import grtrace.cli,
    THEN set jax_platforms='cpu', then driver_startup().  The backend
    must come up as cpu and the cache must be off (CPU opt-in)."""
    r = _run(
        "import grtrace.cli\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "jax.config.update('jax_enable_x64', True)\n"
        "grtrace.cli.driver_startup()\n"
        "assert jax.default_backend() == 'cpu', jax.default_backend()\n"
        "assert jax.config.jax_compilation_cache_dir is None, "
        "jax.config.jax_compilation_cache_dir\n"
        "print('OK')\n")
    assert r.returncode == 0, r.stderr
    assert "OK" in r.stdout


def test_jax_num_cpu_devices_still_settable_after_cli_import():
    """Setting device counts after backend init raises; the import-time
    cache call must leave that window open."""
    r = _run(
        "import grtrace.cli\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "jax.config.update('jax_num_cpu_devices', 4)\n"
        "assert len(jax.devices()) == 4, jax.devices()\n"
        "print('OK')\n")
    assert r.returncode == 0, r.stderr
    assert "OK" in r.stdout


def test_env_cache_dir_is_left_to_jax(tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: JAX reads it itself and the code sets
    no other directory, on any platform (the CPU included: the variable is
    the explicit request)."""
    r = _run(
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "import grtrace\n"
        "grtrace.enable_compilation_cache(allow_backend_init=True)\n"
        f"assert jax.config.jax_compilation_cache_dir == {str(tmp_path)!r}, "
        "jax.config.jax_compilation_cache_dir\n"
        "print('OK')\n",
        env={"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert r.returncode == 0, r.stderr
    assert "OK" in r.stdout


def test_default_cache_dir_is_fixed_in_checkout(tmp_path):
    """Unset variable on an accelerator platform: the cache goes to
    <checkout>/.jax_cache whatever HOME is, and that directory is
    git-ignored."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    r = _run(
        "import jax\n"
        "import grtrace\n"
        "grtrace._configured_platform = lambda: 'gpu'\n"
        "grtrace.enable_compilation_cache()\n"
        f"assert jax.config.jax_compilation_cache_dir == {want!r}, "
        "jax.config.jax_compilation_cache_dir\n"
        "print('OK')\n",
        env={"HOME": str(tmp_path)})
    assert r.returncode == 0, r.stderr
    assert "OK" in r.stdout
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()

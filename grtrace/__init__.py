"""grtrace — a JAX black-hole inverse ray tracer (Schwarzschild to Kerr-Newman).

A ground-up JAX/XLA/Pallas re-design of the capabilities of
ryanchen2134/schwarzchild-einsteinpy-raytracing (reference mounted read-only
at /root/reference): FANTASY order-2 symplectic null-geodesic integration,
pinhole-camera inverse ray tracing of the black-hole shadow / photon ring /
lensed sky, flat-space reference rendering, scene diagnostics, and
multi-chip sharding over jax.sharding meshes.
"""
from .io.scene import (BlackHole, IntegratorConfig, Observer, PatchConfig,
                       Photon, SceneConfig, apply_relative_offsets)
from .engine.render import RenderResult, render, render_pixels
from .engine.integrate import SchwarzschildIntegrator
from .engine.disk import DiskConfig, render_disk

__version__ = "0.4.0"


def _configured_platform():
    """Best-effort JAX platform name WITHOUT initializing any backend.

    jax.default_backend() initializes the backends as a side effect, which
    silently freezes jax_platforms / jax_num_cpu_devices for the rest of
    the process — a library must never do that at import time (CLI drivers
    set jax_platforms *after* importing grtrace.cli).  Order of preference:

    1. the already-initialized backend (xla_bridge's cache), if any —
       reading it is free and exact;
    2. the jax_platforms config / JAX_PLATFORMS env (first entry);
    3. None — unknowable without initializing; caller decides.
    """
    import os

    try:
        import jax
        from jax._src import xla_bridge
        if getattr(xla_bridge, "_backends", None):
            return jax.default_backend()
        plats = getattr(jax.config, "jax_platforms", None) \
            or os.environ.get("JAX_PLATFORMS", "")
        if plats:
            return plats.split(",")[0].strip().lower()
    except Exception:
        pass
    return None


def default_cache_dir():
    """The fixed compile-cache directory: `.jax_cache` at the root of the
    checkout (listed in .gitignore).  A fixed path, so that one process
    finds what an earlier one cached."""
    import os
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".jax_cache")


def enable_compilation_cache(allow_backend_init=False):
    """Turn on JAX's persistent compilation cache for this process.

    If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is
    configured here.  Otherwise the cache goes to default_cache_dir().
    Every CLI driver calls this at startup; library users opt in
    explicitly (a library must not write to disk on import).

    On the CPU backend the cache stays off unless JAX_COMPILATION_CACHE_DIR
    asks for it: XLA:CPU executable (de)serialization has crashed
    long-lived processes (executable.serialize() segfaulted inside a
    process that had compiled a few hundred CPU programs), and a native
    crash cannot be caught from Python.

    The call NEVER initializes a JAX backend unless allow_backend_init=True:
    when the platform cannot be determined without initialization (backends
    not yet up, jax_platforms/JAX_PLATFORMS unset) it defers — CLI driver
    main()s re-call with allow_backend_init=True after making their own
    platform decision (see grtrace/cli/__init__.py).
    """
    import os

    import jax
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    plat = _configured_platform()
    if plat is None:
        if not allow_backend_init:
            return
        plat = jax.default_backend()
    if plat == "cpu":
        # authoritative: undo a cache enabled by the import-time call on a
        # host whose config named an accelerator first
        jax.config.update("jax_compilation_cache_dir", None)
        return
    jax.config.update("jax_compilation_cache_dir", default_cache_dir())
    # cache everything that takes >1 s to compile, however small
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)


__all__ = [
    "BlackHole", "Observer", "Photon", "PatchConfig", "IntegratorConfig",
    "SceneConfig", "apply_relative_offsets", "RenderResult", "render",
    "render_pixels", "SchwarzschildIntegrator", "DiskConfig", "render_disk",
    "enable_compilation_cache", "default_cache_dir", "__version__",
]

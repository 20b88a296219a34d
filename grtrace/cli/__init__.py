"""CLI drivers (application context — not imported by the library core).

Importing this package enables the persistent JAX compilation cache when
the platform is already knowable (initialized backend, or
jax_platforms/JAX_PLATFORMS set); otherwise the decision is DEFERRED so
that the import never initializes a JAX backend — drivers such as
single_ray/images/exact set jax_platforms='cpu' *after* this import, and
a backend initialized here would silently pin them to the accelerator.
Each driver main() therefore calls driver_startup() after its own jax.config platform decision: by then
either jax_platforms is set (CPU drivers -> cache skipped, see
enable_compilation_cache) or initializing the backend is harmless because
the driver is about to jit anyway.

Every driver here jits long integration programs, so for CLI use the
cache turns each program's compile into a one-time cost per checkout.
Library users call grtrace.enable_compilation_cache() explicitly instead.
"""
from .. import enable_compilation_cache

enable_compilation_cache()  # defers if the platform is not yet knowable


def driver_startup():
    """Call from a driver main() AFTER its jax.config platform decision."""
    enable_compilation_cache(allow_backend_init=True)

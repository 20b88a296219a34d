"""Coordinate conversions (spherical <-> Cartesian) and the x-axis rotation trick.

Array-program replacement for the EinsteinPy coordinate helpers the reference
imports (`spherical_to_cartesian_fast` / `cartesian_to_spherical_fast`,
reference: simulation/utils.py:3).  Everything here is pure `jnp`, fully
batched, and works under `jit` / `vmap` / `shard_map`.

Conventions (identical to the reference):
    theta = arccos(z / r)   (polar angle from +z)
    phi   = atan2(y, x)     (azimuth)
"""
from __future__ import annotations

import jax.numpy as jnp


def spherical_to_cartesian(r, theta, phi):
    """(r, theta, phi) -> (x, y, z). Batched elementwise."""
    sin_th = jnp.sin(theta)
    x = r * sin_th * jnp.cos(phi)
    y = r * sin_th * jnp.sin(phi)
    z = r * jnp.cos(theta)
    return x, y, z


def cartesian_to_spherical(x, y, z):
    """(x, y, z) -> (r, theta, phi). Batched elementwise.

    Mirrors einsteinpy.coordinates.utils.cartesian_to_spherical_fast as used in
    reference simulation/utils.py:118,124,139.
    """
    r = jnp.sqrt(x * x + y * y + z * z)
    theta = jnp.arccos(z / r)
    phi = jnp.arctan2(y, x)
    return r, theta, phi


def rotate_x(x, y, z, angle):
    """Rotate points by `angle` about the +x axis (right-handed).

    R_x(a) = [[1, 0, 0], [0, cos a, -sin a], [0, sin a, cos a]].

    The reference uses this both to fold rays into the x-y plane
    (simulation/utils.py:105-113, with angle = -beta) and to un-fold hit
    points back (simulation/raytracing.py:186-194, with angle = +beta).
    `angle` may be a batched array matching x/y/z.
    """
    c = jnp.cos(angle)
    s = jnp.sin(angle)
    return x, c * y - s * z, s * y + c * z

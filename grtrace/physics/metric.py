"""Schwarzschild metric (contravariant, diagonal) and its partial derivatives.

The reference fills dense 4x4 matrices on every integrator step
(reference: simulation/cuda_geodesic.py:432-474).  The Schwarzschild metric is
diagonal, static and axisymmetric, so this design collapses the
matrix algebra to four scalars per point and only two non-trivial derivative
directions (r and theta).  All functions are pure, elementwise `jnp` programs
that batch over arbitrary leading dimensions and are reused verbatim by the
XLA integrator, the Pallas kernel and the float64 NumPy oracle (which passes
`numpy` arrays through the same expressions).

Geometrized units G = c = 1, r_s = 2M (reference: main.py:14-18).

NOTE on a deliberate fix: the reference's derivative kernel hardcodes
``d g^{tt}/dr = 2/(r-rs)^2`` and ``d g^{rr}/dr = 2/r^2``
(simulation/cuda_geodesic.py:459-464) which is only correct for rs = 2
(i.e. M = 1).  The correct general-mass forms are ``rs/(r-rs)^2`` and
``rs/r^2``; we use those.  At the default M = 1 the two agree exactly.
"""
from __future__ import annotations

import jax.numpy as jnp


def contravariant_diag(r, theta, rs):
    """Diagonal of g^{mu nu} at (r, theta): (g^tt, g^rr, g^thth, g^phph).

    Mirrors reference simulation/cuda_geodesic.py:432-447.
    """
    inv_fac = 1.0 - rs / r
    g_tt = -1.0 / inv_fac
    g_rr = inv_fac
    g_thth = 1.0 / (r * r)
    sin_th = jnp.sin(theta)
    g_phph = 1.0 / ((r * sin_th) * (r * sin_th))
    return g_tt, g_rr, g_thth, g_phph


def dcontravariant_dr(r, theta, rs):
    """d/dr of the metric diagonal (general-mass form; see module note).

    Mirrors reference simulation/cuda_geodesic.py:459-469 (wrt == 1).
    """
    denom = r - rs
    d_tt = rs / (denom * denom)
    d_rr = rs / (r * r)
    r3 = r * r * r
    d_thth = -2.0 / r3
    sin_th = jnp.sin(theta)
    d_phph = -2.0 / (r3 * sin_th * sin_th)
    return d_tt, d_rr, d_thth, d_phph


def dcontravariant_dth(r, theta, rs):
    """d/dtheta of the metric diagonal: only g^{phph} depends on theta.

    Mirrors reference simulation/cuda_geodesic.py:470-474 (wrt == 2).
    """
    sin_th = jnp.sin(theta)
    cos_th = jnp.cos(theta)
    d_phph = (-2.0 * cos_th) / ((r * r) * sin_th * sin_th * sin_th)
    return d_phph


def christoffel_nonzero(r, theta, rs):
    """Non-zero Schwarzschild Christoffel symbols as a dict of scalars.

    Used by the legacy Euler integrator (parity with the dead-code kernel at
    reference simulation/cuda_geodesic.py:303-333, offered as a cheap
    cross-check mode per SURVEY C9).
    Keys are (upper, lower1, lower2); symmetric partners are implied.
    """
    sin_th = jnp.sin(theta)
    cos_th = jnp.cos(theta)
    return {
        (0, 1, 0): rs / (2.0 * r * (r - rs)),
        (1, 0, 0): (r - rs) * rs / (2.0 * r * r * r),
        (1, 1, 1): -rs / (2.0 * r * (r - rs)),
        (1, 2, 2): -(r - rs),
        (1, 3, 3): -(r - rs) * sin_th * sin_th,
        (2, 1, 2): 1.0 / r,
        (2, 3, 3): -sin_th * cos_th,
        (3, 1, 3): 1.0 / r,
        (3, 2, 3): cos_th / sin_th,
    }

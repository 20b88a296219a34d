"""Thin accretion-disk rendering: geodesic plane-crossing capture + GR shading.

A capability beyond the reference (whose pipeline renders background lensing
only, simulation/raytracing.py:164-280): an optically-thick, geometrically
thin equatorial disk between r_in (default: the ISCO) and r_out, shaded by
the exact combined gravitational + Doppler shift of circular Keplerian
emitters (physics/orbits.py) and a Shakura-Sunyaev temperature profile.
This is the classic "Interstellar" image — the disk's far side lensed into
arcs above and below the shadow, the approaching limb Doppler-boosted.

Design: the crossing detector rides the same masked
`lax.while_loop` array program as engine.integrate_generic — an extra
(hit, hit_q, hit_p) carry records the first equatorial crossing inside the
annulus, linearly interpolated within the step (the shading inputs E = -p_t
and L_z = x p_y - y p_x are Killing constants, so interpolation error only
touches the O(delta) radius estimate, not the redshift algebra).  Rays are
traced on the horizon-regular Cartesian Kerr-Schild chart for the whole
Kerr-Newman family (Schwarzschild = a = 0); the tuned parity paths
(integrate / integrate_pallas / integrate_ks) are untouched.

Back-traced rays hit the disk at the *last* forward-time crossing first —
exactly the surface an opaque disk shows the camera, so taking the first
crossing along the backward ray is the correct opacity semantics, not an
approximation.
"""
from __future__ import annotations

import dataclasses
import functools
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..physics.hamiltonian import substep_schedule
from ..physics.orbits import isco_radius, redshift_factor
from ..physics.spacetime import METRICS, _charge, horizon_radius, ks_radius, make_step
from .integrate import STATUS_ALIVE, STATUS_CAPTURED, STATUS_ESCAPED
from .integrate_generic import _domain_tools

STATUS_DISK = 3          # extends integrate.STATUS_* (0 alive/1 cap/2 esc)
CLS_DISK = 5             # extends classify.CLS_* (0..4)


@dataclasses.dataclass
class DiskConfig:
    """Thin-disk geometry and shading knobs (geometrized units)."""
    r_in: Optional[float] = None   # inner edge; None -> prograde ISCO
    r_out: float = 14.0            # outer edge
    prograde: bool = True          # disk co-rotates with the hole
    t_peak: float = 9000.0         # color temperature (K) at the profile peak
    exposure: float = 2.5          # tone-mapping gain
    show_background: bool = True   # compose lensed sky behind the disk
    # radial temperature law: 'shakura' = the Newtonian Shakura-Sunyaev
    # profile; 'novikov' = the relativistic Novikov-Thorne flux via the
    # Page-Thorne integral (physics.orbits.page_thorne_flux) — correct GR
    # flux incl. the zero at the ISCO and the outward-shifted peak
    profile: str = "shakura"
    # emissivity power-law index q (I_em ~ r^-q) for the line-profile
    # science product (save_disk_maps); 3.0 = the standard lamp-post far
    # field / Newtonian dissipation scaling
    emissivity_index: float = 3.0
    # magnetic-field geometry for polarized imaging (Walker-Penrose EVPA
    # maps, physics.polarization): None = unpolarized, or one of
    # 'vertical' | 'toroidal' | 'radial'
    bfield: Optional[str] = None
    # camera elevation above the disk plane, degrees.  0 = edge-on (the
    # scene's standard equatorial observer; the infinitely thin disk then
    # shows only its lensed arcs).  The default gives the classic
    # foreground-band + far-side-arc view.
    elevation_deg: float = 12.0
    # camera worldline: None = static observer; a float = circular
    # worldline u = u^t (d_t + omega d_phi) with that coordinate angular
    # velocity; 'keplerian' = the circular-geodesic rate at the camera's
    # BL radius; 'zamo' = the zero-angular-momentum (locally nonrotating)
    # observer.  Exact GR aberration + Doppler via the orthonormal camera
    # tetrad (physics.camera.boosted_ics_from_pixels) and the Killing-
    # constant receiver leg (physics.orbits.redshift_factor omega_obs).
    camera_omega: "float | str | None" = None

    def __post_init__(self):
        if self.profile not in ("shakura", "novikov"):
            raise ValueError(
                f"DiskConfig.profile must be 'shakura' or 'novikov', "
                f"got {self.profile!r}")
        if self.bfield not in (None, "vertical", "toroidal", "radial"):
            raise ValueError(
                f"DiskConfig.bfield must be None, 'vertical', 'toroidal' "
                f"or 'radial', got {self.bfield!r}")
        if isinstance(self.camera_omega, str) and \
                self.camera_omega not in ("keplerian", "zamo"):
            raise ValueError(
                f"DiskConfig.camera_omega must be None, a float, "
                f"'keplerian' or 'zamo', got {self.camera_omega!r}")

    def inner_edge(self, mass, a, charge=0.0):
        """Inner disk edge: explicit r_in, else the ISCO — the BPT closed
        form for Kerr, the exact autodiff root (physics/epicyclic.py)
        once charge makes the closed form an approximation."""
        if self.r_in is not None:
            return self.r_in
        if charge:
            from ..physics.epicyclic import isco_from_kappa
            import jax.numpy as jnp
            return float(isco_from_kappa(
                jnp.array([mass, a, charge], jnp.float64), self.prograde))
        return float(isco_radius(mass, a, self.prograde))


@partial(jax.jit, static_argnames=("steps", "order", "metric"))
def integrate_batch_disk(q0s, p0s, steps, delta, params, r_max, omega,
                         r_in, r_out, order=2, metric="KerrSchild"):
    """Kerr-Schild batch integration with first-equatorial-crossing capture.

    Same early-exit/guard semantics as integrate_batch_generic on the
    KerrSchild chart, plus: when a step crosses z = 0 with the
    interpolated Boyer-Lindquist radius inside [r_in, r_out], the ray
    freezes with STATUS_DISK and (hit_q, hit_p) record the crossing.

    `metric` selects the Cartesian KS chart's mass function: 'KerrSchild'
    (the Kerr-Newman family, default) or a rotating regular family
    ('RotatingBardeen'/'RotatingHayward', physics/rotating_regular.py) —
    the chart radius, the crossing detector and the guards are all
    mass-function-blind, so the whole crossing machinery is shared.

    Returns (final_q, final_p, status, n_steps, hit_q, hit_p).
    """
    g_inv_fn = METRICS[metric]
    step1 = make_step(g_inv_fn)

    dtype = q0s.dtype
    delta = jnp.asarray(delta, dtype)
    params = jnp.asarray(params, dtype)
    r_max = jnp.asarray(r_max, dtype)
    r_in = jnp.asarray(r_in, dtype)
    r_out = jnp.asarray(r_out, dtype)
    subs = substep_schedule(delta, jnp.asarray(omega, dtype), order)

    vstep = jax.vmap(lambda q1, p1, q2, p2: step1(q1, p1, q2, p2, params,
                                                  subs))
    _, _, active_mask, guard, r_cap = _domain_tools(
        metric, params, delta, r_max, dtype, g_inv_fn)
    spin = params[1]

    n = q0s.shape[0]
    n_steps0 = jnp.zeros(n, dtype=jnp.int32)
    hit0 = jnp.zeros(n, dtype=bool)
    carry0 = (q0s, p0s, q0s, p0s, n_steps0, jnp.int32(0),
              hit0, q0s, p0s)

    def cond(c):
        q1, _, _, _, _, k, hit, _, _ = c
        return (k < steps) & jnp.any(active_mask(q1) & ~hit)

    def body(c):
        q1, p1, q2, p2, ns, k, hit, hq, hp = c
        act = active_mask(q1) & ~hit
        nq1, np1, nq2, np2 = vstep(q1, p1, q2, p2)
        bad, nq1 = guard(q1, p1, nq1, np1)
        np1 = jnp.where(bad[:, None], p1, np1)
        nq2 = jnp.where(bad[:, None], q2, nq2)
        np2 = jnp.where(bad[:, None], p2, np2)

        # --- equatorial crossing (z sign change within a sane step) ---
        z0, z1 = q1[:, 3], nq1[:, 3]
        crossed = (z0 * z1) < 0.0
        t = z0 / (z0 - z1)                     # in (0, 1) where crossed
        t = jnp.where(crossed, t, 0.0)         # keep lerp finite elsewhere
        cq = q1 + t[:, None] * (nq1 - q1)
        # record the p2 momentum copy: in this unstaggered scheme both
        # copies sit at step boundaries (equally exact), but p2 is the
        # copy the STAGGERED production kernel holds at step boundaries
        # (integrate_ks.make_ks_step), so recording it here makes the
        # two backends agree to fusion rounding instead of the much
        # larger FANTASY copy-split (which grows ~e^pi per half-orbit
        # near the photon shell)
        cp = p2 + t[:, None] * (np2 - p2)
        r_hit = ks_radius(cq[:, 1], cq[:, 2], cq[:, 3], spin)
        new_hit = (act & ~bad & crossed
                   & (r_hit >= r_in) & (r_hit <= r_out))
        hq = jnp.where(new_hit[:, None], cq, hq)
        hp = jnp.where(new_hit[:, None], cp, hp)
        hit = hit | new_hit

        ns_new = ns + act.astype(jnp.int32)
        ns_new = jnp.where(act & bad, -ns_new, ns_new)

        def masked(new, old):
            return jnp.where(act[:, None], new, old)
        return (masked(nq1, q1), masked(np1, p1), masked(nq2, q2),
                masked(np2, p2), ns_new, k + 1, hit, hq, hp)

    q1, p1, q2, _, ns, _, hit, hq, hp = jax.lax.while_loop(cond, body, carry0)

    # non-disk rays: the standard KS classification incl. the exact
    # conserved-quantity rescue of guard-parked rays (integrate_generic
    # tail) — the quartic Kerr-Newman predicate on the Kerr chart, the
    # golden-section mass-function predicate on the rotating families
    from .integrate_ks import apply_bardeen_rescue
    if metric == "KerrSchild":
        pred = None
    else:
        from ..physics.rotating_regular import escape_pred_rotating
        pred = escape_pred_rotating(metric, q0s, p0s, params)
    q1, p1, status, n_steps = apply_bardeen_rescue(
        q1, p1, ns, q2[:, 1:], q0s, p0s, params[0], params[1],
        _charge(params), r_cap, r_max, pred=pred)
    status = jnp.where(hit, STATUS_DISK, status)
    return q1, p1, status, n_steps, hq, hp


# ---------------------------------------------------------------------------
# Shading
# ---------------------------------------------------------------------------

def blackbody_rgb(kelvin):
    """Planckian-locus RGB in [0, 1] (Tanner Helland's piecewise fit,
    valid ~1000-40000 K), vectorized.  Good to a few percent — plenty for
    tone-mapped rendering."""
    t = jnp.clip(kelvin, 1000.0, 40000.0) / 100.0
    r = jnp.where(t <= 66.0, 255.0,
                  329.698727446 * jnp.maximum(t - 60.0, 1e-6) ** -0.1332047592)
    g = jnp.where(t <= 66.0,
                  99.4708025861 * jnp.log(t) - 161.1195681661,
                  288.1221695283 * jnp.maximum(t - 60.0, 1e-6) ** -0.0755148492)
    b = jnp.where(t >= 66.0, 255.0,
                  jnp.where(t <= 19.0, 0.0,
                            138.5177312231 * jnp.log(jnp.maximum(t - 10.0, 1e-6))
                            - 305.0447927307))
    rgb = jnp.stack([r, g, b], axis=-1)
    return jnp.clip(rgb, 0.0, 255.0) / 255.0


def _temp_profile(r, r_in):
    """Shakura-Sunyaev local effective temperature, normalized to its
    peak: T(r) ~ [r^-3 (1 - sqrt(r_in/r))]^(1/4), peaking at r = 49/36 r_in.
    Zero at the inner edge (no torque boundary condition)."""
    r = jnp.maximum(r, r_in * (1.0 + 1e-6))
    flux = (1.0 - jnp.sqrt(r_in / r)) / (r * r * r)
    r_pk = (49.0 / 36.0) * r_in
    flux_pk = (1.0 - jnp.sqrt(r_in / r_pk)) / (r_pk * r_pk * r_pk)
    return (jnp.maximum(flux, 0.0) / flux_pk) ** 0.25


_NT_TABLE_N = 384      # radial quadrature/interp grid for the NT profile


def _nt_temp_table(r_in, r_out, params, prograde, dtype,
                   metric="KerrSchild"):
    """Peak-normalized Novikov-Thorne temperature T(r) ~ F(r)^(1/4) on a
    geometric radial grid over the disk annulus, from the Page-Thorne
    quadrature (physics.orbits.page_thorne_flux, or its mass-function
    twin for the rotating regular families).  Static shape — the table
    builds inside the jitted render program; shading interpolates
    per-pixel with jnp.interp."""
    lo = r_in * (1.0 + 1e-5)
    u = jnp.linspace(0.0, 1.0, _NT_TABLE_N, dtype=dtype)
    r_grid = lo * (r_out / lo) ** u
    if metric == "KerrSchild":
        from ..physics.orbits import page_thorne_flux
        flux = page_thorne_flux(r_grid, params, prograde)
    else:
        from ..physics.rotating_orbits import page_thorne_flux_rotating
        from ..physics.rotating_regular import MASS_FN
        flux = page_thorne_flux_rotating(r_grid, params, MASS_FN[metric],
                                         prograde)
    t = flux ** 0.25
    return r_grid, t / jnp.maximum(jnp.max(t), 1e-30)


def shade_disk(hit_q, hit_p, params, r_obs, r_in, *, prograde=True,
               t_peak=9000.0, exposure=2.5, theta_obs=jnp.pi / 2,
               profile="shakura", r_out=14.0, omega_obs=0.0,
               metric="KerrSchild"):
    """(N, 4) crossings -> (g, rgb01): per-ray redshift factor and shaded
    color.  Physics: I_obs = g^4 I_em (Liouville), blackbody color at the
    observed temperature g * T_em(r), tone-mapped 1 - exp(-exposure * I).

    `profile` picks the radial temperature law: Shakura-Sunyaev
    (Newtonian) or Novikov-Thorne (relativistic Page-Thorne flux).
    `omega_obs` is the camera worldline's angular velocity (0 = static);
    it changes only the receiver leg of the Killing-constant redshift.
    """
    x, y = hit_q[:, 1], hit_q[:, 2]
    energy = -hit_p[:, 0]
    # L_z = x p_y - y p_x  (axial Killing vector in Cartesian components)
    l_z = x * hit_p[:, 2] - y * hit_p[:, 1]
    r_em = ks_radius(hit_q[:, 1], hit_q[:, 2], hit_q[:, 3], params[1])
    return shade_disk_constants(
        energy, l_z, r_em, params, r_obs, r_in, prograde=prograde,
        t_peak=t_peak, exposure=exposure, theta_obs=theta_obs,
        profile=profile, r_out=r_out, omega_obs=omega_obs, metric=metric)


def shade_disk_constants(energy, l_z, r_em, params, r_obs, r_in, *,
                         prograde=True, t_peak=9000.0, exposure=2.5,
                         theta_obs=jnp.pi / 2, profile="shakura",
                         r_out=14.0, omega_obs=0.0, metric="KerrSchild"):
    """shade_disk's core on the Killing constants directly: (E, L_z,
    r_em) is ALL the shading physics needs (the redshift is a ratio of
    Killing-energy projections, so E's scale and sign cancel) — which
    lets the semi-analytic renderer (engine/render_exact.py) shade
    crossings it never traced.

    metric != 'KerrSchild' selects the mass-function emitter algebra
    (physics/rotating_orbits; static receiver only — render_disk rejects
    moving cameras for those families before tracing)."""
    if metric == "KerrSchild":
        g = jax.vmap(lambda e, l, r: redshift_factor(
            e, l, r, r_obs, params, prograde, theta_obs,
            omega_obs))(energy, l_z, r_em)
    else:
        from ..physics.rotating_orbits import redshift_factor_rotating
        from ..physics.rotating_regular import MASS_FN
        m_fn = MASS_FN[metric]
        g = jax.vmap(lambda e, l, r: redshift_factor_rotating(
            e, l, r, r_obs, params, m_fn, prograde,
            theta_obs))(energy, l_z, r_em)

    if profile == "novikov":
        r_grid, t_tab = _nt_temp_table(r_in, jnp.asarray(r_out, r_em.dtype),
                                       params, prograde, r_em.dtype,
                                       metric=metric)
        t_norm = jnp.interp(r_em, r_grid, t_tab)
    else:
        t_norm = _temp_profile(r_em, r_in)      # [0, 1]
    t_obs = g * t_norm                          # observed (redshifted)
    intensity = exposure * t_obs ** 4           # g^4 beaming * T^4
    tone = 1.0 - jnp.exp(-intensity)
    # the Helland blackbody fit is already display-space (sRGB); the
    # luminance multiplier is linear, so gamma-encode it for display
    tone = tone ** (1.0 / 2.2)
    rgb = blackbody_rgb(t_obs * t_peak) * tone[:, None]
    return g, rgb


def polarization_fields(hit_q, hit_p, q0f, p0f, obs_pos, fov, height, width,
                        params, prograde, bfield, disk_mask, dtype,
                        omega_obs=0.0):
    """Walker-Penrose EVPA per disk pixel on flat (N, 4) arrays.

    Runs inside the shared shading program (shading_program), which both
    the full-frame render and transfer-map reshading invoke — the EVPA is
    a pure function of the emission event, the camera ray, and the field
    geometry, so a saved transfer map can be re-polarized for a new
    `bfield` without retracing.  omega_obs is the camera worldline's
    angular velocity (0 = static): the screen basis the angle is measured
    in is the OBSERVER's (boosted for a moving camera —
    physics.polarization.observer_evpa).
    Returns (evpa, pol_weight, pol_check), each masked to disk pixels.
    """
    from ..physics.camera import _lookat_frame
    from ..physics.polarization import (bl_from_ks, emission_polarization,
                                        observer_evpa)

    def _emit(hq, hp):
        q_bl, p_bl = bl_from_ks(hq, hp, params)
        return emission_polarization(q_bl, p_bl, params, prograde, bfield)

    kap1, kap2, sin2_b = jax.vmap(_emit)(hit_q, hit_p)
    _, _, _, cam_right, cam_up = _lookat_frame(obs_pos, fov, height,
                                               width, dtype)
    evpa, c_norm = jax.vmap(
        lambda k1, k2, qi, pi: observer_evpa(k1, k2, qi, pi, cam_up,
                                             cam_right, params,
                                             omega_obs=omega_obs)
    )(kap1, kap2, q0f, p0f)
    evpa = jnp.where(disk_mask, evpa, 0.0)
    pol_weight = jnp.where(disk_mask, sin2_b, 0.0)
    pol_check = jnp.where(disk_mask, c_norm, 1.0)
    return evpa, pol_weight, pol_check


@functools.lru_cache(maxsize=None)
def shading_program(height, width, profile, prograde, bfield,
                    camera_moving=False, metric="KerrSchild"):
    """THE jitted disk-shading program — one executable shared by the
    full-frame render (render_disk) and transfer-map reshading
    (io.transfer.reshade).

    Byte-equality contract: a reshade with the trace-time knobs must
    reproduce the original render's disk pixels EXACTLY.  Two different
    jitted programs containing the same shading subgraph are not enough —
    XLA fusion/instruction selection can differ between programs (and
    between hosts), and the steep inner-edge temperature profile
    amplifies ulp-level r_em/g deviations into visible color steps
    (round-3 verdict, tests/test_property_fuzz).  Both paths therefore
    call THIS lru-cached program on identically-shaped (H, W[, C]) inputs:
    same program -> same executable -> identical bytes.

    Consumes the per-pixel crossing invariants (hit_q, hit_p, status) plus
    the base image (disk pixels are overwritten, everything else kept) and
    the camera/annulus geometry; returns {image, redshift, disk_count}
    plus the Walker-Penrose polarization maps when `bfield` is set."""

    @jax.jit
    def run(hit_q, hit_p, status, image, params, obs_pos, fov, r_in, r_out,
            t_peak, exposure, omega_obs):
        dtype = hit_q.dtype
        n = height * width
        hq = hit_q.reshape(n, 4)
        hp = hit_p.reshape(n, 4)
        disk_mask = status.reshape(n) == STATUS_DISK

        r_obs_bl = ks_radius(obs_pos[0], obs_pos[1], obs_pos[2], params[1])
        th_obs = jnp.arccos(jnp.clip(
            obs_pos[2] / jnp.maximum(r_obs_bl, 1e-30), -1.0, 1.0))

        g, rgb01 = shade_disk(hq, hp, params, r_obs_bl, r_in,
                              prograde=prograde, t_peak=t_peak,
                              exposure=exposure, theta_obs=th_obs,
                              profile=profile, r_out=r_out,
                              omega_obs=omega_obs, metric=metric)
        disk_u8 = jnp.clip(rgb01 * 255.0 + 0.5, 0.0,
                           255.0).astype(jnp.uint8)
        out_img = jnp.where(disk_mask[:, None], disk_u8,
                            image.reshape(n, 3)).reshape(height, width, 3)
        out = {"image": out_img,
               "redshift": g.reshape(height, width),
               "disk_count": jnp.sum(disk_mask)}
        if bfield is not None:
            from ..physics.camera import (boosted_ics_from_pixels,
                                          cartesian_ics_from_pixels,
                                          pixel_grid_lookat)
            pix = pixel_grid_lookat(obs_pos, fov, height, width,
                                    dtype=dtype)
            # the camera rays the EVPA screen solve needs — recomputed
            # (deterministically) from the saved geometry rather than
            # persisted; a MOVING camera's rays come from the same
            # boosted tetrad the trace used, and the screen basis is
            # built around the same worldline (omega_obs) inside
            # observer_evpa
            if camera_moving:
                q0, p0, _ = boosted_ics_from_pixels(
                    obs_pos, pix, params=params,
                    g_inv_fn=METRICS["KerrSchild"], omega_cam=omega_obs)
            else:
                q0, p0, _ = cartesian_ics_from_pixels(
                    obs_pos, pix, params=params,
                    g_inv_fn=METRICS["KerrSchild"])
            evpa, wgt, chk = polarization_fields(
                hq, hp, q0.reshape(n, 4), p0.reshape(n, 4), obs_pos, fov,
                height, width, params, prograde, bfield, disk_mask, dtype,
                omega_obs=omega_obs if camera_moving else 0.0)
            out |= {"evpa": evpa.reshape(height, width),
                    "pol_weight": wgt.reshape(height, width),
                    "pol_check": chk.reshape(height, width)}
        return out

    return run


def run_shading(result_arrays, *, height, width, profile, prograde, bfield,
                params, obs_pos, fov, r_in, r_out, t_peak, exposure,
                camera_omega, dtype, camera_moving=False,
                metric="KerrSchild"):
    """Invoke shading_program with the canonical host->device argument
    casting.  BOTH call sites (render_disk and io.transfer.reshade) build
    their traced arguments through this function, so the executable sees
    bitwise-identical scalars regardless of which path supplied them."""
    run = shading_program(height, width, profile, prograde, bfield,
                          camera_moving, metric)
    hit_q, hit_p, status, image = result_arrays
    return run(jnp.asarray(hit_q), jnp.asarray(hit_p),
               jnp.asarray(status), jnp.asarray(image),
               jnp.asarray(np.asarray(params, np.float64), dtype),
               jnp.asarray(np.asarray(obs_pos, np.float64), dtype),
               jnp.asarray(fov, dtype), jnp.asarray(r_in, dtype),
               jnp.asarray(r_out, dtype), jnp.asarray(t_peak, dtype),
               jnp.asarray(exposure, dtype),
               jnp.asarray(camera_omega, dtype))


def disk_observer_position(scene, disk):
    """Camera position of the disk scene: `disk.elevation_deg` above the
    equatorial plane at the scene's observer distance (the inclined
    look-at camera physics/camera.pixel_grid_lookat points at the hole)."""
    elev = np.deg2rad(disk.elevation_deg)
    return np.array([scene.observer_distance * np.cos(elev), 0.0,
                     scene.observer_distance * np.sin(elev)])


def resolve_camera_omega(scene, disk):
    """DiskConfig.camera_omega -> (moving, omega) host-side.

    'keplerian' and 'zamo' resolve at the camera's BL (r, theta); an
    explicit float passes through.  Any moving camera is validated
    timelike: -(g_tt + 2 w g_tph + w^2 g_phph) > 0 at the camera event
    (otherwise the requested angular velocity exceeds the local light
    cone and no such observer exists — raise, don't clamp)."""
    from ..physics.orbits import (_invert_bl_metric, kerr_g_inv,
                                  keplerian_omega, zamo_omega)

    spec = disk.camera_omega
    if spec is None:
        return False, 0.0
    obs = disk_observer_position(scene, disk)
    params = np.array([scene.bh_mass, scene.spin, scene.charge])
    r_bl = float(ks_radius(obs[0], obs[1], obs[2], scene.spin))
    th = float(np.arccos(np.clip(obs[2] / max(r_bl, 1e-30), -1.0, 1.0)))
    # default dtype on purpose: under x64 (tests) this is f64; on the
    # f32 production path the O(1) omega only needs ~1e-7 — and forcing
    # float64 would just warn-and-truncate anyway
    if spec == "keplerian":
        omega = float(keplerian_omega(r_bl, scene.bh_mass, scene.spin,
                                      scene.charge, disk.prograde))
    elif spec == "zamo":
        omega = float(zamo_omega(r_bl, jnp.asarray(params), th))
    else:
        omega = float(spec)
    q = jnp.array([0.0, r_bl, th, 0.0])
    g = np.asarray(_invert_bl_metric(kerr_g_inv(q, jnp.asarray(params))),
                   np.float64)
    denom = -(g[0, 0] + 2.0 * omega * g[0, 3] + omega * omega * g[3, 3])
    if not denom > 0.0:
        raise ValueError(
            f"camera_omega = {omega:.6g} is superluminal at the camera "
            f"(BL r = {r_bl:.4g}, theta = {np.rad2deg(th):.3g} deg): the "
            f"circular worldline is not timelike there")
    return True, omega


# ---------------------------------------------------------------------------
# Full-frame disk render
# ---------------------------------------------------------------------------

def _trace_shade_flat(q0f, p0f, bg_array, params, r_obs, r_obs_bl, th_obs,
                      boundary_radius, steps, delta, omega, r_in, r_out,
                      t_peak, exposure, patch_center_theta, patch_center_phi,
                      patch_size_theta, patch_size_phi, *, order,
                      dtype, prograde, profile, flip_theta, flip_phi,
                      has_background, omega_obs=None, metric="KerrSchild"):
    """The per-ray disk chain on FLAT (N, 4) phase points: integrate with
    crossing capture -> shade -> classify non-disk -> composite + opaque
    overlay.  Shared verbatim by the full-frame program and the adaptive
    edge-refinement sub-ray pass (engine/aa.py) so a sub-ray through a
    pixel center reproduces the base color bit-for-bit."""
    from ..physics.coords import cartesian_to_spherical
    from . import classify as _classify

    n = q0f.shape[0]
    final_q, final_p, status, n_steps, hit_q, hit_p = integrate_batch_disk(
        q0f, p0f, steps, delta, params, boundary_radius, omega,
        r_in, r_out, order=order, metric=metric)

    disk_mask = status == STATUS_DISK
    if omega_obs is None:
        omega_obs = jnp.zeros((), dtype)
    g_fac, disk_rgb01 = shade_disk(hit_q, hit_p, params, r_obs_bl, r_in,
                                   prograde=prograde, t_peak=t_peak,
                                   exposure=exposure, theta_obs=th_obs,
                                   profile=profile, r_out=r_out,
                                   omega_obs=omega_obs, metric=metric)

    rho, th, ph = cartesian_to_spherical(final_q[:, 1], final_q[:, 2],
                                         final_q[:, 3])
    rho = jnp.where(status == STATUS_CAPTURED, jnp.zeros_like(rho), rho)
    fq_sph = jnp.stack([final_q[:, 0], rho, th, ph], axis=-1)

    if metric == "KerrSchild":
        r_plus = horizon_radius("Kerr", params[0], params[1], params[2])
    else:
        # rotating regular families: classifier fires exactly at the
        # integrator's 1.05-shell over the bisected Delta-root (or the
        # horizonless floor) — same single-source rule as render_generic
        from ..physics.rotating_regular import rotating_capture_radius
        r_plus = rotating_capture_radius(metric, params) / 1.05
    rs_classify = (1.05 / 1.2) * r_plus
    cls, th_csv, ph_csv, u01, v01 = _classify.classify_rays(
        fq_sph, jnp.full((n,), jnp.pi, dtype), jnp.zeros((n,), dtype),
        rs=rs_classify, r_obs_x=r_obs, boundary_radius=boundary_radius,
        patch_center_theta=patch_center_theta,
        patch_center_phi=patch_center_phi,
        patch_size_theta=patch_size_theta,
        patch_size_phi=patch_size_phi,
        flip_theta=flip_theta, flip_phi=flip_phi,
        has_background=has_background)
    image = _classify.composite(cls, u01, v01, bg_array if has_background
                                else jnp.zeros((1, 1, 3), dtype=jnp.uint8))

    disk_u8 = jnp.clip(disk_rgb01 * 255.0 + 0.5, 0.0,
                       255.0).astype(jnp.uint8)
    image = jnp.where(disk_mask[:, None], disk_u8, image)
    cls = jnp.where(disk_mask, CLS_DISK, cls)
    return {
        "colors": image, "cls": cls, "status": status, "n_steps": n_steps,
        "hit_q": hit_q, "hit_p": hit_p, "g_fac": g_fac, "fq_sph": fq_sph,
        "th_csv": th_csv, "ph_csv": ph_csv,
    }


@partial(jax.jit,
         static_argnames=("height", "width", "steps", "order", "flip_theta",
                          "flip_phi", "has_background", "dtype", "prograde",
                          "profile", "camera_moving", "metric"))
def render_pixels_disk(bg_array, obs_pos, fov, mass, spin, charge,
                       boundary_radius, steps, delta, omega,
                       r_in, r_out, t_peak, exposure,
                       patch_center_theta, patch_center_phi,
                       patch_size_theta, patch_size_phi,
                       camera_omega=0.0,
                       *, height, width, order=2, flip_theta=False,
                       flip_phi=False, has_background=True,
                       dtype=jnp.float32, prograde=True,
                       profile="shakura", camera_moving=False,
                       metric="KerrSchild"):
    """One compiled program: camera -> disk integration -> shade + classify
    -> RGB.  Mirrors render_pixels_generic with the disk overlay on top;
    obs_pos is a full (3,) position (the disk camera may sit above the
    plane, physics.camera.pixel_grid_lookat).  The integrator is the
    autodiff while_loop engine with the crossing monitor
    (integrate_batch_disk)."""
    from ..physics.camera import cartesian_ics_from_pixels, pixel_grid_lookat
    from . import classify as _classify

    # 'charge' doubles as the family parameter (g / l) for the rotating
    # regular metrics — both live in the third params slot
    g_inv_fn = METRICS[metric]
    params = jnp.stack([jnp.asarray(mass, dtype), jnp.asarray(spin, dtype),
                        jnp.asarray(charge, dtype)])
    obs_pos = jnp.asarray(obs_pos, dtype)
    r_obs = jnp.linalg.norm(obs_pos)
    # observer BL (r, theta) for the receiver leg of the redshift
    r_obs_bl = ks_radius(obs_pos[0], obs_pos[1], obs_pos[2], params[1])
    th_obs = jnp.arccos(jnp.clip(obs_pos[2] / jnp.maximum(r_obs_bl, 1e-30),
                                 -1.0, 1.0))
    pix = pixel_grid_lookat(obs_pos, fov, height, width, dtype=dtype)
    camera_omega = jnp.asarray(camera_omega, dtype)
    if camera_moving:
        from ..physics.camera import boosted_ics_from_pixels
        q0, p0, alpha0 = boosted_ics_from_pixels(
            obs_pos, pix, params=params, g_inv_fn=g_inv_fn,
            omega_cam=camera_omega)
    else:
        q0, p0, alpha0 = cartesian_ics_from_pixels(
            obs_pos, pix, params=params, g_inv_fn=g_inv_fn)
    n = height * width
    flat = _trace_shade_flat(
        q0.reshape(n, 4), p0.reshape(n, 4), bg_array, params, r_obs,
        r_obs_bl, th_obs, boundary_radius, steps, delta, omega, r_in,
        r_out, t_peak, exposure, patch_center_theta, patch_center_phi,
        patch_size_theta, patch_size_phi, order=order,
        dtype=dtype, prograde=prograde, profile=profile,
        flip_theta=flip_theta, flip_phi=flip_phi,
        has_background=has_background,
        omega_obs=camera_omega if camera_moving else None,
        metric=metric)
    status, n_steps = flat["status"], flat["n_steps"]
    hit_q, hit_p = flat["hit_q"], flat["hit_p"]
    g_fac = flat["g_fac"]

    image = flat["colors"].reshape(height, width, 3)
    cls = flat["cls"].reshape(height, width)
    fq_sph = flat["fq_sph"].reshape(height, width, 4)
    th_csv = flat["th_csv"].reshape(height, width)
    ph_csv = flat["ph_csv"].reshape(height, width)

    count_vec = jnp.stack([
        jnp.sum(cls == _classify.CLS_BH),
        jnp.sum(cls == _classify.CLS_IN_DOMAIN),
        jnp.sum((cls == _classify.CLS_ESCAPE_NO_PATCH)
                | (cls == _classify.CLS_ESCAPE_BG)),
        jnp.sum(cls == _classify.CLS_ESCAPE_BG),
        jnp.sum(cls == _classify.CLS_NUMERICAL),
        jnp.sum(cls == CLS_DISK),
    ])
    return {
        "image": image,
        "cls": cls,
        "final_q": fq_sph,
        "final_th": th_csv,
        "final_ph": ph_csv,
        "q0": q0,
        "p0": p0,
        "alpha0": alpha0,
        "n_steps": n_steps.reshape(height, width),
        "status": status.reshape(height, width),
        "hit_q": hit_q.reshape(height, width, 4),
        "hit_p": hit_p.reshape(height, width, 4),
        "redshift": g_fac.reshape(height, width),
        "count_vec": count_vec,
    }


def save_disk_maps(result, out_dir, emissivity_index=3.0, spin=0.0,
                   chart="ks"):
    """Write the disk mode's science products from a render_disk result:

    redshift_map.csv — one row per DISK pixel: i, j, g (= nu_obs/nu_em,
    the combined gravitational + Doppler factor), r_em (BL emission
    radius) — sparse, since off-disk pixels carry no emission.
    redshift_map.png — the g map as a diverging image (blue = blueshifted
    approaching limb, red = redshifted receding/inner disk), the standard
    presentation of thin-disk line-emission models.
    line_profile.csv/.png — the relativistic line profile: observed flux
    vs g for a monochromatic line with power-law emissivity
    I_em ~ r^-q, q = `emissivity_index` (3.0 = the standard far-field
    value; each pixel subtends equal image-plane solid angle and
    Liouville gives I_obs = g^4 I_em, so pixel flux ~ g^4 r_em^-q).
    This is the classic skewed double-horned broad-iron-line shape;
    steeper q weights the inner disk and stretches the red wing.
    """
    import os

    import numpy as np

    g = np.asarray(result.device("redshift"))
    status = np.asarray(result.device("status"))
    hq = np.asarray(result.device("hit_q"))
    dm = status == STATUS_DISK
    ii, jj = np.nonzero(dm)
    if chart == "spherical":
        # static-family planar-fold crossings (engine.disk_static) store
        # spherical (t, r, theta, phi): the areal radius is hit_q[..., 1]
        r_em = hq[dm, 1]
    else:
        # BL radius of the Kerr-Schild crossing point — NOT the Euclidean
        # norm, which overshoots by ~a^2/2r on spinning holes (the shading
        # itself always used ks_radius; callers pass the scene's spin)
        r_em = np.asarray(ks_radius(hq[dm, 1], hq[dm, 2], hq[dm, 3], spin))
    rows = np.column_stack([ii, jj, g[dm], r_em])
    header = "i,j,redshift_g,r_emission"
    np.savetxt(os.path.join(out_dir, "redshift_map.csv"), rows,
               delimiter=",", header=header, comments="",
               fmt=("%d", "%d", "%.8g", "%.8g"))

    g_disk = g[dm]
    if g_disk.size:
        flux = g_disk ** 4 * r_em ** -float(emissivity_index)
        hist, edges = np.histogram(g_disk, bins=48, weights=flux)
        centers = 0.5 * (edges[1:] + edges[:-1])
        peak = hist.max()
        if peak > 0:
            hist = hist / peak
        np.savetxt(os.path.join(out_dir, "line_profile.csv"),
                   np.column_stack([centers, hist]), delimiter=",",
                   header="g,relative_flux", comments="", fmt="%.8g")

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if g_disk.size:
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.plot(centers, hist, drawstyle="steps-mid")
        ax.set_xlabel("g = $\\nu_{obs}/\\nu_{em}$")
        ax.set_ylabel("relative flux")
        ax.set_title("relativistic line profile "
                     f"($r^{{-{float(emissivity_index):g}}}$ emissivity)")
        fig.savefig(os.path.join(out_dir, "line_profile.png"), dpi=110,
                    bbox_inches="tight")
        plt.close(fig)

    fig, ax = plt.subplots(figsize=(6, 5))
    gm = np.ma.masked_where(~dm, g)
    span = max(abs(1.0 - gm.min()), abs(gm.max() - 1.0)) if dm.any() else 1.0
    # RdBu (unreversed): low g -> red (redshifted), high g -> blue
    im = ax.imshow(gm, cmap="RdBu", vmin=1.0 - span, vmax=1.0 + span)
    ax.set_facecolor("black")
    ax.set_title("disk redshift factor g = $\\nu_{obs}/\\nu_{em}$")
    fig.colorbar(im, ax=ax, label="g  (<1 redshifted, >1 blueshifted)")
    fig.savefig(os.path.join(out_dir, "redshift_map.png"), dpi=110,
                bbox_inches="tight")
    plt.close(fig)

    if result.has("evpa"):
        _save_polarization_maps(result, out_dir, dm, ii, jj)


def _save_polarization_maps(result, out_dir, dm, ii, jj):
    """Polarized-imaging artifacts (bfield set on DiskConfig):

    polarization_map.csv — per disk pixel: i, j, evpa (radians, mod pi,
    measured from camera-up toward camera-right), pol_weight
    (sin^2 pitch angle: the synchrotron fractional-polarization
    geometry factor), pol_check (WP screen-solve norm, ~1).
    polarization_map.png — EVPA ticks over the rendered disk, the
    standard EHT-style presentation.
    """
    import os

    import numpy as np

    evpa = np.asarray(result.device("evpa"))
    wgt = np.asarray(result.device("pol_weight"))
    chk = np.asarray(result.device("pol_check"))
    rows = np.column_stack([ii, jj, evpa[dm], wgt[dm], chk[dm]])
    np.savetxt(os.path.join(out_dir, "polarization_map.csv"), rows,
               delimiter=",", comments="",
               header="i,j,evpa_rad,pol_weight,pol_check",
               fmt=("%d", "%d", "%.8g", "%.8g", "%.8g"))

    polarization_ticks_png(result, os.path.join(out_dir,
                                                "polarization_map.png"))


def polarization_ticks_png(result, path, stride=1, dpi=110, scale=28.0,
                           width=0.003):
    """EVPA tick overlay on the rendered frame (EHT-style presentation).

    `stride` subsamples the tick grid for dense images.  EVPA chi is the
    screen direction cos(chi)*up + sin(chi)*right; image rows advance
    along the camera's up vector and columns along right, so the tick in
    (col, row) components is (sin, cos), scaled by the pitch-angle
    weight."""
    import numpy as np

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    evpa = np.asarray(result.device("evpa"))
    wgt = np.asarray(result.device("pol_weight"))
    dm = np.asarray(result.device("status")) == STATUS_DISK
    if stride > 1:
        keep = np.zeros_like(dm)
        keep[::stride, ::stride] = True
        dm = dm & keep
    ii, jj = np.nonzero(dm)

    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(result.image)
    if dm.any():
        dj = np.sin(evpa[dm]) * wgt[dm]
        di = np.cos(evpa[dm]) * wgt[dm]
        ax.quiver(jj, ii, dj, di, color="white", scale=scale,
                  headwidth=1, headlength=0, headaxislength=0,
                  pivot="middle", width=width)
    ax.set_title("disk polarization (EVPA ticks, length ~ sin$^2\\theta_B$)")
    ax.set_axis_off()
    fig.savefig(path, dpi=dpi, bbox_inches="tight")
    plt.close(fig)


def render_disk(scene, disk: DiskConfig = None, *, bg_array=None, dtype=None,
                metrics=None, aa_samples=None):
    """SceneConfig-driven disk render -> engine.render.RenderResult.

    scene.metric/spin/charge select the hole (everything runs on the
    Kerr-Schild chart; Schwarzschild is spin = 0).  The result's counts
    carry an extra 'disk' entry; result.device('redshift') is the per-pixel
    g factor (NaN-free: 0 off-disk).
    """
    from .metrics import RenderMetrics
    from .render import RenderResult

    disk = disk or DiskConfig()
    want_metrics = metrics is not None
    if metrics is None:
        metrics = RenderMetrics()
    h, w = scene.image_size
    integ = scene.integrator
    if dtype is None:
        dtype = jnp.float64 if integ.dtype == "float64" else jnp.float32
    has_bg = bg_array is not None and disk.show_background
    bg_dev = (jnp.asarray(bg_array, dtype=jnp.uint8) if has_bg
              else jnp.zeros((1, 1, 3), dtype=jnp.uint8))

    # rotating regular families share the whole pipeline — the family
    # parameter rides the charge slot, the emitter algebra comes from
    # physics/rotating_orbits, everything else is mass-function-blind
    rotating_names = {"rotating-bardeen": "RotatingBardeen",
                      "rotatingbardeen": "RotatingBardeen",
                      "rotating-hayward": "RotatingHayward",
                      "rotatinghayward": "RotatingHayward"}
    metric = rotating_names.get(
        getattr(scene, "metric", "Schwarzschild").lower(), "KerrSchild")
    if metric == "KerrSchild":
        charge_slot = scene.charge
        r_in = disk.inner_edge(scene.bh_mass, scene.spin, scene.charge)
        camera_moving, camera_omega = resolve_camera_omega(scene, disk)
    else:
        if disk.bfield is not None:
            raise NotImplementedError(
                "polarized imaging (DiskConfig.bfield) requires the "
                "Walker-Penrose constant of the exact Kerr-Newman "
                "family — not wired for the mass-function metrics")
        if disk.camera_omega is not None:
            raise NotImplementedError(
                "orbiting cameras (DiskConfig.camera_omega) are wired "
                "for the Kerr-Newman disk path only")
        if aa_samples:
            raise NotImplementedError(
                "--aa on the disk mode rides the Kerr-Newman sub-ray "
                "chain; rotating regular disks render without edge "
                "refinement")
        charge_slot = scene.metric_param
        if disk.r_in is not None:
            r_in = disk.r_in
        else:
            from ..physics.rotating_orbits import rotating_disk_inner_edge
            r_in = rotating_disk_inner_edge(metric, scene.bh_mass,
                                            scene.spin, charge_slot,
                                            disk.prograde)
        camera_moving, camera_omega = False, 0.0
    obs_pos = disk_observer_position(scene, disk)

    with metrics.stage("device_pipeline"):
        out = render_pixels_disk(
            bg_dev,
            jnp.asarray(obs_pos, dtype),
            jnp.asarray(scene.fov, dtype),
            jnp.asarray(scene.bh_mass, dtype),
            jnp.asarray(scene.spin, dtype),
            jnp.asarray(charge_slot, dtype),
            jnp.asarray(scene.boundary_radius, dtype),
            integ.steps,
            jnp.asarray(integ.delta, dtype),
            jnp.asarray(integ.omega, dtype),
            jnp.asarray(r_in, dtype),
            jnp.asarray(disk.r_out, dtype),
            jnp.asarray(disk.t_peak, dtype),
            jnp.asarray(disk.exposure, dtype),
            jnp.asarray(scene.patch.center_theta, dtype),
            jnp.asarray(scene.patch.center_phi, dtype),
            jnp.asarray(scene.patch.size_theta, dtype),
            jnp.asarray(scene.patch.size_phi, dtype),
            jnp.asarray(camera_omega, dtype),
            height=h, width=w, order=integ.order,
            flip_theta=scene.patch.flip_theta,
            flip_phi=scene.patch.flip_phi,
            has_background=has_bg, dtype=dtype, prograde=disk.prograde,
            profile=disk.profile, camera_moving=camera_moving,
            metric=metric)

        # Re-shade the disk pixels through THE shared shading executable
        # (shading_program): the same program io.transfer.reshade runs, so
        # a transfer-map round trip reproduces these bytes exactly.  The
        # fused program's own shading still feeds counts and the AA
        # sub-ray pass; the final image/redshift (and polarization maps)
        # come from the shared program.  Cost: one elementwise program
        # over H*W pixels — microseconds against the geodesic trace.
        shaded = run_shading(
            (out["hit_q"], out["hit_p"], out["status"], out["image"]),
            height=h, width=w, profile=disk.profile, prograde=disk.prograde,
            bfield=disk.bfield,
            params=[scene.bh_mass, scene.spin, charge_slot],
            obs_pos=obs_pos, fov=scene.fov, r_in=r_in, r_out=disk.r_out,
            t_peak=disk.t_peak, exposure=disk.exposure,
            camera_omega=camera_omega, dtype=dtype,
            camera_moving=camera_moving, metric=metric)
        out["image"] = shaded["image"]
        out["redshift"] = shaded["redshift"]
        for key in ("evpa", "pol_weight", "pol_check"):
            if key in shaded:
                out[key] = shaded[key]

        if aa_samples:
            from .aa import refine_edges_disk
            out["image"], out["aa_mask"] = refine_edges_disk(
                out["cls"], out["image"], bg_dev,
                jnp.asarray(obs_pos, dtype),
                jnp.asarray(scene.fov, dtype),
                jnp.asarray(scene.bh_mass, dtype),
                jnp.asarray(scene.spin, dtype),
                jnp.asarray(scene.charge, dtype),
                jnp.asarray(scene.boundary_radius, dtype),
                integ.steps,
                jnp.asarray(integ.delta, dtype),
                jnp.asarray(integ.omega, dtype),
                jnp.asarray(r_in, dtype),
                jnp.asarray(disk.r_out, dtype),
                jnp.asarray(disk.t_peak, dtype),
                jnp.asarray(disk.exposure, dtype),
                jnp.asarray(scene.patch.center_theta, dtype),
                jnp.asarray(scene.patch.center_phi, dtype),
                jnp.asarray(scene.patch.size_theta, dtype),
                jnp.asarray(scene.patch.size_phi, dtype),
                jnp.asarray(camera_omega, dtype),
                height=h, width=w, samples=int(aa_samples),
                order=integ.order,
                flip_theta=scene.patch.flip_theta,
                flip_phi=scene.patch.flip_phi,
                has_background=has_bg, dtype=dtype,
                prograde=disk.prograde, profile=disk.profile,
                camera_moving=camera_moving)

        # the counts fetch is the device sync, so it belongs to the stage
        cv = np.asarray(out.pop("count_vec"))
    counts = {"captured": int(cv[0]), "in_domain": int(cv[1]),
              "escaped": int(cv[2]), "background": int(cv[3]),
              "numerical_error": int(cv[4]), "disk": int(cv[5])}
    metrics.rays = h * w
    if want_metrics:
        metrics.geodesic_steps = int(np.asarray(out["n_steps"],
                                                np.int64).sum())
    out["beta"] = jnp.zeros((h, w), dtype)
    out["heading"] = jnp.zeros((h, w, 3), dtype)
    return RenderResult(out, counts)

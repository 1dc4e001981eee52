"""Balanced initial states for the isentropic model.

JAX re-design of reference ``src/tasmania/isentropic/state.py:61,394``:
build a hydrostatically balanced state from a uniform Brunt–Väisälä frequency
(or temperature) via backward vertical recurrences — expressed as cumulative
sums, mirroring the diagnostics module.  Exact recurrences match the reference
(``state.py:159-205``) for allclose validation.
"""

from __future__ import annotations

from datetime import datetime
from typing import Any, Dict, Optional

import numpy as np

from tasmania_jax.framework.field import FieldArray
from tasmania_jax.framework.options import StorageOptions
from tasmania_jax.utils.constants import get_physical_constants
from tasmania_jax.utils.meteo import convert_relative_humidity_to_water_vapor

mfwv = "mass_fraction_of_water_vapor_in_air"
mfcw = "mass_fraction_of_cloud_liquid_water_in_air"
mfpw = "mass_fraction_of_precipitation_water_in_air"

_DEFAULTS = {
    "gas_constant_of_dry_air": (287.05, "J K^-1 kg^-1"),
    "gravitational_acceleration": (9.80665, "m s^-2"),
    "reference_air_pressure": (1.0e5, "Pa"),
    "specific_heat_of_dry_air_at_constant_pressure": (1004.0, "J K^-1 kg^-1"),
}

DIMS = ("x", "y", "z")


def _scalar(value, units: str) -> float:
    if isinstance(value, FieldArray):
        return float(np.asarray(value.to_units(units).data))
    return float(value)


def get_isentropic_state_from_brunt_vaisala_frequency(
    grid,
    time: datetime,
    x_velocity,
    y_velocity,
    brunt_vaisala,
    moist: bool = False,
    precipitation: bool = False,
    relative_humidity: float = 0.5,
    physical_constants=None,
    *,
    backend: str = "jax",
    storage_options: Optional[StorageOptions] = None,
) -> Dict[str, Any]:
    """Balanced state from uniform (u, v, N) (reference ``state.py:61``)."""
    nx, ny, nz = grid.nx, grid.ny, grid.nz
    so = storage_options or StorageOptions()
    dtype = so.dtype
    dz = float(np.asarray(grid.dz.to_units("K").data))
    hs = np.asarray(grid.topography.profile.to_units("m").data)  # (nx, ny)
    bv = _scalar(brunt_vaisala, "s^-1")
    uval = _scalar(x_velocity, "m s^-1")
    vval = _scalar(y_velocity, "m s^-1")

    pcs = get_physical_constants(_DEFAULTS, physical_constants)
    Rd = pcs["gas_constant_of_dry_air"]
    g = pcs["gravitational_acceleration"]
    pref = pcs["reference_air_pressure"]
    cp = pcs["specific_heat_of_dry_air_at_constant_pressure"]

    theta1d = np.asarray(grid.z.to_units("K").data)[np.newaxis, np.newaxis, :]
    theta_s = float(np.asarray(grid.z_on_interface_levels.to_units("K").data)[-1])

    # velocities
    u = np.full((nx + 1, ny, nz), uval, dtype=dtype)
    v = np.full((nx, ny + 1, nz), vval, dtype=dtype)

    # height of interface levels: h[nz] = hs; h[k] = h[k+1] + g dz/(N² θ[k])
    # (reference ``state.py:162-167``) -> backward cumsum
    dh = g * dz / ((bv**2) * theta1d[0, 0, :])  # (nz,)
    h = np.empty((nx, ny, nz + 1), dtype=dtype)
    h[:, :, nz] = hs
    csum = np.cumsum(dh[::-1])[::-1]  # Σ_{l>=k} dh[l]
    h[:, :, :nz] = hs[:, :, np.newaxis] + csum[np.newaxis, np.newaxis, :]

    # Exner on interface levels: exn[nz] = cp; exn[k] = exn[k+1] − dz g²/(N² θ[k]²)
    dexn = dz * (g**2) / ((bv**2) * theta1d[0, 0, :] ** 2)
    exn = np.empty((nx, ny, nz + 1), dtype=dtype)
    exn[:, :, nz] = cp
    exn_1d = cp - np.cumsum(dexn[::-1])[::-1]
    exn[:, :, :nz] = exn_1d[np.newaxis, np.newaxis, :]

    # pressure, Montgomery, isentropic density, momenta
    p = pref * (exn / cp) ** (cp / Rd)
    mtg_s = g * h[:, :, nz] + theta_s * exn[:, :, nz]
    mtg = np.empty((nx, ny, nz), dtype=dtype)
    mtg[:, :, nz - 1] = mtg_s + 0.5 * dz * exn[:, :, nz]
    for k in range(nz - 2, -1, -1):
        mtg[:, :, k] = mtg[:, :, k + 1] + dz * exn[:, :, k + 1]

    s = -(p[:, :, :nz] - p[:, :, 1 : nz + 1]) / (g * dz)
    su = 0.5 * s * (u[:nx] + u[1 : nx + 1])
    sv = 0.5 * s * (v[:, :ny] + v[:, 1 : ny + 1])

    def dev(x):
        if backend.startswith("numpy"):
            return x
        import jax.numpy as jnp

        return jnp.asarray(x)

    state: Dict[str, Any] = {
        "time": time,
        "air_isentropic_density": FieldArray(dev(s), "kg m^-2 K^-1", DIMS),
        "air_pressure_on_interface_levels": FieldArray(
            dev(p), "Pa", ("x", "y", "z_on_interface_levels")
        ),
        "exner_function_on_interface_levels": FieldArray(
            dev(exn), "J K^-1 kg^-1", ("x", "y", "z_on_interface_levels")
        ),
        "height_on_interface_levels": FieldArray(
            dev(h), "m", ("x", "y", "z_on_interface_levels")
        ),
        "montgomery_potential": FieldArray(dev(mtg), "m^2 s^-2", DIMS),
        "x_momentum_isentropic": FieldArray(dev(su), "kg m^-1 K^-1 s^-1", DIMS),
        "x_velocity_at_u_locations": FieldArray(
            dev(u), "m s^-1", ("x_at_u_locations", "y", "z")
        ),
        "y_momentum_isentropic": FieldArray(dev(sv), "kg m^-1 K^-1 s^-1", DIMS),
        "y_velocity_at_v_locations": FieldArray(
            dev(v), "m s^-1", ("x", "y_at_v_locations", "z")
        ),
    }

    if moist:
        rho = s * dz / (h[:, :, :nz] - h[:, :, 1 : nz + 1])
        temp = 0.5 * (exn[:, :, :nz] + exn[:, :, 1 : nz + 1]) * theta1d / cp
        state["air_density"] = FieldArray(dev(rho), "kg m^-3", DIMS)
        state["air_temperature"] = FieldArray(dev(temp), "K", DIMS)

        p_unstg = 0.5 * (p[:, :, :nz] + p[:, :, 1 : nz + 1])
        qv = convert_relative_humidity_to_water_vapor(
            "tetens", p_unstg, np.asarray(temp), np.full_like(s, relative_humidity)
        )
        state[mfwv] = FieldArray(dev(qv.astype(dtype)), "g g^-1", DIMS)
        state[mfcw] = FieldArray(dev(np.zeros_like(s)), "g g^-1", DIMS)
        state[mfpw] = FieldArray(dev(np.zeros_like(s)), "g g^-1", DIMS)

        if precipitation:
            state["precipitation"] = FieldArray(
                dev(np.zeros((nx, ny, 1), dtype=dtype)), "mm hr^-1", DIMS
            )
            state["accumulated_precipitation"] = FieldArray(
                dev(np.zeros((nx, ny, 1), dtype=dtype)), "mm", DIMS
            )

    return state


def get_isentropic_state_from_temperature(
    grid,
    time: datetime,
    x_velocity,
    y_velocity,
    background_temperature,
    bubble_center_x=None,
    bubble_center_y=None,
    bubble_center_height=None,
    bubble_radius=None,
    bubble_maximum_perturbation=None,
    moist: bool = False,
    precipitation: bool = False,
    relative_humidity: float = 0.5,
    physical_constants=None,
    *,
    backend: str = "jax",
    storage_options: Optional[StorageOptions] = None,
) -> Dict[str, Any]:
    """Balanced state from a uniform background temperature, optionally with a
    warm bubble (reference ``state.py:394``): the Exner function follows from
    exn = cp·T/θ on each isentrope, the rest mirrors the N²-based factory."""
    nx, ny, nz = grid.nx, grid.ny, grid.nz
    so = storage_options or StorageOptions()
    dtype = so.dtype
    dz = float(np.asarray(grid.dz.to_units("K").data))
    hs = np.asarray(grid.topography.profile.to_units("m").data)
    uval = _scalar(x_velocity, "m s^-1")
    vval = _scalar(y_velocity, "m s^-1")
    temp0 = _scalar(background_temperature, "K")

    pcs = get_physical_constants(_DEFAULTS, physical_constants)
    Rd = pcs["gas_constant_of_dry_air"]
    g = pcs["gravitational_acceleration"]
    pref = pcs["reference_air_pressure"]
    cp = pcs["specific_heat_of_dry_air_at_constant_pressure"]

    theta_hl = np.asarray(grid.z_on_interface_levels.to_units("K").data)  # (nz+1,)
    theta_s = float(theta_hl[-1])

    # temperature field (uniform background + optional bubble perturbation)
    t_hl = np.full((nx, ny, nz + 1), temp0, dtype=dtype)
    if bubble_maximum_perturbation is not None:
        cx = _scalar(bubble_center_x, "m") if bubble_center_x is not None else 0.0
        cy = _scalar(bubble_center_y, "m") if bubble_center_y is not None else 0.0
        ch = _scalar(bubble_center_height, "m") if bubble_center_height is not None else 0.0
        r = _scalar(bubble_radius, "m") if bubble_radius is not None else 1.0
        dt_max = _scalar(bubble_maximum_perturbation, "K")
        xv = np.asarray(grid.x.to_units("m").data)[:, None, None]
        yv = np.asarray(grid.y.to_units("m").data)[None, :, None]
        # crude height estimate from the isothermal profile
        zv = (
            -Rd * temp0 / g * np.log(theta_hl / theta_s)
        )[None, None, :]
        dist = np.sqrt(((xv - cx) / r) ** 2 + ((yv - cy) / r) ** 2 + ((zv - ch) / r) ** 2)
        t_hl = t_hl + dt_max * np.where(dist < 1.0, np.cos(0.5 * np.pi * dist) ** 2, 0.0)

    # Exner on interface levels: exn = cp T / θ
    exn = cp * t_hl / theta_hl[np.newaxis, np.newaxis, :]
    p = pref * (exn / cp) ** (cp / Rd)

    # height from hydrostatic integration (backward, as in the diagnostics)
    h = np.empty((nx, ny, nz + 1), dtype=dtype)
    h[:, :, nz] = hs
    for k in range(nz - 1, -1, -1):
        h[:, :, k] = h[:, :, k + 1] - Rd * (
            theta_hl[k] * exn[:, :, k] + theta_hl[k + 1] * exn[:, :, k + 1]
        ) * (p[:, :, k] - p[:, :, k + 1]) / (cp * g * (p[:, :, k] + p[:, :, k + 1]))

    mtg_s = g * h[:, :, nz] + theta_s * exn[:, :, nz]
    mtg = np.empty((nx, ny, nz), dtype=dtype)
    mtg[:, :, nz - 1] = mtg_s + 0.5 * dz * exn[:, :, nz]
    for k in range(nz - 2, -1, -1):
        mtg[:, :, k] = mtg[:, :, k + 1] + dz * exn[:, :, k + 1]

    s = -(p[:, :, :nz] - p[:, :, 1 : nz + 1]) / (g * dz)
    u = np.full((nx + 1, ny, nz), uval, dtype=dtype)
    v = np.full((nx, ny + 1, nz), vval, dtype=dtype)
    su = 0.5 * s * (u[:nx] + u[1 : nx + 1])
    sv = 0.5 * s * (v[:, :ny] + v[:, 1 : ny + 1])

    def dev(x):
        if backend.startswith("numpy"):
            return x
        import jax.numpy as jnp

        return jnp.asarray(x)

    state: Dict[str, Any] = {
        "time": time,
        "air_isentropic_density": FieldArray(dev(s), "kg m^-2 K^-1", DIMS),
        "air_pressure_on_interface_levels": FieldArray(
            dev(p.astype(dtype)), "Pa", ("x", "y", "z_on_interface_levels")
        ),
        "exner_function_on_interface_levels": FieldArray(
            dev(exn.astype(dtype)), "J K^-1 kg^-1", ("x", "y", "z_on_interface_levels")
        ),
        "height_on_interface_levels": FieldArray(
            dev(h), "m", ("x", "y", "z_on_interface_levels")
        ),
        "montgomery_potential": FieldArray(dev(mtg), "m^2 s^-2", DIMS),
        "x_momentum_isentropic": FieldArray(dev(su), "kg m^-1 K^-1 s^-1", DIMS),
        "x_velocity_at_u_locations": FieldArray(
            dev(u), "m s^-1", ("x_at_u_locations", "y", "z")
        ),
        "y_momentum_isentropic": FieldArray(dev(sv), "kg m^-1 K^-1 s^-1", DIMS),
        "y_velocity_at_v_locations": FieldArray(
            dev(v), "m s^-1", ("x", "y_at_v_locations", "z")
        ),
    }

    if moist:
        temp = 0.5 * (t_hl[:, :, :nz] + t_hl[:, :, 1 : nz + 1])
        rho = s * dz / (h[:, :, :nz] - h[:, :, 1 : nz + 1])
        state["air_density"] = FieldArray(dev(rho), "kg m^-3", DIMS)
        state["air_temperature"] = FieldArray(dev(temp), "K", DIMS)
        p_unstg = 0.5 * (p[:, :, :nz] + p[:, :, 1 : nz + 1])
        qv = convert_relative_humidity_to_water_vapor(
            "tetens", p_unstg, temp, np.full_like(s, relative_humidity)
        )
        state[mfwv] = FieldArray(dev(qv.astype(dtype)), "g g^-1", DIMS)
        state[mfcw] = FieldArray(dev(np.zeros_like(s)), "g g^-1", DIMS)
        state[mfpw] = FieldArray(dev(np.zeros_like(s)), "g g^-1", DIMS)
        if precipitation:
            state["precipitation"] = FieldArray(
                dev(np.zeros((nx, ny, 1), dtype=dtype)), "mm hr^-1", DIMS
            )
            state["accumulated_precipitation"] = FieldArray(
                dev(np.zeros((nx, ny, 1), dtype=dtype)), "mm", DIMS
            )
    return state

"""Meteorological formulas (reference ``src/tasmania/utils/meteo.py:51,192,251,276``).

Ported verbatim (they are validation-critical): Tetens and Goff-Gratch
saturation vapor pressure, RH → water-vapor mixing ratio, and the isothermal
analytic mountain-wave solution.
"""

from __future__ import annotations

import numpy as np

from tasmania_jax.utils.array import get_namespace


def tetens_formula(t):
    """Saturation vapor pressure over water [Pa] (reference ``meteo.py:251``)."""
    xp = get_namespace(t)
    pw, aw, tr, bw = 610.78, 17.27, 273.16, 35.86
    return pw * xp.exp(aw * (t - tr) / (t - bw))


def goff_gratch_formula(t):
    """Saturation vapor pressure over water [Pa] (reference ``meteo.py:276``)."""
    xp = get_namespace(t)
    c1, c2, c3, c4, c5, c6 = 7.90298, 5.02808, 1.3816e-7, 11.344, 8.1328e-3, 3.49149
    t_st, e_st = 373.15, 1013.25e2
    return e_st * 10 ** (
        -c1 * (t_st / t - 1.0)
        + c2 * xp.log10(t_st / t)
        - c3 * (10.0 ** (c4 * (1.0 - t / t_st)) - 1.0)
        + c5 * (10 ** (-c6 * (t_st / t - 1.0)) - 1.0)
    )


def convert_relative_humidity_to_water_vapor(method: str, p, t, rh):
    """RH → qv [g g^-1] on raw arrays in (Pa, K, 1) (reference ``meteo.py:192``)."""
    xp = get_namespace(p)
    if method == "tetens":
        p_sat = tetens_formula(t)
    elif method == "goff_gratch":
        p_sat = goff_gratch_formula(t)
    else:
        raise ValueError(f"unknown saturation formula {method!r}")
    pw = rh * p_sat
    B = 0.62198
    return xp.where(p_sat >= 0.616 * p, 0.0, B * pw / (p - pw))


def get_isothermal_isentropic_analytical_solution(
    grid,
    x_velocity_initial,
    temperature,
    mountain_height,
    mountain_width,
    x_staggered: bool = True,
    z_staggered: bool = False,
    physical_constants=None,
):
    """Analytic 2-D hydrostatic isothermal flow over a 'Witch of Agnesi'
    mountain (Durran 1981; reference ``meteo.py:51``), ported verbatim for
    mountain-wave validation.  Returns raw numpy (u, w) of shape (mi, 1, mk).
    Requires ``grid.ny == 1``.
    """
    from tasmania_jax.framework.field import FieldArray
    from tasmania_jax.utils.constants import get_physical_constants

    assert grid.ny == 1, "analytic solution requires ny == 1"

    def val(x, units):
        if isinstance(x, FieldArray):
            return float(np.asarray(x.to_units(units).data))
        return float(x)

    u_bar = val(x_velocity_initial, "m s^-1")
    T = val(temperature, "K")
    h = val(mountain_height, "m")
    a = val(mountain_width, grid.x.units)

    pcs = get_physical_constants(
        {
            "gas_constant_of_dry_air": (287.05, "J K^-1 kg^-1"),
            "gravitational_acceleration": (9.80665, "m s^-2"),
            "reference_air_pressure": (1e5, "Pa"),
            "specific_heat_of_dry_air_at_constant_pressure": (1004.0, "J K^-1 kg^-1"),
        },
        physical_constants,
    )
    Rd = pcs["gas_constant_of_dry_air"]
    g = pcs["gravitational_acceleration"]
    p_ref = pcs["reference_air_pressure"]
    cp = pcs["specific_heat_of_dry_air_at_constant_pressure"]

    # Scorer parameter
    scpam = np.sqrt(
        (g**2) / (cp * T * (u_bar**2)) - (g**2) / (4.0 * (Rd**2) * (T**2))
    )

    xv = np.asarray(
        (grid.x_at_u_locations if x_staggered else grid.x).data
    )
    zv = np.asarray(
        (grid.z_on_interface_levels if z_staggered else grid.z).to_units("K").data
    )
    x, theta = np.meshgrid(xv, zv, indexing="ij")

    zs = h * (a**2) / ((x**2) + (a**2))
    theta_s = float(np.asarray(grid.z_on_interface_levels.to_units("K").data)[-1])
    z = zs + cp * T / g * np.log(theta / theta_s)
    dz_dx = -2.0 * h * (a**2) * x / (((x**2) + (a**2)) ** 2)
    dz_dtheta = cp * T / (g * theta)

    p_bar = p_ref * (T / theta) ** (cp / Rd)
    rho_ref = p_ref / (Rd * T)
    rho_bar = p_bar / (Rd * T)
    drho_bar_dtheta = (
        -cp * p_ref / ((Rd**2) * (T**2)) * ((T / theta) ** (cp / Rd + 1.0))
    )

    d = (
        ((rho_bar / rho_ref) ** (-0.5))
        * h
        * a
        * (a * np.cos(scpam * z) - x * np.sin(scpam * z))
        / ((x**2) + (a**2))
    )
    dd_dx = (
        -((rho_bar / rho_ref) ** (-0.5))
        * h
        * a
        / (((x**2) + (a**2)) ** 2)
        * (
            (
                (a * np.sin(scpam * z) + x * np.cos(scpam * z)) * scpam * dz_dx
                + np.sin(scpam * z)
            )
            * ((x**2) + (a**2))
            + 2.0 * x * (a * np.cos(scpam * z) - x * np.sin(scpam * z))
        )
    )
    dd_dtheta = 0.5 * cp / (Rd * T) * (
        (theta / T) ** (0.5 * cp / Rd - 1.0)
    ) * h * a * (a * np.cos(scpam * z) - x * np.sin(scpam * z)) / (
        (x**2) + (a**2)
    ) - ((theta / T) ** (0.5 * cp / Rd)) * h * a * (
        a * np.sin(scpam * z) + x * np.cos(scpam * z)
    ) * scpam * dz_dtheta / (
        (x**2) + (a**2)
    )
    dd_dz = dd_dtheta / dz_dtheta

    u = u_bar * (1.0 - drho_bar_dtheta * d / (dz_dtheta * rho_bar) - dd_dz)
    w = u_bar * dd_dx
    return u[:, np.newaxis, :], w[:, np.newaxis, :]

"""Physical-constants resolution (reference ``src/tasmania/utils/constants.py``).

Defaults are declared as ``{name: (value, units)}``; overrides may supply a
``FieldArray``-like object with units, a ``(value, units)`` pair, or a bare
number (assumed already in default units).  Resolution converts every override
into the default units so components can use plain floats in kernels.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

from tasmania_jax.utils.units import conversion_factor

#: framework-wide defaults (SI / met units)
DEFAULT_CONSTANTS: Dict[str, Tuple[float, str]] = {
    "gravitational_acceleration": (9.80665, "m s^-2"),
    "gas_constant_of_dry_air": (287.05, "J K^-1 kg^-1"),
    "gas_constant_of_water_vapor": (461.52, "J K^-1 kg^-1"),
    "specific_heat_of_dry_air_at_constant_pressure": (1004.0, "J K^-1 kg^-1"),
    "latent_heat_of_vaporization_of_water": (2.5e6, "J kg^-1"),
    "density_of_liquid_water": (1000.0, "kg m^-3"),
    "air_pressure_at_sea_level": (1e5, "Pa"),
    "air_temperature_at_sea_level": (288.15, "K"),
    "beta": (42.0, "K Pa^-1"),
}


def get_physical_constants(
    defaults: Mapping[str, Any],
    overrides: Optional[Mapping[str, Any]] = None,
) -> Dict[str, float]:
    """Merge ``overrides`` over ``defaults``, converting to default units."""
    out: Dict[str, float] = {}
    overrides = overrides or {}
    for name, spec in defaults.items():
        if isinstance(spec, tuple):
            default_value, default_units = spec
        else:
            default_value, default_units = float(spec), "1"
        if name in overrides:
            ov = overrides[name]
            if hasattr(ov, "units") and hasattr(ov, "data"):  # FieldArray-like
                value = float(np.asarray(ov.data)) * conversion_factor(
                    ov.units, default_units
                )
            elif isinstance(ov, tuple):
                value = float(ov[0]) * conversion_factor(ov[1], default_units)
            else:
                value = float(ov)
        else:
            value = float(default_value)
        out[name] = value
    return out

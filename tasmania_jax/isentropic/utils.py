"""Isentropic-model promoters (reference ``src/tasmania/isentropic/utils.py:27,46``)."""

from __future__ import annotations

from tasmania_jax.framework.promoter import (
    FromDiagnosticToTendency,
    FromTendencyToDiagnostic,
)

DIMS = ("x", "y", "z")


class AirPotentialTemperatureToDiagnostic(FromTendencyToDiagnostic):
    """Expose the θ-tendency as the state diagnostic
    ``tendency_of_air_potential_temperature``."""

    @property
    def input_tendency_properties(self):
        return {
            "air_potential_temperature": {
                "dims": DIMS,
                "units": "K s^-1",
                "diagnostic_name": "tendency_of_air_potential_temperature",
            }
        }


class AirPotentialTemperatureToTendency(FromDiagnosticToTendency):
    """Demote the diagnostic ``tendency_of_air_potential_temperature`` back to
    a tendency on ``air_potential_temperature``."""

    @property
    def input_properties(self):
        return {
            "tendency_of_air_potential_temperature": {
                "dims": DIMS,
                "units": "K s^-1",
                "tendency_name": "air_potential_temperature",
            }
        }


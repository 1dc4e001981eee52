import numpy as np
import pytest

from tasmania_jax.utils.units import (
    conversion_factor,
    parse_units,
    per_second,
    units_are_compatible,
    units_are_same,
)


def test_basic_parse():
    assert parse_units("m").scale == 1.0
    assert parse_units("km").scale == 1000.0
    assert parse_units("hPa").scale == 100.0
    assert parse_units("g kg^-1").scale == pytest.approx(1e-3)
    assert parse_units("m s^-1").dims == parse_units("km hr^-1").dims


def test_conversion():
    assert conversion_factor("km", "m") == pytest.approx(1000.0)
    assert conversion_factor("m s^-1", "km hr^-1") == pytest.approx(3.6)
    assert conversion_factor("hPa", "Pa") == pytest.approx(100.0)
    assert conversion_factor("mm h^-1", "m s^-1") == pytest.approx(1e-3 / 3600)
    assert conversion_factor("K day^-1", "K s^-1") == pytest.approx(1 / 86400)
    assert conversion_factor("g g^-1", "kg kg^-1") == pytest.approx(1.0)


def test_compound_division():
    assert conversion_factor("m/s", "m s^-1") == pytest.approx(1.0)


def test_incompatible():
    with pytest.raises(ValueError):
        conversion_factor("m", "s")
    assert not units_are_compatible("kg", "m")
    assert units_are_compatible("J", "N m")


def test_same():
    assert units_are_same("kg m^-2 s^-1", "kg m^-2 s^-1")
    assert not units_are_same("km", "m")
    assert units_are_same("1", "")


def test_tendency_units():
    assert units_are_compatible(per_second("kg m^-2"), "kg m^-2 s^-1")

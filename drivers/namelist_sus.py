"""Default namelist for the moist isentropic SUS benchmark driver.

Mirrors reference ``drivers/benchmarking/isentropic_moist/namelist_sus.py``
(grid nx=ny=161, nz=120; dt=5 s; niter=100; rk3ws_si + fifth_order_upwind;
relaxed BC nb=3/nr=6; Gaussian mountain growing over 1800 s).
"""

from datetime import datetime, timedelta

import numpy as np

from tasmania_jax.framework.field import FieldArray
from tasmania_jax.framework.options import BackendOptions, StorageOptions

# computational domain (reference namelist_sus.py:34-40)
domain_x = (-176e3, 176e3)
nx = 161
domain_y = (-176e3, 176e3)
ny = 161
domain_z = FieldArray(np.array([400.0, 280.0]), "K", ("z",))
nz = 120

# horizontal boundary
hb_type = "relaxed"
nb = 3
hb_kwargs = {"nr": 6}

# backend settings
backend = "jax"
bo = BackendOptions()
so = StorageOptions(dtype=np.float32)
enable_checks = False

# topography (reference :65-75)
topo_type = "gaussian"
topo_kwargs = {
    "time": timedelta(seconds=1800),
    "max_height": FieldArray(np.asarray(0.5), "km", ()),
    "width_x": FieldArray(np.asarray(50.0), "km", ()),
    "width_y": FieldArray(np.asarray(50.0), "km", ()),
    "smooth": False,
}

# initial conditions
init_time = datetime(1992, 2, 20)
x_velocity = FieldArray(np.asarray(22.5), "m s^-1", ())
y_velocity = FieldArray(np.asarray(0.0), "m s^-1", ())
brunt_vaisala = FieldArray(np.asarray(0.015), "s^-1", ())
relative_humidity = 0.95

# time stepping (reference :88-96)
time_integration_scheme = "rk3ws_si"
eps = 0.5
physics_time_integration_scheme = "rk2"

# advection
horizontal_flux_scheme = "fifth_order_upwind"
vertical_advection = True
implicit_vertical_advection = False
vertical_flux_scheme = "third_order_upwind"

# damping
damp = True
damp_type = "rayleigh"
damp_depth = 15
damp_max = 0.0005
damp_at_every_stage = False

# horizontal smoothing
smooth = True
smooth_type = "second_order"
smooth_coeff = 1.0
smooth_coeff_max = 1.0
smooth_damp_depth = 0
smooth_moist = True
smooth_moist_coeff = 1.0
smooth_moist_coeff_max = 1.0
smooth_moist_damp_depth = 0

# turbulence
smagorinsky_constant = 0.18

# coriolis
coriolis_parameter = None

# microphysics (reference :124-133)
sedimentation = True
sedimentation_flux_scheme = "second_order_upwind"
rain_evaporation = True
autoconversion_threshold = FieldArray(np.asarray(0.1), "g kg^-1", ())
autoconversion_rate = FieldArray(np.asarray(0.001), "s^-1", ())
collection_rate = FieldArray(np.asarray(2.2), "s^-1", ())
saturation_rate = FieldArray(np.asarray(0.025), "s^-1", ())

# simulation length (reference :134-135)
timestep = timedelta(seconds=5)
niter = 100

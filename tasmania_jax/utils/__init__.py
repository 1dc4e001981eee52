from tasmania_jax.utils.checkpoint import CheckpointManager
from tasmania_jax.utils.iox import HDF5Monitor, load_hdf5_dataset

__all__ = ["CheckpointManager", "HDF5Monitor", "load_hdf5_dataset"]

from tasmania_jax.parallel.halo import halo_exchange
from tasmania_jax.parallel.mesh import CartesianDecomposition, make_mesh


def __getattr__(name):
    # lazy: distributed/runner pull in jax.shard_map machinery
    if name in ("DistributedBoundary", "LocalDomain"):
        from tasmania_jax.parallel import distributed

        return getattr(distributed, name)
    if name == "DistributedModel":
        from tasmania_jax.parallel.runner import DistributedModel

        return DistributedModel
    raise AttributeError(name)


__all__ = [
    "halo_exchange",
    "CartesianDecomposition",
    "make_mesh",
    "DistributedBoundary",
    "LocalDomain",
    "DistributedModel",
]

from tasmania_jax.domain.boundaries import dirichlet, identity, periodic, relaxed  # noqa: F401

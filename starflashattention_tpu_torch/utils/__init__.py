"""Device resolution and the numpy bridge to the JAX package's arrays."""

"""Process-internal helpers of the port (copies of the JAX package's
``_private`` modules that the port needs)."""

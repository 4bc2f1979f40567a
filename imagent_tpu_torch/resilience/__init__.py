"""Exit-code taxonomy (a copy of the JAX package's registry)."""

"""Datasets and the τ-round sampler (copies of the JAX package's pure modules)."""

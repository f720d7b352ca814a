"""Utilities: state conversion from the JAX package and parity checks."""

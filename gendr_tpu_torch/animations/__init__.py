"""Render sweeps of the reference's animations/ directory (port of the
JAX package's ``animations/``)."""

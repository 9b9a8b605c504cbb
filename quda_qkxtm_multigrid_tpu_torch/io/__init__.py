"""Gauge-configuration reading and correlator writers (numpy host code,
copied from the JAX package's ``io/``, which cannot be imported without
JAX)."""

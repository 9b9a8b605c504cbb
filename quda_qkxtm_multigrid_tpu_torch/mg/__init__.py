"""Adaptive aggregation multigrid: transfer, coarse operator, setup,
V-cycle and the MG-preconditioned outer solves."""

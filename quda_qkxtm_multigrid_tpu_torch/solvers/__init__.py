"""Krylov solvers of the port."""

"""Utilities of the port: random fields."""

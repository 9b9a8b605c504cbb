"""Utilities of the port: random fields, null-vector files, full
float32 products."""

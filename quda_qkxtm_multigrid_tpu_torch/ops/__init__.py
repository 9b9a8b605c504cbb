"""Operators of the port: gamma tables, small-matrix algebra, the Wilson
hop (plain and kernel), twist and clover terms, and the field BLAS."""

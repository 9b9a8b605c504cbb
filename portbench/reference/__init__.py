"""The plain reference of the benchmark: PyTorch written from the
equations, with no kernel, cache or layout of the port.  It imports
nothing of ``quda_qkxtm_multigrid_tpu_torch`` and takes only the fields
that the benchmark made (the gauge, the sources) and the outputs of the
port that it judges."""

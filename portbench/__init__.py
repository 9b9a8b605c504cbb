"""The benchmark of the PyTorch and CUDA port
(``quda_qkxtm_multigrid_tpu_torch``).

``python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints its
result as the last line of standard output.  Everything of one
configuration, traffic mix, solve route or metric sits in a file of its
own, found by the name that ``BENCHMARK.json``, the configuration or
the traffic gives: ``configs/<name>.json``, ``traffic/<name>.json``
(data), ``units/<name>.py`` (the work a unit of the window does),
``routes/<name>.py`` (the program's entries), ``checks/<name>.py`` (how
the reference judges an answer), ``metrics/<name>.py``.  ``reference/`` is the plain
PyTorch yardstick that decides ``correct``; it imports nothing of the
port.
"""

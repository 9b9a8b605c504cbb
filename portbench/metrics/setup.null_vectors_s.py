"""Mean seconds of the null-vector solves a unit (``setup_mg``'s
``setup_stats["null_vector_secs"]``, host clock with the card
synchronised)."""

from portbench.metrics._mean import mean_setup


def read(run):
    return mean_setup(run, "null_vector_secs")

"""Mean seconds of the Galerkin coarse build a unit
(``setup_mg``'s ``setup_stats["coarse_build_secs"]``, host clock with
the card synchronised)."""

from portbench.metrics._mean import mean_setup


def read(run):
    return mean_setup(run, "coarse_build_secs")

"""Units: what the window repeats.  A traffic mix names its unit kind
(``"unit"``); each kind is a module of its own here with

  prepare(bench) → state or None      the run's own set-up, before the
                                      warm-up units
  work(bench, state, item) → (info, parts)
                                      one unit of work on one item

``bench`` (``run.Bench``) gives the configuration (``cfg``), its route
(``route``), ``build(gauge_seed)``, ``device`` and the run's gauge seed
(``run_gauge_seed``).  ``info`` is what the per-layer readers see of the
unit (``metrics/``); ``parts`` maps the name of a comparison
(``checks/<name>.py``) to the payload it judges, of which the run keeps
a sample drawn from the seed.  The harness times the unit, the card
synchronised at its end.
"""

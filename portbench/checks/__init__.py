"""Comparisons: how the plain reference judges one kind of answer.  A
unit names the kinds it produces (``units/``); each kind is a module of
its own here with

  judge(ref, payload) → [(number, value), …]

``ref`` (``check.Reference``) gives the configuration (``cfg``), the
run's ``seed``, ``device``, the gauge of a seed made again
(``gauge(seed)``) and the reference's own operator on it
(``operator(seed)``).  Each number's limit is the configuration's
``certify[number]``.
"""

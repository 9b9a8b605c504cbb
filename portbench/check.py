"""The comparison that decides ``correct``: every answer sampled from
the window, judged by the plain reference once the program's state is
freed.  Each kind of answer has its comparison in ``checks/<kind>.py``;
each number's limit is the configuration's ``certify[number]``."""

from __future__ import annotations

import importlib

import torch

from portbench.gauge import config_gauge
from portbench.reference.operator import TwistedClover


def reference_operator(cfg: dict, u: torch.Tensor, **kw) -> TwistedClover:
    a = cfg["action"]
    return TwistedClover(u, cfg["lattice"], a["kappa"], a["mu"], a["csw"],
                         **kw)


class Reference:
    """What a comparison reads: the gauge of a seed made again (the last
    one kept) and the reference's own operator on it."""

    def __init__(self, cfg: dict, seed: int, device):
        self.cfg, self.seed, self.device = cfg, seed, device
        self._gauges = {}

    def gauge(self, gauge_seed: int) -> torch.Tensor:
        if gauge_seed not in self._gauges:
            self._gauges.clear()
            self._gauges[gauge_seed] = config_gauge(self.cfg, gauge_seed,
                                                    self.device)
        return self._gauges[gauge_seed]

    def operator(self, gauge_seed: int, **kw) -> TwistedClover:
        return reference_operator(self.cfg, self.gauge(gauge_seed), **kw)


def compare(cfg: dict, kept: dict, seed: int, device) -> list:
    """[(number, value, limit, unit index)] of every kept answer;
    ``kept`` maps a comparison's name to its (item, payload) pairs."""
    ref = Reference(cfg, seed, device)
    numbers = []
    for kind in sorted(kept):
        judge = importlib.import_module(f"portbench.checks.{kind}").judge
        for item, payload in sorted(kept[kind], key=lambda s: s[0]["index"]):
            for name, value in judge(ref, payload):
                numbers.append((name, value, cfg["certify"][name],
                                item["index"]))
    return numbers

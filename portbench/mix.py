"""The one generator of work items.  A traffic mix (``traffic/<name>.json``)
sets its parameters; the seed draws the items.

  "unit"                 the kind of unit the window repeats: the module
                         ``units/<unit>.py``, which does an item's work
  "columns_per_position" 12: the twelve spin-colour columns of a point
                         source, in turn, as a propagator's are; n < 12:
                         n of them, drawn from the seed
  "columns_per_item"     columns handed to one unit (default 1)
  "cycle"                n (optional): the same n items for every seed,
                         drawn from "fixed_seed", solved over and over,
                         each pass in an order drawn from the seed; the
                         run's one gauge comes from "fixed_seed" too
  "warmup_units"         units run in set-up, drawn from a stream of
                         their own
  "trace_units"          units that a traced run profiles

Every seed draws the same kind and number of items: only the source
positions, the columns and the gauges differ, or, in a cycle, only
their order.
"""

from __future__ import annotations

import itertools

import numpy as np

from portbench.gauge import derive_seed

WINDOW, WARMUP = 0, 1    # item streams


def run_gauge_seed(traffic: dict, seed: int) -> int:
    """The seed of the run's one gauge and MG set-up."""
    return derive_seed(traffic.get("fixed_seed", seed), 0)


def items(traffic: dict, dims, seed: int, stream: int = WINDOW):
    """Work items without end: dicts with ``index``, ``coords`` (x, y, z,
    t), ``columns`` ([(spin, colour), …]) and ``gauge_seed`` (the seed of
    the item's own gauge, for a unit that makes one)."""
    if "cycle" in traffic:
        yield from _cycled(traffic, dims, seed, stream)
        return
    rng = np.random.default_rng(derive_seed(seed, 10, stream))
    ncol = traffic["columns_per_position"]
    per_item = traffic.get("columns_per_item", 1)
    if ncol % per_item:
        raise ValueError("columns_per_item has to divide "
                         "columns_per_position")
    i = 0
    while True:
        coords = tuple(int(rng.integers(n)) for n in dims)
        cols = (range(12) if ncol == 12
                else rng.choice(12, size=ncol, replace=False))
        cols = [divmod(int(c), 3) for c in cols]
        for k in range(0, ncol, per_item):
            yield {"index": i, "coords": coords,
                   "columns": cols[k:k + per_item],
                   "gauge_seed": derive_seed(seed, 11, stream, i)}
            i += 1


def _cycled(traffic: dict, dims, seed: int, stream: int):
    """The first ``cycle`` items of ``fixed_seed``'s window stream, each
    pass in an order drawn from ``seed``."""
    plain = {k: v for k, v in traffic.items() if k != "cycle"}
    pool = list(itertools.islice(
        items(plain, dims, traffic["fixed_seed"], WINDOW), traffic["cycle"]))
    rng = np.random.default_rng(derive_seed(seed, 13, stream))
    i = 0
    while True:
        for k in rng.permutation(len(pool)):
            yield dict(pool[int(k)], index=i)
            i += 1


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from the
    seed (reservoir sampling): which units the comparison checks."""

    def __init__(self, k: int, seed: int, salt: int):
        self.k, self.kept, self.seen = k, [], 0
        self.rng = np.random.default_rng(derive_seed(seed, 12, salt))

    def offer(self, entry) -> bool:
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append(entry)
            return True
        j = int(self.rng.integers(self.seen))
        if j < self.k:
            self.kept[j] = entry
            return True
        return False

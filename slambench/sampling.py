"""A uniform sample of the window's steps, drawn from the seed as they come."""

from __future__ import annotations

import numpy as np


class Reservoir:
    """Keeps ``k`` of the items offered so far, each equally likely
    (Algorithm R), with its own generator so the choice depends on the seed
    and the number of steps alone."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([seed, 0x5A3])
        self.items: list = []
        self.seen = 0

    def offer(self, make):
        """Counts one item; calls ``make()`` to build it only if it is kept."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make())
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            self.items[j] = make()

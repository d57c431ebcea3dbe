"""Named seeded RNG streams (engine layer).

All randomness in the simulator is injected: each consumer draws from its
own named stream, so adding a draw in one subsystem can never shift the
sequence another subsystem sees (the classic way seeded experiments rot).

The ``root`` stream is ``random.Random(seed)`` — bit-compatible with the
pre-kernel ``Simulator._rng``, whose ``choice`` stream the seeded paper
§7.8 random-dispatch replays depend on (tests/test_dispatch.py). Named
streams hash ``"{seed}:{name}"`` through ``random.Random``'s stable
str-seeding (SHA-512), the same scheme ``repro_torch.api.workload`` uses for
per-function arrival streams.
"""
from __future__ import annotations

import random
from typing import Dict

__all__ = ["RngStreams"]


class RngStreams:
    """Registry of independent, deterministically-seeded RNG streams."""

    __slots__ = ("seed", "root", "_named")

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.root = random.Random(seed)
        self._named: Dict[str, random.Random] = {}

    def get(self, name: str) -> random.Random:
        """The stream for ``name`` (created on first use; stable across
        processes and unaffected by draws on any other stream)."""
        rng = self._named.get(name)
        if rng is None:
            rng = self._named[name] = random.Random(f"{self.seed}:{name}")
        return rng

"""Per-frame extra-update caps of the distribution ``min(Geometric(p) - 1,
max)``, the realistic-gate load of the DynaBOA benchmark's bench, laid out
in blocks of ``block`` frames that each hold the same counts of every cap:
the distribution's shares times ``block``, rounded by the largest
remainders.  A block is laid out as pairs, the i-th smallest cap with the
i-th largest, and the seed draws the order of the pairs and the order
within each; so every seed has the same work in any stretch of frames, to
within a pair's, and runs of different seeds measure the same load.

``spec``: ``p``, ``max``, ``block``."""

from __future__ import annotations

import numpy as np


def block(p: float, cap_max: int, size: int) -> np.ndarray:
    """The sorted caps of one block."""
    k = np.arange(cap_max + 1)
    prob = p * (1 - p) ** k
    prob[-1] = (1 - p) ** cap_max
    want = size * prob
    counts = np.floor(want).astype(int)
    rest = np.argsort(-(want - counts), kind="stable")
    counts[rest[:size - counts.sum()]] += 1
    return np.repeat(k, counts)


def caps(spec: dict, seed: int, n: int) -> np.ndarray:
    """(n,) extra-update caps for ``seed``."""
    base = block(spec["p"], spec["max"], spec["block"])
    half = len(base) // 2
    pairs = np.stack([base[:half], base[::-1][:half]], 1)
    r = np.random.default_rng(int(seed) % (2 ** 63))
    out = []
    while len(out) < n:
        for a, b in pairs[r.permutation(half)]:
            out += [a, b] if r.integers(2) else [b, a]
    return np.asarray(out[:n])

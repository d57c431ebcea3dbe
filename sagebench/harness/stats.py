"""Order statistics over all the samples of a window, and the spread of
runs that sets a bound."""
from __future__ import annotations

import math
import statistics
from typing import Sequence


def quantile(values: Sequence[float], q: float) -> float:
    """The q-quantile (0 <= q <= 1) of every value, linear between order
    statistics; an infinite value (an invocation that failed or never
    returned) sorts last, so it counts as missing every limit."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    pos = q * (len(xs) - 1)
    lo, hi = math.floor(pos), math.ceil(pos)
    if lo == hi or xs[lo] == xs[hi]:
        return float(xs[lo])
    return float(xs[lo] + (xs[hi] - xs[lo]) * (pos - lo))


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartiles as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2

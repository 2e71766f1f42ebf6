"""Streaming statistics — counterpart of ``Math/Statistics.h``.

A copy of ``bifrost3d_tpu/math/statistics.py`` (plain Python, no array
library): Welford-style accumulation of mean and variance with merge
support, for statistical test harnesses and benchmark machinery.
"""

from __future__ import annotations


class Statistics:
    def __init__(self):
        self.count = 0
        self.mean = 0.0
        self._m2 = 0.0
        self.minimum = float("inf")
        self.maximum = float("-inf")

    def add(self, value: float) -> None:
        self.count += 1
        delta = value - self.mean
        self.mean += delta / self.count
        self._m2 += delta * (value - self.mean)
        self.minimum = min(self.minimum, value)
        self.maximum = max(self.maximum, value)

    @property
    def variance(self) -> float:
        return self._m2 / self.count if self.count else 0.0

    @property
    def standard_deviation(self) -> float:
        return self.variance ** 0.5

    def merge(self, other: "Statistics") -> "Statistics":
        """Parallel merge (Chan et al.) — Statistics.h merge()."""
        merged = Statistics()
        n = self.count + other.count
        if n == 0:
            return merged
        delta = other.mean - self.mean
        merged.count = n
        merged.mean = self.mean + delta * other.count / n
        merged._m2 = (self._m2 + other._m2
                      + delta * delta * self.count * other.count / n)
        merged.minimum = min(self.minimum, other.minimum)
        merged.maximum = max(self.maximum, other.maximum)
        return merged

    @staticmethod
    def of(values) -> "Statistics":
        s = Statistics()
        for v in values:
            s.add(float(v))
        return s

"""Tiny counters/gauges registry for launcher and host-loop logging
(the port's own copy of ``repro.obs.metrics``).

Hot loops bump named counters/gauges, and callers pull a consistent
``snapshot()`` dict to log, assert on, or write out.  Counters are
monotone by construction (negative increments raise).  Host-side only:
it serves the eager control plane (requests, tokens, seconds, moved
bytes), as in ``repro_torch.launch.serve``.
"""
from __future__ import annotations

import threading
from typing import Dict, Union

Number = Union[int, float]


class Counter:
    """Monotonically non-decreasing named value."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0

    def inc(self, amount: Number = 1) -> float:
        if amount < 0:
            raise ValueError(
                f"counter {self.name!r} is monotone; cannot inc({amount})")
        self._value += float(amount)
        return self._value

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-write-wins named value."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0

    def set(self, value: Number) -> float:
        self._value = float(value)
        return self._value

    @property
    def value(self) -> float:
        return self._value


class MetricsRegistry:
    """Name → Counter/Gauge map with an atomic ``snapshot()``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            if name in self._gauges:
                raise ValueError(f"{name!r} is already a gauge")
            return self._counters.setdefault(name, Counter(name))

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            if name in self._counters:
                raise ValueError(f"{name!r} is already a counter")
            return self._gauges.setdefault(name, Gauge(name))

    def snapshot(self) -> Dict[str, float]:
        """Flat name → value dict (counters and gauges together)."""
        with self._lock:
            out = {n: c.value for n, c in self._counters.items()}
            out.update({n: g.value for n, g in self._gauges.items()})
            return dict(sorted(out.items()))

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()


#: Process-wide default registry (what the launchers use).
_default = MetricsRegistry()


def counter(name: str) -> Counter:
    return _default.counter(name)


def gauge(name: str) -> Gauge:
    return _default.gauge(name)


def snapshot() -> Dict[str, float]:
    return _default.snapshot()


def reset() -> None:
    _default.reset()

"""Straggler detection: the reference's watchdog (``repro.runtime.
straggler``), which holds no tensor and is copied as it is.

The watchdog keeps an EWMA of step durations; a step longer than
``threshold x EWMA`` is a strike against its host, and ``strikes_to_evict``
strikes evict it: ``Trainer`` then saves and raises ``ElasticRestart``.  A
healthy step takes one strike off its host and feeds the EWMA.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class StragglerWatchdog:
    threshold: float = 2.5          # x EWMA => suspect
    ewma_alpha: float = 0.1
    strikes_to_evict: int = 3

    ewma: Optional[float] = None
    strikes: Dict[str, int] = dataclasses.field(default_factory=dict)
    evicted: List[str] = dataclasses.field(default_factory=list)

    def observe(self, host: str, duration_s: float) -> str:
        """Feed one step duration; returns 'ok' | 'suspect' | 'evict'."""
        if self.ewma is None:
            self.ewma = duration_s
            return "ok"
        verdict = "ok"
        if duration_s > self.threshold * self.ewma:
            self.strikes[host] = self.strikes.get(host, 0) + 1
            verdict = "suspect"
            if self.strikes[host] >= self.strikes_to_evict:
                self.evicted.append(host)
                self.strikes[host] = 0
                verdict = "evict"
        else:
            # healthy steps decay strikes and update the EWMA
            self.strikes[host] = max(0, self.strikes.get(host, 0) - 1)
            self.ewma = (1 - self.ewma_alpha) * self.ewma + \
                self.ewma_alpha * duration_s
        return verdict

    def deadline(self) -> Optional[float]:
        return None if self.ewma is None else self.threshold * self.ewma

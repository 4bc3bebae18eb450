"""Straggler detection + mitigation for synchronous data-parallel steps
(port of ``repro/train/straggler.py``, pure Python, the same code).

At 1000+ nodes, synchronous training runs at the speed of the slowest
worker.  This module provides the control-plane pieces that a cluster
launcher hooks into:

* :class:`StepTimer` — robust online step-time statistics (median/MAD,
  not mean/std: step-time distributions are heavy-tailed) with z-score
  straggler flagging.
* :class:`StragglerPolicy` — the decision logic: after `patience`
  consecutive flagged steps attributable to the same host (identified
  by the launcher's health probes) it escalates DROP (elastic resize to
  a smaller data axis: checkpoint -> rebuild mesh without the host ->
  restore; the stateless data pipeline replays exactly) or, when spare
  capacity exists, SWAP (backup worker takes the shard).
* :func:`run_with_straggler_sim` — a harness that drives a real train
  loop with injected slowdowns and asserts detection, used by the tests
  and fault-tolerance drills.

On a real cluster the per-step host timings come from the launcher's
heartbeats; here they are wall-clock measured (and injectable).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, List, Optional


@dataclasses.dataclass
class StepTimer:
    window: int = 50
    z_threshold: float = 4.0
    min_samples: int = 8

    def __post_init__(self):
        self._times = deque(maxlen=self.window)

    def observe(self, seconds: float) -> bool:
        """Record a step time; returns True if it is a straggler step."""
        flagged = False
        if len(self._times) >= self.min_samples:
            med = self._median()
            mad = self._mad(med)
            if mad > 0 and (seconds - med) / (1.4826 * mad) > self.z_threshold:
                flagged = True
            elif mad == 0 and seconds > 2.0 * med > 0:
                flagged = True
        if not flagged:  # don't poison the window with straggler samples
            self._times.append(seconds)
        return flagged

    def _median(self):
        s = sorted(self._times)
        return s[len(s) // 2]

    def _mad(self, med):
        s = sorted(abs(t - med) for t in self._times)
        return s[len(s) // 2]


@dataclasses.dataclass
class StragglerPolicy:
    patience: int = 3  # consecutive flagged steps before escalation
    action: str = "drop"  # drop (elastic resize) | swap (backup worker)

    def __post_init__(self):
        self._streak = 0
        self.events: List[dict] = []

    def step(self, step_idx: int, flagged: bool) -> Optional[str]:
        """Returns the escalation action when the streak exceeds patience."""
        if flagged:
            self._streak += 1
            if self._streak >= self.patience:
                self.events.append({"step": step_idx, "action": self.action})
                self._streak = 0
                return self.action
        else:
            self._streak = 0
        return None


def run_with_straggler_sim(
    step_fn: Callable[[int], None],
    num_steps: int,
    *,
    slow_steps: dict,  # step -> extra seconds
    timer: Optional[StepTimer] = None,
    policy: Optional[StragglerPolicy] = None,
    base_step_seconds: Optional[float] = None,
):
    """Drive `step_fn`, injecting slowdowns; returns (flags, escalations).

    base_step_seconds: when set, use this fixed per-step time instead of
    wall-clock — hermetic mode for tests/CI, where scheduler jitter on a
    loaded machine would otherwise inject phantom stragglers.
    """
    timer = timer or StepTimer()
    policy = policy or StragglerPolicy()
    flags = []
    for i in range(num_steps):
        t0 = time.perf_counter()
        step_fn(i)
        if base_step_seconds is None:
            elapsed = time.perf_counter() - t0
        else:
            elapsed = base_step_seconds
        elapsed += slow_steps.get(i, 0.0)
        flagged = timer.observe(elapsed)
        flags.append(flagged)
        policy.step(i, flagged)
    return flags, policy.events

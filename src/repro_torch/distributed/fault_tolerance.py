"""Fault tolerance and straggler mitigation, host side.

The port's copy of the JAX package's ``distributed/fault_tolerance.py``
(plain Python; numpy only for the jitter's default generator):

  * PreemptionGuard — SIGTERM/SIGINT handler that flips a flag the train loop
    and the engine poll; the loop checkpoints and exits cleanly inside the
    grace window, the engine drains.
  * StragglerMonitor — per-step wall-time EMA + z-score flagging; on one
    host it flags local step-time spikes.
  * retry_on_transient — bounded-retry wrapper for collective/IO ops that
    fail transiently on large fleets.
  * elastic_mesh_shape — given the surviving device count, the (data,
    model) mesh that keeps per-device memory bounded — the decision logic
    for scale-down restarts.
"""
from __future__ import annotations

import math
import signal
import time

__all__ = ["PreemptionGuard", "StragglerMonitor", "retry_on_transient",
           "elastic_mesh_shape"]


class PreemptionGuard:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._requested = False
        self._prev = {}
        for s in signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except (ValueError, OSError):  # non-main thread / platform
                pass

    def _handler(self, signum, frame):
        self._requested = True

    @property
    def preempted(self) -> bool:
        return self._requested

    def request(self):
        """Programmatic trigger — same effect as receiving SIGTERM.  Lets
        orchestrators (and chaos tests) start a graceful drain without
        delivering a real signal."""
        self._requested = True

    def restore(self):
        for s, h in self._prev.items():
            signal.signal(s, h)


class StragglerMonitor:
    """EMA step-time tracker with z-score anomaly flags."""

    def __init__(self, alpha: float = 0.05, z_threshold: float = 4.0,
                 warmup_steps: int = 10, clock=None):
        # clock: a function of no argument giving seconds (None:
        # time.monotonic); ranks that must flag alike pass one clock
        self._clock = clock
        self.alpha = alpha
        self.z = z_threshold
        self.warmup = warmup_steps
        self.mean = None
        self.var = 0.0
        self.n = 0
        self.flags: list[tuple[int, float, float]] = []
        self._t0 = None

    def _time(self) -> float:
        return self._clock() if self._clock is not None else time.monotonic()

    def start_step(self):
        self._t0 = self._time()

    def end_step(self, step: int) -> bool:
        """Returns True if this step is flagged as a straggler event."""
        dt = self._time() - self._t0
        self.n += 1
        if self.mean is None:
            self.mean, self.var = dt, 0.0
            return False
        # test against the PRE-update statistics: folding the sample into the
        # EMA first would let a large spike mask itself
        sigma = math.sqrt(self.var) + 1e-9
        zscore = (dt - self.mean) / sigma
        flagged = self.n > self.warmup and zscore > self.z
        if flagged:
            self.flags.append((step, dt, zscore))
        else:
            # only non-outlier samples update the baseline statistics
            delta = dt - self.mean
            self.mean += self.alpha * delta
            self.var = (1 - self.alpha) * (self.var
                                           + self.alpha * delta * delta)
        return flagged


def retry_on_transient(fn, retries: int = 3, backoff: float = 0.5,
                       exceptions=(OSError, RuntimeError),
                       jitter: float = 0.0, rng=None,
                       backoff_cap: float = 30.0):
    """Call fn() with bounded retries + exponential backoff.

    ``jitter`` > 0 switches to *decorrelated jitter* (AWS-style): each sleep
    is drawn uniformly from ``[backoff, prev_sleep * 3]``, capped at
    ``backoff_cap``, scaled so ``jitter=1.0`` is fully decorrelated and
    smaller values interpolate toward the deterministic schedule.  Sharded
    writers hitting the same filesystem stamp retry at the same instant
    under pure exponential backoff; jitter spreads the herd.  Pass a seeded
    ``rng`` (``np.random.Generator``-like, needs ``.uniform``) for
    reproducible chaos runs; default draws a fresh one per call.
    """
    if jitter > 0.0 and rng is None:
        import numpy as np
        rng = np.random.default_rng()
    prev = backoff
    for attempt in range(retries + 1):
        try:
            return fn()
        except exceptions:
            if attempt == retries:
                raise
            base = backoff * (2**attempt)
            if jitter > 0.0:
                decorr = min(backoff_cap, rng.uniform(backoff, prev * 3))
                sleep = (1.0 - jitter) * base + jitter * decorr
                prev = max(decorr, backoff)
            else:
                sleep = base
            time.sleep(min(sleep, backoff_cap))


def elastic_mesh_shape(n_devices: int, model_parallel: int = 16,
                       pod_size: int = 256) -> tuple:
    """Mesh shape for a (possibly degraded) device count.

    Keeps the model axis fixed (weight shards must still fit) and absorbs
    device loss into the data(+pod) axes.  Raises if n_devices can't form a
    rectangle — callers then drop to the next lower multiple.
    """
    if n_devices % model_parallel:
        n_devices -= n_devices % model_parallel
    data = n_devices // model_parallel
    if data <= 0:
        raise ValueError("not enough devices for one model shard")
    if n_devices > pod_size and data % (n_devices // pod_size) == 0:
        pods = n_devices // pod_size
        return (pods, data // pods, model_parallel)
    return (data, model_parallel)

"""Seeded, deterministic fault injection for the serving engine and the
train loop.

The port's own copy of the JAX package's ``robustness/faults.py`` (numpy
only): the same RNG keying, so a plan fires at the same consultations in
both packages and a chaos trace replays across them.

A :class:`FaultPlan` is a named set of injection points the hardened code
paths *consult* (``plan.fires("engine.page_alloc")``) at well-defined
moments; the plan decides — deterministically, from its seed and the
consultation index — whether the fault fires this time.  The consuming code
then exercises its real recovery path (stall/evict, retry/requeue,
quarantine, drain, skip/rollback) exactly as it would for an organic fault,
so chaos tests pin failure *semantics*, not mocks.

Design rules:
  * **Deterministic.**  Each point gets its own ``np.random.default_rng``
    seeded from ``(seed, crc32(point))`` plus a consultation counter.  The
    same seed + spec + consultation order always fires the same faults —
    a chaos trace is replayable bit-for-bit.
  * **Zero-cost when disabled.**  Hardened code holds :data:`NO_FAULTS`
    (whose ``fires`` is a constant ``False``) unless a plan is supplied;
    there is no per-step dict lookup or RNG draw in clean runs.
  * **Bounded.**  ``max_fires`` caps a point's total fires so probabilistic
    faults cannot livelock a bounded-retry loop.

Engine injection points (consulted by ``repro_torch.launch.engine.Engine``):
  * ``engine.page_alloc`` — one per page-pool pop; firing makes the
    allocation fail as if the pool were dry (slot stalls / eviction).
  * ``engine.step``      — one per step launch; firing raises
    :class:`InjectedFault` *before* the launch (request-scoped failure:
    participants are retried/requeued, the pool state stays valid).
  * ``engine.nan_logits``— one per decode launch; firing poisons the first
    KV page of the oldest decoding slot with NaNs, so the *real* in-graph
    non-finite guard trips and the engine quarantines that slot only.
  * ``engine.straggler`` — one per scheduler tick; firing sleeps
    ``delay_s`` (artificial straggler step — deadline/timeout pressure).
  * ``engine.preempt``   — one per scheduler tick; firing flips the engine
    into graceful drain (stop admitting, finish in-flight work).

Train injection points (consulted by ``repro_torch.launch.train.run_training``):
  * ``train.grad_spike`` — one per step; firing forces the grad-spike
    detector's threshold below any real norm, so the in-graph guard skips
    the update (and K consecutive fires exercise checkpoint rollback).

Streaming-PTQ injection points (for the streaming PTQ, which the port
has not taken yet; nothing in it consults them):
  * ``ptq.kill_at_block``     — one per freshly-processed block; firing
    raises :class:`InjectedFault` at the block boundary, before any work.
  * ``ptq.kill_mid_write``    — one per shard write; firing kills between
    the temp-file write and the atomic publish (temp is stray, no shard).
  * ``ptq.kill_before_commit``— one per block commit; firing kills after
    the shard is published but before its ledger entry lands.
  * ``ptq.corrupt_shard``     — one per shard write; firing flips a byte
    of the *published* shard (bitrot the resume audit must catch).
  * ``ptq.transient_oserror`` — one per shard-write attempt; firing raises
    ``OSError`` inside the retried write fn (``retry_on_transient`` path).
  * ``ptq.oom_spike``         — one per budget charge; firing adds a
    phantom allocation of the full limit, tripping the memory watchdog.

Checkpoint injection points (consulted by ``repro_torch.checkpoint``):
  * ``ckpt.save_crash``       — one per leaf written during a save; firing
    raises :class:`InjectedFault` mid-save, leaving a stray ``.tmp`` step
    dir that ``latest_step``/``restore`` must ignore.

Mesh injection points (consulted by ``repro_torch.launch.train`` and
``repro_torch.launch.engine``; on one device nothing is lost, so
``dist.device_loss`` is consulted and never rebuilds):
  * ``dist.device_loss``       — one per step/tick; firing simulates a host
    dropping out of the mesh: a multi-device consumer rebuilds a smaller
    mesh, reshards its state onto it and continues.
  * ``dist.host_crash``        — one per step; firing raises
    :class:`InjectedFault` (whole-process crash drill — the outer driver
    restarts and resumes from the latest checkpoint/ledger).
  * ``dist.collective_timeout``— one per collective step launch; firing
    raises :class:`InjectedFault` *before* the launch, exercising the
    bounded retry path without corrupting device state.
  * ``dist.replica_desync``    — one per desync-digest interval; firing
    perturbs one replica's digest so the *real* compare-quarantine-rollback
    path runs (silent divergence cannot be created under single-controller
    SPMD, so — like ``train.grad_spike`` — the detector input is forced
    and the recovery path is exercised for real).
  * ``dist.straggler``         — one per (tick, shard); firing sleeps
    ``delay_s`` so the straggler watchdog flags that shard.

Mesh points are consulted with an explicit *shard/process index*
(``plan.fires("dist.straggler", index=3)``): every (point, index) pair owns
an independent RNG stream keyed ``[seed, crc32(point), index]`` and its own
consultation counter, so a multi-process replay is bit-identical no matter
how many processes consult concurrently — shard 3's fault schedule never
depends on how many siblings exist (the acceptance contract for
deterministic mesh chaos across process counts).  ``FaultSpec.only_index``
restricts a point to one shard (e.g. "host 1 dies", "shard 3 straggles").
"""
from __future__ import annotations

import dataclasses
import time
import zlib

import numpy as np

__all__ = ["FaultSpec", "FaultPlan", "InjectedFault", "NO_FAULTS"]


class InjectedFault(RuntimeError):
    """Raised by hardened code when a ``*.step``-style point fires; kept a
    distinct type so recovery code can tell an injected failure (state
    known-good: raised before the launch) from an organic one."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """When one injection point fires.

    ``at``: consultation indices (0-based) that fire deterministically.
    ``prob``: per-consultation fire probability (seeded RNG).
    ``max_fires``: cap on total fires (None = unbounded).  For indexed
    (mesh) points the cap is **per stream** — a global cap would make one
    shard's schedule depend on sibling interleaving and break cross-
    process-count determinism.
    ``delay_s``: sleep this long on fire (straggler-style points).
    ``only_index``: restrict an indexed point to one shard/process
    (e.g. "host 1 dies"); consultations with any other index never fire.
    """
    prob: float = 0.0
    at: tuple = ()
    max_fires: int | None = None
    delay_s: float = 0.0
    only_index: int | None = None

    def __post_init__(self):
        object.__setattr__(self, "at", tuple(self.at))
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"prob {self.prob} outside [0, 1]")


def _point_rng(seed: int, point: str,
               index: int | None = None) -> np.random.Generator:
    # crc32, not hash(): stable across processes (PYTHONHASHSEED)
    key = [seed, zlib.crc32(point.encode())]
    if index is not None:
        # index + 1, never a bare 0: SeedSequence zero-pads its entropy
        # list, so [seed, crc, 0] would be the *same* stream as the
        # un-indexed [seed, crc] — shard 0 must not mirror the legacy point
        key.append(int(index) + 1)
    return np.random.default_rng(key)


class FaultPlan:
    """Seeded fault plan: ``spec`` maps point name -> FaultSpec (or the
    kwargs dict for one).  Replayable: same seed + spec + consultation
    order => same fires."""

    enabled = True

    def __init__(self, seed: int, spec: dict):
        self.seed = int(seed)
        self.spec: dict[str, FaultSpec] = {
            k: (v if isinstance(v, FaultSpec) else FaultSpec(**v))
            for k, v in spec.items()}
        # Streams are keyed (point, index); index None is the classic
        # un-indexed stream and keeps the exact pre-existing RNG keying.
        # Indexed streams materialize lazily on first consultation.
        self._rngs: dict[tuple, np.random.Generator] = {}
        self._consults: dict[tuple, int] = {}
        self._fired: dict[tuple, int] = {}
        for k in self.spec:
            self._stream(k, None)

    def _stream(self, point: str, index: int | None) -> tuple:
        key = (point, index)
        if key not in self._rngs:
            self._rngs[key] = _point_rng(self.seed, point, index)
            self._consults[key] = 0
            self._fired[key] = 0
        return key

    def fires(self, point: str, index: int | None = None) -> bool:
        """Consult ``point``; True iff the fault fires this consultation.

        ``index`` names the consulting shard/process for mesh points: each
        (point, index) pair is an independent deterministic stream, so the
        schedule seen by shard *i* does not depend on how many other shards
        consult, or in what order.
        """
        s = self.spec.get(point)
        if s is None:
            return False
        key = self._stream(point, index)
        i = self._consults[key]
        self._consults[key] = i + 1
        if s.only_index is not None and index != s.only_index:
            return False
        hit = i in s.at
        if not hit and s.prob > 0.0:
            hit = self._rngs[key].random() < s.prob
        if not hit:
            return False
        if s.max_fires is not None and self._fired[key] >= s.max_fires:
            return False
        self._fired[key] += 1
        if s.delay_s > 0.0:
            time.sleep(s.delay_s)
        return True

    def fired(self, point: str, index: int | None = ...) -> int:
        if index is not ...:
            return self._fired.get((point, index), 0)
        return sum(n for (p, _), n in self._fired.items() if p == point)

    def consulted(self, point: str, index: int | None = ...) -> int:
        if index is not ...:
            return self._consults.get((point, index), 0)
        return sum(n for (p, _), n in self._consults.items() if p == point)

    def reset(self):
        """Rewind every point to consultation 0 (fresh replay)."""
        self._rngs = {}
        self._consults = {}
        self._fired = {}
        for k in self.spec:
            self._stream(k, None)

    def summary(self) -> dict:
        def _label(key):
            point, index = key
            return point if index is None else f"{point}[{index}]"
        return {"enabled": True, "seed": self.seed,
                "consults": {_label(k): v for k, v in self._consults.items()},
                "fired": {_label(k): v for k, v in self._fired.items()}}


class _NoFaults:
    """Null plan: the zero-cost default every hardened path holds."""

    enabled = False

    def fires(self, point: str, index: int | None = None) -> bool:
        return False

    def fired(self, point: str, index: int | None = ...) -> int:
        return 0

    def consulted(self, point: str, index: int | None = ...) -> int:
        return 0

    def reset(self):
        pass

    def summary(self) -> dict:
        return {"enabled": False}


NO_FAULTS = _NoFaults()

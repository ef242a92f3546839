"""Continuous-batching serving engine over the block-paged KV cache.

Port of the JAX package's ``launch/engine.py``, on one device or on a
``data × model`` mesh of ranks (one process a rank).  It serves a *stream*
of requests:

  * **Page pool** — every layer's KV lives in a global pool of fixed-size
    pages (``models.paged_cache_init``, bf16 or int8); a request holds only
    the pages its tokens fill, through a per-slot page table.  Page 0 is
    the dummy: unmapped entries point at it, so dead rows write there and
    never touch live state.
  * **Scheduler** — FIFO admission while free pages last; decode pages are
    allocated on demand, and when the pool runs dry the *youngest* admitted
    request is evicted (pages freed, request requeued at the front for
    recompute), so the oldest always completes.
  * **Chunked prefill** — prompts prefill ``chunk`` tokens per tick
    (``steps.prefill_chunk_step``), interleaved with decode steps, so a long
    prompt never stalls the decode batch.
  * **Fixed-shape steps** — every tick runs the whole slot batch; slot
    activity is in the data (dead rows: positions -1, page-table rows 0),
    never in the shapes.  ``burst`` decode steps run back to back
    (``steps.paged_generate``) when nothing else waits.

Token for token it follows the JAX engine: token 1 is sampled from the
prefill logits at the prompt's last row, decode step k runs at position
``prompt_len + k - 1``.

**Failure semantics**, as the JAX engine's: every request ends in exactly
one terminal status — ``completed`` / ``timeout`` / ``rejected`` /
``failed`` — and :meth:`Engine.run` *returns* its stats dict under every
fault below instead of raising away completed work:

  * **Deadlines.**  ``Request.deadline_s`` (relative to arrival) cancels a
    late request wherever it is, queued or mid-decode, reclaiming its pages
    and recording ``status='timeout', reason='deadline'`` with the tokens it
    produced.  ``run``'s ``timeout_s`` is a drain guard: on expiry the
    engine stops admitting, cancels in-flight work keeping partial results,
    marks unserved requests ``timeout`` and returns.
  * **Retry and requeue.**  A failed step requeues its participants for
    recompute with a per-request retry budget (``max_retries``); an
    exhausted budget ends in ``failed``.  Injected failures
    (:class:`repro_torch.robustness.InjectedFault`, raised *before* the
    launch) are request-scoped: bystander slots keep their KV.  An organic
    failure (any other exception, logged with its traceback) cannot trust
    the pools the step was writing, so the pool is rebuilt and every active
    sequence recomputes.
  * **Overload shedding.**  ``admission_budget`` bounds the admission queue;
    arrivals beyond it are rejected at once (``reason='overload'``).
  * **Non-finite quarantine.**  The steps sample through
    ``sample_token_guarded``: a slot whose logits hold a NaN or Inf emits
    ``NONFINITE_TOKEN``, and the engine fails *that slot only*
    (``failed/non_finite``, its pages scrubbed, then reclaimed) while the
    rest of the batch decodes on.
  * **Graceful drain.**  A ``PreemptionGuard`` (or the ``engine.preempt``
    fault point) flips the engine into drain: waiting requests are rejected
    with ``reason='preempted'``, in-flight requests run to completion.

**On a mesh** (``mesh=``, a :class:`repro_torch.launch.mesh.Mesh`, the
engine made on each of its ranks): the parameters are cut to this rank's
windows (:func:`repro_torch.distributed.sharding.model_pspecs`, as
``serve_batch`` cuts them: a MoE model's expert stacks over its
dispatch's axes), the pools are built inside the shard scope, so
a rank holds its own KV heads (and their int8 scales), and both steps run
in the scope.  The slot rows replicate over the data axis, as the pages
do: every rank runs the whole slot batch and samples the same tokens from
the same gathered logits.  Every rank's host scheduler takes the same
decisions (admissions, evictions, ticks, records): the fault plan is
seeded alike on every rank and consulted in the same order, and every
clock reading the scheduler makes is rank 0's, broadcast over the mesh's
own group (records, deadlines, arrivals and the straggler monitor alike).

The ``dist.*`` points are consulted as the JAX engine consults them:
``dist.collective_timeout`` is an injected step failure counted in
``collective_timeouts``; ``dist.straggler`` is drawn once a shard, over
``range(mesh.size)``, and the shards that fired and a step-time z-score
feed ``straggler_flags``; ``dist.device_loss`` is consulted while
``mesh_rebuilds < max_mesh_rebuilds``, and a fire on more than one rank
runs :meth:`Engine._elastic_rebuild` (on one rank there is no device to
lose: the fire is consumed and nothing is rebuilt, as the JAX engine's
``_elastic_rebuild`` returns False there).  So under one seeded
:class:`repro_torch.robustness.FaultPlan` the two packages' engines consult
the same points in the same order and show the same ``faults.summary()``.

Every recovery action is counted in ``Engine.stats`` (``evictions``,
``retries``, ``step_failures``, ``quarantined``, ``shed``,
``deadline_cancels``, ``collective_timeouts``, ``mesh_rebuilds``,
``lost_devices``, ``resharded_restores``), and :meth:`Engine.audit_pages`
checks the page-pool invariant after each recovery when faults are active
(or ``audit_every``) and always at exit.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque

import numpy as np
import torch

from repro_torch.distributed import collectives
from repro_torch.distributed.fault_tolerance import StragglerMonitor
from repro_torch.distributed.sharding import (
    gather_tree,
    model_pspecs,
    shard_tree,
)
from repro_torch.kernels import dispatch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import (
    NONFINITE_TOKEN,
    paged_generate,
    prefill_chunk_step,
)
from repro_torch.models import model_init, paged_cache_init
from repro_torch.models.common import resolve_device
from repro_torch.robustness import NO_FAULTS, InjectedFault

__all__ = ["Request", "Engine", "TERMINAL_STATUSES"]

TERMINAL_STATUSES = ("completed", "timeout", "rejected", "failed")

_log = logging.getLogger(__name__)


@dataclasses.dataclass
class Request:
    """One generation request: ``tokens`` is the prompt (1-D int array),
    ``max_new`` the generation budget, ``arrival`` the trace-relative
    arrival time in seconds (0 = available immediately), ``deadline_s`` an
    optional latency budget relative to arrival (None = none): its expiry
    cancels the request wherever it is and records a ``timeout`` with the
    tokens it produced."""
    rid: int
    tokens: np.ndarray
    max_new: int
    arrival: float = 0.0
    deadline_s: float | None = None


_FREE, _PREFILL, _DECODE = "free", "prefill", "decode"


@dataclasses.dataclass
class _Slot:
    state: str = _FREE
    req: Request | None = None
    pages: list = dataclasses.field(default_factory=list)
    chunk_done: int = 0       # prompt tokens already prefilled
    tok: int = 0              # last generated token (next decode input)
    pos: int = 0              # next decode write position
    out: list = dataclasses.field(default_factory=list)
    admit_seq: int = -1       # admission order (eviction picks the max)
    admit_t: float = 0.0
    first_tok_t: float | None = None


class Engine:
    """Continuous-batching engine; see the module docstring.

    Geometry: ``slots`` concurrent sequences, a pool of ``total_pages``
    pages of ``page_size`` tokens (page 0 reserved), per-slot page tables
    of ``max_pages`` entries (the per-request capacity ceiling), prompts
    prefilled ``chunk`` tokens at a time (``chunk % page_size == 0``).
    ``burst`` decode steps run back to back when no prefill or arrival is
    waiting (1 while interleaving, so prompts never stall).

    ``device`` is ``cuda`` unless named (raising when no card is visible);
    ``backend`` pins the dispatch backend (``fused`` | ``ref``; None = the
    device's default).  ``params`` None draws a random model from ``seed``.

    ``mesh`` (default one rank): the mesh of ranks this engine runs on,
    made on each of them with the same arguments; ``params`` are the whole
    model's, cut here.  ``max_mesh_rebuilds`` bounds the elastic rebuilds
    after ``dist.device_loss``.

    Robustness knobs: ``faults`` (a :class:`repro_torch.robustness.FaultPlan`;
    default :data:`NO_FAULTS`, which costs nothing), ``admission_budget``
    (queued requests before shedding; None = unbounded), ``max_retries``
    (a request's step-failure budget), ``preemption_guard`` (a
    :class:`repro_torch.distributed.PreemptionGuard` polled each tick for a
    graceful drain), ``audit_every`` (audit the page pool after every
    recovery even without a fault plan).
    """

    def __init__(self, cfg, *, slots: int, total_pages: int, page_size: int,
                 max_pages: int, chunk: int, burst: int = 8, mesh=None,
                 backend: str | None = None, temperature: float = 0.0,
                 seed: int = 0, params=None, device=None, faults=None,
                 admission_budget: int | None = None, max_retries: int = 2,
                 preemption_guard=None, audit_every: bool = False,
                 max_mesh_rebuilds: int = 4):
        if cfg.input_kind != "tokens":
            raise ValueError("the paged engine serves token models")
        if chunk % page_size:
            raise ValueError(f"chunk {chunk} % page_size {page_size}")
        if total_pages < 2:
            raise ValueError("need at least one real page beyond the dummy")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.backend = backend
        self.slots = slots
        self.total_pages = total_pages
        self.page_size = page_size
        self.max_pages = max_pages
        self.chunk = chunk
        self.burst = max(int(burst), 1)
        self.temperature = temperature
        self.faults = faults or NO_FAULTS
        self.admission_budget = admission_budget
        self.max_retries = max_retries
        self.preemption_guard = preemption_guard
        self.audit_every = audit_every
        self.max_mesh_rebuilds = max_mesh_rebuilds
        self._set_mesh(mesh if mesh is not None else make_host_mesh())
        if not self.mesh.member:
            raise ValueError(f"rank {self.mesh.rank} is outside {self.mesh}")
        self._place(params if params is not None
                    else model_init(cfg, seed, device=self.device))
        self.pools = self._new_pools()
        # the JAX engine's PRNG key: advanced once a launched step
        self._key = torch.Generator().manual_seed(seed + 1)
        self._slots = [_Slot() for _ in range(slots)]
        self._free_pages = list(range(1, total_pages))  # page 0 = dummy
        self._admit_seq = 0
        self._warm = False
        self._poisoned: set = set()     # pages holding injected NaNs
        self._records: list = []
        self._recorded: set = set()
        self._retries: dict = {}
        self._drain_reason: str | None = None
        self.stats: dict = {}

    # ---- the mesh ---------------------------------------------------------

    def _set_mesh(self, mesh):
        self.mesh = mesh
        self._clock_device = self.device
        if mesh.group is not None:
            import torch.distributed as dist

            if dist.get_backend(mesh.group) == "gloo":
                self._clock_device = torch.device("cpu")  # no copy to a card

    def _scope(self):
        # the slot rows replicate over the data axis
        return dispatch.shard_scope(self.mesh if self.mesh.size > 1 else None,
                                    tokens_split=False)

    def _place(self, whole: dict):
        """Cut the whole ``params`` to this rank's windows on ``self.mesh``."""
        self._specs = None
        self.params = whole
        if self.mesh.size > 1:
            self._specs = model_pspecs(whole, self.cfg, self.mesh)
            self.params = shard_tree(whole, self._specs, self.mesh)

    def _new_pools(self):
        """Empty pools, built in the shard scope: a rank's own KV heads."""
        with torch.inference_mode(), self._scope():
            return paged_cache_init(self.cfg, self.total_pages, self.page_size,
                                    device=self.device)

    def _tensor(self, a) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _split_key(self) -> torch.Generator | None:
        """The step's generator, drawn from the engine's key (one draw a
        launched step, as the JAX engine splits its key).  Greedy decoding
        draws nothing from it, so no device generator is made then."""
        sub = int(torch.randint(0, 2**62, (), generator=self._key))
        if self.temperature <= 0.0:
            return None
        return torch.Generator(device=self.device).manual_seed(sub)

    def _chunk_step(self, tokens, pt, qpos, pos0) -> np.ndarray:
        """One chunk step; returns tok1 (slots,) on the host (the copy
        waits for the device)."""
        with (torch.inference_mode(), dispatch.backend_scope(self.backend),
              self._scope()):
            tok1, self.pools = prefill_chunk_step(
                self.params, self.cfg, self._tensor(tokens).long(), self.pools,
                self._tensor(pt), self._tensor(qpos), self._tensor(pos0),
                temperature=self.temperature, generator=self._split_key())
        return tok1.cpu().numpy()

    def _decode_step(self, tok, pt, pos, n: int) -> np.ndarray:
        """``n`` decode steps; returns tokens (slots, n) on the host."""
        with (torch.inference_mode(), dispatch.backend_scope(self.backend),
              self._scope()):
            toks, self.pools = paged_generate(
                self.params, self.cfg, self._tensor(tok), self.pools,
                self._tensor(pt), self._tensor(pos), n=n,
                temperature=self.temperature, generator=self._split_key())
        return toks.cpu().numpy()

    def warmup(self):
        """Run one all-dead chunk step and one decode step, so the first
        timed tick holds no first-launch cost (kernel loading, library
        handles).  All-dead inputs (positions -1, page tables 0) only write
        the dummy page, so the pools stay semantically empty."""
        if self._warm:
            return
        z_pt = np.zeros((self.slots, self.max_pages), np.int32)
        z = np.zeros((self.slots,), np.int32)
        self._chunk_step(np.zeros((self.slots, self.chunk), np.int32), z_pt,
                         np.full((self.slots, self.chunk), -1, np.int32), z)
        self._decode_step(z, z_pt, z, 1)
        self._warm = True

    # ---- page accounting ------------------------------------------------

    def _pages_needed(self, req: Request) -> int:
        """Pages a request holds at peak: prompt chunks round up to the
        chunk grid, and decode writes through plen + max_new - 2."""
        plen = len(req.tokens)
        hi = max(-(-plen // self.chunk) * self.chunk,
                 plen + req.max_new - 1)
        return -(-hi // self.page_size)

    def _validate(self, req: Request):
        need = self._pages_needed(req)
        cap = min(self.max_pages, self.total_pages - 1)
        if need > cap:
            raise ValueError(
                f"request {req.rid} needs {need} pages "
                f"(prompt {len(req.tokens)} + gen {req.max_new}, page size "
                f"{self.page_size}) but the ceiling is {cap} "
                f"(max_pages={self.max_pages}, pool={self.total_pages})")
        if not req.max_new:
            raise ValueError(f"request {req.rid}: max_new must be >= 1")

    def _set_pages(self, pages, value: float, floating_only: bool):
        """Write ``value`` into physical ``pages`` of every layer's pool
        leaves (only the floating ones when ``floating_only``)."""
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        with torch.inference_mode():
            for pool in self.pools:
                for leaf in pool.values():
                    if floating_only and not leaf.is_floating_point():
                        continue
                    leaf.index_fill_(0, idx, value)

    def _free_slot_pages(self, slot: _Slot):
        """Return a slot's pages to the free pool, scrubbing any that hold
        injected NaNs first (a reclaimed page must never leak non-finite
        state into its next owner)."""
        doomed = [p for p in slot.pages if p in self._poisoned]
        if doomed:
            self._set_pages(doomed, 0, floating_only=False)
            self._poisoned.difference_update(doomed)
        self._free_pages.extend(slot.pages)

    def _release(self, slot: _Slot):
        self._free_slot_pages(slot)
        self._reset(slot)

    def _evict_youngest(self, queue: deque) -> bool:
        """Free the youngest admitted slot and requeue its request at the
        front (recompute on readmission).  False if nothing is active."""
        active = [s for s in self._slots if s.state != _FREE]
        if not active:
            return False
        victim = max(active, key=lambda s: s.admit_seq)
        req = victim.req
        self._release(victim)
        queue.appendleft(req)
        self.stats["evictions"] += 1
        self._post_recovery_audit("eviction")
        return True

    def _try_page(self, slot: _Slot, logical: int) -> bool:
        """Grow the slot's page list through logical index ``logical`` from
        the free pool; False if the pool runs dry (partial growth is kept:
        it is still valid).  The ``engine.page_alloc`` point makes an
        allocation fail as if the pool were empty."""
        while len(slot.pages) <= logical:
            if not self._free_pages or self.faults.fires("engine.page_alloc"):
                return False
            slot.pages.append(self._free_pages.pop())
        return True

    def _claim(self, slots_, need_fn, queue: deque, can_wait: bool):
        """The slots of a phase whose pages are available this tick.  A
        starved slot stalls (skips the tick, keeps its pages).  Only when no
        slot of the phase can move and there is no other progress to wait
        on (``can_wait``) is the youngest admitted request evicted."""
        ready, stalled = [], []
        for s in slots_:
            (ready if self._try_page(s, need_fn(s)) else stalled).append(s)
        while not ready and stalled and not can_wait:
            if not self._evict_youngest(queue):
                break
            # the victim may have been anywhere, including `stalled`
            stalled = [s for s in stalled if s.req is not None]
            retry, stalled = stalled, []
            for s in retry:
                (ready if self._try_page(s, need_fn(s))
                 else stalled).append(s)
        return [s for s in ready if s.req is not None]

    def _reset(self, slot: _Slot):
        slot.state = _FREE
        slot.req = None
        slot.pages = []
        slot.chunk_done = 0
        slot.tok = 0
        slot.pos = 0
        slot.out = []
        slot.admit_seq = -1
        slot.first_tok_t = None

    # ---- fault handling and accounting ----------------------------------

    def audit_pages(self) -> dict:
        """Page-pool invariant: every page but the dummy is in exactly one
        place (the free list or one slot's table), nothing duplicated."""
        held = [p for s in self._slots for p in s.pages]
        free = list(self._free_pages)
        issues = []
        if len(held) != len(set(held)):
            issues.append("page held by two slots")
        if len(free) != len(set(free)):
            issues.append("free-list duplicate")
        if set(held) & set(free):
            issues.append("page both free and held")
        if 0 in held or 0 in free:
            issues.append("dummy page 0 circulating")
        if len(set(held)) + len(set(free)) != self.total_pages - 1:
            issues.append(
                f"leak: held {len(set(held))} + free {len(set(free))} "
                f"!= {self.total_pages - 1}")
        return {"ok": not issues, "free": len(free), "held": len(held),
                "total_pages": self.total_pages, "issues": issues}

    def _post_recovery_audit(self, label: str):
        if not (self.faults.enabled or self.audit_every):
            return
        a = self.audit_pages()
        if not a["ok"]:
            self.stats.setdefault("audit_failures", []).append(
                dict(a, after=label))

    def _now(self) -> float:
        """Seconds since the run's start: on a mesh, rank 0's clock on every
        rank, so every rank's scheduler reads the same time."""
        t = time.perf_counter() - self._t0
        if self.mesh.group is None:
            return t
        buf = torch.tensor([t], dtype=torch.float64, device=self._clock_device)
        return float(collectives.broadcast_mesh(buf, self.mesh)[0])

    def _record(self, req: Request, status: str, *, reason=None,
                tokens=(), slot: _Slot | None = None):
        """Append a request's single terminal record (once per rid)."""
        if req.rid in self._recorded:
            return
        self._recorded.add(req.rid)
        t = self._now()
        self._records.append({
            "rid": req.rid,
            "arrival": req.arrival,
            "status": status,
            "reason": reason,
            "admitted": slot.admit_t if slot is not None else None,
            "first_token": slot.first_tok_t if slot is not None else None,
            "finished": t,
            "latency": t - req.arrival,
            "prompt_len": int(len(req.tokens)),
            "tokens": list(tokens),
        })

    def _finish(self, slot: _Slot):
        self._record(slot.req, "completed", tokens=slot.out, slot=slot)
        self._release(slot)

    def _quarantine(self, slot: _Slot):
        """Non-finite logits in this slot only: record the failure with the
        tokens generated before the poison, scrub and reclaim its pages (its
        own KV writes are suspect too), and keep every other slot going."""
        self._poisoned.update(slot.pages)
        self._record(slot.req, "failed", reason="non_finite",
                     tokens=slot.out, slot=slot)
        self._release(slot)
        self.stats["quarantined"] += 1
        self._post_recovery_audit("quarantine")

    def _reinit_pools(self):
        """Rebuild the page pool from scratch (organic step failure: the
        state of the pools the step was writing is unknown; a mesh rebuild:
        the heads are laid out anew)."""
        self.pools = None  # the old pools go before the new ones are made
        self.pools = self._new_pools()
        self._free_pages = list(range(1, self.total_pages))
        self._poisoned = set()

    def _elastic_rebuild(self, queue: deque) -> bool:
        """Elastic recovery from an (injected) device loss, the JAX engine's
        ``_elastic_rebuild``: shrink the mesh (the data axis halves first,
        the model axis only once data parallelism is gone), rebuild the
        parameters' shards on the surviving ranks from the old mesh's bytes
        (every rank of the old mesh, the lost ones included, all-gathers
        its shards over the old groups of the axes they are split along:
        same bytes, new placement; the new mesh's layout, expert-parallel
        axes included, is computed afresh),
        requeue every in-flight request, oldest at the front, without
        charging its retry budget (the hardware failed, not the request),
        rebuild the pools on the new mesh, warm up and audit.  A rank
        outside the new mesh stops after the hand-over (``self.mesh`` is
        then a mesh it is no member of).  Returns False on one rank (nothing
        to lose)."""
        old = self.mesh
        if old.size <= 1:
            return False
        t0 = time.perf_counter()
        whole = gather_tree(self.params, self._specs, old)
        t_gather = time.perf_counter() - t0
        new = old.shrink()
        self.stats["lost_devices"] += old.size - new.size
        self._set_mesh(new)
        if not new.member:
            self.params = self.pools = None
            return True
        self._place(whole)
        del whole
        self.stats["resharded_restores"] += 1
        active = [s for s in self._slots if s.state != _FREE]
        for s in sorted(active, key=lambda s: s.admit_seq, reverse=True):
            req = s.req
            self._reset(s)
            queue.appendleft(req)
        t1 = time.perf_counter()
        self._reinit_pools()
        t_pools = time.perf_counter() - t1
        self.stats["mesh_rebuilds"] += 1
        t1 = time.perf_counter()
        self._warm = False
        self.warmup()
        self.stats["rebuild_s"].append({"gather": t_gather, "pools": t_pools,
                                        "warmup": time.perf_counter() - t1,
                                        "mesh": dict(new.shape)})
        self._post_recovery_audit("mesh_rebuild")
        return True

    def _step_failure(self, participants, queue: deque, *, injected: bool,
                      phase: str):
        """Recover from a failed step launch.  Participants are charged a
        retry (``failed`` once the budget is gone) and requeued at the
        front for recompute.  Injected faults fire *before* the launch, so
        bystander slots keep their pages and KV; an organic failure cannot
        trust the pools, so the pool is rebuilt and every active sequence
        recomputes."""
        self.stats["step_failures"] += 1
        affected = (list(participants) if injected
                    else [s for s in self._slots if s.state != _FREE])
        charged = {id(s) for s in participants}
        # appendleft in reverse admission order keeps the oldest frontmost
        for s in sorted(affected, key=lambda s: s.admit_seq, reverse=True):
            req = s.req
            if id(s) in charged:
                n = self._retries[req.rid] = self._retries.get(req.rid, 0) + 1
                self.stats["retries"] += 1
                if n > self.max_retries:
                    self._record(req, "failed",
                                 reason=f"{phase}_step_failure",
                                 tokens=s.out, slot=s)
                    if injected:
                        self._free_slot_pages(s)
                    self._reset(s)
                    continue
            if injected:
                self._free_slot_pages(s)
            self._reset(s)
            queue.appendleft(req)
        if not injected:
            self._reinit_pools()
        self._post_recovery_audit(f"{phase}_step_failure")

    def _launch(self, phase: str, participants, queue: deque, step):
        """Run ``step()`` behind the ``dist.collective_timeout`` and
        ``engine.step`` points (consulted in that order, before the
        launch); returns its tokens, or None after a failure was
        recovered."""
        try:
            if self.faults.fires("dist.collective_timeout"):
                self.stats["collective_timeouts"] += 1
                raise InjectedFault(f"injected collective timeout ({phase})")
            if self.faults.fires("engine.step"):
                raise InjectedFault(f"injected {phase}-step failure")
            return step()
        except InjectedFault:
            self._step_failure(participants, queue, injected=True,
                               phase=phase)
        except Exception:
            _log.exception("organic %s-step failure: requeueing every "
                           "active request on a rebuilt pool", phase)
            self._step_failure(participants, queue, injected=False,
                               phase=phase)
        return None

    def _enforce_deadlines(self, queue: deque):
        """Cancel deadline-expired requests wherever they are: queued ones
        are recorded unserved; in-flight ones free their pages and keep the
        tokens they produced."""
        expired = [r for r in queue
                   if r.deadline_s is not None
                   and self._now() - r.arrival > r.deadline_s]
        for r in expired:
            queue.remove(r)
            self._record(r, "timeout", reason="deadline")
            self.stats["deadline_cancels"] += 1
        for s in self._slots:
            if s.state == _FREE or s.req.deadline_s is None:
                continue
            if self._now() - s.req.arrival > s.req.deadline_s:
                self._record(s.req, "timeout", reason="deadline",
                             tokens=s.out, slot=s)
                self._release(s)
                self.stats["deadline_cancels"] += 1
                self._post_recovery_audit("deadline_cancel")

    def _drain_all(self, pending: deque, queue: deque, reason: str):
        """Global-timeout drain: cancel in-flight work keeping partial
        output, mark everything still waiting unserved.  Nothing raises."""
        for s in self._slots:
            if s.state != _FREE:
                self._record(s.req, "timeout", reason=reason,
                             tokens=s.out, slot=s)
                self._release(s)
        while queue:
            self._record(queue.popleft(), "timeout", reason="unserved")
        while pending:
            self._record(pending.popleft(), "timeout", reason="unserved")
        self._post_recovery_audit("drain")

    # ---- run loop -------------------------------------------------------

    def run(self, requests, *, timeout_s: float = 300.0) -> dict:
        """Serve ``requests`` (any order; sorted by arrival) to completion
        or controlled degradation.

        Returns a stats dict: one terminal record per request (status in
        ``TERMINAL_STATUSES``), goodput (completed requests' tokens / wall
        second), latency percentiles over completed requests, per-phase
        prefill / decode milliseconds (host clock around each step, ending
        when its tokens reach the host), step, eviction and recovery
        counters, the fault plan's summary and the exit page-pool audit.
        ``timeout_s`` is a drain guard, not an exception: on expiry the
        engine stops admitting, keeps partial results and returns.  On a
        rank that an elastic rebuild lost the run stops there: its stats
        say ``lost`` True and hold the records made until then
        (``final_mesh`` is the mesh after the rebuild; ``rebuild_s`` the
        seconds of each rebuild's hand-over, pool rebuild and warm-up).
        """
        for r in requests:
            self._validate(r)
        self.warmup()
        pending = deque(sorted(requests, key=lambda r: r.arrival))
        queue: deque = deque()
        self._records = []
        self._recorded = set()
        self._retries = {}
        self._poisoned = set()
        self._drain_reason = None
        self.stats = {"evictions": 0, "chunk_steps": 0, "decode_steps": 0,
                      "prefill_ms": 0.0, "decode_ms": 0.0,
                      "step_failures": 0, "retries": 0, "quarantined": 0,
                      "shed": 0, "deadline_cancels": 0, "nan_injections": 0,
                      "preempted": False, "mesh_rebuilds": 0,
                      "lost_devices": 0, "resharded_restores": 0,
                      "collective_timeouts": 0, "straggler_flags": [],
                      "rebuild_s": []}
        self._t0 = time.perf_counter()
        now = self._now
        tick = 0
        lost = False
        mon = StragglerMonitor(warmup_steps=5, clock=now)
        guard = self.preemption_guard

        while pending or queue or any(s.state != _FREE for s in self._slots):
            # the drain guard; and when nothing is runnable and the next
            # arrival lands past it, declare the timeout now instead of
            # sleeping into it
            if now() > timeout_s or (
                    not queue and pending
                    and all(s.state == _FREE for s in self._slots)
                    and pending[0].arrival > timeout_s):
                self._drain_reason = "timeout"
                self._drain_all(pending, queue, "global_timeout")
                break

            if self._drain_reason is None and (
                    (guard is not None and guard.preempted)
                    or self.faults.fires("engine.preempt")):
                # graceful drain: reject everything waiting, let in-flight
                # slots run to completion
                self._drain_reason = "preempted"
                self.stats["preempted"] = True
                while queue:
                    self._record(queue.popleft(), "rejected",
                                 reason="preempted")
                while pending:
                    self._record(pending.popleft(), "rejected",
                                 reason="preempted")

            if (self.faults.enabled
                    and self.stats["mesh_rebuilds"] < self.max_mesh_rebuilds
                    and self.faults.fires("dist.device_loss")
                    and self._elastic_rebuild(queue)
                    and not self.mesh.member):
                lost = True     # this rank's device is gone
                break

            self.faults.fires("engine.straggler")   # sleeps when it fires
            # straggler watchdog: one injection stream a shard (deterministic
            # across process counts) plus an EMA z-score over tick wall time
            # that flags organic slowness
            tick += 1
            mon.start_step()
            slow_shards = []
            if self.faults.enabled:
                for sidx in range(self.mesh.size):
                    if self.faults.fires("dist.straggler", index=sidx):
                        slow_shards.append(sidx)  # fires() slept in line

            while pending and pending[0].arrival <= now():
                r = pending.popleft()
                if (self.admission_budget is not None
                        and len(queue) >= self.admission_budget):
                    self._record(r, "rejected", reason="overload")
                    self.stats["shed"] += 1
                else:
                    queue.append(r)

            self._enforce_deadlines(queue)

            # admission: FIFO while a slot is free and the pool can cover
            # the whole prompt (pages past the first chunk are still
            # allocated lazily)
            for slot in self._slots:
                if not queue or slot.state != _FREE:
                    continue
                req = queue[0]
                if len(self._free_pages) < -(-len(req.tokens)
                                             // self.page_size):
                    break
                first = -(-min(len(req.tokens), self.chunk)
                          // self.page_size)
                queue.popleft()
                slot.state = _PREFILL
                slot.req = req
                slot.pages = [self._free_pages.pop() for _ in range(first)]
                slot.admit_seq = self._admit_seq
                self._admit_seq += 1
                slot.admit_t = now()

            prefilling = [s for s in self._slots if s.state == _PREFILL]
            if prefilling:
                self._run_chunk(prefilling, queue)

            decoding = [s for s in self._slots if s.state == _DECODE]
            if decoding:
                # burst only when nothing competes for the device: no
                # prefill in flight and no admissible work waiting
                can_admit = any(s.state == _FREE for s in self._slots)
                waiting = bool(queue) or (
                    pending and pending[0].arrival <= now() + 1e-3)
                quiet = not prefilling and not (can_admit and waiting)
                n = self.burst if quiet else 1
                n = min(n, max(len(s.req.tokens) + s.req.max_new - s.pos - 1
                               for s in decoding))
                self._run_decode(decoding, max(n, 1), queue)

            if (prefilling or decoding) and (
                    mon.end_step(tick) or slow_shards):
                flagged = mon.flags[-1] if mon.flags else None
                self.stats["straggler_flags"].append({
                    "tick": tick, "shards": slow_shards,
                    "injected": bool(slow_shards),
                    "dt_s": flagged[1] if flagged else None,
                    "zscore": flagged[2] if flagged else None})

            if not prefilling and not decoding and not queue and pending:
                time.sleep(min(max(pending[0].arrival - now(), 0.0), 0.05))

        wall = now()
        records = self._records
        completed = [r for r in records if r["status"] == "completed"]
        lat = sorted(r["latency"] for r in completed)

        def pct(p):
            return lat[min(int(p * len(lat)), len(lat) - 1)] if lat else 0.0

        statuses: dict = {}
        for r in records:
            statuses[r["status"]] = statuses.get(r["status"], 0) + 1
        gen_tokens = sum(len(r["tokens"]) for r in completed)
        self.stats.update({
            "requests": len(records),
            "completed": len(completed),
            "statuses": statuses,
            "all_completed": len(completed) == len(requests),
            "drained": self._drain_reason,
            "wall_s": wall,
            "goodput_tok_s": gen_tokens / max(wall, 1e-9),
            "generated_tokens": gen_tokens,
            "latency_p50_s": pct(0.50),
            "latency_p99_s": pct(0.99),
            "records": records,
            "page_audit": self.audit_pages(),
            "faults": self.faults.summary(),
            "ticks": tick,
            "lost": lost,
            "final_mesh": dict(self.mesh.shape),
        })
        return dict(self.stats)

    # ---- phase steps ----------------------------------------------------

    def _page_table(self, live) -> np.ndarray:
        pt = np.zeros((self.slots, self.max_pages), np.int32)
        for i, s in enumerate(self._slots):
            if id(s) in live:
                pt[i, : len(s.pages)] = s.pages
        return pt

    def _run_chunk(self, prefilling, queue):
        cs = self.chunk

        def pages_for_chunk(s):
            # pages ahead of this chunk are allocated lazily, so a long
            # prompt does not hold its whole footprint from its first tick
            return (min(s.chunk_done + cs, len(s.req.tokens)) - 1) \
                // self.page_size

        prefilling = self._claim(
            prefilling, pages_for_chunk, queue,
            can_wait=any(s.state == _DECODE for s in self._slots))
        if not prefilling:
            return
        tokens = np.zeros((self.slots, cs), np.int32)
        qpos = np.full((self.slots, cs), -1, np.int32)
        pos0 = np.zeros((self.slots,), np.int32)
        for s in prefilling:
            i = self._slots.index(s)
            seg = np.asarray(s.req.tokens[s.chunk_done: s.chunk_done + cs],
                             np.int32)
            tokens[i, : len(seg)] = seg
            qpos[i, : len(seg)] = s.chunk_done + np.arange(len(seg))
            pos0[i] = s.chunk_done
        pt = self._page_table({id(s) for s in prefilling})
        t0 = time.perf_counter()
        tok1 = self._launch("prefill", prefilling, queue,
                            lambda: self._chunk_step(tokens, pt, qpos, pos0))
        if tok1 is None:
            return
        self.stats["prefill_ms"] += (time.perf_counter() - t0) * 1e3
        self.stats["chunk_steps"] += 1
        for s in prefilling:
            i = self._slots.index(s)
            s.chunk_done += cs
            if s.chunk_done < len(s.req.tokens):
                continue
            if int(tok1[i]) == NONFINITE_TOKEN:
                self._quarantine(s)
                continue
            s.state = _DECODE
            s.tok = int(tok1[i])
            s.pos = len(s.req.tokens)
            s.out = [s.tok]
            s.first_tok_t = self._now()
            if len(s.out) >= s.req.max_new:
                self._finish(s)

    def _poison_page(self, page: int):
        """Write NaNs into one physical page of every floating pool leaf
        (bf16 K/V directly; an int8 pool through its f32 scales), so the
        real non-finite guard trips on the next read."""
        self._set_pages([page], float("nan"), floating_only=True)
        self._poisoned.add(int(page))
        self.stats["nan_injections"] += 1

    def _run_decode(self, decoding, n, queue):
        def pages_for_burst(s):
            # decode writes positions pos .. pos+n-1, capped at the
            # request's last write (plen + max_new - 2); overrun steps past
            # it land in the dummy page
            return min((s.pos + n - 1) // self.page_size,
                       (len(s.req.tokens) + s.req.max_new - 2)
                       // self.page_size)

        decoding = self._claim(decoding, pages_for_burst, queue,
                               can_wait=False)
        if not decoding:
            return
        if self.faults.fires("engine.nan_logits"):
            victim = min(decoding, key=lambda s: s.admit_seq)
            if victim.pages:
                self._poison_page(victim.pages[0])
        tok = np.zeros((self.slots,), np.int32)
        pos = np.zeros((self.slots,), np.int32)
        for s in decoding:
            i = self._slots.index(s)
            tok[i] = s.tok
            pos[i] = s.pos
        pt = self._page_table({id(s) for s in decoding})
        if n != self.burst:
            n = 1  # a burst runs whole or not at all, as in the JAX engine
        t0 = time.perf_counter()
        toks = self._launch("decode", decoding, queue,
                            lambda: self._decode_step(tok, pt, pos, n))
        if toks is None:
            return
        self.stats["decode_ms"] += (time.perf_counter() - t0) * 1e3
        self.stats["decode_steps"] += n
        for s in decoding:
            i = self._slots.index(s)
            poisoned = False
            for j in range(n):
                if len(s.out) >= s.req.max_new:
                    break
                t = int(toks[i, j])
                if t == NONFINITE_TOKEN:
                    poisoned = True
                    break
                s.out.append(t)
                s.tok = t
                s.pos += 1
            if poisoned:
                self._quarantine(s)
            elif len(s.out) >= s.req.max_new:
                self._finish(s)

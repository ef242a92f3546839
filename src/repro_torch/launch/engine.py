"""Continuous-batching serving engine over the block-paged KV cache.

Port of the JAX package's ``launch/engine.py`` without its fault handling.
It serves a *stream* of requests:

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
``prompt_len + k - 1``.  Every request completes; nothing here catches an
error: a failed kernel launch raises out of :meth:`Engine.run`, and so does
a non-finite logit (``NONFINITE_TOKEN``), naming the request.  Deadlines,
retries, overload shedding, drain and quarantine are not ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.kernels import dispatch
from repro_torch.launch.steps import (
    NONFINITE_TOKEN,
    paged_generate,
    prefill_chunk_step,
)
from repro_torch.models import model_init, paged_cache_init
from repro_torch.models.common import resolve_device

__all__ = ["Request", "Engine"]


@dataclasses.dataclass
class Request:
    """One generation request: ``tokens`` is the prompt (1-D int array),
    ``max_new`` the generation budget, ``arrival`` the trace-relative
    arrival time in seconds (0 = available immediately)."""
    rid: int
    tokens: np.ndarray
    max_new: int
    arrival: float = 0.0


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
    """

    def __init__(self, cfg, *, slots: int, total_pages: int, page_size: int,
                 max_pages: int, chunk: int, burst: int = 8,
                 backend: str | None = None, temperature: float = 0.0,
                 seed: int = 0, params=None, device=None):
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
        self.params = (params if params is not None
                       else model_init(cfg, seed, device=self.device))
        self.pools = paged_cache_init(cfg, total_pages, page_size,
                                      device=self.device)
        self._generator = torch.Generator(device=self.device).manual_seed(
            seed + 1)
        self._slots = [_Slot() for _ in range(slots)]
        self._free_pages = list(range(1, total_pages))  # page 0 = dummy
        self._admit_seq = 0
        self._warm = False
        self._records: list = []
        self.stats: dict = {}

    def _tensor(self, a) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _chunk_step(self, tokens, pt, qpos, pos0) -> np.ndarray:
        """One chunk step; returns tok1 (slots,) on the host (the copy
        waits for the device)."""
        with torch.inference_mode(), dispatch.backend_scope(self.backend):
            tok1, self.pools = prefill_chunk_step(
                self.params, self.cfg, self._tensor(tokens).long(), self.pools,
                self._tensor(pt), self._tensor(qpos), self._tensor(pos0),
                temperature=self.temperature, generator=self._generator)
        return tok1.cpu().numpy()

    def _decode_step(self, tok, pt, pos, n: int) -> np.ndarray:
        """``n`` decode steps; returns tokens (slots, n) on the host."""
        with torch.inference_mode(), dispatch.backend_scope(self.backend):
            toks, self.pools = paged_generate(
                self.params, self.cfg, self._tensor(tok), self.pools,
                self._tensor(pt), self._tensor(pos), n=n,
                temperature=self.temperature, generator=self._generator)
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

    def _release(self, slot: _Slot):
        self._free_pages.extend(slot.pages)
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
        return True

    def _try_page(self, slot: _Slot, logical: int) -> bool:
        """Grow the slot's page list through logical index ``logical`` from
        the free pool; False if the pool runs dry (partial growth is kept:
        it is still valid)."""
        while len(slot.pages) <= logical:
            if not self._free_pages:
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

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def _finish(self, slot: _Slot):
        req = slot.req
        t = self._now()
        self._records.append({
            "rid": req.rid,
            "arrival": req.arrival,
            "status": "completed",
            "admitted": slot.admit_t,
            "first_token": slot.first_tok_t,
            "finished": t,
            "latency": t - req.arrival,
            "prompt_len": int(len(req.tokens)),
            "tokens": list(slot.out),
        })
        self._release(slot)

    @staticmethod
    def _check_finite(slot: _Slot, tok: int):
        if tok == NONFINITE_TOKEN:
            raise RuntimeError(
                f"request {slot.req.rid}: non-finite logits at position "
                f"{slot.pos} (quarantine is not ported; the run stops)")

    # ---- run loop -------------------------------------------------------

    def run(self, requests) -> dict:
        """Serve ``requests`` (any order; sorted by arrival) to completion.

        Returns a stats dict: one record per request, goodput (generated
        tokens / wall second), latency percentiles, per-phase prefill /
        decode milliseconds (host clock around each step, ending when its
        tokens reach the host), step and eviction counts, and the exit
        page-pool audit.  An error in a step propagates.
        """
        for r in requests:
            self._validate(r)
        self.warmup()
        pending = deque(sorted(requests, key=lambda r: r.arrival))
        queue: deque = deque()
        self._records = []
        self.stats = {"evictions": 0, "chunk_steps": 0, "decode_steps": 0,
                      "prefill_ms": 0.0, "decode_ms": 0.0}
        self._t0 = time.perf_counter()
        now = self._now

        while pending or queue or any(s.state != _FREE for s in self._slots):
            while pending and pending[0].arrival <= now():
                queue.append(pending.popleft())

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

            if not prefilling and not decoding and not queue and pending:
                time.sleep(min(max(pending[0].arrival - now(), 0.0), 0.05))

        wall = now()
        records = self._records
        lat = sorted(r["latency"] for r in records)

        def pct(p):
            return lat[min(int(p * len(lat)), len(lat) - 1)] if lat else 0.0

        gen_tokens = sum(len(r["tokens"]) for r in records)
        self.stats.update({
            "requests": len(records),
            "completed": len(records),
            "statuses": {"completed": len(records)} if records else {},
            "all_completed": len(records) == len(requests),
            "wall_s": wall,
            "goodput_tok_s": gen_tokens / max(wall, 1e-9),
            "generated_tokens": gen_tokens,
            "latency_p50_s": pct(0.50),
            "latency_p99_s": pct(0.99),
            "records": records,
            "page_audit": self.audit_pages(),
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
        tok1 = self._chunk_step(tokens, pt, qpos, pos0)
        self.stats["prefill_ms"] += (time.perf_counter() - t0) * 1e3
        self.stats["chunk_steps"] += 1
        for s in prefilling:
            i = self._slots.index(s)
            s.chunk_done += cs
            if s.chunk_done < len(s.req.tokens):
                continue
            self._check_finite(s, int(tok1[i]))
            s.state = _DECODE
            s.tok = int(tok1[i])
            s.pos = len(s.req.tokens)
            s.out = [s.tok]
            s.first_tok_t = self._now()
            if len(s.out) >= s.req.max_new:
                self._finish(s)

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
        toks = self._decode_step(tok, pt, pos, n)
        self.stats["decode_ms"] += (time.perf_counter() - t0) * 1e3
        self.stats["decode_steps"] += n
        for s in decoding:
            i = self._slots.index(s)
            for j in range(n):
                if len(s.out) >= s.req.max_new:
                    break
                t = int(toks[i, j])
                self._check_finite(s, t)
                s.out.append(t)
                s.tok = t
                s.pos += 1
            if len(s.out) >= s.req.max_new:
                self._finish(s)

"""Atomic, pickle-free checkpoints of a training state on one device.

The single-device part of the JAX package's checkpointer:

  * atomic: leaves are written into ``step_<N>.tmp/``, which is renamed to
    ``step_<N>/``; ``MANIFEST.json`` is written last (through a rename too),
    so a crash mid-save never corrupts the latest checkpoint;
  * content: one ``.npy`` per leaf plus ``spec.json`` (each leaf's kind,
    dtype and shape) — no pickle.  bf16 tensors are stored as their uint16
    bit pattern with the dtype named in the spec (numpy has no bfloat16);
  * retention: the newest ``keep`` checkpoints stay, older ones are deleted;
  * IO retries: every file write and read goes through
    :func:`repro_torch.distributed.retry_on_transient` (``io_retries``
    attempts after the first, ``io_backoff`` seconds doubling, an
    ``io_jitter`` share of decorrelated jitter), so a transient ``OSError``
    does not kill a run; a permanent one still raises;
  * chaos: the ``ckpt.save_crash`` point of ``faults`` is consulted once a
    leaf; a fire raises :class:`repro_torch.robustness.InjectedFault`
    mid-save and leaves a stray ``step_<N>.tmp/``, which ``latest_step`` and
    ``restore`` ignore.

A state is a tree of dicts (any hashable keys, e.g. the tuple paths of
:func:`repro_torch.core.peft.partition`), lists, tuples (NamedTuples
included) and leaves: tensors and Python ints / floats.  ``restore`` reads
into the structure of an example state, each tensor onto its example's
device.  Checkpoints of the JAX package are not read.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch.distributed.fault_tolerance import retry_on_transient
from repro_torch.robustness import NO_FAULTS, InjectedFault

__all__ = ["Checkpointer"]


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _rebuild(tree, it):
    """``tree``'s structure with its leaves taken from the iterator ``it``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, it) for v in tree]
    if isinstance(tree, tuple):
        vals = [_rebuild(v, it) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return next(it)


def _encode(leaf) -> tuple[np.ndarray, dict]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            arr = t.contiguous().view(torch.int16).numpy().view(np.uint16)
        else:
            arr = t.numpy()
        return arr, {"kind": "tensor", "dtype": str(t.dtype).removeprefix(
            "torch."), "shape": list(t.shape)}
    if isinstance(leaf, (bool, int, float)):
        return np.asarray(leaf), {"kind": type(leaf).__name__}
    raise TypeError(f"cannot checkpoint a leaf of type {type(leaf).__name__}")


def _decode(arr: np.ndarray, entry: dict, example):
    kind = entry["kind"]
    if kind != "tensor":
        return {"bool": bool, "int": int, "float": float}[kind](arr)
    if entry["dtype"] == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if list(t.shape) != entry["shape"]:
        raise ValueError(f"leaf shape {list(t.shape)} != spec {entry['shape']}")
    device = example.device if isinstance(example, torch.Tensor) else "cpu"
    return t.to(device)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, io_retries: int = 2,
                 io_backoff: float = 0.05, io_jitter: float = 0.0,
                 faults=NO_FAULTS):
        self.dir = directory
        self.keep = keep
        self.io_retries = io_retries
        self.io_backoff = io_backoff
        self.io_jitter = io_jitter
        self.faults = faults
        os.makedirs(directory, exist_ok=True)

    def _io(self, fn):
        """``fn()`` behind bounded retries with backoff on ``OSError``."""
        return retry_on_transient(fn, retries=self.io_retries,
                                  backoff=self.io_backoff,
                                  exceptions=(OSError,),
                                  jitter=self.io_jitter)

    def save(self, step: int, state) -> None:
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        entries = []
        for i, leaf in enumerate(_leaves(state)):
            if self.faults.fires("ckpt.save_crash"):
                raise InjectedFault(
                    f"killed mid checkpoint save (step {step}, leaf {i})")
            arr, entry = _encode(leaf)
            entry["file"] = f"leaf_{i:05d}.npy"
            path = os.path.join(tmp, entry["file"])
            self._io(lambda: np.save(path, arr, allow_pickle=False))
            entries.append(entry)

        def write_spec():
            with open(os.path.join(tmp, "spec.json"), "w") as f:
                json.dump({"version": 1, "step": step, "leaves": entries}, f)

        self._io(write_spec)
        if os.path.exists(final):
            shutil.rmtree(final)
        self._io(lambda: os.replace(tmp, final))
        self._write_manifest(step)
        self._gc()

    def _write_manifest(self, step: int) -> None:
        man = os.path.join(self.dir, "MANIFEST.json")
        steps = sorted(set(self.all_steps()) | {step})

        def write_man():
            with open(man + ".tmp", "w") as f:
                json.dump({"steps": steps, "latest": max(steps)}, f)
            os.replace(man + ".tmp", man)

        self._io(write_man)

    def _gc(self) -> None:
        if not self.keep:
            return
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        """The newest step the manifest lists and whose directory exists
        (every step directory, when the manifest is missing or torn)."""
        live = set(self.all_steps())
        try:
            with open(os.path.join(self.dir, "MANIFEST.json")) as f:
                cands = [s for s in json.load(f).get("steps", []) if s in live]
        except (OSError, ValueError, AttributeError):
            cands = sorted(live)
        return max(cands) if cands else None

    def restore(self, example_state, step: int | None = None):
        """The checkpoint at ``step`` (default: the latest) in the structure
        of ``example_state``; None when there is none."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        path = os.path.join(self.dir, f"step_{step}")

        def read_spec():
            with open(os.path.join(path, "spec.json")) as f:
                return json.load(f)

        spec = self._io(read_spec)
        examples = _leaves(example_state)
        if len(examples) != len(spec["leaves"]):
            raise ValueError(
                f"checkpoint has {len(spec['leaves'])} leaves; the target "
                f"structure has {len(examples)}")
        loaded = [
            _decode(self._io(lambda e=e: np.load(os.path.join(path, e["file"]),
                                                 allow_pickle=False)), e, ex)
            for e, ex in zip(spec["leaves"], examples)]
        return _rebuild(example_state, iter(loaded))

"""Atomic, pickle-free checkpoints of a training state, sharded or not.

The JAX package's checkpointer:

  * atomic: leaves are written into ``step_<N>.tmp/``, which is renamed to
    ``step_<N>/``; ``MANIFEST.json`` is written last (through a rename too),
    so a crash mid-save never corrupts the latest checkpoint;
  * content: one ``.npy`` per leaf plus ``spec.json`` (each leaf's kind,
    dtype and shape) — no pickle.  bf16 tensors are stored as their uint16
    bit pattern with the dtype named in the spec (numpy has no bfloat16);
  * sharded save (``mesh``, ``specs``): a leaf split over the mesh is
    written as one ``.npy`` per distinct shard, each by the first rank that
    holds it (no gather), and ``spec.json`` records the leaf's global
    shape, its shards' index windows and the :class:`repro_torch.
    distributed.sharding.PartitionSpec` it was saved under
    (:meth:`Checkpointer.saved_pspecs` reads them back); every rank of the
    mesh calls ``save``, rank 0 writes the spec and renames;
  * restore onto any mesh: each rank reads the windows of its own layout
    (``specs`` on ``mesh``, replicated by default) from whichever shards
    cover them, so a checkpoint saved on one mesh restores on another, and
    bit for bit on the same one;
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

from repro_torch.distributed import collectives
from repro_torch.distributed.fault_tolerance import retry_on_transient
from repro_torch.distributed.sharding import PartitionSpec, local_window, spec_axes
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


def _spec_leaves(specs, tree) -> list:
    """The spec of each leaf of ``tree``: ``specs`` matches its structure,
    and a None or a :class:`PartitionSpec` in it covers the whole subtree."""
    if specs is None or isinstance(specs, PartitionSpec):
        return [specs] * len(_leaves(tree))
    if isinstance(tree, dict):
        return [s for k, v in tree.items() for s in _spec_leaves(specs[k], v)]
    if isinstance(tree, (list, tuple)):
        return [s for v, sv in zip(tree, specs) for s in _spec_leaves(sv, v)]
    raise TypeError(f"no spec for a leaf of type {type(tree).__name__}")


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _to_tensor(arr: np.ndarray, dtype: str, device):
    """A C-contiguous host array (0-d included) → a tensor on ``device``."""
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _global_shape(shape, spec, mesh) -> list[int]:
    """A local shape under ``spec`` → the global shape."""
    entries = tuple(spec or ()) + (None,) * (len(shape) - len(spec or ()))
    return [d * (1 if mesh is None else mesh.axis_size(spec_axes(e)))
            for d, e in zip(shape, entries)]


def _all_windows(shape, spec, mesh) -> list[list[list[int]]]:
    """Every distinct shard window of a global ``shape`` under ``spec``, in
    the row-major order of the spec's mesh axes."""
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    per_dim = []
    for dim, e in zip(shape, entries):
        n = mesh.axis_size(spec_axes(e))
        step = dim // n
        per_dim.append([[i * step, (i + 1) * step] for i in range(n)])
    out = [[]]
    for choices in per_dim:
        out = [w + [c] for w in out for c in choices]
    return out


def _owner(spec, mesh) -> bool:
    """Whether this rank writes its shard: the first holder, at index 0 of
    every mesh axis the spec does not split over."""
    used = {a for e in spec for a in spec_axes(e)}
    return all(c == 0 for a, c in mesh.coords.items() if a not in used)


def _barrier(mesh) -> None:
    """A barrier over the mesh's own ranks: a mesh smaller than the world
    (shrunk after a lost device, or a sub-mesh) must not wait on ranks
    outside it."""
    collectives.barrier(mesh)


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

    def save(self, step: int, state, *, mesh=None, specs=None) -> None:
        """Write ``state`` as step ``step``.  Under a ``mesh`` of more than
        one rank every rank calls this with its own windows; ``specs`` (a
        tree of :class:`PartitionSpec` matching ``state``, None leaves
        replicated) says how each tensor is split."""
        multi = mesh is not None and mesh.size > 1
        lead = not multi or mesh.rank == 0
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        if lead:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
        _barrier(mesh)
        leaves = _leaves(state)
        leaf_specs = (_spec_leaves(specs, state) if multi
                      else [None] * len(leaves))
        entries = []
        for i, (leaf, spec) in enumerate(zip(leaves, leaf_specs)):
            if self.faults.fires("ckpt.save_crash"):
                raise InjectedFault(
                    f"killed mid checkpoint save (step {step}, leaf {i})")
            entry = self._save_leaf(tmp, i, leaf, spec, mesh, lead)
            entries.append(entry)
        _barrier(mesh)
        if lead:
            def write_spec():
                with open(os.path.join(tmp, "spec.json"), "w") as f:
                    json.dump({"version": 2, "step": step, "leaves": entries}, f)

            self._io(write_spec)
            if os.path.exists(final):
                shutil.rmtree(final)
            self._io(lambda: os.replace(tmp, final))
            self._write_manifest(step)
            self._gc()
        _barrier(mesh)

    def _save_leaf(self, tmp, i, leaf, spec, mesh, lead) -> dict:
        if not isinstance(leaf, torch.Tensor):
            if not isinstance(leaf, (bool, int, float)):
                raise TypeError(
                    f"cannot checkpoint a leaf of type {type(leaf).__name__}")
            entry = {"kind": type(leaf).__name__, "files": [f"leaf_{i:05d}.npy"]}
            if lead:
                path = os.path.join(tmp, entry["files"][0])
                self._io(lambda: np.save(path, np.asarray(leaf), allow_pickle=False))
            return entry
        entry = {"kind": "tensor", "dtype": str(leaf.dtype).removeprefix("torch.")}
        split = spec is not None and any(
            mesh.shape.get(a, 1) > 1 for e in spec for a in spec_axes(e))
        if not split:
            entry.update(shape=list(leaf.shape), files=[f"leaf_{i:05d}.npy"],
                         windows=None, pspec=None)
            if lead:
                path = os.path.join(tmp, entry["files"][0])
                arr = _host(leaf)
                self._io(lambda: np.save(path, arr, allow_pickle=False))
            return entry
        shape = _global_shape(leaf.shape, spec, mesh)
        windows = _all_windows(shape, spec, mesh)
        mine = [list(w) for w in local_window(shape, spec, mesh)]
        entry.update(shape=shape, windows=windows, pspec=str(spec),
                     files=[f"leaf_{i:05d}_s{j}.npy" for j in range(len(windows))])
        if _owner(spec, mesh):
            path = os.path.join(tmp, entry["files"][windows.index(mine)])
            arr = _host(leaf)
            self._io(lambda: np.save(path, arr, allow_pickle=False))
        return entry

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

    def _read_spec(self, step: int) -> dict:
        path = os.path.join(self.dir, f"step_{step}")

        def read_spec():
            with open(os.path.join(path, "spec.json")) as f:
                return json.load(f)

        return self._io(read_spec)

    def restore(self, example_state, step: int | None = None, *, mesh=None,
                specs=None):
        """The checkpoint at ``step`` (default: the latest) in the structure
        of ``example_state``, None when there is none.  Each tensor is this
        rank's window under its spec in ``specs`` on ``mesh`` (default:
        whole), read from the saved shards that cover it, onto its
        example's device."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        path = os.path.join(self.dir, f"step_{step}")
        spec = self._read_spec(step)
        examples = _leaves(example_state)
        if len(examples) != len(spec["leaves"]):
            raise ValueError(
                f"checkpoint has {len(spec['leaves'])} leaves; the target "
                f"structure has {len(examples)}")
        multi = mesh is not None and mesh.size > 1
        leaf_specs = (_spec_leaves(specs, example_state) if multi
                      else [None] * len(examples))
        loaded = [self._load_leaf(path, e, ex, sp, mesh)
                  for e, ex, sp in zip(spec["leaves"], examples, leaf_specs)]
        return _rebuild(example_state, iter(loaded))

    def _load_leaf(self, path, entry, example, spec, mesh):
        kind = entry["kind"]
        files = entry.get("files") or [entry["file"]]  # version 1: one file
        if kind != "tensor":
            arr = self._io(lambda: np.load(os.path.join(path, files[0]),
                                           allow_pickle=False))
            return {"bool": bool, "int": int, "float": float}[kind](arr)
        shape = entry["shape"]
        target = ([(0, d) for d in shape] if spec is None
                  else local_window(shape, spec, mesh))
        windows = entry.get("windows") or [[[0, d] for d in shape]]
        dtype = np.uint16 if entry["dtype"] == "bfloat16" else None
        out = None
        for name, win in zip(files, windows):
            lo = [max(a, t0) for (a, _), (t0, _) in zip(win, target)]
            hi = [min(b, t1) for (_, b), (_, t1) in zip(win, target)]
            if any(l >= h for l, h in zip(lo, hi)):
                continue
            arr = self._io(lambda n=name: np.load(os.path.join(path, n),
                                                  mmap_mode="r", allow_pickle=False))
            if out is None:
                out = np.empty([t1 - t0 for t0, t1 in target], dtype=dtype or arr.dtype)
            src = tuple(slice(l - a, h - a) for l, h, (a, _) in zip(lo, hi, win))
            dst = tuple(slice(l - t0, h - t0) for l, h, (t0, _) in zip(lo, hi, target))
            out[dst] = arr[src]
        if out is None:  # a leaf with no elements
            out = np.empty([t1 - t0 for t0, t1 in target],
                           dtype=dtype or np.dtype(entry["dtype"]))
        device = example.device if isinstance(example, torch.Tensor) else "cpu"
        t = _to_tensor(out, entry["dtype"], device)
        if isinstance(example, torch.Tensor) and tuple(t.shape) != tuple(example.shape):
            raise ValueError(f"leaf window {tuple(t.shape)} != the target's "
                             f"{tuple(example.shape)}")
        return t

    def saved_pspecs(self, step: int | None = None) -> list | None:
        """The :class:`PartitionSpec` strings recorded at save time, one a
        leaf (None for a whole leaf): how a checkpoint was laid out, read
        without loading it."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        return [e.get("pspec") for e in self._read_spec(step)["leaves"]]

"""Training entry point (PEFT / QAT) on one device or a mesh of ranks, with
the spike guard, checkpoint rollback, the cross-replica desync digest and
the JAX package's fault paths.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
        --smoke --device cpu --steps 3 [--mode qat] [--backend fused] \\
        [--mesh DxM] [--desync-every N] [--ckpt-dir DIR] \\
        [--io-retries 2 --io-backoff 0.05 --io-jitter 0.0]

Without ``--device`` it runs on the card (and raises when there is none).
``--mesh DATAxMODEL`` trains on that many ranks (processes of
:func:`repro_torch.launch.ranks.run_ranks`).  The fault points of a
:class:`repro_torch.robustness.FaultPlan` are consulted as the JAX
``run_training`` consults them, the elastic mesh rebuild after
``dist.device_loss`` included.
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import SHAPES, ShapeCfg, get_config, smoke_variant
from repro_torch.core import peft
from repro_torch.data import SyntheticLM, make_batch_iterator
from repro_torch.distributed.desync import desync_spread, replica_digests
from repro_torch.distributed.fault_tolerance import (
    PreemptionGuard,
    StragglerMonitor,
)
from repro_torch.distributed.sharding import (
    gather_tree,
    model_pspecs,
    shard_tree,
    spec_axes,
)
from repro_torch.kernels import dispatch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.launch.serve import parse_mesh
from repro_torch.launch.steps import train_step
from repro_torch.models import model_init
from repro_torch.models.common import resolve_device
from repro_torch.optim import AdamWState, adamw_init
from repro_torch.robustness import NO_FAULTS, InjectedFault

__all__ = ["run_training", "batch_tensors", "main"]


def batch_tensors(batch: dict, device) -> dict:
    """A pipeline batch (numpy) as int64 tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v, np.int64)).to(device)
            for k, v in batch.items()}


def _spec_at(specs, path: tuple):
    for key in path:
        specs = specs[key]
    return specs


def _state_specs(trainable: dict, specs) -> dict:
    """The checkpoint state's spec tree: the trainable leaves' specs, the
    moments' the same, the rest replicated."""
    ts = {k: _spec_at(specs, k) for k in trainable}
    return {"trainable": ts, "opt": AdamWState(mu=ts, nu=dict(ts), step=None),
            "data_step": None}


# the spike guard: a threshold of SPIKE_FACTOR x the EMA of accepted grad
# norms after SPIKE_WARMUP accepted steps; ROLLBACK_AFTER consecutive skips
# restore the latest checkpoint (the JAX package's defaults)
SPIKE_FACTOR, SPIKE_WARMUP, ROLLBACK_AFTER = 10.0, 10, 3


def run_training(cfg, shape_cfg, *, steps: int, lr: float = 1e-4,
                 ckpt_dir: str | None = None, ckpt_every: int = 50,
                 seed: int = 0, log_every: int = 10,
                 backend: str | None = None, device=None,
                 params=None, faults=None, desync_every: int = 0,
                 collective_retries: int = 2, io_retries: int = 2,
                 io_backoff: float = 0.05, io_jitter: float = 0.0,
                 preemption_guard=None, mesh=None,
                 max_mesh_rebuilds: int = 4) -> dict:
    """Train ``cfg`` for ``steps`` steps of ``shape_cfg``'s batches.

    ``params`` (default: :func:`repro_torch.models.model_init` from
    ``seed``) is split by :func:`repro_torch.core.peft.partition`; the
    trainable leaves are updated in place.  ``backend`` pins the dispatch
    backend for the forward, the backward and the remat recompute.

    ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`, on each of its
    ranks): the whole ``params`` are cut to this rank's windows
    (:func:`repro_torch.distributed.sharding.model_pspecs`: the quantized
    linears' rows over the model axis, the expert stacks over their
    dispatch's axes), every step splits the
    global batch over the data axis and runs sharded
    (:func:`repro_torch.launch.steps.train_step`), and checkpoints are
    saved a shard a file and restored onto this mesh's layout.  The mesh
    is made on each of its ranks with the same arguments (and on every
    other rank of the world, :func:`repro_torch.launch.mesh.make_host_mesh`).

    Every update goes through :func:`repro_torch.optim.guarded_update`
    behind the spike threshold above: a non-finite or spiking gradient
    skips the update (counted in ``skipped_steps``), and after
    ``ROLLBACK_AFTER`` consecutive skips the latest checkpoint is restored,
    the data position included (``rollbacks``).  With ``ckpt_dir`` the run
    resumes from the latest checkpoint there and saves every ``ckpt_every``
    steps; the checkpointer retries its IO (``io_retries``, ``io_backoff``,
    ``io_jitter``).

    Fault points of ``faults`` (a :class:`repro_torch.robustness.FaultPlan`;
    default none), a step at a time in the JAX package's order:
    ``dist.device_loss`` (on a mesh of more than one rank, while
    ``mesh_rebuilds < max_mesh_rebuilds``: the elastic rebuild.  The mesh
    shrinks, :func:`repro_torch.launch.mesh.shrink_shape`; every rank of
    the old mesh hands its state over, all-gathered over the old groups of
    the axes it is split along; the survivors cut it to the new layout
    (the expert-parallel axes recomputed) and restore the latest
    checkpoint onto it with the data position (``resharded_restores``),
    or with no checkpoint go on from the live state; a rank outside the
    new mesh returns at once with ``status="lost"``.  On one device
    there is nothing to lose: the fire is consumed, no rebuild),
    ``dist.host_crash`` (raises :class:`InjectedFault` with no save; a
    second ``run_training`` on the same ``ckpt_dir`` resumes),
    ``dist.straggler`` for the one data shard, ``train.grad_spike`` (the
    threshold drops to -1, so the guard skips the step) and
    ``dist.collective_timeout`` (the launch is retried; past
    ``collective_retries`` fires in a row it raises :class:`InjectedFault`).
    A preemption (``preemption_guard``, default a
    :class:`repro_torch.distributed.PreemptionGuard` on SIGTERM / SIGINT
    for the run) saves a checkpoint after the step and ends the run with
    ``status="preempted"``.  ``desync_every`` > 0 compares the data
    replicas' state digests (:mod:`repro_torch.distributed.desync`) every
    that many completed steps: a spread counts in ``desyncs_detected`` and
    rolls back to the latest checkpoint (``desync_rollbacks``), or without
    one ends the run with ``status="quarantined"``; the
    ``dist.replica_desync`` point perturbs a replica's report.

    Returns {"losses", "grad_norms", "step_ms", "trainable", "frozen", "opt",
    "skipped_steps", "rollbacks", "status", "collective_timeouts",
    "straggler_flags", "straggler_injected", "mesh_rebuilds",
    "lost_devices", "resharded_restores", "desyncs_detected",
    "desync_rollbacks", "final_mesh"}; ``grad_norms`` holds every step's
    global gradient norm (a skipped step's too), ``step_ms`` the host
    time of each step, ending when its loss reaches the host; ``trainable`` /
    ``frozen`` / ``opt`` are this rank's windows.
    """
    if cfg.input_kind != "tokens":
        raise ValueError(f"{cfg.name} takes embeddings and run_training draws "
                         "token batches: train it through train_step with an "
                         "embeds batch")
    faults = faults or NO_FAULTS
    device = resolve_device(device)
    if params is None:
        params = model_init(cfg, seed, device=device)
    mesh = mesh if mesh is not None else make_host_mesh()
    if not mesh.member:
        raise ValueError(f"rank {mesh.rank} is outside {mesh}")

    def layout(whole: dict):
        """This rank's windows of the ``whole`` params on ``mesh``, split
        into (trainable, frozen), with the layout's specs: the parameter
        specs, the checkpoint state's, the sharded trainable paths, the
        checkpointer's keywords and the data replicas."""
        if mesh.size == 1:
            trainable, frozen = peft.partition(whole, cfg.quant)
            return trainable, frozen, None, None, {}, {}, 1
        specs = model_pspecs(whole, cfg, mesh)
        trainable, frozen = peft.partition(shard_tree(whole, specs, mesh), cfg.quant)
        state_specs = _state_specs(trainable, specs)
        sharded = {k: axes for k, sp in state_specs["trainable"].items()
                   if (axes := tuple(a for e in sp for a in spec_axes(e)))}
        n_data = mesh.axis_size(tuple(a for a in mesh.axis_names if a != "model"))
        return (trainable, frozen, specs, state_specs, sharded,
                dict(mesh=mesh, specs=state_specs), n_data)

    trainable, frozen, specs, state_specs, sharded, ckpt_kw, n_data = layout(params)
    opt = adamw_init(trainable)
    print(f"[train] {cfg.name} mode={cfg.quant.mode} "
          f"backend={dispatch.resolve_backend(backend, params['final_norm'])} "
          f"device={device} mesh={dict(mesh.shape)} "
          f"trainable={sum(t.numel() for t in trainable.values())}", flush=True)

    ckpt = (Checkpointer(ckpt_dir, io_retries=io_retries,
                         io_backoff=io_backoff, io_jitter=io_jitter)
            if ckpt_dir else None)
    start_step = 0
    if ckpt is not None:
        restored = ckpt.restore({"trainable": trainable, "opt": opt,
                                 "data_step": 0}, **ckpt_kw)
        if restored is not None:
            trainable, opt = restored["trainable"], restored["opt"]
            start_step = restored["data_step"]
            print(f"[train] resumed from step {start_step}", flush=True)

    source = SyntheticLM(cfg.vocab_size, shape_cfg.seq_len,
                         shape_cfg.global_batch, seed=seed)
    it = make_batch_iterator(source, start_step)
    losses, grad_norms, step_ms = [], [], []
    gnorm_ema, accepted, consecutive_skips = None, 0, 0
    skipped_steps = rollbacks = collective_timeouts = 0
    desyncs_detected = desync_rollbacks = 0
    mesh_rebuilds = lost_devices = resharded_restores = 0
    straggler_injected: list[tuple[int, int]] = []
    status = "complete"
    own_guard = preemption_guard is None
    guard = PreemptionGuard() if own_guard else preemption_guard
    mon = StragglerMonitor()
    dist_on = faults.enabled  # no dist.* consult without a plan

    def restore_latest(reason: str) -> bool:
        """The latest checkpoint and its data position, or False."""
        nonlocal trainable, opt, it, gnorm_ema, accepted, consecutive_skips
        if ckpt is None or ckpt.latest_step() is None:
            return False
        restored = ckpt.restore({"trainable": trainable, "opt": opt,
                                 "data_step": 0}, **ckpt_kw)
        trainable, opt = restored["trainable"], restored["opt"]
        it = make_batch_iterator(source, restored["data_step"])
        gnorm_ema, accepted, consecutive_skips = None, 0, 0
        print(f"[train] {reason} — restored step {restored['data_step']}",
              flush=True)
        return True

    def rebuild() -> bool:
        """The elastic rebuild after a device loss; False on a rank the
        shrunk mesh lost (after its hand-over)."""
        nonlocal mesh, trainable, frozen, opt, specs, state_specs, sharded
        nonlocal ckpt_kw, n_data, mesh_rebuilds, lost_devices, resharded_restores
        old = mesh
        # the hand-over: every rank of the old mesh, the lost ones included,
        # gathers the state whole over its old groups (same bytes)
        whole = gather_tree(peft.combine(trainable, frozen), specs, old)
        moments = {name: gather_tree(getattr(opt, name), state_specs["trainable"], old)
                   for name in ("mu", "nu")}
        mesh = old.shrink()
        lost_devices += old.size - mesh.size
        if not mesh.member:
            return False
        mesh_rebuilds += 1
        print(f"[train] device loss — rebuilt mesh {old.shape['data']}x"
              f"{old.shape['model']} -> {mesh.shape['data']}x{mesh.shape['model']}",
              flush=True)
        trainable, frozen, specs, state_specs, sharded, ckpt_kw, n_data = layout(whole)
        step_count = opt.step
        opt = adamw_init(trainable)   # the restore's example, on the new layout
        if restore_latest("elastic restore"):
            resharded_restores += 1
        else:
            # no checkpoint: the live state, cut to the new layout
            cut = {name: (m if mesh.size == 1 else
                          shard_tree(m, state_specs["trainable"], mesh))
                   for name, m in moments.items()}
            opt = AdamWState(mu=cut["mu"], nu=cut["nu"], step=step_count)
        return True

    done = 0
    try:
        while done < steps:
            if (dist_on and faults.fires("dist.device_loss") and mesh.size > 1
                    and mesh_rebuilds < max_mesh_rebuilds):
                if not rebuild():
                    status = "lost"   # this rank's device is gone
                    break
                continue    # the step is consulted again on the new mesh
            if dist_on:
                if faults.fires("dist.host_crash"):
                    # a whole-process crash: no save; a new run_training on
                    # the same ckpt_dir resumes
                    raise InjectedFault(
                        f"injected host crash at step count {done}")
            step, batch = next(it)
            mon.start_step()
            if dist_on:
                for shard in range(n_data):  # per data shard streams
                    if faults.fires("dist.straggler", index=shard):
                        straggler_injected.append((step, shard))  # fires() slept
            if faults.fires("train.grad_spike"):
                thr = -1.0          # the guard skips this step
            elif gnorm_ema is None or accepted < SPIKE_WARMUP:
                thr = math.inf      # no baseline yet
            else:
                thr = SPIKE_FACTOR * gnorm_ema
            attempts = 0
            while dist_on and faults.fires("dist.collective_timeout"):
                collective_timeouts += 1
                attempts += 1
                if attempts > collective_retries:
                    raise InjectedFault(
                        "collective timeout persisted past "
                        f"{collective_retries} retries (step {step})")
            t0 = time.perf_counter()
            trainable, opt, metrics = train_step(
                trainable, frozen, opt, batch_tensors(batch, device), cfg=cfg,
                lr=lr, backend=backend, max_gnorm=thr,
                mesh=mesh if mesh.size > 1 else None, sharded=sharded)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            grad_norms.append(metrics["grad_norm"])
            mon.end_step(step)
            done += 1
            if metrics["update_skipped"]:
                skipped_steps += 1
                consecutive_skips += 1
                print(f"[train] step {step:5d} SKIPPED (grad_norm "
                      f"{metrics['grad_norm']:.3g} > threshold {thr:.3g})",
                      flush=True)
                if (consecutive_skips >= ROLLBACK_AFTER and restore_latest(
                        f"{ROLLBACK_AFTER} consecutive skips")):
                    rollbacks += 1
                continue
            consecutive_skips = 0
            gn = metrics["grad_norm"]
            if math.isfinite(gn):
                gnorm_ema = gn if gnorm_ema is None else 0.9 * gnorm_ema + 0.1 * gn
                accepted += 1
            losses.append(metrics["loss"])
            if step % log_every == 0:
                print(f"[train] step {step:5d} loss {metrics['loss']:.4f}",
                      flush=True)
            if ckpt is not None and (step + 1) % ckpt_every == 0:
                ckpt.save(step + 1, {"trainable": trainable, "opt": opt,
                                     "data_step": step + 1}, **ckpt_kw)
            if desync_every > 0 and done % desync_every == 0:
                digests = replica_digests(
                    (trainable, opt), mesh if mesh.size > 1 else None,
                    faults=faults, step=step,
                    specs=(None if state_specs is None else
                           (state_specs["trainable"], state_specs["opt"])))
                if desync_spread(digests) > 0.0:
                    desyncs_detected += 1
                    if restore_latest("replica desync detected"):
                        desync_rollbacks += 1
                    else:
                        status = "quarantined"
                        print("[train] desync with no checkpoint — "
                              "quarantining run", flush=True)
                        break
            if guard.preempted:
                print("[train] preemption signal — checkpoint and clean exit",
                      flush=True)
                if ckpt is not None:
                    ckpt.save(step + 1, {"trainable": trainable, "opt": opt,
                                         "data_step": step + 1}, **ckpt_kw)
                status = "preempted"
                break
    finally:
        if own_guard:
            guard.restore()
    return {"losses": losses, "grad_norms": grad_norms, "step_ms": step_ms,
            "trainable": trainable,
            "frozen": frozen, "opt": opt, "skipped_steps": skipped_steps,
            "rollbacks": rollbacks, "status": status,
            "collective_timeouts": collective_timeouts,
            "straggler_flags": mon.flags,
            "straggler_injected": straggler_injected,
            "mesh_rebuilds": mesh_rebuilds, "lost_devices": lost_devices,
            "resharded_restores": resharded_restores,
            "desyncs_detected": desyncs_detected,
            "desync_rollbacks": desync_rollbacks, "final_mesh": dict(mesh.shape)}


def _cli_setup(args):
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
        shape = ShapeCfg("smoke", args.seq_len or 128, args.global_batch or 8,
                         "train")
    else:
        shape = SHAPES[args.shape]
        shape = ShapeCfg(shape.name, args.seq_len or shape.seq_len,
                         args.global_batch or shape.global_batch, "train")
    if args.mode:
        cfg = cfg.with_(quant=cfg.quant.with_(mode=args.mode))
    return cfg, shape


def _train_rank(args, data: int = 1, model: int = 1) -> dict:
    """The CLI's run_training on one rank of a ``data`` × ``model`` mesh;
    the losses and counters (tensors stay on the rank)."""
    cfg, shape = _cli_setup(args)
    out = run_training(cfg, shape, steps=args.steps, lr=args.lr,
                       ckpt_dir=args.ckpt_dir, backend=args.backend,
                       device=args.device, desync_every=args.desync_every,
                       io_retries=args.io_retries, io_backoff=args.io_backoff,
                       io_jitter=args.io_jitter, mesh=make_host_mesh(data, model))
    return {k: v for k, v in out.items() if k not in ("trainable", "frozen", "opt")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k", choices=sorted(SHAPES))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config and shape (CPU)")
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--mode", default=None, choices=["peft", "qat"],
                    help="override cfg.quant.mode for this run")
    ap.add_argument("--backend", default=None, choices=list(dispatch.BACKENDS),
                    help="pin the kernel backend (forward and backward)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="train on DATA x MODEL ranks, one process each")
    ap.add_argument("--desync-every", type=int, default=0,
                    help="cross-replica state-digest cadence in steps (0 = off)")
    ap.add_argument("--io-retries", type=int, default=2,
                    help="checkpoint IO retry attempts")
    ap.add_argument("--io-backoff", type=float, default=0.05,
                    help="checkpoint IO retry backoff base (s)")
    ap.add_argument("--io-jitter", type=float, default=0.0,
                    help="decorrelated-jitter share of the IO retries' sleeps "
                         "(0 = deterministic exponential)")
    args = ap.parse_args(argv)

    data, model = parse_mesh(args.mesh)
    t0 = time.time()
    if data * model > 1:
        out = run_ranks(_train_rank, data * model, args=(args, data, model),
                        device=args.device or "cuda")[0]
    else:
        out = _train_rank(args)
    dt = time.time() - t0
    if out["losses"]:
        print(f"[train] done: {len(out['losses'])} steps in {dt:.1f}s; "
              f"loss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}")
    else:
        print(f"[train] done in {dt:.1f}s; every step was skipped")


if __name__ == "__main__":
    main()

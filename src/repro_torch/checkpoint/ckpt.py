"""Atomic checkpoints, in the JAX package's file formats.

Counterpart of src/repro/checkpoint/ckpt.py, whose module imports JAX (for
its tree paths) and msgpack; this one needs neither, and the files cross
between the two packages in both directions.

Parameter trees (``save_pytree``/``load_pytree``) are nested ``dict``s,
``list``s and ``tuple``s of ``torch.Tensor`` or numpy leaves, the shape of
the port's ``params``. A checkpoint is a directory ``<path>.ckpt`` holding
``data.npz`` (one array a leaf, named by its ``/``-joined path of dict keys
and list indices) and ``manifest.json`` (``{"step", "leaves": {path:
{shape, dtype}}}``). Leaves are flattened in JAX's order (dict keys
sorted; ``None`` is an empty subtree), so the manifest is the one the
reference writes for the same tree. Tensors are copied to the host;
bfloat16 leaves, which numpy has no type for, are stored as 2-byte void
records (what ``np.savez`` makes of the reference's ml_dtypes bfloat16)
under the manifest's ``"bfloat16"``, and read back through it.

Scheduler state (``save_scheduler_state``/``load_scheduler_state``: MRET
windows, context assignments, the migration counter and the partition
geometry — what lets a restarted server skip the AFET cold start) is one
MessagePack document, written by the port's own codec (``_msgpack``) with
the bytes ``msgpack.packb`` gives.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import _msgpack

BF16 = "bfloat16"


def _flatten_with_path(tree, prefix: Tuple[str, ...] = ()
                       ) -> List[Tuple[Tuple[str, ...], object]]:
    """``(path, leaf)`` pairs in ``jax.tree_util.tree_flatten_with_path``
    order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _flatten_with_path(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in _flatten_with_path(v, prefix + (str(i),))]
    return [(prefix, tree)]


def _host_array(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the host array ``data.npz`` stores and its manifest
    dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _flatten(tree) -> Dict[str, Tuple[np.ndarray, str]]:
    return {"/".join(p): _host_array(leaf)
            for p, leaf in _flatten_with_path(tree)}


def save_pytree(tree, path: str, step: Optional[int] = None) -> str:
    """Atomic save: the previous checkpoint survives every crash window.

    The write sequence is stage -> sidestep -> swap -> reap:

      1. materialize the new checkpoint in a fresh staging dir,
      2. rename the existing ``.ckpt`` (if any) out of the way to ``.old``,
      3. rename staging to ``.ckpt``,
      4. delete ``.old``.

    ``os.rename`` is the only operation that touches the live name, so at
    every instant either ``.ckpt`` or ``.old`` holds a complete
    checkpoint. ``load_pytree`` falls back to ``.old`` when only the
    sidestep survived (crash between steps 2 and 3).
    """
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    flat = _flatten(tree)
    manifest = {"step": step, "leaves": {k: {"shape": list(v.shape),
                                             "dtype": dtype}
                                         for k, (v, dtype) in flat.items()}}
    final = p.with_suffix(".ckpt")
    old = p.parent / (final.name + ".old")
    # reap staging dirs orphaned by earlier crashed saves (SIGKILL skips
    # the except-cleanup below, and every save stages under a fresh name)
    for stale in p.parent.glob(p.name + ".tmp*"):
        shutil.rmtree(stale, ignore_errors=True)
    staging = pathlib.Path(tempfile.mkdtemp(dir=p.parent,
                                            prefix=p.name + ".tmp"))
    try:
        np.savez(staging / "data.npz", **{k: v for k, (v, _) in flat.items()})
        (staging / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            # only now is .old redundant: final is a complete checkpoint.
            # When final is MISSING (a crash landed between sidestep and
            # swap last time), .old is the sole survivor — leave it alone
            # until the swap below completes.
            if old.exists():
                shutil.rmtree(old)
            os.rename(final, old)
        os.rename(staging, final)
    except BaseException:
        shutil.rmtree(staging, ignore_errors=True)
        raise
    if old.exists():
        shutil.rmtree(old)
    return str(final)


def _restore_leaf(arr: np.ndarray, dtype: str, leaf):
    """``arr`` as ``leaf``'s kind: a tensor on its device and in its
    memory format with the manifest's dtype, or the numpy array as stored
    (bf16 as 2-byte records, as the reference returns it)."""
    if not isinstance(leaf, torch.Tensor):
        return arr
    if dtype == BF16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return torch.empty_like(leaf, dtype=t.dtype).copy_(t)


def load_pytree(template, path: str):
    """Restore into the structure of ``template`` (shapes must match).
    Falls back to the ``.old`` sidestep if a crash interrupted
    ``save_pytree`` between sidestep and swap. Each leaf comes back in the
    kind of the template's leaf. A CNN file written by the JAX package
    (HWIO convolutions) loads through a template of numpy arrays and then
    ``models.cnn.cnn_params_from_jax``, as its tree would."""
    final = pathlib.Path(path).with_suffix(".ckpt")
    if not final.exists():
        old = final.parent / (final.name + ".old")
        if old.exists():
            final = old
    dtypes = {k: v["dtype"] for k, v in json.loads(
        (final / "manifest.json").read_text())["leaves"].items()}
    with np.load(final / "data.npz") as data:
        restored = {}
        for p, leaf in _flatten_with_path(template):
            key = "/".join(p)
            arr = data[key]
            assert arr.shape == tuple(np.shape(leaf)), (key, arr.shape)
            restored[p] = _restore_leaf(arr, dtypes[key], leaf)
    return _rebuild(template, (), restored)


def _rebuild(tree, prefix: Tuple[str, ...], restored):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, prefix + (str(k),), restored)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, prefix + (str(i),), restored)
                          for i, v in enumerate(tree))
    return restored[prefix]


# ------------------------------------------------------- scheduler state
def save_scheduler_state(sched, path: str, *, chaos=None) -> str:
    """Serialize everything a restarted scheduler needs to reproduce this
    one's placement exactly: per-task MRET windows and context
    assignments, the migration counter, the runtime shape, and the FULL
    partition geometry — including retired contexts, so task ``ctx``
    indices stay meaningful after fail_context / reconfigure events."""
    state = {
        "tasks": [
            {
                "name": t.name, "ctx": t.ctx, "fixed": t.fixed_ctx,
                "mret_windows": [list(s.window) for s in t.mret.stages],
                "afets": [s.afet_ms for s in t.mret.stages],
            }
            for t in sched.tasks
        ],
        "migrations": sched.migrations,
        "contexts": [
            {"index": c.index, "alive": c.alive, "n_streams": c.n_streams,
             "units": sorted(c.units)}
            for c in sched.contexts
        ],
        "shape": {"n_contexts": sched.cfg.n_contexts,
                  "n_streams": sched.cfg.n_streams,
                  "oversubscription": sched.cfg.oversubscription},
    }
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_suffix(".tmp")
    blob = _msgpack.packb(state)
    attempts = 1 + (chaos.plan.io_max_retries if chaos is not None else 0)
    for i in range(attempts):
        try:
            if chaos is not None and chaos.io_fails():
                raise OSError("chaos: injected checkpoint write failure")
            tmp.write_bytes(blob)
            os.replace(tmp, p)
            break
        except OSError:
            if i + 1 >= attempts:
                raise
    return str(p)


def load_scheduler_state(sched, path: str) -> None:
    """Inverse of ``save_scheduler_state``: restores MRET history, task
    placement, the migration counter, and (when present) the saved
    partition geometry — contexts beyond the constructor-built set are
    created, geometries overwritten, dead ones retired — so a scheduler
    restored after fail_context/reconfigure events places work
    identically to the one that was saved. Raises ``ValueError`` when a
    task's saved MRET windows don't match its current stage count."""
    state = _msgpack.unpackb(pathlib.Path(path).read_bytes())
    by_name = {t["name"]: t for t in state["tasks"]}
    for t in sched.tasks:
        if t.name not in by_name:
            continue
        rec = by_name[t.name]
        if len(rec["mret_windows"]) != len(t.mret.stages):
            raise ValueError(
                f"checkpoint shape mismatch for task {t.name!r}: saved "
                f"{len(rec['mret_windows'])} stage windows, scheduler has "
                f"{len(t.mret.stages)} stages (was the task set or "
                f"no_staging changed since the save?)")
        t.ctx = rec["ctx"]
        t.fixed_ctx = rec["fixed"]
        for s, win in zip(t.mret.stages, rec["mret_windows"]):
            s.window.clear()
            s.window.extend(win)
        t.mret.invalidate()   # windows were mutated behind the memo
    sched.migrations = state.get("migrations", sched.migrations)
    shape = state.get("shape")
    if shape:
        sched.cfg.n_contexts = shape["n_contexts"]
        sched.cfg.n_streams = shape["n_streams"]
        sched.cfg.oversubscription = shape["oversubscription"]
    for rec in state.get("contexts", []):
        idx = rec["index"]
        while idx >= len(sched.contexts):
            # geometry is overwritten from the record below
            from ..core.partition import Context
            ctx = Context(index=len(sched.contexts), units=set(),
                          n_streams=rec["n_streams"])
            sched._install_context(ctx)
        ctx = sched.contexts[idx]
        if ctx.n_streams != rec["n_streams"]:
            # a constructor-built context's lane table cannot be resized
            # here; silently adopting the saved stream count would skew
            # Eq. 11 (n_streams) against the lanes that actually exist
            raise ValueError(
                f"checkpoint shape mismatch for context {idx}: saved "
                f"n_streams={rec['n_streams']}, scheduler built with "
                f"{ctx.n_streams} (restore into a server configured like "
                f"the saved one)")
        ctx.units = set(rec["units"])
        if ctx.alive and not rec["alive"]:
            sched.lanes.retire_ctx(idx)
        ctx.alive = rec["alive"]
    if state.get("contexts"):
        sched._invalidate_live()

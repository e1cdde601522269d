"""Checkpointing: best/current weights + optimizer state.

Port of ``dmfusion/train/checkpoint.py`` in the port's own format: one
``torch.save`` payload ``{"__meta__": {...}, "tree": {...}}``, written
atomically (a tmp file, then ``os.replace``), with every tensor on the
host.  The solver names its files ``{time}_weights.pt`` (the best
parameters, a ``state_dict``) and ``{time}_curweights.pt`` (``{"params",
"opt_state", "epoch"}``).  Semantics kept:
  * ``__meta__`` stamps the format and the solver's model name and width;
    ``load_checkpoint(expect=...)`` raises on a mismatch unless
    ``lenient``;
  * a non-strict load keeps the template's value for any leaf missing
    from the file or of another shape, and warns which;
  * :class:`AsyncCheckpointWriter` writes on a worker thread.

On the mesh's ``model`` axis a rank holds shards: the solver gathers the
whole parameters and moments over the model group before it hands a tree
here (``parallel/partition.py::full_state``, ``full_opt_state``), so a
file is the same as a one-process run's and loads there.

In torch, ``optimizer.step()`` updates parameters and moments in place and
``state_dict()`` returns references to them, so a tree held for later (the
best parameters, an asynchronous save) must be a real copy taken before
the next step: :func:`snapshot` clones every tensor on its device.
"""

from __future__ import annotations

import os
import warnings
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any

import torch

# Checkpoint file format version.
CKPT_FORMAT = 1


def _map_tensors(fn, tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return tree


def save_checkpoint(path: str | os.PathLike, tree: Any,
                    meta: dict[str, Any] | None = None) -> None:
    """Write ``tree`` (nested dicts/lists of tensors and plain values) as
    one atomic ``torch.save`` file, its tensors moved to the host."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    payload = {"__meta__": dict({"format": CKPT_FORMAT}, **(meta or {})),
               "tree": _map_tensors(lambda t: t.detach().cpu(), tree)}
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def snapshot(tree: Any) -> Any:
    """A copy of ``tree`` whose tensors are clones on their own devices,
    safe to keep while training goes on updating the originals."""
    return _map_tensors(lambda t: t.detach().clone(), tree)


def _merge_lenient(template: Any, loaded: Any,
                   kept: list[str] | None = None, path: str = "") -> Any:
    """Overlay loaded state onto the template, keeping template leaves
    where the file has no (or a mis-shaped) counterpart; the paths of kept
    leaves are appended to ``kept``."""
    def keep(why: str):
        if kept is not None:
            kept.append(f"{path or '<root>'} ({why})")
        return template

    if loaded is None:
        return keep("missing from checkpoint")
    if isinstance(template, dict):
        if not isinstance(loaded, dict):
            return keep("stored node is not a dict")
        return {k: _merge_lenient(v, loaded.get(k), kept,
                                  f"{path}/{k}" if path else str(k))
                for k, v in template.items()}
    t_shape = getattr(template, "shape", None)
    l_shape = getattr(loaded, "shape", None)
    if t_shape is not None and l_shape is not None and t_shape != l_shape:
        return keep(f"shape {tuple(l_shape)} != expected {tuple(t_shape)}")
    return loaded


def load_checkpoint(path: str | os.PathLike, template: Any,
                    strict: bool = False,
                    expect: dict[str, Any] | None = None,
                    lenient: bool = False) -> Any:
    """Restore a checkpoint against a like-shaped template tree; returns
    the loaded tree (host tensors).

    ``expect`` is compared field by field with the file's ``__meta__``: a
    mismatch raises unless ``lenient``.  ``strict`` returns the stored
    tree as it is; otherwise leaves missing from the file or of another
    shape keep the template's value, with a warning.
    """
    payload = torch.load(path, map_location="cpu", weights_only=True)
    meta, tree = payload.get("__meta__"), payload["tree"]
    if expect and meta:
        bad = {k: (meta[k], v) for k, v in expect.items()
               if k in meta and meta[k] != v}
        if bad:
            detail = "; ".join(f"{k}: file has {got!r}, run expects "
                               f"{want!r}" for k, (got, want) in bad.items())
            if not lenient:
                raise ValueError(
                    f"checkpoint {os.path.basename(str(path))} was written "
                    f"by a different configuration ({detail}).  Point the "
                    "run at matching weights, or set "
                    "train.pretrained_lenient: 1 to load what matches "
                    "leniently.")
            warnings.warn(f"loading mismatched checkpoint leniently "
                          f"({detail})")
    if strict:
        return tree
    kept: list[str] = []
    merged = _merge_lenient(template, tree, kept)
    if kept:
        shown = ", ".join(kept[:8]) + (" ..." if len(kept) > 8 else "")
        warnings.warn(
            f"load_checkpoint({os.path.basename(str(path))}): "
            f"{len(kept)} leaves kept freshly-initialized values "
            f"(missing or mis-shaped in the file): {shown}")
    return merged


def exists(path: str | os.PathLike) -> bool:
    return os.path.exists(path)


class AsyncCheckpointWriter:
    """Write checkpoints on one worker thread while training goes on.

    ``save(copy=True)`` snapshots first (a clone on the device, in the
    caller's stream order), so the worker never reads tensors that the
    next step updates; pass ``copy=False`` only for a tree that is itself
    a snapshot (the solver's best parameters).  At most one write per path
    is in flight, and ``flush()`` joins every pending write and re-raises
    the first error.
    """

    def __init__(self) -> None:
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="dmfusion-torch-ckpt")
        self._pending: dict[str, Future] = {}

    def save(self, path: str | os.PathLike, tree: Any,
             copy: bool = True, meta: dict[str, Any] | None = None) -> None:
        key = os.fspath(path)
        prev = self._pending.pop(key, None)
        if prev is not None:
            prev.result()
        if copy:
            tree = snapshot(tree)
        self._pending[key] = self._executor.submit(
            save_checkpoint, path, tree, meta)

    def flush(self) -> None:
        pending, self._pending = self._pending, {}
        errs = []
        for fut in pending.values():
            try:
                fut.result()
            except Exception as e:  # join everything before raising
                errs.append(e)
        if errs:
            raise errs[0]

    def close(self) -> None:
        self.flush()
        self._executor.shutdown(wait=True)

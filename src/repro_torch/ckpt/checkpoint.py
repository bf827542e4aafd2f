"""Fault-tolerant checkpointing, counterpart of ``repro/ckpt/checkpoint.py``.

Guarantees:

* **atomic**: writes go to ``<dir>/tmp.<step>`` then ``os.replace`` to
  ``step_<n>`` — a crash mid-write never corrupts the latest checkpoint;
* **keep-k** garbage collection;
* **device-independent restore**: leaves are stored as host numpy arrays
  under their tree paths; :func:`restore` rebuilds the structure of any
  ``tree_like`` and, with ``device=``, puts the leaves on that device as
  tensors;
* **preemption hook**: ``install_sigterm_hook`` saves on SIGTERM before
  exiting.

Format (the reference's, byte for byte in layout): one ``arrays.npz`` per
checkpoint with leaves keyed by their tree path, and a JSON manifest (step,
leaf shapes and dtypes, payload digest, ``extra``); a ``latest.json``
pointer beside the step directories.  Tree paths join dict keys (sorted),
sequence indices and ``NamedTuple`` field names with ``/``, as
``jax.tree_util``'s key paths do, so a checkpoint written by either package
restores in the other.

Integrity: :func:`save` records a content digest of the payload in the
manifest; :func:`latest` and :func:`restore` verify it.  A corrupt or
truncated step is *quarantined* (renamed aside, counted) and :func:`latest`
falls back to the newest intact snapshot.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import signal
import threading
from typing import Any, Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..faults.errors import CheckpointCorrupt
from ..faults.inject import corrupt_file as _corrupt_file
from ..faults.inject import fire as _fire_fault
from ..obs import metrics as _obs_metrics

__all__ = ["CheckpointManager", "save", "restore", "latest", "latest_step",
           "gc_keep_k", "quarantine_count"]

_M_QUARANTINED = _obs_metrics.REGISTRY.counter(
    "ckpt.quarantined",
    help="Corrupt checkpoint step dirs renamed aside (digest mismatch)")


def quarantine_count() -> int:
    """Checkpoints quarantined (renamed aside) this process."""
    return _M_QUARANTINED.value


def _payload_digest(path: str) -> str:
    h = hashlib.blake2b(digest_size=16)
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaves(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """``(key path, leaf)`` in ``jax.tree_util`` order: dict keys sorted,
    ``NamedTuple`` fields by name, sequences by index; ``None`` is an empty
    subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from _leaves(getattr(tree, name), path + (name,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def _rebuild(tree, leaves: Iterator):
    """``tree``'s structure with its leaves replaced, in :func:`_leaves`
    order, by the values ``leaves`` yields."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*[_rebuild(getattr(tree, f), leaves)
                            for f in tree._fields])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            # numpy has no bfloat16: stored widened to float32 (exact) and
            # narrowed back on a restore into a bfloat16 tensor
            leaf = leaf.float()
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten_with_paths(tree) -> dict:
    return {key: _host(leaf) for key, leaf in _leaves(tree)}


def save(directory: str, step: int, tree: Any,
         extra_manifest: Optional[dict] = None) -> str:
    """Atomic checkpoint write; ``extra_manifest`` merges caller metadata
    (JSON-serialisable) into the manifest under ``"extra"`` — the serving
    layer stores its path cursor there."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}")
    final = os.path.join(directory, f"step_{step:012d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten_with_paths(tree)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {
        "step": step,
        "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in flat.items()},
        "payload_digest": _payload_digest(os.path.join(tmp, "arrays.npz")),
        "extra": dict(extra_manifest) if extra_manifest else {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)     # atomic publish
    # Injection hook: bit-rot strikes AFTER publish, after the digest was
    # recorded — exactly the corruption verification must catch.
    specs = _fire_fault("ckpt.payload")
    if specs:
        _corrupt_file(os.path.join(final, "arrays.npz"), specs)
    _write_latest_pointer(directory, step, manifest)
    return final


def _write_latest_pointer(directory: str, step: int, manifest: dict) -> None:
    """Atomic ``latest.json`` next to the step dirs: the newest step and
    its full manifest, so :func:`latest` is one read, no dir scan."""
    tmp = os.path.join(directory, "latest.json.tmp")
    with open(tmp, "w") as f:
        json.dump({"step": step, "manifest": manifest}, f)
    os.replace(tmp, os.path.join(directory, "latest.json"))


def _verify_step(directory: str, step: int) -> bool:
    """True iff the step's payload matches its recorded digest.

    Manifests written without a digest have nothing to verify and pass; a
    missing or unreadable payload or manifest fails.
    """
    path = os.path.join(directory, f"step_{step:012d}")
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return False
    want = manifest.get("payload_digest")
    if want is None:
        return True
    try:
        return _payload_digest(os.path.join(path, "arrays.npz")) == want
    except FileNotFoundError:
        return False


def _quarantine(directory: str, step: int) -> None:
    """Rename a corrupt step dir aside so scans never see it again."""
    src = os.path.join(directory, f"step_{step:012d}")
    dst = os.path.join(directory, f"quarantined.step_{step:012d}")
    if os.path.exists(dst):
        shutil.rmtree(dst, ignore_errors=True)
    try:
        os.replace(src, dst)
    except FileNotFoundError:
        return
    _M_QUARANTINED.inc()


def latest(directory: str) -> Optional[tuple]:
    """``(step, manifest)`` of the newest *intact* checkpoint, or ``None``.

    Reads the atomic ``latest.json`` pointer written by :func:`save` and
    falls back to :func:`latest_step` + the step's own ``manifest.json``
    when the pointer is missing or points at a step that is gone.  Every
    candidate is digest-verified before being returned; a corrupt step is
    quarantined and the scan falls back to the next newest intact one.
    """
    pointer = os.path.join(directory, "latest.json")
    try:
        with open(pointer) as f:
            data = json.load(f)
        step = int(data["step"])
        if os.path.isdir(os.path.join(directory, f"step_{step:012d}")):
            if _verify_step(directory, step):
                return step, data["manifest"]
            _quarantine(directory, step)
    except (FileNotFoundError, KeyError, ValueError, json.JSONDecodeError):
        pass
    while True:
        step = latest_step(directory)
        if step is None:
            return None
        if not _verify_step(directory, step):
            _quarantine(directory, step)
            continue
        with open(os.path.join(directory, f"step_{step:012d}",
                               "manifest.json")) as f:
            return step, json.load(f)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(m.group(1))
        for m in (re.match(r"step_(\d+)$", d) for d in os.listdir(directory))
        if m
    ]
    return max(steps) if steps else None


def restore(directory: str, tree_like: Any, step: Optional[int] = None,
            device=None) -> Any:
    """Restore into the structure of ``tree_like`` (only its structure, and
    which leaves are bfloat16 tensors, is read).  Leaves come back as numpy
    arrays, or with ``device`` as tensors on that device."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:012d}")
    if not _verify_step(directory, step):
        raise CheckpointCorrupt(path, "payload digest mismatch")
    data = np.load(os.path.join(path, "arrays.npz"))
    arrays: List = []
    for key, like in _leaves(tree_like):
        arr = data[key]
        if device is not None:
            arr = torch.as_tensor(arr).to(device)
            if isinstance(like, torch.Tensor) and like.dtype == torch.bfloat16:
                arr = arr.to(torch.bfloat16)
        arrays.append(arr)
    return _rebuild(tree_like, iter(arrays))


def gc_keep_k(directory: str, keep: int = 3) -> None:
    if not os.path.isdir(directory):
        return
    steps = sorted(
        int(m.group(1))
        for m in (re.match(r"step_(\d+)$", d) for d in os.listdir(directory))
        if m
    )
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:012d}"),
                      ignore_errors=True)


class CheckpointManager:
    """save-every-N + keep-k + preemption hook."""

    def __init__(self, directory: str, every: int = 100, keep: int = 3):
        self.directory = directory
        self.every = every
        self.keep = keep
        self._lock = threading.Lock()
        self._latest_provider: Optional[Callable[[], tuple]] = None
        self._sigterm_installed = False
        self._sigterm_prev: Any = None
        self._sigterm_once = threading.Lock()

    def maybe_save(self, step: int, tree: Any) -> Optional[str]:
        if step % self.every != 0:
            return None
        with self._lock:
            path = save(self.directory, step, tree)
            gc_keep_k(self.directory, self.keep)
            return path

    def install_sigterm_hook(self, provider: Callable[[], tuple]) -> None:
        """provider() -> (step, tree); called on SIGTERM (preemption).

        Idempotent: installing twice updates the provider without stacking
        handlers.  A pre-existing SIGTERM handler is chained (called after
        the save); a second SIGTERM landing while a save is already in
        progress skips the save rather than re-entering the write.  Like
        ``signal.signal``, it works only from the main thread.
        """
        self._latest_provider = provider
        if self._sigterm_installed:
            return

        def handler(signum, frame):
            if self._sigterm_once.acquire(blocking=False):
                try:
                    if self._latest_provider is not None:
                        step, tree = self._latest_provider()
                        save(self.directory, step, tree)
                finally:
                    self._sigterm_once.release()
            prev = self._sigterm_prev
            if callable(prev) and prev is not handler:
                prev(signum, frame)
            raise SystemExit(143)

        self._sigterm_prev = signal.signal(signal.SIGTERM, handler)
        self._sigterm_installed = True

    def restore_latest(self, tree_like: Any, device=None):
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return step, restore(self.directory, tree_like, step, device)

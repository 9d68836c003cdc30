"""Atomic, optionally asynchronous checkpoints
(``repro/checkpoint/checkpointer.py``).

  * **Atomicity** -- a save writes ``step_N.tmp/`` and renames it to
    ``step_N/`` only after every array and the metadata are fsync'd, so a
    crash mid-save never corrupts the latest good checkpoint.
  * **Async** -- ``save()`` copies the state to host numpy arrays at once
    and hands the writing to a background thread; a failed write surfaces
    on the next ``wait()`` or ``save()``.
  * **Retention** -- keeps the newest ``keep`` checkpoints.
  * **Restore** -- into the structure of a template state, shape-checked,
    each leaf cast to the template's dtype and placed on its device; the
    values are the saved ones bit for bit (bf16 goes through f32, which
    holds it exactly).

Format: one ``.npy`` per leaf (path-encoded file name) and ``meta.json``
(step, extra state, leaf keys).  A state is nested dicts, lists, tuples
and named tuples of tensors or numpy arrays.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor


def _is_sharding(x) -> bool:
    """A ``launch/sharding.py::NamedSharding`` (a named tuple that is a
    leaf of a shardings tree)."""
    return hasattr(x, "placements") and hasattr(x, "place")


def _flatten_with_paths(tree, prefix=()) -> list:
    """(path, leaf) pairs; dict keys in sorted order, named-tuple fields
    by name, list and tuple items by index (a sharding is a leaf)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten_with_paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields") and \
            not _is_sharding(tree):
        return [kv for k in tree._fields
                for kv in _flatten_with_paths(getattr(tree, k),
                                              prefix + (k,))]
    if isinstance(tree, (list, tuple)) and not _is_sharding(tree):
        return [kv for i, t in enumerate(tree)
                for kv in _flatten_with_paths(t, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _rebuild(tree, leaves: Dict[str, Any], prefix=()):
    """``tree``'s structure with the leaf at each path from ``leaves``."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves, prefix + (str(k),))
                for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, k), leaves,
                                     prefix + (k,)) for k in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(t, leaves, prefix + (str(i),))
                          for i, t in enumerate(tree))
    return leaves["/".join(prefix)]


def _to_host(leaf) -> np.ndarray:
    """A leaf as a numpy array of its own (never a view of live memory,
    since the caller may update the state while a save is in flight);
    bf16 as f32, which holds it exactly.  A DTensor is saved whole
    (``full_tensor()``), so a checkpoint is the same file on any mesh."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if isinstance(t, DTensor):
            t = t.full_tensor()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()
    return np.array(leaf, copy=True)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, state: Any, extra: Optional[Dict] = None,
             blocking: bool = False) -> None:
        """Snapshot ``state`` to the host now, then write it (in the
        background unless ``blocking``)."""
        self.wait()
        payload = {k: _to_host(v) for k, v in _flatten_with_paths(state)}
        meta = {"step": int(step), "extra": extra or {},
                "keys": sorted(payload), "time": time.time()}

        def work():
            tmp = self.dir / f"step_{step:012d}.tmp"
            final = self.dir / f"step_{step:012d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            for key, arr in payload.items():
                with open(tmp / (key.replace("/", "__") + ".npy"), "wb") as f:
                    np.save(f, arr)
                    f.flush()
                    os.fsync(f.fileno())
            with open(tmp / "meta.json", "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            self._gc()

        if blocking:
            work()
        else:
            self._thread = threading.Thread(target=self._guard(work),
                                            daemon=True)
            self._thread.start()

    def _guard(self, fn):
        def wrapped():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 -- raised by wait()
                self._error = e
        return wrapped

    def wait(self) -> None:
        """Join the save in flight; raise if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint save failed: {err}") \
                from err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.dir / f"step_{s:012d}", ignore_errors=True)

    def all_steps(self):
        """Steps of the complete checkpoints, oldest first (a ``.tmp``
        directory is never one)."""
        out = []
        for p in self.dir.iterdir():
            if p.is_dir() and p.name.startswith("step_") and \
                    not p.name.endswith(".tmp") and (p / "meta.json").exists():
                out.append(int(p.name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None,
                shardings: Any = None):
        """Restore into the structure of ``template`` (default step: the
        latest).  Each leaf must match the template's shape; it takes the
        template's dtype and device, and with ``shardings`` (a tree like
        ``template``'s of ``launch/sharding.py::NamedSharding``) its
        placements on their mesh.  Returns (state, step, extra)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step:012d}"
        meta = json.loads((d / "meta.json").read_text())
        saved = set(meta["keys"])
        out: Dict[str, Any] = {}
        for key, leaf in _flatten_with_paths(template):
            if key not in saved:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = np.load(d / (key.replace("/", "__") + ".npy"))
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"shape mismatch for {key}: checkpoint {arr.shape} vs "
                    f"template {tuple(leaf.shape)}")
            if isinstance(leaf, torch.Tensor):
                out[key] = torch.from_numpy(arr).to(device=leaf.device,
                                                    dtype=leaf.dtype)
            else:
                out[key] = arr.astype(leaf.dtype)
        state = _rebuild(template, out)
        if shardings is not None:
            placed = dict(_flatten_with_paths(shardings))
            state = _rebuild(template, {k: placed[k].place(v) for k, v in
                                        _flatten_with_paths(state)})
        return state, step, meta["extra"]

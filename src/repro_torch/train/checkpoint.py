"""Checkpointing: atomic on-disk snapshots + lock-free async writer.

As ``src/repro/train/checkpoint.py:44-178``:

  * **Atomicity** — leaves are written to ``<dir>.tmp`` and the directory
    is renamed into place, so a crash mid-save never leaves a partial
    restore point.
  * **Integrity** — a manifest records every leaf's name, shape, dtype
    and the CRC32 of its stored bytes; ``restore`` verifies before
    handing state back.
  * **Async, lock-free** — the trainer publishes a snapshot through an
    NBW cell (never blocking the step loop) and a writer thread saves the
    freshest version; slower saving skips intermediate versions.
  * **GC** — keep the newest ``keep`` checkpoints.

Layout: ``<root>/step_<n>/{manifest.json, leaf_00000.npy, ...}``.  A
bfloat16 leaf is stored as the raw ``int16`` view of its bits (numpy has
no bfloat16 without ``ml_dtypes``), with ``"dtype": "bfloat16"`` in the
manifest, and viewed back on restore.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import nbw
from repro_torch.train import tree

# Stored as the int16 view of their bits; everything else as itself.
_VIEWED = {torch.bfloat16: (torch.int16, "bfloat16")}
_VIEWED_BACK = {"bfloat16": torch.bfloat16}


def _stored(leaf: Any) -> Tuple[np.ndarray, str]:
    """-> (the array written to disk, the leaf's true dtype name)."""
    t = torch.as_tensor(leaf).detach().cpu()
    if t.dtype in _VIEWED:
        view, name = _VIEWED[t.dtype]
        return t.view(view).numpy(), name
    arr = t.numpy()
    return arr, str(arr.dtype)


def save(root: os.PathLike, step: int, state: Any, keep: int = 3) -> Path:
    """Synchronous atomic save of a tree of tensors."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:08d}"
    tmp = root / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    leaves, spec = tree.flatten(state)
    manifest: Dict[str, Any] = {"step": step, "treedef": repr(spec),
                                "leaves": []}
    for i, leaf in enumerate(leaves):
        arr, dtype = _stored(leaf)
        name = f"leaf_{i:05d}.npy"
        np.save(tmp / name, arr)
        manifest["leaves"].append({
            "name": name, "shape": list(arr.shape), "dtype": dtype,
            "crc32": zlib.crc32(arr.tobytes()),
        })
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)          # atomic publish
    _gc(root, keep)
    return final


def _gc(root: Path, keep: int) -> None:
    ckpts = sorted(p for p in root.glob("step_*") if p.is_dir()
                   and not p.name.endswith(".tmp"))
    for p in ckpts[:-keep] if keep else []:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(root: os.PathLike) -> Optional[int]:
    root = Path(root)
    if not root.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in root.glob("step_*")
             if p.is_dir() and not p.name.endswith(".tmp")]
    return max(steps) if steps else None


def restore(root: os.PathLike, template: Any,
            step: Optional[int] = None) -> Tuple[int, Any]:
    """Restore into the structure of ``template`` (verifies CRC and
    shape); each leaf lands on its template leaf's device."""
    root = Path(root)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    d = root / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    t_leaves, spec = tree.flatten(template)
    if len(manifest["leaves"]) != len(t_leaves):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, template "
            f"has {len(t_leaves)} (architecture mismatch?)")
    out = []
    for entry, tmpl in zip(manifest["leaves"], t_leaves):
        arr = np.load(d / entry["name"])
        if zlib.crc32(arr.tobytes()) != entry["crc32"]:
            raise IOError(f"CRC mismatch in {d / entry['name']}")
        want_shape = tuple(torch.as_tensor(tmpl).shape)
        if tuple(arr.shape) != want_shape:
            raise ValueError(f"{entry['name']}: shape {arr.shape} != "
                             f"template {want_shape}")
        t = torch.from_numpy(arr)
        if entry["dtype"] in _VIEWED_BACK:
            t = t.view(_VIEWED_BACK[entry["dtype"]])
        device = tmpl.device if torch.is_tensor(tmpl) else "cpu"
        out.append(t.to(device))
    return step, tree.unflatten(spec, out)


class AsyncCheckpointer:
    """NBW-published snapshots drained by a daemon writer thread.

    trainer:  ckpt.publish(step, state)     # a reference, never blocks
    writer:   polls the NBW cell, saves the newest unseen snapshot.

    Each snapshot carries its own publish number, and the writer records
    the number of the one it saved.  (The JAX package's writer reads the
    cell's version after the value, so a publish landing between the two
    reads marks the newer snapshot saved while the older one is written,
    and ``drain`` returns with the newest never on disk.)
    """

    def __init__(self, root: os.PathLike, keep: int = 3,
                 poll_s: float = 0.01):
        self.root = Path(root)
        self.keep = keep
        self._cell = nbw.HostNBW(depth=2)
        self._stop = threading.Event()
        self._published = 0
        self._last_saved = 0
        self._poll_s = poll_s
        self._errors: list = []
        self._saved_steps: list = []
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def publish(self, step: int, state: Any) -> None:
        """Hand a snapshot to the writer by reference: no copy, no block.
        Safe because nothing writes a published tensor again — the
        optimizer and the train step are functional and return new
        tensors (the JAX package relies on immutable arrays for the
        same).  One thread publishes."""
        self._published += 1
        self._cell.write((self._published, step, state))

    def _run(self) -> None:
        while not self._stop.is_set():
            status, value = self._cell.try_read()
            if status == nbw.OK and value is not None \
                    and value[0] > self._last_saved:
                number, step, state = value
                try:
                    save(self.root, step, state, keep=self.keep)
                    self._saved_steps.append(step)
                except Exception as e:  # noqa: BLE001 — surfaced via .errors
                    self._errors.append(e)
                self._last_saved = number
            else:
                time.sleep(self._poll_s)

    def drain(self, timeout: float = 60.0) -> None:
        """Block until the newest published snapshot is on disk."""
        deadline = time.monotonic() + timeout
        while (self._published > self._last_saved
               and time.monotonic() < deadline):
            time.sleep(self._poll_s)

    def close(self) -> None:
        self.drain()
        self._stop.set()
        self._thread.join(timeout=10)
        if self._errors:
            raise self._errors[0]

    @property
    def saved_steps(self):
        return list(self._saved_steps)

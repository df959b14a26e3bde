"""Checkpointing: atomic, async, mesh-agnostic; the port of
``repro/training/checkpoint.py`` with the reference's layout.

Layout: ``<dir>/step_<N>/arrays.npz`` + ``meta.json``, written into
``step_<N>.tmp`` and renamed into place; a ``LATEST`` marker file is
replaced last, so a crash mid-save never corrupts the restore path, and
only the newest ``keep`` steps are kept.  Arrays are stored as full
logical arrays keyed by tree path (``params/blocks/attn/wq``,
``opt/m/...``, ``opt/step``; the train loop hands in the unranked tree of
``parallel/steps.py::train_state``), which makes checkpoints
mesh-agnostic: a run on a ``VirtualMesh(4, 1)`` restores on one rank, and
the reference's ``restore`` reads an f32 checkpoint of the port (and the
port's reads the reference's).  bf16 is stored as its 16 bits, viewed as
the 2-byte void type under which npz round-trips the reference's bf16,
with "bfloat16" named in ``meta.json`` (no ``ml_dtypes`` needed).
:class:`AsyncCheckpointer` copies device to host first, then writes on a
background thread, so the train loop never blocks on disk.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.tree import tree_items, tree_map, tree_map_with_path


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _to_numpy(t: Any) -> np.ndarray:
    """A host copy of ``t`` (never a view of a tensor the train loop goes
    on updating in place); bf16 as its bits in a 2-byte void array."""
    if isinstance(t, np.ndarray):
        return t
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def save(ckpt_dir: str, step: int, state: Dict[str, Any],
         keep: int = 3) -> str:
    """Synchronous atomic save.  ``state`` is a tree of tensors (or numpy
    arrays)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays, dtypes = {}, {}
    for path, leaf in tree_items(state):
        arrays[path] = _to_numpy(leaf)
        dtypes[path] = "bfloat16" if arrays[path].dtype.kind == "V" \
            else str(arrays[path].dtype)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "keys": list(arrays), "dtypes": dtypes,
                   "time": time.time()}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                        # atomic publish
    latest_tmp = os.path.join(ckpt_dir, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(os.path.basename(final))
    os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    marker = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(ckpt_dir, name)):
        return None
    return int(name.split("_")[1])


def restore(ckpt_dir: str, template: Any, step: Optional[int] = None
            ) -> Tuple[int, Any]:
    """(step, a tree of tensors) restored into the structure, shapes and
    dtypes of ``template`` (a tree of tensors), each leaf on its template
    leaf's device; the latest step unless ``step`` is given."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    data = np.load(os.path.join(d, "arrays.npz"))
    with open(os.path.join(d, "meta.json")) as f:
        saved_dtypes = json.load(f).get("dtypes", {})

    def load(path, tmpl: torch.Tensor) -> torch.Tensor:
        key = "/".join(map(str, path))
        arr = data[key]
        want = _dtype_name(tmpl.dtype)
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                             f"template {tuple(tmpl.shape)}")
        if arr.dtype.kind == "V" or tmpl.dtype == torch.bfloat16:
            saved = saved_dtypes.get(key, str(arr.dtype))
            if saved != want:
                raise ValueError(f"{key}: checkpoint dtype {saved} != "
                                 f"template {want}")
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
                .view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.asarray(arr).astype(want, copy=False))
        return t.to(tmpl.device)

    return step, tree_map_with_path(load, template)


class AsyncCheckpointer:
    """Snapshot-to-host then write-on-thread; at most one pending save."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save(self, step: int, state):
        self.wait()
        host_state = tree_map(_to_numpy, state)

        def work():
            try:
                save(self.ckpt_dir, step, host_state, keep=self.keep)
            except BaseException as e:  # noqa: BLE001
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err


__all__ = ["save", "restore", "latest_step", "AsyncCheckpointer"]

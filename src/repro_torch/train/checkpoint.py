"""Elastic, async checkpointing (twin of ``repro.train.checkpoint``, with
its on-disk layout).

Layout: ``<dir>/step_<k>/`` with one ``.npy`` per tree leaf (its
flattened key path: dict keys sorted, a NamedTuple's fields and a
tuple's items in order, joined by ``.``) + ``manifest.json`` (step, and
for each leaf its file, dtype and shape). Properties:

  * **device-agnostic restore**: leaves are stored whole; ``restore`` puts
    them on the device asked for, or on each template leaf's device;
  * **async save**: the leaves are copied to the host synchronously, the
    file I/O happens on a background thread (``wait()`` joins);
  * **atomic**: writes go to ``<dir>/.tmp_step_<k>`` then ``os.replace``;
  * **keep**: only the newest ``keep`` steps stay on disk.

bfloat16 leaves (``moments_dtype="bfloat16"``) are stored as their raw
16-bit patterns, a ``uint16`` array, with ``"bfloat16"`` as the
manifest's dtype: numpy has no bfloat16 of its own, and the card's
machine has no ``ml_dtypes``. A bfloat16 leaf that ``repro`` wrote (its
``.npy`` holds two-byte items) is read back through the same 16-bit
view. float32 and int32 leaves are plain ``.npy`` arrays, so the two
packages read each other's checkpoints of them.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch


def _flatten(tree) -> dict:
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}.{k}" if prefix else str(k), node[k])
        elif isinstance(node, (tuple, list)) and not hasattr(node, "_fields"):
            for i, v in enumerate(node):
                walk(f"{prefix}.{i}", v)
        elif hasattr(node, "_fields"):          # NamedTuple
            for k in node._fields:
                walk(f"{prefix}.{k}" if prefix else k, getattr(node, k))
        else:
            flat[prefix] = node
    walk("", tree)
    return flat


def _unflatten_into(template, flat: dict):
    def walk(prefix, node):
        if isinstance(node, dict):
            return {k: walk(f"{prefix}.{k}" if prefix else str(k), node[k])
                    for k in sorted(node)}
        if hasattr(node, "_fields"):
            vals = {k: walk(f"{prefix}.{k}" if prefix else k,
                            getattr(node, k)) for k in node._fields}
            return type(node)(**vals)
        if isinstance(node, (tuple, list)):
            return type(node)(walk(f"{prefix}.{i}", v)
                              for i, v in enumerate(node))
        return flat[prefix](node)
    return walk("", template)


def _to_host(x: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(the array to store, the manifest's dtype name) of one leaf."""
    x = x.detach()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).cpu().numpy().view(np.uint16), "bfloat16"
    a = x.cpu().numpy()
    return a, str(a.dtype)


def _from_host(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, blocking: bool = False):
        """Snapshot to the host now, write in the background (unless
        blocking)."""
        flat = {k: _to_host(v) for k, v in _flatten(tree).items()}
        self.wait()
        if blocking:
            self._write(step, flat)
        else:
            self._thread = threading.Thread(
                target=self._write, args=(step, flat), daemon=True)
            self._thread.start()

    def _write(self, step: int, flat: dict):
        tmp = os.path.join(self.dir, f".tmp_step_{step}")
        final = os.path.join(self.dir, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": {}}
        for k, (v, dtype) in flat.items():
            fn = k.replace("/", "_") + ".npy"
            np.save(os.path.join(tmp, fn), v)
            manifest["leaves"][k] = {"file": fn, "dtype": dtype,
                                     "shape": list(v.shape)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- restore ------------------------------------------------------------

    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_"):
                try:
                    out.append(int(d.split("_", 1)[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None,
                device=None) -> Tuple[int, Any]:
        """Load into the structure of ``template`` (a tree of tensors), each
        leaf on ``device``, or on its template leaf's device where
        ``device`` is None (elastic: a checkpoint written from one device
        restores onto another)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        base = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(base, "manifest.json")) as f:
            manifest = json.load(f)

        def loader(meta):
            def load(like):
                a = np.load(os.path.join(base, meta["file"]))
                return _from_host(a, meta["dtype"],
                                  like.device if device is None else device)
            return load
        flat = {k: loader(meta) for k, meta in manifest["leaves"].items()}
        return step, _unflatten_into(template, flat)

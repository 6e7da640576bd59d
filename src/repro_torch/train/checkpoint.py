"""Checkpoint manager: atomic step directories and an async writer.

The counterpart of ``repro.train.checkpoint``, with its on-disk layout:
``<dir>/step_<N:08d>/MANIFEST.json`` plus one ``.npy`` file per leaf.  A
leaf's key joins the dict keys and list indices on its path with ``/``
(dict keys in sorted order, as JAX flattens them); its file name is the key
with ``/`` replaced by ``__``.  Writes go to ``step_<N>.tmp`` and are renamed
atomically, so a killed writer never leaves a half checkpoint;
``latest_step`` trusts only renamed directories.  Restore reads only the
leaf files named by ``like``'s keys, so a checkpoint written by either
package restores in the other; the manifest's ``treedef`` is this module's
own structural string.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike


def _items(node):
    """A container's (key, child) pairs in flattening order, or None for a
    leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    items = _items(tree)
    if items is None:
        if tree is not None:                   # None is an empty subtree
            flat[prefix] = tree
        return flat
    for k, child in items:
        flat.update(_flatten(child, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def _structure(tree) -> str:
    """The tree's shape with every leaf written ``*``."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_structure(c) for c in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "None" if tree is None else "*"


def _host(leaf) -> np.ndarray:
    """A copy of the leaf in host memory, taken now."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, extra: Optional[dict] = None):
        """Snapshot to host memory NOW; write (possibly async) afterwards."""
        flat = {k: _host(v) for k, v in _flatten(tree).items()}
        manifest = {
            "step": int(step),
            "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                       for k, v in flat.items()},
            "treedef": _structure(tree),
            "extra": extra or {},
        }
        self.wait()
        if self.async_write:
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, manifest), daemon=True)
            self._thread.start()
        else:
            self._write(step, flat, manifest)

    def _write(self, step: int, flat, manifest):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for k, v in flat.items():
            np.save(os.path.join(tmp, k.replace("/", "__") + ".npy"), v)
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name,
                                               "MANIFEST.json")):
                    out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like, device: DeviceLike = None):
        """``like``: a tree of the saved structure.  Returns (tree,
        manifest): ``like``'s structure with every leaf a tensor loaded from
        its file, on ``device`` if given, else on the device of ``like``'s
        leaf (the CPU for a leaf that is not a tensor)."""
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)

        def load(node, key):
            items = _items(node)
            if items is None:
                if node is None:
                    return None
                arr = np.load(os.path.join(d, key.replace("/", "__")
                                           + ".npy"))
                dev = device if device is not None else (
                    node.device if isinstance(node, torch.Tensor) else "cpu")
                return torch.from_numpy(arr).to(dev)
            out = {k: load(c, f"{key}/{k}" if key else str(k))
                   for k, c in items}
            if isinstance(node, dict):
                return {k: out[k] for k in node}
            return type(node)(out[i] for i in range(len(node)))

        return load(like, ""), manifest

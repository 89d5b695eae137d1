"""The checkpoint format (port of ``repro/checkpoint/manager.py``): a
directory of per-leaf ``.npy`` files and a ``manifest.json`` naming each
leaf, its file, shape and dtype. :func:`save_pytree` writes a flat dict of
arrays (an artifact) as the reference's ``save_pytree`` writes one, so
either package reads it; :func:`read_manifest` reads the reference's files
unchanged. Training checkpoints (``CheckpointManager``) arrive with the
training slice of the port.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch


def save_pytree(tree: dict, directory: str, extra_meta: dict | None = None) -> None:
    """Atomic write (temporary directory + rename) of a flat dict of arrays
    or tensors. Leaves go in the reference's order (sorted keys) under its
    names (``"['<key>']"``, the ``keystr`` of a flat string key)."""
    parent = os.path.dirname(os.path.abspath(directory)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent, prefix=".ckpt_tmp_")
    try:
        manifest = {"leaves": [], "meta": extra_meta or {}}
        for i, key in enumerate(sorted(tree)):
            leaf = tree[key]
            if isinstance(leaf, dict):
                raise TypeError(f"save_pytree writes a flat dict; {key!r} holds a dict")
            if isinstance(leaf, torch.Tensor):
                if leaf.dtype == torch.bfloat16:
                    raise TypeError(f"{key!r}: bfloat16 leaves have no numpy type")
                leaf = leaf.detach().cpu().numpy()
            arr = np.asarray(leaf)
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"].append({"name": f"[{key!r}]", "file": fname,
                                       "shape": list(arr.shape), "dtype": str(arr.dtype)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(directory):
            shutil.rmtree(directory)
        os.replace(tmp, directory)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _load_leaf(directory: str, entry: dict) -> np.ndarray:
    arr = np.load(os.path.join(directory, entry["file"]))
    if entry.get("dtype") == "bfloat16":
        # numpy has no bfloat16: the file holds the raw 16-bit patterns;
        # widening them to float32 is exact
        bits = np.ascontiguousarray(arr).view(np.uint16).astype(np.uint32) << 16
        arr = bits.view(np.float32)
    return arr


def read_manifest(directory: str) -> tuple[dict[str, np.ndarray], dict]:
    """All leaves of a checkpoint directory as numpy arrays keyed by their
    manifest name, plus the manifest's ``meta``. bfloat16 leaves come back
    as exactly-widened float32."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {e["name"]: _load_leaf(directory, e) for e in manifest["leaves"]}
    return flat, manifest.get("meta", {})

"""Read side of the checkpoint format (port of
``repro/checkpoint/manager.py``): a directory of per-leaf ``.npy`` files
and a ``manifest.json`` naming each leaf, its file, shape and dtype. The
JAX package writes it (``save_pytree``); the port reads it unchanged. The
write side arrives with the training slice of the port.
"""

from __future__ import annotations

import json
import os

import numpy as np


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

"""Checkpoints (port of ``repro/checkpoint/manager.py``): a directory of
per-leaf ``.npy`` files and a ``manifest.json`` naming each leaf, its file,
shape and dtype, an async writer thread, and retention.

A tree is nested dicts (keys sorted, as ``jax.tree`` flattens them), tuples
and lists of leaves: torch tensors or numpy arrays. Each leaf is written
under the reference's name for its path, the ``keystr`` of a JAX pytree
path (``['params']['layers'][0]['mixer']['wq']``), and a bfloat16 leaf as
the reference writes it: its 16-bit patterns in an ``.npy`` of descr
``<V2``, ``"bfloat16"`` in the manifest. So either package reads what the
other wrote. :mod:`repro_torch.interop` maps a model and a train state to
the reference's tree (``reference_tree``, ``train_state_tree``).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time

import numpy as np
import torch

_BF16_DESCR = "<V2"  # ml_dtypes' bfloat16 in an .npy header


def _flatten_with_names(tree) -> list[tuple[str, object]]:
    """(name, leaf) of every leaf of ``tree`` in the reference's order: the
    name is the ``keystr`` of its path, ``['key']`` for a dict key and
    ``[i]`` for a sequence index; None is an empty subtree."""
    out = []

    def walk(node, prefix):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}[{k!r}]")
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}[{i}]")
        else:
            out.append((prefix, node))

    walk(tree, "")
    return out


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken in order from ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _host_array(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a host numpy array (a copy) and its manifest dtype; a
    bfloat16 tensor becomes its 16-bit patterns."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    arr = np.array(leaf)
    return arr, str(arr.dtype)


def _save_leaf(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False, "shape": arr.shape})
        f.write(arr.tobytes(order="C"))


def save_pytree(tree, directory: str, extra_meta: dict | None = None) -> None:
    """Atomic write (temporary directory + rename) of a tree of arrays or
    tensors, under the reference's leaf names and order."""
    parent = os.path.dirname(os.path.abspath(directory)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent, prefix=".ckpt_tmp_")
    try:
        manifest = {"leaves": [], "meta": extra_meta or {}}
        for i, (name, leaf) in enumerate(_flatten_with_names(tree)):
            arr, dtype = _host_array(leaf)
            fname = f"leaf_{i:05d}.npy"
            _save_leaf(os.path.join(tmp, fname), arr, dtype)
            manifest["leaves"].append({"name": name, "file": fname,
                                       "shape": list(arr.shape), "dtype": dtype})
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
        arr = bits.view(np.float32).reshape(arr.shape)  # ascontiguousarray makes 0-d 1-d
    return arr


def read_manifest(directory: str) -> tuple[dict[str, np.ndarray], dict]:
    """All leaves of a checkpoint directory as numpy arrays keyed by their
    manifest name, plus the manifest's ``meta``. bfloat16 leaves come back
    as exactly-widened float32."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {e["name"]: _load_leaf(directory, e) for e in manifest["leaves"]}
    return flat, manifest.get("meta", {})


def _restored(arr: np.ndarray, target, device):
    """``arr`` in the target leaf's kind and dtype: a numpy target gives
    numpy, a tensor target a tensor on ``device`` (default: the target's,
    the CPU for a meta tensor)."""
    if isinstance(target, np.ndarray):
        return arr.astype(target.dtype)
    t = torch.from_numpy(np.ascontiguousarray(arr).reshape(arr.shape)).to(target.dtype)
    dev = device if device is not None else (
        "cpu" if target.device.type == "meta" else target.device)
    return t.to(dev)


def load_pytree(target, directory: str, *, device=None):
    """Restore into the structure of ``target``, a tree whose leaves are
    tensors (meta tensors will do) or numpy arrays, read for their shapes
    and dtypes. Returns (tree, meta). A leaf the checkpoint lacks raises
    ``KeyError``, a shape that differs ``ValueError``; leaves the target
    does not name are ignored (a params target reads a train state)."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {e["name"]: e for e in manifest["leaves"]}
    out = []
    for name, tl in _flatten_with_names(target):
        entry = by_name.get(name)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {name}")
        arr = _load_leaf(directory, entry)
        if tuple(arr.shape) != tuple(tl.shape):
            raise ValueError(f"{name}: checkpoint shape {arr.shape} != target "
                             f"{tuple(tl.shape)}")
        out.append(_restored(arr, tl, device))
    return _unflatten(target, iter(out)), manifest["meta"]


def _snapshot(tree):
    """A host copy of every leaf (tensors stay tensors, on the CPU)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_snapshot(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return np.array(tree)


class CheckpointManager:
    """Step-indexed checkpoints with retention and an async writer.

    ``save()`` snapshots the tree to host memory synchronously (so the
    train loop may update its tensors in place at once) and writes it on a
    background thread; ``wait()`` joins the outstanding write. ``keep``
    newest steps are retained."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        self._thread: threading.Thread | None = None
        os.makedirs(root, exist_ok=True)

    def directory(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def latest_step(self) -> int | None:
        steps = [
            int(d.split("_")[1])
            for d in os.listdir(self.root)
            if d.startswith("step_") and os.path.exists(os.path.join(self.root, d,
                                                                     "manifest.json"))
        ]
        return max(steps) if steps else None

    def save(self, step: int, tree, meta: dict | None = None, blocking: bool = False):
        host_tree = _snapshot(tree)
        meta = dict(meta or {}, step=step, time=time.time())

        def work():
            save_pytree(host_tree, self.directory(step), meta)
            self._gc()

        self.wait()
        if blocking:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def restore(self, step: int, target, *, device=None):
        return load_pytree(target, self.directory(step), device=device)

    def restore_latest(self, target, *, device=None):
        """(step, tree, meta) of the newest checkpoint, or None."""
        step = self.latest_step()
        if step is None:
            return None
        tree, meta = self.restore(step, target, device=device)
        return step, tree, meta

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.root) if d.startswith("step_"))
        for s in steps[: -self.keep]:
            shutil.rmtree(self.directory(s), ignore_errors=True)

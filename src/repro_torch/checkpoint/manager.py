"""Checkpoint/restart for fault tolerance.

Layout per step::

    <dir>/step_000123/
        arrays.npz          flattened tree leaves (keyed by index)
        manifest.json       treedef repr, shapes/dtypes, content hash, step
    <dir>/LATEST            atomic pointer file (written last)

Writes go to a temp dir then ``os.replace`` — a crash mid-save never
corrupts the previous checkpoint, and LATEST only advances after the
payload is fully durable.  ``CheckpointManager`` adds async saves (a
background thread), retention, and restore-with-validation (content hash +
shape/dtype check).  Restores compose with the stateless data pipeline:
resuming at step N replays the exact stream.

The counterpart of the JAX package's ``repro/checkpoint/manager.py``, with
its on-disk layout: a tree is flattened as ``jax.tree_util`` flattens it
(dict keys sorted, lists, tuples and named tuples in order, ``None`` an
empty subtree), so each package restores the other's checkpoints of one
tree.  Leaves are tensors (or numpy arrays); numpy has no bfloat16 without
``ml_dtypes``, so a bf16 leaf is stored as its raw 16-bit words under the
manifest dtype ``bfloat16`` (the JAX package stores the same bytes) and
restored through a ``uint16`` view.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

BF16 = "bfloat16"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaves(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree_util.tree_leaves`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in _leaves(sub)]
    return [tree]


def _treedef(tree) -> str:
    """``str`` of the tree's ``jax.tree_util`` structure, inner part."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        return (f"CustomNode(namedtuple[{type(tree).__name__}], ["
                + ", ".join(_treedef(t) for t in tree) + "])")
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef(t) for t in tree) + "]"
    if isinstance(tree, tuple):
        inner = ", ".join(_treedef(t) for t in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    return "*"


def _unflatten(template, leaves: list):
    """``template``'s structure with its leaves taken in order from
    ``leaves`` (consumed)."""
    if template is None:
        return None
    if isinstance(template, dict):
        out = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: out[k] for k in template}
    if _is_namedtuple(template):
        return type(template)(*(_unflatten(t, leaves) for t in template))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(t, leaves) for t in template)
    return leaves.pop(0)


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(host array, manifest dtype) of a leaf; bf16 as its 16-bit words."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def _to_tensor(a: np.ndarray, dtype: str, like) -> torch.Tensor:
    """The stored array as a tensor of ``like``'s dtype and device."""
    like = torch.as_tensor(like)
    a = np.array(a)                     # a C-contiguous copy, any rank
    if dtype == BF16:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=like.device, dtype=like.dtype)


def _content_hash(arrays: list) -> str:
    # bytes+shape only: exotic dtypes (bfloat16) round-trip through npz as
    # raw words, so dtype strings are validated via the manifest
    h = hashlib.sha256()
    for a in arrays:
        h.update(str(tuple(a.shape)).encode())
        h.update(a.tobytes()[:65536])  # prefix hash: fast, catches corruption
    return h.hexdigest()


def _save_host(directory: str, step: int, arrays: List[np.ndarray],
               dtypes: List[str], treedef: str,
               extra: Optional[dict]) -> str:
    final = os.path.join(directory, f"step_{step:09d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"leaf_{i}": a for i, a in enumerate(arrays)})
    manifest = {
        "step": step,
        "n_leaves": len(arrays),
        "treedef": treedef,
        "shapes": [list(a.shape) for a in arrays],
        "dtypes": dtypes,
        "hash": _content_hash(arrays),
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    latest_tmp = os.path.join(directory, ".LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(f"step_{step:09d}")
    os.replace(latest_tmp, os.path.join(directory, "LATEST"))
    return final


def _host_copy(tree) -> Tuple[List[np.ndarray], List[str], str]:
    pairs = [_to_numpy(leaf) for leaf in _leaves(tree)]
    return ([a for a, _ in pairs], [d for _, d in pairs],
            f"PyTreeDef({_treedef(tree)})")


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[dict] = None) -> str:
    arrays, dtypes, treedef = _host_copy(tree)
    return _save_host(directory, step, arrays, dtypes, treedef, extra)


def load_checkpoint(directory: str, template: Any,
                    step: Optional[int] = None) -> Tuple[Any, dict]:
    """Restore into the structure of ``template`` (validates shapes/dtypes
    and the content hash); each leaf takes its template leaf's dtype and
    device.  ``step=None`` loads LATEST."""
    if step is None:
        with open(os.path.join(directory, "LATEST")) as f:
            name = f.read().strip()
    else:
        name = f"step_{step:09d}"
    path = os.path.join(directory, name)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    arrays = []
    with np.load(os.path.join(path, "arrays.npz"),
                 allow_pickle=False) as data:
        for i in range(manifest["n_leaves"]):
            a = data[f"leaf_{i}"]
            want = manifest["dtypes"][i]
            if want == BF16:
                a = a.view(np.uint16)
            elif str(a.dtype) != want:
                raise ValueError(f"leaf {i}: stored {a.dtype}, manifest "
                                 f"says {want}")
            arrays.append(a)
    if _content_hash(arrays) != manifest["hash"]:
        raise IOError(f"checkpoint {path} failed content-hash validation")
    t_leaves = _leaves(template)
    if len(t_leaves) != len(arrays):
        raise ValueError(
            f"checkpoint has {len(arrays)} leaves, template expects "
            f"{len(t_leaves)}")
    for i, (t, a) in enumerate(zip(t_leaves, arrays)):
        if tuple(t.shape) != tuple(a.shape):
            raise ValueError(f"leaf {i}: shape {a.shape} != {t.shape}")
    restored = [_to_tensor(a, d, t) for a, d, t in
                zip(arrays, manifest["dtypes"], t_leaves)]
    return _unflatten(template, restored), manifest


class CheckpointManager:
    """Async checkpointing with retention — save() returns immediately;
    wait() joins the in-flight write (called before exit / next save)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             blocking: bool = False) -> None:
        self.wait()
        # materialize on host before handing to the writer thread
        arrays, dtypes, treedef = _host_copy(tree)

        def work():
            _save_host(self.directory, step, arrays, dtypes, treedef, extra)
            self._gc()

        if blocking:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def _gc(self) -> None:
        steps = sorted(d for d in os.listdir(self.directory)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for d in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, d),
                          ignore_errors=True)

    def latest_step(self) -> Optional[int]:
        try:
            with open(os.path.join(self.directory, "LATEST")) as f:
                return int(f.read().strip().split("_")[1])
        except (FileNotFoundError, IndexError, ValueError):
            return None

    def restore(self, template: Any, step: Optional[int] = None):
        return load_checkpoint(self.directory, template, step)

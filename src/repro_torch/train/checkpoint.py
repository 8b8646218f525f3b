"""Fault-tolerant checkpointing (ports ``repro/train/checkpoint.py``).

The reference's layout, so either package reads the other's directories:

  * atomic: a checkpoint is either fully visible or absent (tmp dir +
    rename; rename is atomic on POSIX);
  * self-validating: every array carries a CRC32 in the manifest; restore
    verifies before handing arrays back, so a torn write from a preempted
    writer can never poison a run;
  * bounded: keep_last trims old steps; a ``LATEST`` pointer file makes
    discovery O(1);
  * async-capable: save() can write on a background thread (the caller
    only blocks on the device-to-host copy);
  * the arrays are written, loaded and CRC-checked by a pool of
    ``IO_THREADS`` threads (``np.save``'s write and ``zlib.crc32`` release
    the interpreter lock), which a model zoo's multi-GB tables need: one
    thread wrote dlrm-rm2's 21 GB at some 0.7 GB/s.

A tree is nested NamedTuples, dictionaries, lists and tuples whose leaves
are tensors, numpy arrays or numbers; an array's key is its path in
``jax.tree_util.keystr`` form (``.params/['W']/[0]/['in']/['w']``), as the
reference writes it. A ``TrainState`` is saved as
``trainer.train_state_to_numpy(state)``. bfloat16 is stored as a uint16
view, with the logical dtype in the manifest.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

Tree = Any

_MANIFEST = "manifest.json"
_LATEST = "LATEST"
IO_THREADS = 8


def _to_storable(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the array written to disk and its logical dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, arr.dtype.name
    arr = np.asarray(leaf)
    return arr, arr.dtype.name


def _from_storable(arr: np.ndarray, logical_dtype: str, like):
    """The stored array back in the form of the target leaf ``like``: a
    tensor on its device, else a numpy array (bfloat16 only as a tensor)."""
    if isinstance(like, torch.Tensor):
        if logical_dtype == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        return t.to(like.device)
    if logical_dtype == "bfloat16":
        raise TypeError("a bfloat16 array restores only into a tensor leaf")
    return arr


def _crc32(arr: np.ndarray) -> int:
    """``zlib.crc32(arr.tobytes())`` without the copy (the bytes of a C-ordered array)."""
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_with_paths(tree: Tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in ``jax.tree_util`` order: NamedTuple fields in
    order, dictionary keys sorted, sequences in order."""
    if _is_namedtuple(tree):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return [("/".join(prefix), tree)]
    out = []
    for part, sub in items:
        out += _flatten_with_paths(sub, prefix + (part,))
    return out


def flatten_tree(tree: Tree) -> Dict[str, Any]:
    """The leaves of ``tree`` keyed by their checkpoint keys, in
    ``jax.tree_util``'s leaf order (the order the reference's global norm
    and Adam walk a parameter tree)."""
    return dict(_flatten_with_paths(tree))


def unflatten_tree(target: Tree, leaves) -> Tree:
    """``leaves`` (in ``flatten_tree``'s order) put into ``target``'s structure."""
    it = iter(leaves)

    def build(node):
        if _is_namedtuple(node):
            return type(node)(*(build(getattr(node, f)) for f in node._fields))
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(target)


def save(ckpt_dir: str, step: int, tree: Tree, *, keep_last: int = 3,
         blocking: bool = True) -> str:
    """Write checkpoint atomically. Returns the final directory path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    # device-to-host copies on the caller's thread; disk IO may be async
    host = [(k, *_to_storable(v)) for k, v in _flatten_with_paths(tree)]

    def _write():
        tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=f".tmp_step_{step}_")

        def one(i):
            k, storable, logical = host[i]
            fname = f"arr_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), storable)
            return k, {"file": fname, "crc32": _crc32(storable),
                       "shape": list(storable.shape), "dtype": logical}

        with ThreadPoolExecutor(IO_THREADS) as pool:
            arrays = list(pool.map(one, range(len(host))))
        manifest = {"step": step, "arrays": dict(arrays)}
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
        final = os.path.join(ckpt_dir, f"step_{step:010d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        # latest pointer (write-then-rename, atomic)
        with tempfile.NamedTemporaryFile("w", dir=ckpt_dir, delete=False) as f:
            f.write(os.path.basename(final))
            tmp_ptr = f.name
        os.replace(tmp_ptr, os.path.join(ckpt_dir, _LATEST))
        _trim(ckpt_dir, keep_last)
        return final

    if blocking:
        return _write()
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return os.path.join(ckpt_dir, f"step_{step:010d}")


def _trim(ckpt_dir: str, keep_last: int):
    steps = sorted(
        d for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and os.path.isdir(os.path.join(ckpt_dir, d))
    )
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Find the newest *valid* checkpoint (skips torn/corrupt ones)."""
    if not os.path.isdir(ckpt_dir):
        return None
    candidates = sorted(
        (d for d in os.listdir(ckpt_dir) if d.startswith("step_")), reverse=True
    )
    for d in candidates:
        path = os.path.join(ckpt_dir, d)
        if os.path.isfile(os.path.join(path, _MANIFEST)):
            try:
                with open(os.path.join(path, _MANIFEST)) as f:
                    return int(json.load(f)["step"])
            except (json.JSONDecodeError, KeyError, ValueError):
                continue
    return None


def restore(ckpt_dir: str, target: Tree, step: Optional[int] = None) -> Tuple[Tree, int]:
    """Restore into the structure of ``target``.

    CRC-verifies every array. A tensor leaf of ``target`` comes back as a
    tensor on its device, any other leaf as a numpy array.
    """
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no valid checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)

    flat = _flatten_with_paths(target)
    for k, _ in flat:
        if k not in manifest["arrays"]:
            raise KeyError(f"checkpoint missing array {k!r}")

    def load(k):
        meta = manifest["arrays"][k]
        arr = np.load(os.path.join(path, meta["file"]))
        if _crc32(arr) != meta["crc32"]:
            raise IOError(f"CRC mismatch for {k!r}: checkpoint corrupt")
        return arr

    with ThreadPoolExecutor(IO_THREADS) as pool:
        arrays = list(pool.map(load, [k for k, _ in flat]))
    leaves = [_from_storable(arr, manifest["arrays"][k]["dtype"], like)
              for arr, (k, like) in zip(arrays, flat)]
    return unflatten_tree(target, leaves), step

"""Train-once binarizer checkpoints, cached under a content digest (ports
``repro/launch/binarizer_cache.py``).

The serve driver needs a trained recurrent-MLP binarizer before it can
build an index, and training one is deterministic for a fixed (corpus,
config, steps, batch, seed) tuple on one kind of device: train it once,
checkpoint it keyed by a digest of everything that shaped it, and reload
it on every later launch with the same inputs.

The digest covers the corpus bytes, the full ``TrainConfig`` repr (a
frozen dataclass of scalars, so the repr is stable; it equals the
reference's), the loop knobs, and a tag of this package and the device
type (``repro_torch-threefry/cuda``, ``repro_torch-threefry/cpu``). The
initial weights are the reference's draws from ``PRNGKey(seed)``
(``prng``) on either device, but a card's training arithmetic differs
from the CPU's, and both from the reference's, so the same tuple trains
other weights in each; the tag keeps the caches apart, and its
``threefry`` keeps out the files that earlier versions of the port
trained from torch's own generator. Without it one would load
another's file under the promise that a hit is the run that wrote it. Either package still reads
the other's archive by explicit path (``load_checkpoint``, and the
reference's loader on the port's files): the layout is one.

A checkpoint is an ``np.savez`` archive of the flattened ``(params,
bn_state)`` pytree, leaves named ``leaf_000, leaf_001, ...`` in
``jax.tree_util.tree_flatten`` order (``binarize_lib.leaf_layout``), no
pickle, written atomically (tmp + rename) so a crashed run never leaves
a half-written file.

Cache location: ``--ckpt-cache`` / the ``cache_dir`` argument, else the
``REPRO_BEBR_CACHE`` environment variable, else ``~/.cache/repro-bebr``.
"""

from __future__ import annotations

import hashlib
import os
import zipfile
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.binarize_lib import (
    BinarizerConfig,
    RecurrentBinarizer,
    binarizer_from_numpy,
    leaf_layout,
    nest_leaves,
    numpy_leaves,
)
from repro_torch.core.trainer import TrainConfig, init_train_state, train_step
from repro_torch.data import synthetic
from repro_torch.device import resolve_device

CACHE_ENV = "REPRO_BEBR_CACHE"
_DEFAULT_CACHE = os.path.join("~", ".cache", "repro-bebr")
PACKAGE_TAG = "repro_torch-threefry"


class BinarizerCheckpoint(NamedTuple):
    """A trained binarizer, plus where it came from.

    ``model`` is an eval-mode ``RecurrentBinarizer`` on the asked device;
    ``trained`` is False when it was loaded from the cache.
    """

    model: RecurrentBinarizer
    digest: str
    path: str | None
    trained: bool


def resolve_cache_dir(cache_dir: str | None = None) -> str:
    """Explicit argument, else $REPRO_BEBR_CACHE, else ~/.cache."""
    if cache_dir:
        return os.path.expanduser(cache_dir)
    return os.path.expanduser(os.environ.get(CACHE_ENV) or _DEFAULT_CACHE)


def checkpoint_digest(
    docs: np.ndarray, cfg: TrainConfig, *, steps: int, batch: int, seed: int, device="cuda"
) -> str:
    """Digest of everything that determines the trained weights: the
    reference's bytes, preceded by ``PACKAGE_TAG/<device type>``."""
    h = hashlib.sha1()
    h.update(f"{PACKAGE_TAG}/{torch.device(device).type}".encode())
    arr = np.ascontiguousarray(np.asarray(docs))
    h.update(str((arr.shape, str(arr.dtype))).encode())
    h.update(arr.tobytes())
    h.update(repr(cfg).encode())
    h.update(str((steps, batch, seed)).encode())
    return h.hexdigest()[:20]


def load_checkpoint_numpy(path: str, cfg: BinarizerConfig):
    """The archive as the reference's ``(params, state)`` tree of numpy arrays."""
    layout = leaf_layout(cfg)
    with np.load(path) as z:
        if len(z.files) != len(layout):
            raise ValueError(
                f"{path}: {len(z.files)} leaves, expected {len(layout)} for {cfg}"
            )
        leaves = []
        for i, (_, group, t, name, shape) in enumerate(layout):
            leaf = z[f"leaf_{i:03d}"]
            if leaf.shape != shape:
                raise ValueError(f"{path}: leaf {i} ({group}[{t}].{name}) has shape "
                                 f"{leaf.shape}, expected {shape}")
            leaves.append(leaf)
    return nest_leaves(cfg, leaves)


def load_checkpoint(path: str, cfg: BinarizerConfig, device="cuda") -> RecurrentBinarizer:
    """Load a checkpoint (the port's or the reference's) into an eval-mode
    binarizer on ``device``."""
    params, state = load_checkpoint_numpy(path, cfg)
    return binarizer_from_numpy(params, state, cfg, device)


def _save(path: str, model: RecurrentBinarizer) -> None:
    # np.savez appends ".npz" to names missing it: keep it on the tmp file
    # so the rename target is what was actually written.
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **{f"leaf_{i:03d}": x for i, x in enumerate(numpy_leaves(model))})
    os.replace(tmp, path)


def trained_binarizer(
    docs: np.ndarray,
    cfg: TrainConfig,
    *,
    steps: int = 300,
    batch: int = 256,
    seed: int = 0,
    cache_dir: str | None = None,
    device="cuda",
) -> BinarizerCheckpoint:
    """Train a recurrent-MLP binarizer on ``device``, or reload the cached weights.

    The initial weights come from ``prng.key(seed)`` and the pairs from
    ``pair_batches(docs, seed + 1, batch)``, as the reference's do. On a cache hit the model
    is bit-identical to the run that wrote the checkpoint; a stale or
    corrupt file (wrong leaf count or shape, a truncated archive) is
    treated as a miss and overwritten.
    """
    device = resolve_device(device)
    digest = checkpoint_digest(docs, cfg, steps=steps, batch=batch, seed=seed, device=device)
    root = resolve_cache_dir(cache_dir)
    path = os.path.join(root, f"binarizer-{digest}.npz")
    if os.path.exists(path):
        try:
            model = load_checkpoint(path, cfg.binarizer, device)
            return BinarizerCheckpoint(model, digest, path, False)
        except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
            pass  # fall through to retrain

    state = init_train_state(cfg, prng.key(seed, device), device)
    gen = synthetic.pair_batches(docs, seed + 1, batch, device=device)
    for _ in range(steps):
        a, p = next(gen)
        state, _ = train_step(state, a, p, cfg)

    os.makedirs(root, exist_ok=True)
    _save(path, state.model)
    return BinarizerCheckpoint(state.model.eval(), digest, path, True)

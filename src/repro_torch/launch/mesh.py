"""Leaf layouts of the distributed engine (ports ``repro/launch/mesh.py``).

The reference lays its leaves out as a JAX ``Mesh`` and drives them from
one controller through ``shard_map``. Here a ``LeafMesh`` is the same grid
of named axes over ``torch.device``s, and one process drives every leaf
(``index/engine.py``): no ``torch.distributed``.

Functions, never module-level constants, so importing this module touches
no device. With ``devices=None`` a mesh takes the visible cards and raises
when there are too few (never a silent move to the CPU). An explicit
``devices`` list may repeat a device: ``["cuda:0"] * 4`` puts four leaves
on one card, ``["cpu"] * 8`` is a mesh of eight CPU leaves.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LeafMesh:
    """A grid of leaves: ``shape`` over named ``axes``, one ``torch.device``
    per grid position in row-major order (``devices``)."""

    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        shape = tuple(int(s) for s in self.shape)
        axes = tuple(self.axes)
        devices = tuple(torch.device(d) for d in self.devices)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} do not match")
        if len(devices) != math.prod(shape):
            raise ValueError(f"mesh of shape {shape} needs {math.prod(shape)} devices, "
                             f"got {len(devices)}")
        object.__setattr__(self, "shape", shape)
        object.__setattr__(self, "axes", axes)
        object.__setattr__(self, "devices", devices)

    @property
    def n_leaves(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, axis: str) -> int:
        if axis not in self.axes:
            raise ValueError(f"mesh has no axis {axis!r}; its axes are {self.axes}")
        return self.shape[self.axes.index(axis)]

    def leaf_devices(self, shard_axes: Sequence[str]) -> list:
        """The device of each leaf rank over ``shard_axes``.

        The rank is linearised over the sharded axes in the order given,
        as the reference's engine does with ``axis_index``. A position
        that differs from another only on an unsharded axis holds the same
        shard; the leaf runs at the first such position (0 on every
        unsharded axis).
        """
        sizes = [self.axis_size(ax) for ax in shard_axes]
        where = [self.axes.index(ax) for ax in shard_axes]
        out = [None] * math.prod(sizes)
        for flat, pos in enumerate(itertools.product(*map(range, self.shape))):
            rank = 0
            for size, i in zip(sizes, where):
                rank = rank * size + pos[i]
            if out[rank] is None:
                out[rank] = self.devices[flat]
        return out


def _devices(devices, need: int, message: str) -> list:
    """``devices`` (the visible cards when None), at least ``need`` of them."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if len(devices) < need:
        raise RuntimeError(message.format(have=len(devices)))
    return devices


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> LeafMesh:
    """16x16 single-pod (256 leaves) or 2x16x16 multi-pod (512 leaves).

    Axes: (data, model) or (pod, data, model), as in the reference.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    devs = _devices(devices, n, f"need {n} devices, have {{have}} — pass devices= (a device "
                                "may repeat) to lay the leaves out on fewer cards")
    return LeafMesh(shape, axes, tuple(devs[:n]))


def make_host_mesh(shape=(2, 2), axes=("data", "model"), devices=None) -> LeafMesh:
    """Small mesh over ``devices`` (the visible cards when None)."""
    n = math.prod(shape)
    devs = _devices(devices, n, f"need {n} devices, have {{have}}")
    return LeafMesh(tuple(shape), tuple(axes), tuple(devs[:n]))


def make_replica_meshes(n_replicas: int, shape=(2, 2), axes=("data", "model"),
                        devices=None) -> list:
    """Partition ``devices`` (the visible cards when None) into
    ``n_replicas`` submeshes, consecutive runs of ``prod(shape)`` devices.

    Each submesh is a full serving replica: the engine shards the corpus
    over *its* leaves. Disjointness is the point on distinct cards: one
    replica's failure or saturation leaves the others' capacity untouched.
    From a list that repeats a device (``["cuda:0"] * 8``) the replicas
    share that card: disjointness then holds for the leaf ranks, not for
    the memory, and replicas built from one snapshot share its leaf
    tensors (``launch/lifecycle.EngineBuilder``).
    """
    per = math.prod(shape)
    need = n_replicas * per
    devs = _devices(devices, need,
                    f"need {need} devices ({n_replicas} replicas x {per}), have {{have}}")
    return [LeafMesh(tuple(shape), tuple(axes), tuple(devs[i * per:(i + 1) * per]))
            for i in range(n_replicas)]

"""SPMD execution over a process group: the port's counterpart of GSPMD
and ``shard_map`` (the reference partitions a jitted step with XLA's
GSPMD from its ``NamedSharding``s and writes explicit per-device code
under ``jax.experimental.shard_map``).

Here a ``launch/mesh.LeafMesh`` is bound to a ``DeviceMesh`` of the same
axes over a ``torch.distributed`` process group (``bind``), and a step
runs on ``DTensor``s laid out by the reference's ``parallel/sharding``
specs (``distribute_tree``): DTensor propagates the shardings through
every operator and inserts the collectives a layout change needs, as
GSPMD does. ``shard_map`` runs a function on each rank's local pieces,
where the collectives below are written out by hand.

``fake_mesh`` binds a mesh to a ``"fake"`` process group of as many ranks
as the mesh has leaves, in which this process is rank 0 and every
collective returns at once: with meta tensors, a step at production size
runs with each operator at its per-device shapes and nothing allocated
(``launch/hlo_cost.sharded_step_costs``, ``launch/hillclimb.py``). A real
group (gloo on the CPU, NCCL on the card) runs the same code with values.

The collectives (``all_gather``, ``psum``, ``pmean``, ``all_to_all``)
record their kind, group size and per-device wire bytes at the call, under
the reference's ring model (``repro/launch/dryrun.parse_collectives``):

  * all-reduce: 2 B (g - 1) / g, B the operand's bytes;
  * all-gather: B_out (g - 1) / g;
  * reduce-scatter: B_out (g - 1);
  * all-to-all: B (g - 1) / g;
  * collective-permute: B.

So an all-to-all is counted as one even where the group's backend has
none and it runs as an all-gather (the CPU's). A group of one rank moves
nothing and is not counted, as in the reference.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten

from repro_torch.device import is_dtensor
from repro_torch.launch.mesh import LeafMesh
from repro_torch.parallel.sharding import Sharding
from repro_torch.train.checkpoint import flatten_tree, unflatten_tree

Axes = Union[str, Sequence[str]]

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                    "collective-permute")

_BOUND: Dict[LeafMesh, Any] = {}  # LeafMesh -> (DeviceMesh, its dims' groups of axes)
_RECORDERS: list = []
_EXPLICIT = [0]  # depth of the hand-written collectives being run
_REPLAYING = [0]  # depth of checkpointed regions being recomputed


def wire_bytes(kind: str, nbytes: float, g: int) -> float:
    """Per-device wire bytes of one collective of ``kind`` over ``g`` ranks
    whose per-device result (operand for all-reduce and all-to-all) is
    ``nbytes`` bytes."""
    if kind == "all-reduce":
        return 2.0 * nbytes * (g - 1) / g
    if kind in ("all-gather", "all-to-all"):
        return nbytes * (g - 1) / g
    if kind == "reduce-scatter":
        return float(nbytes * (g - 1))
    if kind == "collective-permute":
        return float(nbytes)
    raise ValueError(f"unknown collective {kind!r}")


class CollectiveLog:
    """Wire bytes and counts by kind of the collectives recorded while it
    is active (``recording``)."""

    def __init__(self):
        self.wire = dict.fromkeys(COLLECTIVE_KINDS, 0.0)
        self.counts = dict.fromkeys(COLLECTIVE_KINDS, 0)
        self.mult = 1

    def add(self, kind: str, nbytes: float, g: int) -> None:
        if g <= 1:
            return
        self.wire[kind] += self.mult * wire_bytes(kind, nbytes, g)
        self.counts[kind] += self.mult

    @contextlib.contextmanager
    def repeat(self, n: int):
        """Each collective recorded inside counts ``n`` times (a loop's body
        run once for ``n`` trips, ``launch/hlo_cost``)."""
        outer = self.mult
        self.mult = outer * n
        try:
            yield
        finally:
            self.mult = outer


@contextlib.contextmanager
def recording(log: CollectiveLog):
    _RECORDERS.append(log)
    try:
        yield log
    finally:
        _RECORDERS.remove(log)


def record(kind: str, nbytes: float, g: int) -> None:
    """Add one collective to every active ``CollectiveLog``."""
    for log in _RECORDERS:
        log.add(kind, nbytes, g)


def _record_own(kind: str, nbytes: float, g: int) -> None:
    """``record`` for a collective that this module issues, except while a
    checkpointed region is replayed (``checkpoint``): the process group's
    operators then return the outputs saved in the forward pass."""
    if not _REPLAYING[0]:
        record(kind, nbytes, g)


def in_explicit() -> bool:
    """True while a hand-written collective runs: the process-group
    operators it issues are already recorded."""
    return _EXPLICIT[0] > 0


@contextlib.contextmanager
def _explicit():
    _EXPLICIT[0] += 1
    try:
        yield
    finally:
        _EXPLICIT[0] -= 1


# ---------------------------------------------------------------------------
# Meshes.
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def bind(mesh: LeafMesh, device_type: Optional[str] = None, merged: Sequence[Sequence[str]] = ()):
    """Bind ``mesh`` to a ``DeviceMesh`` over the live default process group
    (whose size must be ``mesh.n_leaves``); unbound on exit. ``device_type``
    defaults to the mesh's devices' type.

    Each group of ``merged`` (adjacent mesh axes, in mesh order) is one dim
    of the ``DeviceMesh``, of their sizes' product, named by the axes joined
    with "+": a dim split over all of them is split over that one dim in the
    same order (the first axis major), and a collective over all of them is
    one collective over it. A layout or collective that names only some of a
    group's axes raises. DTensor prices each operator's strategies over
    every combination of mesh dims, so a 2x16x16 mesh whose pod and data
    axes always go together (``dp_axes``) runs as 32x16, far faster."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("bind needs a live default process group")
    if dist.get_world_size() != mesh.n_leaves:
        raise ValueError(f"a mesh of {mesh.n_leaves} leaves needs a group of as many ranks, "
                         f"not {dist.get_world_size()}")
    groups, i = [], 0
    starts = {tuple(g)[0]: tuple(g) for g in merged}
    while i < len(mesh.axes):
        g = starts.get(mesh.axes[i], (mesh.axes[i],))
        if tuple(mesh.axes[i:i + len(g)]) != g:
            raise ValueError(f"merged axes {g} are not adjacent in mesh order {mesh.axes}")
        groups.append(g)
        i += len(g)
    device_type = device_type or mesh.devices[0].type
    _register_strategies()
    dm = init_device_mesh(device_type, tuple(math.prod(mesh.axis_size(a) for a in g)
                                             for g in groups),
                          mesh_dim_names=tuple("+".join(g) for g in groups))
    _BOUND[mesh] = (dm, tuple(groups))
    try:
        yield dm
    finally:
        _BOUND.pop(mesh, None)


def axis_groups(mesh: LeafMesh, shardings: Any, args: Any = None,
                microbatches: int = 1) -> Tuple[Tuple[str, ...], ...]:
    """``bind``'s ``merged`` for a step over ``mesh`` whose arguments are laid
    out by the trees ``shardings``: the data-parallel axes (``("pod",
    "data")`` on the multi-pod mesh, ``sharding.dp_axes``) when every spec
    names all of them, in order, or none; else nothing. A step that cuts
    the rows of its last argument (the batch, ``args[-1]``) into
    ``microbatches`` gets nothing too where a microbatch's rows do not
    divide over the merged axes: it is then split over the axes it divides
    (``steps._rows_like``), which a merged dim cannot express."""
    from repro_torch.parallel.sharding import dp_axes

    dp = dp_axes(mesh)
    if len(dp) < 2:
        return ()
    for sh in flatten_tree(shardings).values():
        for d in range(len(sh.spec)):
            named = sh._axes(d)
            hit = [a for a in named if a in dp]
            if hit and (tuple(hit) != dp or tuple(named[named.index(dp[0]):][:len(dp)]) != dp):
                return ()
    if microbatches > 1 and args is not None:
        g = group_size(mesh, dp)
        specs = flatten_tree(shardings[-1])
        for key, t in flatten_tree(args[-1]).items():
            rows = specs[key]._axes(0) if isinstance(t, torch.Tensor) and t.dim() else ()
            if dp[0] in rows and (t.shape[0] // microbatches) % g:
                return ()
    return (dp,)


def _register_strategies() -> None:
    """The hand-written kernels' custom operators' DTensor sharding
    strategies (each module registers its own, once)."""
    from repro_torch.kernels.dot_interact import kernel as dot_interact
    from repro_torch.kernels.sdc import sdc

    dot_interact.register_sharding_strategies()
    sdc.register_sharding_strategies()


@contextlib.contextmanager
def fake_mesh(mesh: LeafMesh, merged: Sequence[Sequence[str]] = ()):
    """A ``"fake"`` process group of ``mesh.n_leaves`` ranks (this process is
    rank 0) and ``mesh`` bound to a CPU ``DeviceMesh`` over it (``merged``
    as ``bind`` takes it); both torn down on exit. The group is process-global state: no default group may
    be alive on entry, and none is left on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a default process group is already alive")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=mesh.n_leaves)
    try:
        with bind(mesh, "cpu", merged) as dm:
            yield dm
    finally:
        dist.destroy_process_group()


def _binding(mesh: LeafMesh):
    bound = _BOUND.get(mesh)
    if bound is None:
        raise RuntimeError("the mesh is not bound to a process group: run under "
                           "spmd.fake_mesh(mesh) or spmd.bind(mesh)")
    return bound


def device_mesh(mesh: LeafMesh):
    """The ``DeviceMesh`` bound to ``mesh`` (``bind``/``fake_mesh``)."""
    return _binding(mesh)[0]


def _dims(mesh: LeafMesh, axes: Sequence[str]) -> list:
    """The bound ``DeviceMesh``'s dims that ``axes`` (in mesh order within a
    merged group) name, each whole; raises if ``axes`` split a group."""
    _, groups = _binding(mesh)
    dims, i = [], 0
    axes = tuple(axes)
    while i < len(axes):
        j = next((j for j, g in enumerate(groups) if g[0] == axes[i]), None)
        if j is None or tuple(axes[i:i + len(groups[j])]) != groups[j]:
            raise ValueError(f"axes {axes} split the bound mesh's merged axes {groups}")
        dims.append(j)
        i += len(groups[j])
    return dims


def is_bound(mesh: LeafMesh) -> bool:
    return mesh in _BOUND


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def group_size(mesh: LeafMesh, axes: Axes) -> int:
    return math.prod(mesh.axis_size(a) for a in _axes(axes))


def _group(mesh: LeafMesh, axes: Axes):
    """The process group of the ranks that differ only on ``axes``: a 1-D
    ``DeviceMesh`` (several axes flattened, the first major)."""
    dm = device_mesh(mesh)
    names = [dm.mesh_dim_names[j] for j in _dims(mesh, _axes(axes))]
    if len(names) == 1:
        return dm[names[0]]
    return dm[tuple(names)]._flatten()


def axis_index(mesh: LeafMesh, axes: Axes) -> int:
    """This rank's index over ``axes`` (the first major), as the reference
    linearises ``jax.lax.axis_index``."""
    dm = device_mesh(mesh)
    idx = 0
    for j in _dims(mesh, _axes(axes)):
        idx = idx * dm.size(j) + dm.get_local_rank(j)
    return idx


# ---------------------------------------------------------------------------
# Layouts.
# ---------------------------------------------------------------------------


def placements(sharding: Sharding) -> tuple:
    """A ``Sharding``'s DTensor placements, one per mesh axis: ``Shard(d)``
    on every axis that splits dim d (a dim split over several axes is
    sharded on each, in mesh order, so the first axis is major, as
    ``Sharding.piece_index`` orders the pieces), ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = sharding.mesh
    groups = _BOUND[mesh][1] if mesh in _BOUND else tuple((a,) for a in mesh.axes)
    out = [Replicate()] * len(groups)
    for d in range(len(sharding.spec)):
        named = sharding._axes(d)
        idx = [mesh.axes.index(a) for a in named]
        if idx != sorted(idx):
            raise ValueError(f"spec {sharding.spec} splits dim {d} over mesh axes out of the "
                             f"mesh's order {mesh.axes}: DTensor nests them in mesh order")
        for j in (_dims(mesh, named) if mesh in _BOUND else idx):
            out[j] = Shard(d)
    return tuple(out)


def distribute(t: torch.Tensor, sharding: Sharding):
    """``t`` laid out by ``sharding`` as a DTensor: each rank keeps its own
    piece of its whole copy (a meta tensor gives meta pieces, nothing
    allocated). An uneven dim is split as ``torch.chunk`` splits it: rank
    0's piece is the ceiling-sized one, the size ``Sharding.shard_shape``
    pads every piece to."""
    from torch.distributed.tensor import distribute_tensor

    sharding.shard_shape(t.shape)  # raises on a spec longer than the tensor's rank
    return distribute_tensor(t, device_mesh(sharding.mesh), placements(sharding),
                             src_data_rank=None)


def distribute_tree(tree: Any, shardings: Any) -> Any:
    """Each tensor leaf of ``tree`` as a DTensor laid out by the ``Sharding``
    at the same key of ``shardings`` (``checkpoint.flatten_tree``'s keys);
    a leaf that is not a tensor is kept as it is."""
    leaves, specs = flatten_tree(tree), flatten_tree(shardings)
    if list(leaves) != list(specs):
        raise ValueError(f"tree and shardings differ: {sorted(set(leaves) ^ set(specs))}")
    return unflatten_tree(tree, [distribute(v, specs[k]) if isinstance(v, torch.Tensor) else v
                                 for k, v in leaves.items()])


def constrain(x, sharding: Sharding, even: bool = False):
    """The reference's ``with_sharding_constraint``: a DTensor is
    redistributed to ``sharding``; a plain tensor is returned as it is,
    after a check that the spec fits its rank. With ``even``, a dim that the
    spec's mesh dims do not divide is split over the part of them it
    divides (the major dims let go, whole), where GSPMD pads it: a
    microbatch of 16 rows over pod x data of 32 is split over data alone."""
    sharding.shard_shape(x.shape)
    if not is_dtensor(x):
        return x
    places = list(placements(sharding))
    if even:
        places = evenly(x.shape, places, x.device_mesh)
    return x.redistribute(x.device_mesh, places)


def evenly(shape, places, dm) -> list:
    """``places`` with, for each dim of ``shape`` that its mesh dims do not
    divide, the major ones of them let go (``Replicate()``) until the rest
    do."""
    from torch.distributed.tensor import Replicate, Shard

    places = list(places)
    for d, n in enumerate(shape):
        split = [i for i, p in enumerate(places) if p == Shard(d)]
        while split and n % math.prod(dm.size(i) for i in split):
            places[split.pop(0)] = Replicate()
    return places


def laid_out_as(y, x):
    """``y`` laid out as ``x`` is, for an elementwise op of the two: a
    partial sum reduced where ``x`` is whole and scattered where ``x`` is
    split, as GSPMD lays out a row-parallel product's output for the
    residual add. DTensor leaves the choice to its strategies, which
    differ between torch releases. ``y`` itself on one device."""
    if not (is_dtensor(y) and is_dtensor(x)) or list(y.placements) == list(x.placements):
        return y
    return y.redistribute(y.device_mesh, x.placements)


def partial_scattered(x, dim: int):
    """DTensor ``x`` with each partial sum reduce-scattered over ``dim``
    (a row-parallel product's output, split for the next product rather
    than reduced whole); ``x`` itself when it holds none."""
    from torch.distributed.tensor import Shard

    if not (is_dtensor(x) and any(p.is_partial() for p in x.placements)):
        return x
    places = [Shard(dim % x.dim()) if p.is_partial() else p for p in x.placements]
    return x.redistribute(x.device_mesh, places)


def shard_map(fn, mesh: LeafMesh, in_specs: Sequence[tuple], out_specs: Union[tuple, Sequence]):
    """``jax.experimental.shard_map(fn, mesh, in_specs, out_specs,
    check_rep=False)`` over ``torch.distributed.tensor.experimental.local_map``:
    each positional argument's tensors are redistributed to its spec of
    ``in_specs`` (one spec a positional argument, for every tensor in it)
    and ``fn`` runs on the local pieces; every tensor of its result is a
    local piece under ``out_specs`` (one spec a member of a tuple result,
    for every tensor in it; one spec for any other result). ``fn`` sees no
    DTensor: its collectives are this module's, over ``mesh``'s axes."""
    from torch.distributed.tensor.experimental import local_map

    def run(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"{len(args)} arguments for {len(in_specs)} in_specs")
        in_pl = [placements(Sharding(mesh, spec)) if isinstance(x, torch.Tensor) else None
                 for a, spec in zip(args, in_specs) for x in tree_flatten(a)[0]]
        results = []

        def kept(*local_args):
            results.append(fn(*local_args))
            return results[-1]

        # local_map wants the result's placements, one a leaf, before it runs:
        # they are resolved from the result once ``fn`` has returned it
        out_pl = _LazyPlacements(mesh, out_specs, results)
        return local_map(kept, out_placements=out_pl, in_placements=tuple(in_pl),
                         device_mesh=device_mesh(mesh), redistribute_inputs=True)(*args)

    return run


class _LazyPlacements(tuple):
    """``out_placements`` for ``local_map`` whose length is the result's
    number of leaves, known once ``fn`` has run: ``local_map`` zips it with
    the flattened result after the call."""

    def __new__(cls, mesh, out_specs, results):
        self = super().__new__(cls)
        self._mesh, self._specs, self._results = mesh, out_specs, results
        return self

    def _resolved(self):
        out, specs = self._results[-1], self._specs
        if isinstance(out, tuple):
            if len(specs) != len(out):
                raise ValueError(f"{len(specs)} out_specs for a result of {len(out)}")
            per = [s for o, s in zip(out, specs) for _ in tree_flatten(o)[0]]
        else:
            per = [specs] * len(tree_flatten(out)[0])
        return tuple(placements(Sharding(self._mesh, s)) for s in per)

    def __iter__(self):
        return iter(self._resolved())

    def __len__(self):
        return len(self._resolved())

    def __getitem__(self, i):
        return self._resolved()[i]


# ---------------------------------------------------------------------------
# Collectives on local pieces (inside shard_map).
# ---------------------------------------------------------------------------


def _wait(t):
    """The result of a functional collective, waited for."""
    return t.wait() if type(t).__name__ == "AsyncCollectiveTensor" else t


def _gather(x, group, axis: int):
    from torch.distributed import _functional_collectives as funcol

    gather = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor
    return _wait(gather(x.contiguous(), axis, group))


def _reduce_scatter(x, group, axis: int):
    from torch.distributed import _functional_collectives as funcol

    scatter = getattr(funcol, "reduce_scatter_single", None) or funcol.reduce_scatter_tensor
    return _wait(scatter(x.contiguous(), "sum", axis, group))


class _AllGather(torch.autograd.Function):
    """Tiled all-gather along ``axis``; its gradient is the reduce-scatter."""

    @staticmethod
    def forward(ctx, x, mesh, axes, axis):
        ctx.mesh, ctx.axes, ctx.axis = mesh, axes, axis
        g = group_size(mesh, axes)
        _record_own("all-gather", x.numel() * x.element_size() * g, g)
        with _explicit():
            return _gather(x, _group(mesh, axes), axis)

    @staticmethod
    def backward(ctx, grad):
        g = group_size(ctx.mesh, ctx.axes)
        _record_own("reduce-scatter", grad.numel() * grad.element_size() // g, g)
        with _explicit():
            return _reduce_scatter(grad, _group(ctx.mesh, ctx.axes), ctx.axis), None, None, None


def all_gather(x: torch.Tensor, mesh: LeafMesh, axes: Axes, axis: int = 0, tiled: bool = True):
    """``jax.lax.all_gather(x, axes, axis=axis, tiled=tiled)``: the pieces of
    every rank over ``axes``, in rank order, concatenated along ``axis``
    (``tiled``) or stacked on a new ``axis``."""
    if not tiled:
        x = x.unsqueeze(axis)
    return _AllGather.apply(x, mesh, _axes(axes), axis)


def psum(x: torch.Tensor, mesh: LeafMesh, axes: Axes) -> torch.Tensor:
    """``jax.lax.psum`` over ``axes`` (not differentiated)."""
    from torch.distributed._functional_collectives import all_reduce

    g = group_size(mesh, axes)
    _record_own("all-reduce", x.numel() * x.element_size(), g)
    with _explicit():
        return _wait(all_reduce(x.contiguous(), "sum", _group(mesh, axes)))


def pmean(x: torch.Tensor, mesh: LeafMesh, axes: Axes) -> torch.Tensor:
    """``jax.lax.pmean`` over ``axes``: ``psum`` / the group's size."""
    return psum(x, mesh, axes) / group_size(mesh, axes)


def _exchange(x, mesh, axes, split_axis: int, concat_axis: int):
    """All-to-all: the ``split_axis`` of ``x`` in g chunks, chunk r sent to
    rank r, the chunks received concatenated along ``concat_axis`` in rank
    order. On the card, NCCL's all-to-all; on a CPU group (which has none),
    an all-gather of the whole of ``x`` and each source's chunk for this
    rank; on meta tensors, the result's shape."""
    g = group_size(mesh, axes)
    c = x.shape[split_axis] // g
    if x.shape[split_axis] % g:
        raise ValueError(f"all_to_all splits dim {split_axis} of {tuple(x.shape)} over {g} ranks")
    out_shape = list(x.shape)
    out_shape[split_axis] = c
    out_shape[concat_axis] = out_shape[concat_axis] * g
    if x.device.type == "meta":
        return x.new_empty(out_shape)
    group = _group(mesh, axes)
    if x.device.type == "cuda":
        from torch.distributed._functional_collectives import all_to_all_single

        y = _wait(all_to_all_single(x.movedim(split_axis, 0).contiguous(), None, None, group))
        pieces = [p.movedim(0, split_axis) for p in y.chunk(g, 0)]
    else:
        whole = _gather(x.unsqueeze(0), group, 0)  # [g, *x.shape]
        me = axis_index(mesh, axes)
        pieces = list(whole.narrow(split_axis + 1, me * c, c).unbind(0))
    return torch.cat(pieces, dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, split_axis, concat_axis):
        ctx.args = (mesh, axes, split_axis, concat_axis)
        _record_own("all-to-all", x.numel() * x.element_size(), group_size(mesh, axes))
        with _explicit():
            return _exchange(x, mesh, axes, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, grad):
        mesh, axes, split_axis, concat_axis = ctx.args
        _record_own("all-to-all", grad.numel() * grad.element_size(), group_size(mesh, axes))
        with _explicit():
            return _exchange(grad, mesh, axes, concat_axis, split_axis), None, None, None, None


def all_to_all(x: torch.Tensor, mesh: LeafMesh, axes: Axes, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axes, split_axis, concat_axis, tiled=True)``:
    ``split_axis`` in g chunks, chunk r to rank r, the chunks received
    concatenated along ``concat_axis`` in rank order; differentiable (its
    gradient is the all-to-all back). The reference's ``tiled=False`` call
    on [g, 1, b] pieces is this one with the same layout of the result."""
    return _AllToAll.apply(x, mesh, _axes(axes), split_axis, concat_axis)


@contextlib.contextmanager
def _replaying(ctx):
    _REPLAYING[0] += 1
    try:
        with ctx:
            yield
    finally:
        _REPLAYING[0] -= 1


_PRODUCTS = ("mm", "addmm", "bmm", "baddbmm")


def _policy(save_products: bool):
    """The selective-checkpoint policy: the process group's operators'
    outputs saved, and the products' where ``save_products``; the rest
    recomputed."""
    from torch.utils.checkpoint import CheckpointPolicy

    def policy(ctx, op, *args, **kwargs):
        if op.namespace in ("_c10d_functional", "_dtensor") or (
                save_products and op.namespace == "aten"
                and op._overloadpacket.__name__ in _PRODUCTS):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def checkpoint(fn, *args, save_products: bool = False):
    """``torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)``
    whose recompute in the backward pass runs no collective again: a
    selective-checkpoint policy saves the outputs of the process group's
    operators (the gathered node states of a layer, a halo's rows), as XLA
    keeps a rematerialised layer's collectives' results, and recomputes the
    rest; the collectives this module issues record nothing while the
    recompute replays them. With ``save_products`` the matrix products'
    outputs are saved too, and only elementwise work is recomputed (where
    the reference's compiled step keeps them). On one device, without
    ``save_products``, it recomputes everything, as the plain checkpoint
    does."""
    from torch.utils.checkpoint import checkpoint as plain
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    def contexts():
        forward, recompute = create_selective_checkpoint_contexts(_policy(save_products))
        return forward, _replaying(recompute)

    return plain(fn, *args, use_reentrant=False, context_fn=contexts)


# ---------------------------------------------------------------------------
# Operators whose sharding DTensor cannot place well by itself.
# ---------------------------------------------------------------------------


def run(fn, args: Tuple[Any, ...], shardings: Tuple[Any, ...]):
    """``fn(*args)`` with each argument laid out by its ``shardings`` tree
    (``distribute_tree``) over a bound mesh, under ``implicit_replication``:
    a plain tensor that the step makes (a constant, a zeros) meets the
    DTensors as a replicated one."""
    from torch.distributed.tensor.experimental import implicit_replication

    with implicit_replication():
        return fn(*(distribute_tree(a, s) for a, s in zip(args, shardings)))


def _as_dtensor(x, dm):
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, dm, [Replicate()] * dm.ndim, run_check=False)


def _from_local(local, dm, places, shape):
    from torch.distributed.tensor import DTensor

    # the whole shape's contiguous strides, computed (an empty tensor of the
    # whole shape would count as memory under a cost counter)
    stride, step = [], 1
    for n in reversed(shape):
        stride.insert(0, step)
        step *= max(n, 1)
    return DTensor.from_local(local, dm, places, run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


def _row_index(table, rows) -> tuple:
    """The index of ``table[...]`` that looks up ``rows``: ``(rows,)`` for a
    table [V, D]; for stacked tables [F, V, D] and ``rows`` [..., F], field f
    in table f."""
    if table.dim() == 2:
        return (rows,)
    return (torch.arange(table.shape[0], device=rows.device), rows)


def _locate_rows(ids, n_rows: int, sizes: Sequence[int]):
    """Where rows ``ids`` of a dim of ``n_rows`` lie when it is split over
    mesh dims of ``sizes`` (in mesh order, the first major, each piece split
    again as ``torch.chunk`` splits it, as DTensor nests them): each id's
    piece coordinate on every such dim, and its offset in its piece."""
    coords, rem, n = [], ids, n_rows
    for size in sizes:
        chunk = (n + size - 1) // size
        k = torch.div(rem, chunk, rounding_mode="floor")
        coords.append(k)
        rem = rem - k * chunk
        n = torch.clamp(n - k * chunk, max=chunk)
    return coords, rem


class _RowTake(torch.autograd.Function):
    """A rank's share of ``table[ids]`` (``_row_index``) when the table's
    rows are split over the mesh dims ``plan.dims`` and it holds ``piece``:
    its piece is first gathered over the dims ``plan.gathered`` (each padded
    to the largest piece, ``plan.pad`` rows), so it holds every piece whose
    coordinates on the other dims are its own; then the ids that fall in
    those rows are looked up, zeros for the others (the sum over the ranks
    of the other dims is the lookup). The gradient goes into those rows by
    ``index_put_(accumulate=True)`` and is reduce-scattered back onto each
    rank's own piece over ``plan.gathered``."""

    @staticmethod
    def forward(ctx, piece, ids, plan):
        rows = piece.dim() - 2
        table = piece
        if plan.gathered:
            g = math.prod(plan.dm.size(i) for i in plan.gathered)
            pad = [0, 0] * (piece.dim() - 1 - rows) + [0, plan.pad - piece.shape[rows]]
            table = torch.nn.functional.pad(piece, pad)
            _record_own("all-gather", table.numel() * table.element_size() * g, g)
            with _explicit():
                table = _gather(table, _mesh_group(plan.dm, plan.gathered), rows)
        coords, rem = _locate_rows(ids.long(), plan.n_rows, [plan.dm.size(i) for i in plan.dims])
        mine = torch.ones(ids.shape, dtype=torch.bool, device=ids.device)
        pos = torch.zeros_like(rem)
        for i, k in zip(plan.dims, coords):
            if i in plan.gathered:
                pos = pos * plan.dm.size(i) + k
            else:
                mine = mine & (k == plan.dm.get_local_rank(i))
        local = torch.where(mine, pos * plan.pad + rem, 0)
        mask = mine.unsqueeze(-1)
        ctx.save_for_backward(local, mask)
        ctx.plan, ctx.shape, ctx.piece = plan, table.shape, piece.shape
        return table[_row_index(table, local)] * mask.to(table.dtype)

    @staticmethod
    def backward(ctx, grad):
        local, mask = ctx.saved_tensors
        plan, rows = ctx.plan, len(ctx.shape) - 2
        out = torch.zeros(ctx.shape, dtype=grad.dtype, device=grad.device)
        idx = torch.broadcast_tensors(*_row_index(out, local))
        g = (grad * mask.to(grad.dtype)).reshape(-1, ctx.shape[-1])
        out.index_put_(tuple(i.reshape(-1) for i in idx), g, accumulate=True)
        if plan.gathered:
            g = math.prod(plan.dm.size(i) for i in plan.gathered)
            _record_own("reduce-scatter", out.numel() * out.element_size() // g, g)
            with _explicit():
                out = _reduce_scatter(out, _mesh_group(plan.dm, plan.gathered), rows)
            out = out.narrow(rows, 0, ctx.piece[rows])
        return out, None, None


class _TakePlan:
    """How ``_RowTake`` finds the rows: the ``DeviceMesh`` ``dm``, the mesh
    dims that split the table's ``n_rows`` rows (mesh order), those of them
    over which the pieces are gathered, and the largest piece's rows."""

    def __init__(self, dm, n_rows: int, dims: Sequence[int], gathered: Sequence[int]):
        self.dm, self.n_rows, self.dims, self.gathered = dm, n_rows, list(dims), list(gathered)
        self.pad = n_rows
        for i in self.dims:
            self.pad = -(-self.pad // dm.size(i))


def _mesh_group(dm, dims):
    """The process group of the ``DeviceMesh`` dims ``dims`` (several
    flattened, the first major)."""
    if len(dims) == 1:
        return dm.get_group(dims[0])
    return dm[tuple(dm.mesh_dim_names[i] for i in dims)]._flatten()


class _SumPartials(torch.autograd.Function):
    """A rank's partial sums summed over the ranks: reduce-scattered along
    ``axis`` over the mesh dims ``scatter`` (one collective over all of
    them), then all-reduced over the dims ``summed`` (one collective over
    all of them). The gradient, laid out as the result, is gathered back
    along ``axis`` over ``scatter``."""

    @staticmethod
    def forward(ctx, x, dm, scatter, axis, summed):
        ctx.dm, ctx.scatter, ctx.axis = dm, scatter, axis
        with _explicit():
            if scatter:
                g = math.prod(dm.size(i) for i in scatter)
                _record_own("reduce-scatter", x.numel() * x.element_size() // g, g)
                x = _reduce_scatter(x, _mesh_group(dm, scatter), axis)
            if summed:
                from torch.distributed._functional_collectives import all_reduce

                _record_own("all-reduce", x.numel() * x.element_size(),
                            math.prod(dm.size(i) for i in summed))
                x = _wait(all_reduce(x.contiguous(), "sum", _mesh_group(dm, summed)))
        return x

    @staticmethod
    def backward(ctx, grad):
        if ctx.scatter:
            g = math.prod(ctx.dm.size(i) for i in ctx.scatter)
            _record_own("all-gather", grad.numel() * grad.element_size() * g, g)
            with _explicit():
                grad = _gather(grad, _mesh_group(ctx.dm, ctx.scatter), ctx.axis)
        return grad, None, None, None, None


def _sum_partials(local, dm, places, back, shape):
    """The DTensor of global ``shape`` whose pieces ``local`` lie as
    ``places``, with each partial sum there summed into ``back``'s
    placement: reduce-scattered where ``back`` splits a dim, then reduced
    over the merged group of the others, one collective each (DTensor
    reduces one mesh dim at a time). An uneven split is left to DTensor."""
    from torch.distributed.tensor import Shard

    partial = [i for i, p in enumerate(places) if p.is_partial()]
    scatter = [i for i in partial if isinstance(back[i], Shard)]
    axes = {back[i].dim for i in scatter}
    if not partial:
        return _from_local(local, dm, places, shape)
    if len(axes) > 1 or (scatter and shape[back[scatter[0]].dim] % math.prod(
            dm.size(i) for i in scatter)):
        return _from_local(local, dm, places, shape).redistribute(dm, back)
    axis = back[scatter[0]].dim if scatter else 0
    out = _SumPartials.apply(local, dm, scatter, axis, [i for i in partial if i not in scatter])
    return _from_local(out, dm, back, shape)


def sharded_take(table, ids):
    """``table[ids]`` for a DTensor ``table`` [V, D] (the rows of an embedding
    table or of node states), or for stacked tables [F, V, D] with ``ids``
    [..., F], field f looked up in table f (the reference's ``vmap`` of the
    lookup over the table axis): the counterpart of GSPMD's gather from a
    row-sharded operand. Per mesh axis:

      * rows split, ids whole: each rank looks up the ids that fall in its
        rows (zeros for the others), a partial sum there;
      * rows and ids split: the smaller piece moves. Where a rank's piece of
        the table is the smaller, the pieces are gathered there (each rank
        then holds the rows of every rank that differs from it only there,
        and looks up its own ids; the gradient is reduce-scattered back);
        else the ids are gathered whole, each rank looks up those in its
        rows, and the partial result is reduce-scattered back to the ids'
        split;
      * columns split and ids whole: the result's last dim stays split;
      * otherwise the table is whole there (gathered if split): the result
        follows the ids, and a whole table looked up by split ids has a
        partial gradient.

    The partial sums are summed at once (``_sum_partials``): one
    reduce-scatter, then one all-reduce over every other such axis (the
    reference's GSPMD reduces a lookup over the whole mesh in one).
    """
    from torch.distributed.tensor import Partial, Replicate, Shard

    dm = table.device_mesh
    rows, last = table.dim() - 2, table.dim() - 1
    ids = _as_dtensor(ids, dm)
    # a rank's piece of the table and of the result (at the ids' split)
    table_piece = table._local_tensor.numel()
    result_piece = ids._local_tensor.numel() * table.shape[-1]
    t_pl, i_pl, o_pl, g_pl, final, dims, gathered = [], [], [], [], [], [], []
    for i, (tp, ip) in enumerate(zip(table.placements, ids.placements)):
        final.append(ip if isinstance(ip, Shard) else Replicate())
        if tp == Shard(rows):
            dims.append(i)
            t_pl.append(tp)
            if isinstance(ip, Shard) and table_piece < result_piece:
                gathered.append(i)
                i_pl.append(ip)
                o_pl.append(ip)
            else:
                i_pl.append(Replicate())
                o_pl.append(Partial())
            g_pl.append(tp)
            continue
        if tp == Shard(last) and isinstance(ip, Replicate):
            t_pl.append(tp)
            i_pl.append(ip)
            o_pl.append(Shard(ids.dim()))
        else:
            t_pl.append(Replicate())
            i_pl.append(ip)
            o_pl.append(ip)
        g_pl.append(Partial() if isinstance(t_pl[-1], Replicate) and isinstance(ip, Shard)
                    else t_pl[-1])
    table = table.redistribute(dm, t_pl)
    ids = ids.redistribute(dm, i_pl)
    plan = _TakePlan(dm, table.shape[rows], dims, gathered)
    local = _RowTake.apply(table.to_local(grad_placements=g_pl), ids.to_local(), plan)
    back = [f if isinstance(o, Partial) else o for o, f in zip(o_pl, final)]
    return _sum_partials(local, dm, o_pl, back, tuple(ids.shape) + (table.shape[-1],))


def stack_alike(xs):
    """``torch.stack(xs, -1)`` of tensors laid out alike; on DTensors, their
    local pieces stacked and laid out as they are, the new last dim whole
    (torch releases' own strategies for the stack differ)."""
    if not is_dtensor(xs[0]):
        return torch.stack(xs, -1)
    x = xs[0]
    if any(list(t.placements) != list(x.placements) for t in xs):
        raise ValueError(f"stack_alike of layouts {[t.placements for t in xs]}")
    local = torch.stack([t.to_local() for t in xs], -1)
    return _from_local(local, x.device_mesh, x.placements, tuple(x.shape) + (len(xs),))


def sharded_segment_sum(rows, segment_ids, num_segments: int):
    """``jax.ops.segment_sum`` of a DTensor ``rows`` [n, ...]: the segment
    ids are laid out as the rows' first dim, each rank sums its own rows,
    and the result is a partial sum (``Partial``) on every mesh axis that
    splits the rows, reduced where it is next needed."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    dm = rows.device_mesh
    seg = _as_dtensor(segment_ids, dm)
    s_pl, o_pl = [], []
    for rp in rows.placements:
        if isinstance(rp, Shard) and rp.dim == 0:
            s_pl.append(Shard(0))
            o_pl.append(Partial())
        else:
            s_pl.append(Replicate())
            o_pl.append(rp if isinstance(rp, Shard) else Replicate())
    seg = seg.redistribute(dm, s_pl)
    local_rows = rows.to_local()
    out = torch.zeros((num_segments,) + tuple(local_rows.shape[1:]), dtype=local_rows.dtype,
                      device=local_rows.device)
    out = out.index_put((seg.to_local().long(),), local_rows, accumulate=True)
    return _from_local(out, dm, o_pl, (num_segments,) + tuple(rows.shape[1:]))


def split_dim(x, dim: int, sizes: Sequence[int]):
    """``x`` with dim ``dim`` split into ``sizes`` (the heads split of an
    attention projection). DTensor splits a sharded dim only where its mesh
    axes divide the first new dim evenly; otherwise those axes are gathered
    first (8 key-value heads over 16 model shards)."""
    dim = dim % x.dim()
    shape = tuple(x.shape[:dim]) + tuple(sizes) + tuple(x.shape[dim + 1:])
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard

        dm = x.device_mesh
        split = [i for i, p in enumerate(x.placements) if isinstance(p, Shard) and p.dim == dim]
        if split and sizes[0] % math.prod(dm.size(i) for i in split):
            x = x.redistribute(dm, [Replicate() if i in split else p
                                    for i, p in enumerate(x.placements)])
    return x.reshape(shape)


def _rank_over(dm, dims) -> int:
    """This rank's index over the ``DeviceMesh`` dims ``dims`` (in mesh
    order, the first major), as DTensor nests a dim split over several."""
    idx = 0
    for i in dims:
        idx = idx * dm.size(i) + dm.get_local_rank(i)
    return idx


def _kv_for_heads(kl, vl, h0: int, n: int, groups: int):
    """The key/value heads that query heads ``h0`` .. ``h0 + n - 1`` use
    (head h uses key/value head h // groups), from ``kl``/``vl`` [B, KV, T,
    hd] holding every key/value head: a slice where the query heads are
    whole groups or lie within one, else one key/value head a query head."""
    first, last = h0 // groups, (h0 + n - 1) // groups
    if n % groups == 0 or groups % n == 0:
        return kl.narrow(1, first, last - first + 1), vl.narrow(1, first, last - first + 1)
    idx = torch.div(torch.arange(h0, h0 + n, device=kl.device), groups, rounding_mode="floor")
    return kl[:, idx], vl[:, idx]


def _reduce_dims(x, dm, dims, op: str):
    """``x`` all-reduced with ``op`` over each ``DeviceMesh`` dim of ``dims``."""
    from torch.distributed._functional_collectives import all_reduce

    for i in dims:
        _record_own("all-reduce", x.numel() * x.element_size(), dm.size(i))
        with _explicit():
            x = _wait(all_reduce(x.contiguous(), op, dm.get_group(i)))
    return x


def _heads_layout(q) -> list:
    """The placements of ``q`` [B, H, ...] with only its batch and heads
    left split, the heads whole where their split is uneven."""
    from torch.distributed.tensor import Replicate, Shard

    dm = q.device_mesh
    keep = [p if isinstance(p, Shard) and p.dim in (0, 1) else Replicate() for p in q.placements]
    if q.shape[1] % math.prod(dm.size(i) for i, p in enumerate(keep) if p == Shard(1)):
        keep = [Replicate() if p == Shard(1) else p for p in keep]
    return keep


def _more_heads(dm, places, n_heads: int, skip=()) -> list:
    """The mesh dims, in mesh order, over which a rank's ``n_heads`` query
    heads are split further by hand: those where the heads are whole
    (``Replicate()`` in ``places``; not in ``skip``) while every rank there
    keeps at least one head (40 heads over 16 model shards, which DTensor
    cannot split: 3 or 2 a shard)."""
    from torch.distributed.tensor import Replicate

    dims, n = [], 1
    for i, p in enumerate(places):
        if isinstance(p, Replicate) and i not in skip and n * dm.size(i) <= n_heads:
            dims.append(i)
            n *= dm.size(i)
    return dims


def _my_heads(dm, dims, n_heads: int) -> Tuple[int, int]:
    """(first, count) of this rank's run of ``n_heads`` heads split over the
    mesh dims ``dims``: the first ``n_heads % g`` ranks (g the dims' size)
    take one more, so rank 0's run is the longest."""
    g = math.prod(dm.size(i) for i in dims)
    r = _rank_over(dm, dims)
    base, extra = divmod(n_heads, g)
    return r * base + min(r, extra), base + (r < extra)


def _padded_heads(ctx, first: int, n_heads: int, hd: int):
    """A rank's context [B, S, n * hd] of heads ``first`` .. ``first + n - 1``
    in place among ``n_heads`` heads, zeros elsewhere: its share of a sum
    over the ranks that split the heads by hand."""
    n = ctx.shape[-1] // hd
    return torch.nn.functional.pad(ctx, (first * hd, (n_heads - first - n) * hd))


def by_heads(attend, q, k, v, groups: int):
    """Grouped-query attention split by query heads: ``attend(q, k, v)``
    with ``q`` [B, H, S, hd] and ``k``/``v`` [B, KV, S, hd] (query head h
    attends with key/value head h // ``groups``) returns the context [B, S,
    H' * hd] of the H' query heads it was given, in their order.

    On plain tensors it is ``attend(q, k, v)``. On DTensors each rank keeps
    its own query heads (the mesh axes that split the heads of ``q`` stay
    split; the batch stays split as it is), gathers ``k`` and ``v`` whole
    over those axes (KV heads are fewer than the query heads, and DTensor
    cannot split 8 of them over 16 shards), takes the key/value heads its
    query heads use and runs ``attend`` on its local pieces. The context
    comes back split over the heads as ``q`` was, ready for the row-parallel
    output projection; the gradients of ``k`` and ``v`` are partial sums
    over the heads' axes, reduced where DTensor next needs them.

    Where the heads are whole on a mesh axis (40 query heads over 16 model
    shards, gathered by ``split_dim``), they are split there by hand
    (``_more_heads``, ``_my_heads``): each rank attends with its own run
    and its context is placed among all the heads with zeros elsewhere, a
    partial sum there that the output projection reduce-scatters onto its
    rows (``matmul``)."""
    if not is_dtensor(q):
        return attend(q, k, v)
    from torch.distributed.tensor import Partial, Replicate, Shard

    dm = q.device_mesh
    B, H, S, hd = q.shape
    keep = _heads_layout(q)
    hdims = [i for i, p in enumerate(keep) if p == Shard(1)]
    q = q.redistribute(dm, keep)
    n_local = H // math.prod(dm.size(i) for i in hdims)
    more = _more_heads(dm, keep, n_local)
    kv = [Replicate() if i in hdims else p for i, p in enumerate(keep)]
    k, v = k.redistribute(dm, kv), v.redistribute(dm, kv)
    grad_kv = [Partial() if i in hdims + more else p for i, p in enumerate(kv)]
    ql = q.to_local(grad_placements=[Partial() if i in more else p for i, p in enumerate(keep)])
    h0 = _rank_over(dm, hdims) * n_local
    first, n = _my_heads(dm, more, n_local) if more else (0, n_local)
    kl, vl = _kv_for_heads(k.to_local(grad_placements=grad_kv),
                           v.to_local(grad_placements=grad_kv), h0 + first, n, groups)
    ctx = attend(ql.narrow(1, first, n) if more else ql, kl, vl)
    out = [Shard(2) if p == Shard(1) else Partial() if i in more else p
           for i, p in enumerate(keep)]
    if more:
        ctx = _padded_heads(ctx, first, n_local, hd)
    return _from_local(ctx, dm, out, (B, S, H * hd))


def decode_by_heads(attend, q, keys, vals, groups: int):
    """One decode step's grouped-query attention over a cache:
    ``attend(q, keys, vals, t0, softmax)`` with ``q`` [B, H, S, hd] and
    ``keys``/``vals`` [B, KV, T, hd] holding cache positions ``t0`` ..
    ``t0 + T - 1`` returns the context [B, S, H' * hd] of the H' query heads
    it was given, with ``softmax(logits)`` over the cache's positions.

    On plain tensors it is ``attend(q, keys, vals, 0, softmax over the last
    dim)``. On DTensors, per mesh axis: where the cache's positions are
    split (the decode cell lays T over the model axis), ``q`` is gathered
    there, each rank attends over its own positions, the softmax's max and
    sum are all-reduced, and the context's partial sums are reduce-scattered
    back to the heads' split (or, where the heads were whole, left to the
    output projection, ``matmul``, which reduces them or reduce-scatters
    them onto its rows);
    where only the heads are split, each rank keeps its query heads and
    takes the key/value heads they use, as ``by_heads`` does; the batch
    stays split as it is. The cache is never moved.

    Where the heads are whole on an axis that does not split the positions
    (heads that do not split evenly, gathered by ``split_dim``), they are
    split there by hand as ``by_heads`` splits them."""
    if not is_dtensor(q):
        return attend(q, keys, vals, 0, lambda x: torch.softmax(x, -1))
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    dm = q.device_mesh
    B, H, S, hd = q.shape
    tdims = [i for i, p in enumerate(keys.placements) if p == Shard(2)]
    qp = _heads_layout(q)
    hdims = [i for i, p in enumerate(qp) if p == Shard(1) and i not in tdims]
    ql = q.redistribute(dm, [Replicate() if i in tdims else p for i, p in enumerate(qp)]).to_local()
    n_local = ql.shape[1]
    more = _more_heads(dm, qp, n_local, skip=tdims)
    kv = [Shard(2) if i in tdims else (Replicate() if i in hdims + more else qp[i])
          for i in range(dm.ndim)]
    keys, vals = keys.redistribute(dm, kv), vals.redistribute(dm, kv)
    _, offset = compute_local_shape_and_global_offset(keys.shape, dm, kv)
    first, n = _my_heads(dm, more, n_local) if more else (0, n_local)
    kl, vl = _kv_for_heads(keys.to_local(), vals.to_local(),
                           _rank_over(dm, hdims) * n_local + first, n, groups)

    def softmax(x):
        e = torch.exp(x - _reduce_dims(torch.amax(x, -1, keepdim=True), dm, tdims, "max"))
        return e / _reduce_dims(torch.sum(e, -1, keepdim=True), dm, tdims, "sum")

    ctx = attend(ql.narrow(1, first, n) if more else ql, kl, vl, offset[2],
                 softmax if tdims else lambda x: torch.softmax(x, -1))
    out = [Shard(2) if p == Shard(1) else Partial() if i in tdims + more else p
           for i, p in enumerate(qp)]
    for i in tdims:
        if qp[i] == Shard(1):
            g = dm.size(i)
            _record_own("reduce-scatter", ctx.numel() * ctx.element_size() // g, g)
            with _explicit():
                ctx = _reduce_scatter(ctx, dm.get_group(i), 2)
    if more:
        ctx = _padded_heads(ctx, first, n_local, hd)
    return _from_local(ctx, dm, out, (B, S, H * hd))


def split_as(x, dim: int, w, wdim: int):
    """DTensor ``x`` with dim ``dim`` split over the mesh axes that split dim
    ``wdim`` of DTensor ``w`` where ``x`` is whole (each rank keeps its own
    slice: nothing moves); ``x`` itself on plain tensors or where there is
    no such axis."""
    from torch.distributed.tensor import Replicate, Shard

    if not (is_dtensor(x) and is_dtensor(w)):
        return x
    places = [Shard(dim % x.dim()) if wp == Shard(wdim % w.dim()) and isinstance(p, Replicate)
              else p for p, wp in zip(x.placements, w.placements)]
    return x if places == list(x.placements) else x.redistribute(x.device_mesh, places)


def one_hot(idx, n: int, dtype, like=None, dim: int = 0):
    """``jax.nn.one_hot(idx, n)``: a comparison with ``arange(n)``, so
    nothing reads the device to size it. For DTensor ``idx`` and ``like``
    the classes are split over the mesh axes that split dim ``dim`` of
    ``like`` where ``idx`` is whole (a rank compares its local ``idx`` with
    its own classes only: the experts a rank holds), and the result is laid
    out as ``idx`` elsewhere."""
    if not (is_dtensor(idx) and is_dtensor(like)):
        return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    dm = idx.device_mesh
    split = [i for i, (p, lp) in enumerate(zip(idx.placements, like.placements))
             if lp == Shard(dim % like.dim()) and isinstance(p, Replicate)]
    cls = [Shard(0) if i in split else Replicate() for i in range(dm.ndim)]
    (count,), (first,) = compute_local_shape_and_global_offset((n,), dm, cls)
    local = idx.to_local()
    out = (local[..., None] == torch.arange(first, first + count, device=local.device)).to(dtype)
    places = [Shard(idx.dim()) if i in split else p for i, p in enumerate(idx.placements)]
    return _from_local(out, dm, places, tuple(idx.shape) + (n,))


def einsum(eq: str, a, b):
    """``torch.einsum(eq, a, b)``; on DTensors, on each rank's local pieces
    as they are laid out (the MoE's dispatch and combine, which DTensor's
    own strategies would gather). On each mesh axis the operands split at
    most one index between them (an index of both split in both); the
    result is split where that index is kept, a partial sum where it is
    summed over, and whole where neither operand is split. An operand whole
    on an axis where the other is split gets a partial sum of its gradient
    there."""
    if not (is_dtensor(a) or is_dtensor(b)):
        return torch.einsum(eq, a, b)
    from torch.distributed.tensor import Partial, Replicate, Shard

    dm = (a if is_dtensor(a) else b).device_mesh
    a, b = _as_dtensor(a, dm), _as_dtensor(b, dm)
    ins, out = eq.replace(" ", "").split("->")
    subs = ins.split(",")
    sizes = {c: n for sub, t in zip(subs, (a, b)) for c, n in zip(sub, t.shape)}
    places, grads = [], ([], [])
    for i in range(dm.ndim):
        split = {sub[p.dim] for sub, t in zip(subs, (a, b))
                 for p in [t.placements[i]] if isinstance(p, Shard)}
        if len(split) > 1 or any(p.is_partial() for p in (a.placements[i], b.placements[i])) or (
                split and any(c in sub and not isinstance(t.placements[i], Shard)
                              for sub, t in zip(subs, (a, b)) for c in split)):
            raise ValueError(f"einsum {eq!r}: operands laid out {a.placements} and "
                             f"{b.placements} split different indices on mesh dim {i}")
        c = next(iter(split), None)
        places.append(Replicate() if c is None else Shard(out.index(c)) if c in out else Partial())
        for g, t in zip(grads, (a, b)):
            g.append(Partial() if c is not None and isinstance(t.placements[i], Replicate)
                     else t.placements[i])
    local = torch.einsum(eq, a.to_local(grad_placements=grads[0]),
                         b.to_local(grad_placements=grads[1]))
    return _from_local(local, dm, places, tuple(sizes[c] for c in out))


def weight_einsum(eq: str, x, w):
    """``einsum(eq, x, w)`` of an activation ``x`` and a weight ``w`` (the
    experts' products), with the weight laid out as FSDP x tensor
    parallelism runs it, as ``matmul`` lays out a projection's weight: on
    each mesh axis ``w`` keeps its split where ``x`` is split alike, or
    whole there (``x`` then takes the same split of a contracted index,
    its local slice, and the product is a partial sum; or the index is
    ``w``'s own, and the product is split over it); where ``x`` splits
    another index, ``w`` is split over it too if it has it and gathered
    otherwise (the FSDP all-gather), unless ``w``'s piece is the larger:
    then ``x`` takes ``w``'s split and the product is laid out back as
    ``x`` was (reduce-scattered, or moved by an all-to-all). ``x``'s partial
    sums are reduced first."""
    if not (is_dtensor(x) and is_dtensor(w)):
        return torch.einsum(eq, x, w)
    from torch.distributed.tensor import Replicate, Shard

    ins, out = eq.replace(" ", "").split("->")
    xs, ws = ins.split(",")
    x = reduced(x)
    x_pl, w_pl, back = list(x.placements), list(w.placements), {}
    # a weight's piece larger than the activation's (decode's few tokens):
    # the activation moves to the weight's split and its product back
    move_x = w._local_tensor.numel() * w.element_size() > \
        x._local_tensor.numel() * x.element_size()
    for i, (xp, wp) in enumerate(zip(x.placements, w.placements)):
        a = xs[xp.dim] if isinstance(xp, Shard) else None
        c = ws[wp.dim] if isinstance(wp, Shard) else None
        if a is None and c is not None and c in xs:
            x_pl[i] = Shard(xs.index(c))
        elif a is not None and a != c and c is not None and move_x:
            x_pl[i] = Shard(xs.index(c)) if c in xs else Replicate()
            back[i] = Shard(out.index(a))
        elif a is not None and a != c:
            w_pl[i] = Shard(ws.index(a)) if a in ws else Replicate()
    if x_pl != list(x.placements):
        x = x.redistribute(x.device_mesh, x_pl)
    if w_pl != list(w.placements):
        w = w.redistribute(w.device_mesh, w_pl)
    y = einsum(eq, x, w)
    if back:
        y = y.redistribute(y.device_mesh, [back.get(i, p) for i, p in enumerate(y.placements)])
    return y


def rowwise(fn, x, *sizes: int):
    """``fn(x)``, a function of each row of the last dim on its own (a sort,
    a top-k) returning tensors whose last dims are ``sizes``; on a DTensor
    whose last dim is whole, run on each rank's local piece, each result
    laid out as ``x`` (DTensor's strategies for the sort's backward scatter
    differ between torch releases: 2.11 gathers the batch)."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import Shard

    last = x.dim() - 1
    if any(isinstance(p, Shard) and p.dim == last for p in x.placements) or any(
            p.is_partial() for p in x.placements):
        raise ValueError(f"rowwise needs the last dim whole and no partial sums, not {x.placements}")
    outs = fn(x.to_local())
    return tuple(_from_local(o, x.device_mesh, x.placements, tuple(x.shape[:-1]) + (n,))
                 for o, n in zip(outs, sizes))


def write_at(dst, dim: int, start: int, src) -> None:
    """``dst[..., start:start + n, ...] = src`` along ``dim`` (n =
    ``src.shape[dim]``), in place: a decode step's keys and values written
    into the cache. On a DTensor ``dst`` whose ``dim`` is split (the cache's
    positions), each rank writes the part that falls in its own positions,
    from ``src`` laid out as ``dst`` but whole along ``dim``; nothing else
    moves."""
    index = (slice(None),) * dim + (slice(start, start + src.shape[dim]),)
    if not is_dtensor(dst):
        dst[index] = src
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    dm = dst.device_mesh
    src = _as_dtensor(src, dm).redistribute(
        dm, [Replicate() if p == Shard(dim) else p for p in dst.placements])
    shape, offset = compute_local_shape_and_global_offset(dst.shape, dm, dst.placements)
    lo, hi = max(start, offset[dim]), min(start + src.shape[dim], offset[dim] + shape[dim])
    if lo < hi:
        dst.to_local().narrow(dim, lo - offset[dim], hi - lo).copy_(
            src.to_local().narrow(dim, lo - start, hi - lo))


def class_nll(logits, labels):
    """``-log_softmax(logits)[..., label]`` in float32 for DTensor ``logits``
    [..., V]: the label's logit is picked on each rank from its own
    classes where the class dim is sharded (the vocabulary-parallel
    cross-entropy), by a one-hot laid out as the logits are, and summed
    over the shards; the log-sum-exp reduces each row's max and sum over
    the shards and never gathers the class dim (``_logsumexp``)."""
    from torch.distributed.tensor import Replicate, Shard

    dm = logits.device_mesh
    x = reduced(logits.to(torch.float32))
    last = x.dim() - 1
    split = [i for i, p in enumerate(x.placements) if isinstance(p, Shard) and p.dim == last]
    lead = [p if isinstance(p, Shard) and p.dim < last else Replicate() for p in x.placements]
    labels = _as_dtensor(labels, dm).redistribute(dm, lead).to_local()
    n_local = x._local_tensor.shape[-1]
    width = -(-x.shape[-1] // math.prod(dm.size(i) for i in split))  # DTensor's chunk
    first = _rank_over(dm, split) * width
    classes = torch.arange(first, first + n_local, device=labels.device)
    onehot = _from_local(labels.unsqueeze(-1) == classes, dm, x.placements, x.shape)
    picked = reduced(torch.sum(torch.where(onehot, x, 0.0), -1))
    return _logsumexp(x) - picked


def diagonal_log_softmax(score, q, items, *cols):
    """``torch.diagonal(torch.log_softmax(score(q, items, *cols), -1))`` for
    DTensors ``q`` [B, ...] and ``items`` [B, ...], where ``score`` gives the
    [B, B] matrix whose entry (i, j) depends on row i of ``q`` and on row j
    of ``items`` and of each of ``cols`` (an in-batch softmax: each row's
    positive is the item on the diagonal).

    Each rank scores its own block of the matrix, nothing gathered: rows of
    ``q`` split as they are, columns (the items) split over every other
    mesh dim; the softmax's max and sum are all-reduced over the columns'
    dims, and each rank picks the diagonal entries that lie in its block, as
    ``class_nll`` picks its own classes. The result [B] is laid out as
    ``q``'s rows; the gradients of ``q`` and ``items`` are partial sums over
    the dims that split the other."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    dm = q.device_mesh
    q = reduced(q)
    rdims = [i for i, p in enumerate(q.placements) if p == Shard(0)]
    cdims = [i for i in range(dm.ndim) if i not in rdims]
    qp = [Shard(0) if i in rdims else Replicate() for i in range(dm.ndim)]
    ip = [Shard(0) if i in cdims else Replicate() for i in range(dm.ndim)]
    q = q.redistribute(dm, qp)
    items, cols = reduced(_as_dtensor(items, dm)).redistribute(dm, ip), [
        reduced(_as_dtensor(c, dm)).redistribute(dm, ip) for c in cols]
    qg = [Partial() if i in cdims else p for i, p in enumerate(qp)]
    ig = [Partial() if i in rdims else p for i, p in enumerate(ip)]
    block = score(q.to_local(grad_placements=qg), items.to_local(grad_placements=ig),
                  *(c.to_local(grad_placements=ig) for c in cols))
    (n_rows,), (row0,) = compute_local_shape_and_global_offset((q.shape[0],), dm, qp)
    (n_cols,), (col0,) = compute_local_shape_and_global_offset((items.shape[0],), dm, ip)
    m = _reduce_dims(torch.amax(block.detach(), -1, keepdim=True), dm, cdims, "max")
    rows = torch.arange(row0, row0 + n_rows, device=block.device)
    diag = rows[:, None] == torch.arange(col0, col0 + n_cols, device=block.device)
    sums = torch.cat([torch.sum(torch.exp(block - m), -1, keepdim=True),
                      torch.sum(torch.where(diag, block, 0.0), -1, keepdim=True)], -1)
    if cdims:
        sums = _SumPartials.apply(sums, dm, [], 0, cdims)
    logp = sums[:, 1] - (torch.log(sums[:, 0]) + m[:, 0])
    return _from_local(logp, dm, qp, (q.shape[0],))


class _LogSumExp(torch.autograd.Function):
    """``torch.logsumexp`` over the last dim of a rank's local piece ``x``
    [..., n] of logits whose last dim (the classes) is split over the
    ``DeviceMesh`` dims ``dims``: the row max over the rank's own classes
    all-reduced (max) over ``dims``, the sum of ``exp(x - max)`` all-reduced
    (sum), ``log(sum) + max``. The gradient, ``exp(x - result)`` times the
    incoming one, is computed on the rank's own classes: nothing gathered,
    one temporary of the piece's size."""

    @staticmethod
    def forward(ctx, x, dm, dims):
        m = _reduce_dims(torch.amax(x, -1), dm, dims, "max")
        s = _reduce_dims(torch.sum((x - m.unsqueeze(-1)).exp_(), -1), dm, dims, "sum")
        out = torch.log(s) + m
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return (x - out.unsqueeze(-1)).exp_().mul_(grad.unsqueeze(-1)), None, None


def _logsumexp(x):
    """``torch.logsumexp(x, -1)`` of DTensor ``x`` (no partial sums) whose
    last dim, the classes, may be split: the vocabulary-parallel
    log-sum-exp of ``_LogSumExp`` on each rank's piece, laid out as ``x``'s
    rows (whole over the dims that split the classes), as GSPMD reduces a
    max and a sum a row for a log-softmax over split classes."""
    from torch.distributed.tensor import Replicate, Shard

    dm, last = x.device_mesh, x.dim() - 1
    split = [i for i, p in enumerate(x.placements) if p == Shard(last)]
    rows = [Replicate() if i in split else p for i, p in enumerate(x.placements)]
    out = _LogSumExp.apply(x.to_local(grad_placements=x.placements), dm, split)
    return _from_local(out, dm, rows, tuple(x.shape[:-1]))


def reduced(x):
    """DTensor ``x`` with each partial sum reduced (``Replicate()``), where
    torch releases would reduce it at different operators; ``x`` itself
    when it holds none or is a plain tensor."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, summed(x.placements))


def summed(placements) -> list:
    """``placements`` with each partial sum reduced (``Replicate()``)."""
    from torch.distributed.tensor import Replicate

    return [Replicate() if p.is_partial() else p for p in placements]


def whole_dims(x, dims):
    """DTensor ``x`` with every mesh axis that splits one of ``dims``
    gathered (``Replicate()``); ``x`` itself when none does or on a plain
    tensor."""
    from torch.distributed.tensor import Replicate, Shard

    if not is_dtensor(x):
        return x
    dims = {d % x.dim() for d in dims}
    places = [Replicate() if isinstance(p, Shard) and p.dim in dims else p
              for p in x.placements]
    return x if places == list(x.placements) else x.redistribute(x.device_mesh, places)


def shared_input(x):
    """DTensor ``x`` [..., K] laid out for several products that read it
    (an attention's q, k and v projections; an FFN's gate and up), as
    ``matmul`` lays out each one's input: every dim between the first and
    the last whole (a split sequence gathered, as Megatron-SP gathers it),
    here once for all of them, as GSPMD gathers a shared operand once. Its
    gradient, the products' partial sums added up, is reduce-scattered back
    once by the gather's backward (``matmul`` leaves it as it comes). ``x``
    itself on a plain tensor or where nothing is split there."""
    if not is_dtensor(x):
        return x
    grad_as(x)
    xg = whole_dims(x, range(1, x.dim() - 1))
    if xg is not x:
        xg.spmd_shared = True  # matmul leaves its gradient as it comes
    return xg


def matmul(x, w):
    """``x @ w`` for a DTensor activation ``x`` [..., K] and weight ``w``
    [K, N], with the weight laid out as FSDP x tensor parallelism runs it
    (a partial ``x``, the context of heads split by hand, reduce-scattered
    onto the weight's split rows):
    on each mesh axis ``w`` keeps its split only where the product can use
    it as it is (the contraction dim where ``x``'s last dim is split alike:
    row parallel; the output dim where ``x`` is whole: column parallel) and
    is gathered elsewhere (the FSDP all-gather of the axes the batch is
    split over); where both are whole, the weight's columns are split.
    DTensor's own choice weighs communication alone and may gather the
    activation, or keep the weight whole over every axis."""
    from torch.distributed.tensor import Replicate, Shard

    if not (is_dtensor(x) and is_dtensor(w)):
        return x @ w
    # the input's gradient (a partial sum where the weight's output dim is
    # split) reduced as the input is laid out, before other gradients of
    # the input add to it: torch releases differ in where they reduce a sum
    # of a partial and a whole gradient. An input gathered for several
    # products (``shared_input``) sums their partial gradients first.
    if not getattr(x, "spmd_shared", False):
        grad_as(x)
    last = x.dim() - 1
    # the product flattens x's leading dims, which DTensor does only where
    # no dim past the first is split: a sequence split (Megatron-SP) is
    # gathered before the product, as Megatron gathers it
    x = whole_dims(x, range(1, last))
    # partial sums are reduce-scattered onto the features where the weight's
    # rows are split (a row-parallel product takes them split) and reduced
    # elsewhere, and features split where the weight's rows are not are
    # gathered: a column-parallel product takes its input whole
    places = [(Shard(last) if rows else Replicate()) if p.is_partial() else
              Replicate() if isinstance(p, Shard) and p.dim == last and not rows else p
              for p, wp in zip(x.placements, w.placements)
              for rows in [isinstance(wp, Shard) and wp.dim == 0]]
    if places != list(x.placements):
        x = x.redistribute(x.device_mesh, places)
    keep, n_cols = [], w.shape[1]
    for i, (wp, xp) in enumerate(zip(w.placements, x.placements)):
        row = isinstance(wp, Shard) and wp.dim == 0 and isinstance(xp, Shard) and xp.dim == last
        col = isinstance(wp, Shard) and wp.dim == 1 and isinstance(xp, Replicate)
        keep.append(wp if row or col else Replicate())
    # where both are whole (a router's weight), the weight's columns are split
    # (its local slice) where they divide: no rank repeats another's product
    n_cols //= math.prod(w.device_mesh.size(i) for i, p in enumerate(keep) if p == Shard(1))
    for i, (wp, xp) in enumerate(zip(keep, x.placements)):
        if isinstance(wp, Replicate) and isinstance(xp, Replicate) \
                and n_cols % w.device_mesh.size(i) == 0:
            keep[i] = Shard(1)
            n_cols //= w.device_mesh.size(i)
    if keep != list(w.placements):
        w = w.redistribute(w.device_mesh, keep)
    return grad_as(x @ w)


def grad_as(y):
    """DTensor ``y`` whose gradient is laid out as ``y`` is (partial sums
    reduced) before it reaches the operator that made ``y``; ``y`` itself
    on a plain tensor. A gradient arrives laid out as the next layer's
    input wants it (a split sequence under Megatron-SP), or as a partial
    sum that torch releases reduce at different operators (the MoE's gate
    values), and the backward of a reshape cannot flatten a split dim
    behind another on every torch (2.11 refuses what 2.13 places)."""
    if is_dtensor(y) and y.requires_grad:
        places = summed(y.placements)
        y.register_hook(lambda g: g if list(g.placements) == places
                        else g.redistribute(g.device_mesh, places))
    return y


def reshape(x, shape):
    """``x.reshape(shape)``; on a DTensor, with its gradient laid out as the
    result is before the reshape's backward (``grad_as``)."""
    y = x.reshape(shape)
    return grad_as(y) if is_dtensor(y) else y

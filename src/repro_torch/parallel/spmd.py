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


def axis_groups(mesh: LeafMesh, shardings: Any) -> Tuple[Tuple[str, ...], ...]:
    """``bind``'s ``merged`` for a step over ``mesh`` whose arguments are laid
    out by the trees ``shardings``: the data-parallel axes (``("pod",
    "data")`` on the multi-pod mesh, ``sharding.dp_axes``) when every spec
    names all of them, in order, or none; else nothing."""
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


def constrain(x, sharding: Sharding):
    """The reference's ``with_sharding_constraint``: a DTensor is
    redistributed to ``sharding``; a plain tensor is returned as it is,
    after a check that the spec fits its rank."""
    sharding.shard_shape(x.shape)
    if not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, placements(sharding))


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
        record("all-gather", x.numel() * x.element_size() * g, g)
        with _explicit():
            return _gather(x, _group(mesh, axes), axis)

    @staticmethod
    def backward(ctx, grad):
        g = group_size(ctx.mesh, ctx.axes)
        record("reduce-scatter", grad.numel() * grad.element_size() // g, g)
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
    record("all-reduce", x.numel() * x.element_size(), g)
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
        record("all-to-all", x.numel() * x.element_size(), group_size(mesh, axes))
        with _explicit():
            return _exchange(x, mesh, axes, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, grad):
        mesh, axes, split_axis, concat_axis = ctx.args
        record("all-to-all", grad.numel() * grad.element_size(), group_size(mesh, axes))
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

    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, dm, places, run_check=False, shape=torch.Size(shape),
                              stride=stride)


class _MaskedTake(torch.autograd.Function):
    """A rank's share of ``table[ids]`` when it holds rows [offset, offset +
    n) of the table: those rows where an id falls in them, zeros elsewhere
    (the sum over the ranks is the lookup). Its gradient goes into the
    rank's own rows by ``index_put_(accumulate=True)``."""

    @staticmethod
    def forward(ctx, table, ids, offset):
        n = table.shape[0]
        rel = ids.long() - offset
        mask = ((rel >= 0) & (rel < n)).unsqueeze(-1)
        rel = rel.clamp(0, max(n - 1, 0))
        ctx.save_for_backward(rel, mask)
        ctx.shape = table.shape
        return table[rel] * mask.to(table.dtype)

    @staticmethod
    def backward(ctx, grad):
        rel, mask = ctx.saved_tensors
        out = torch.zeros(ctx.shape, dtype=grad.dtype, device=grad.device)
        g = (grad * mask.to(grad.dtype)).reshape(-1, ctx.shape[-1])
        out.index_put_((rel.reshape(-1),), g, accumulate=True)
        return out, None, None


def sharded_take(table, ids):
    """``table[ids]`` for a DTensor ``table`` [V, D] (the rows of an embedding
    table or of node states), the counterpart of GSPMD's gather from a
    row-sharded operand. Per mesh axis:

      * rows sharded: the ids are gathered whole on that axis, each rank
        looks up the ids that fall in its rows (zeros for the others) and the
        result is a partial sum there, reduced at once, as GSPMD reduces its
        masked gather: reduce-scattered back to the ids' sharding where the
        ids were sharded on that axis, else all-reduced (so the work after
        the lookup is split as the ids are, and no further);
      * columns sharded: with ids whole there, the result's last dim stays
        sharded; with ids sharded there too, the table is gathered (FSDP);
      * replicated: the result follows the ids.
    """
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    dm = table.device_mesh
    ids = _as_dtensor(ids, dm)
    t_pl, i_pl, o_pl, final = [], [], [], []
    for tp, ip in zip(table.placements, ids.placements):
        final.append(ip if isinstance(ip, Shard) else None)
        if isinstance(tp, Shard) and tp.dim == 0:
            t_pl.append(tp)
            i_pl.append(Replicate())
            o_pl.append(Partial())
        elif isinstance(tp, Shard) and isinstance(ip, Replicate):
            t_pl.append(tp)
            i_pl.append(ip)
            o_pl.append(Shard(ids.dim()))
        else:
            t_pl.append(Replicate())
            i_pl.append(ip)
            o_pl.append(ip)
    table = table.redistribute(dm, t_pl)
    ids = ids.redistribute(dm, i_pl)
    _, offset = compute_local_shape_and_global_offset(table.shape, dm, t_pl)
    local = _MaskedTake.apply(table.to_local(), ids.to_local(), offset[0])
    out = _from_local(local, dm, o_pl, tuple(ids.shape) + (table.shape[1],))
    back = [(f or Replicate()) if isinstance(o, Partial) else o for o, f in zip(o_pl, final)]
    return out if back == o_pl else out.redistribute(dm, back)


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


class _MergeDims(torch.autograd.Function):
    """A reshape that merges dims of a DTensor, whose gradient splits them
    again through ``split_dim`` (DTensor cannot split a sharded dim whose
    shards do not divide the first new dim, as the gradient of the
    attention heads merge must)."""

    @staticmethod
    def forward(ctx, x, dim, n):
        ctx.dim, ctx.sizes = dim, tuple(x.shape[dim:dim + n])
        return x.reshape(tuple(x.shape[:dim]) + (-1,) + tuple(x.shape[dim + n:]))

    @staticmethod
    def backward(ctx, grad):
        return split_dim(grad, ctx.dim, ctx.sizes), None, None


def merge_dims(x, dim: int, n: int):
    """``x`` with its dims ``dim`` .. ``dim + n - 1`` merged into one (a
    reshape; on a DTensor, with the gradient of ``_MergeDims``)."""
    dim = dim % x.dim()
    if is_dtensor(x):
        return _MergeDims.apply(x, dim, n)
    return x.reshape(tuple(x.shape[:dim]) + (-1,) + tuple(x.shape[dim + n:]))


def class_nll(logits, labels):
    """``-log_softmax(logits)[..., label]`` in float32 for DTensor ``logits``
    [..., V], without gathering the class dim where it is sharded (the
    vocabulary-parallel cross-entropy): the log-sum-exp reduces over the
    shards (DTensor's partial max and sum), and the label's logit is picked
    by a one-hot laid out as the logits' class dim is."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    dm = logits.device_mesh
    x = logits.to(torch.float32)
    last = x.dim() - 1
    classes = torch.arange(x.shape[-1], device=x._local_tensor.device)
    places = [Shard(0) if isinstance(p, Shard) and p.dim == last else Replicate()
              for p in x.placements]
    classes = distribute_tensor(classes, dm, places, src_data_rank=None)
    labels = _as_dtensor(labels, dm)
    picked = torch.sum(torch.where(labels.unsqueeze(-1) == classes, x, 0.0), -1)
    return torch.logsumexp(x, -1) - picked




def whole_dims(x, dims):
    """DTensor ``x`` with every mesh axis that splits one of ``dims``
    gathered (``Replicate()``); ``x`` itself when none does."""
    from torch.distributed.tensor import Replicate, Shard

    dims = {d % x.dim() for d in dims}
    places = [Replicate() if isinstance(p, Shard) and p.dim in dims else p
              for p in x.placements]
    return x if places == list(x.placements) else x.redistribute(x.device_mesh, places)


def matmul(x, w):
    """``x @ w`` for a DTensor activation ``x`` [..., K] and weight ``w``
    [K, N], with the weight laid out as FSDP x tensor parallelism runs it:
    on each mesh axis ``w`` keeps its split only where the product can use
    it as it is (the contraction dim where ``x``'s last dim is split alike:
    row parallel; the output dim where ``x`` is whole: column parallel) and
    is gathered elsewhere (the FSDP all-gather of the axes the batch is
    split over). DTensor's own choice weighs communication alone and may
    gather the activation, or keep the weight whole over every axis."""
    from torch.distributed.tensor import Replicate, Shard

    if not (is_dtensor(x) and is_dtensor(w)):
        return x @ w
    last = x.dim() - 1
    # the product flattens x's leading dims, which DTensor does only where
    # no dim past the first is split: a sequence split (Megatron-SP) is
    # gathered before the product, as Megatron gathers it
    x = whole_dims(x, range(1, last))
    keep = []
    for wp, xp in zip(w.placements, x.placements):
        row = isinstance(wp, Shard) and wp.dim == 0 and isinstance(xp, Shard) and xp.dim == last
        col = isinstance(wp, Shard) and wp.dim == 1 and isinstance(xp, Replicate)
        keep.append(wp if row or col else Replicate())
    if keep != list(w.placements):
        w = w.redistribute(w.device_mesh, keep)
    return x @ w

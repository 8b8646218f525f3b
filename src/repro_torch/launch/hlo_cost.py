"""Cost of one step: FLOPs, bytes and peak live bytes (the counterpart of
``repro/launch/hlo_cost.py``).

The reference walks the post-SPMD HLO text of a compiled step and
multiplies each while-loop body by its trip count. The port has no HLO: it
runs the step eagerly, usually on meta tensors (``launch/dryrun.py``), and
counts what is dispatched, every loop iteration as it runs, but for one
loop: a step's microbatches on meta tensors run their first trip and their
second, which counts for the rest (``_Counter.repeat``, asked for by
``train/steps._accumulate_grads``; the counts equal those of every trip,
tested). ``step_costs`` counts:

  * ``flops``: the products, 2 x M x N x K per matrix product (the
    reference's ``_dot_flops``), from ``torch.utils.flop_counter``'s
    formulas, plus the formula each hand-written kernel registers (the
    DLRM interaction's custom operator);
  * ``bytes``: each dispatched operator's tensor operands plus its
    results, skipping views, reshapes and uninitialised allocations (as the
    reference's ``_SKIP_BYTES_OPS`` skips bitcasts and reshapes). These are
    eager bytes: with no fusion, every intermediate counts as written and
    read again, which a fused program would not do;
  * ``unsharded_peak_bytes``: the most bytes alive at once, the arguments
    included, in the step as one device runs it whole. This is not a
    per-device figure of a sharded step.

Only the products count as FLOPs, as in the reference: elementwise work
and reductions are in ``bytes``.

``sharded_step_costs`` is the counterpart of the reference's per-device
record of a partitioned step: it runs the step on DTensors over a fake
process group (``parallel/spmd.py``) and counts the operators each rank
runs on its local pieces, so ``flops``, ``bytes`` and ``peak_bytes`` are
per device, and ``collectives`` holds the wire bytes and counts of every
collective by kind (the hand-written ones as they are called, those that
DTensor inserts from the process-group operators it issues).
"""

from __future__ import annotations

import contextlib
import os
import traceback
import weakref
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils.flop_counter import flop_registry

from repro_torch.device import is_dtensor
from repro_torch.parallel import spmd

_aten = torch.ops.aten
# operators that move no bytes: allocations whose contents are never read
# before written, and aliases (every view operator is skipped too)
_SKIP_BYTES_OPS = {
    _aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
    _aten.new_empty.default, _aten.new_empty_strided.default, _aten._unsafe_view.default,
    _aten.detach.default, _aten.alias.default, _aten.lift_fresh.default,
}


def _tensor_bytes(xs) -> int:
    """Bytes of the tensors in ``xs`` and in its lists and tuples (one level)."""
    n = 0
    for x in xs:
        if isinstance(x, torch.Tensor):
            n += x.numel() * x.element_size()
        elif isinstance(x, (list, tuple)):
            n += sum(t.numel() * t.element_size() for t in x if isinstance(t, torch.Tensor))
    return n


def _signature(x):
    """A hashable key of an operator argument (a meta tensor's shape, strides
    and dtype); TypeError for a tensor that is not on the meta device or a
    value that cannot be hashed."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise TypeError("not a meta tensor")
        return (x.shape, x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_signature(v) for v in x)
    hash(x)
    return x


def _mv_flops(a, b, *args, out_val=None, **kwargs) -> int:
    """A matrix-vector product: 2 x M x K (``flop_counter`` has no formula for it)."""
    return 2 * a.shape[0] * a.shape[1]


def _dot_flops(a, b, *args, out_val=None, **kwargs) -> int:
    return 2 * a.shape[0]


_FLOPS = {_aten.mv: _mv_flops, _aten.dot: _dot_flops}


class _Counter(TorchDispatchMode):
    """Per operator: its FLOPs (``flop_counter``'s formula for it, if any),
    its operand and result bytes, and the bytes of the storages alive (each
    storage counted once, from its first sight until it is freed).

    A functional operator (no mutation, no alias, tensor results) whose
    tensor arguments and results are all meta tensors has results that
    depend only on its arguments' shapes, strides, dtypes and other values,
    so they are computed once per signature and then made with
    ``empty_strided``: many of the meta kernels are Python reference
    implementations, and a deep model repeats the same signatures layer
    after layer.
    """

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.mult = 1
        self.live = 0
        self.peak = 0
        self._alive: Dict[int, Any] = {}
        self._moves_bytes: Dict[Any, bool] = {}
        self._functional: Dict[Any, bool] = {}
        self._results: Dict[Any, Any] = {}

    # ``steps._accumulate_grads`` asks for this: a loop over meta
    # microbatches runs its body once under ``repeat``
    counts_loops = True

    @contextlib.contextmanager
    def repeat(self, n: int):
        """Count what runs inside ``n`` times: a loop's body that runs once
        for a loop of ``n`` identical trips (the microbatches of a step on
        meta tensors), as the reference multiplies a while loop's body by its
        trip count. The most bytes alive are the body's, once."""
        outer = self.mult
        self.mult = outer * n
        try:
            yield
        finally:
            self.mult = outer

    def track(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = id(s)
        if key in self._alive:
            return
        n = s.nbytes()
        self._alive[key] = (n, weakref.ref(s, lambda _r, key=key: self._free(key)))
        self.live += n
        if self.live > self.peak:
            self.peak = self.live

    def _free(self, key: int) -> None:
        n, _ = self._alive.pop(key, (0, None))
        self.live -= n

    def _call(self, func, args, kwargs):
        """``func``'s result, from the signature memo where it applies."""
        functional = self._functional.get(func)
        if functional is None:
            schema = func._schema
            functional = self._functional[func] = not schema.is_mutable and bool(
                schema.returns) and all(r.alias_info is None and str(r.type) == "Tensor"
                                        for r in schema.returns)
        if not functional:
            return func(*args, **kwargs)
        try:
            key = (func, _signature(args), _signature(tuple(sorted(kwargs.items()))))
        except TypeError:  # a tensor off the meta device, or an unhashable value
            return func(*args, **kwargs)
        specs = self._results.get(key)
        if specs is None:
            out = func(*args, **kwargs)
            results = out if isinstance(out, tuple) else (out,)
            if all(t.device.type == "meta" for t in results):
                self._results[key] = (isinstance(out, tuple),
                                      tuple((t.shape, t.stride(), t.dtype) for t in results))
            return out
        many, specs = specs
        outs = tuple(torch.empty_strided(shape, stride, dtype=dtype, device="meta")
                     for shape, stride, dtype in specs)
        return outs if many else outs[0]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._call(func, args, kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        self.ops += self.mult
        formula = flop_registry.get(func._overloadpacket) or _FLOPS.get(func._overloadpacket)
        if formula is not None:
            self.flops += self.mult * formula(*args, **kwargs, out_val=out)
        moves = self._moves_bytes.get(func)
        if moves is None:
            moves = self._moves_bytes[func] = func not in _SKIP_BYTES_OPS and not func.is_view
        results = out if isinstance(out, (list, tuple)) else (out,)
        if moves:
            self.bytes += self.mult * (_tensor_bytes(args) + _tensor_bytes(kwargs.values())
                                       + _tensor_bytes(results))
        for t in results:
            if isinstance(t, torch.Tensor):
                self.track(t)


def step_costs(fn, *args) -> Dict[str, Any]:
    """Run ``fn(*args)`` once, counting; returns ``flops``, ``bytes``,
    ``unsharded_peak_bytes``, ``unsharded_argument_bytes`` (the arguments'
    storages, each once) and ``ops`` (operators dispatched)."""
    counter = _Counter()
    for t in tree_flatten(args)[0]:
        if isinstance(t, torch.Tensor):
            counter.track(t)
    arg_bytes = counter.live
    with counter:
        out = fn(*args)
    del out
    return {
        "flops": int(counter.flops),
        "bytes": int(counter.bytes),
        "unsharded_peak_bytes": int(counter.peak),
        "unsharded_argument_bytes": int(arg_bytes),
        "ops": counter.ops,
    }


# The process-group operators DTensor issues, by the collective each is.
_C10D_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}


# what DTensor raises for an operator it cannot place: no strategy
# (NotImplementedError), a propagation or view it cannot derive
# (RuntimeError, AssertionError, ValueError, IndexError)
_PROPAGATION_ERRORS = (NotImplementedError, RuntimeError, AssertionError, ValueError, IndexError)


def _is_fake(*groups) -> bool:
    """True if a tensor in ``groups`` (sequences of operator arguments or
    results, lists and tuples in them looked into once) is a fake tensor."""
    from torch._subclasses.fake_tensor import FakeTensor

    for xs in groups:
        for x in xs:
            if isinstance(x, FakeTensor):
                return True
            if isinstance(x, (list, tuple)) and any(isinstance(t, FakeTensor) for t in x):
                return True
    return False


def _device_type(*groups):
    """The device type of the first tensor in ``groups`` (sequences of
    operator arguments or results, lists in them looked into once)."""
    for xs in groups:
        for x in xs:
            if isinstance(x, torch.Tensor):
                return x.device.type
            if isinstance(x, (list, tuple)):
                for t in x:
                    if isinstance(t, torch.Tensor):
                        return t.device.type
    return None


def _dkey(x):
    """A hashable key of an argument of an operator on DTensors: a DTensor's
    global and local shapes, strides, dtype and placements, a plain meta
    tensor's shape, strides and dtype; TypeError for anything else that
    cannot be hashed or that holds values (a tensor off the meta device)."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        local = x._local_tensor
        if local.device.type != "meta":
            raise TypeError("not a meta DTensor")
        return ("D", x.shape, x.stride(), x.dtype, x.placements, id(x.device_mesh),
                local.shape, local.stride())
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise TypeError("not a meta tensor")
        return ("T", x.shape, x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_dkey(v) for v in x)
    hash(x)
    return x


class _Uncounted:
    """One of the sharding propagator's entry points, run with the counter's
    propagation depth raised (``_ShardedCounter.not_counting_propagation``);
    its other attributes (a cache's ``cache_info``) are the wrapped one's."""

    def __init__(self, fn, counter):
        self._fn, self._counter = fn, counter

    def __call__(self, *args, **kwargs):
        self._counter._propagating += 1
        try:
            return self._fn(*args, **kwargs)
        finally:
            self._counter._propagating -= 1

    def __getattr__(self, name):
        return getattr(self._fn, name)


class _ShardedCounter(_Counter):
    """``_Counter`` over a step on DTensors: an operator on DTensors is let
    through to DTensor, which runs it on the local pieces, and those
    operators are counted. DTensor's sharding propagation runs each new
    operator once on fake tensors of the global shapes to learn the result's
    shape (``not_counting_propagation``), and its device mesh computes ranks
    on CPU tensors; those operators are not counted.

    An operator whose sharding DTensor cannot propagate (no strategy, or a
    layout it cannot derive) runs on replicated operands instead: its
    DTensor operands are redistributed to ``Replicate()`` (the collectives
    that takes are counted) and it runs whole on each rank's local copies,
    its results replicated, as GSPMD falls back to replicating an operand
    it cannot partition. A written operand
    is laid out again as it was. ``replicated`` counts these operators, and
    ``replicated_at`` says, for each, where it was first called from (the
    innermost line outside torch and the counter), its DTensor operands'
    shapes and placements, and why DTensor could not place it."""

    @contextlib.contextmanager
    def repeat(self, n: int):
        with super().repeat(n), self.log.repeat(n):
            yield

    def __init__(self, log: "spmd.CollectiveLog", device_type: str):
        super().__init__()
        self.replicated: Dict[str, int] = {}
        self.replicated_at: Dict[str, str] = {}
        self._through = False
        self.log = log
        self.device_type = device_type
        self._memo: Dict[Any, Any] = {}
        self._propagating = 0
        # the arguments' pieces no operator has read yet: id -> bytes (each
        # piece, alive throughout, is an operand of the first operator that
        # reads it or a view of it)
        self.unread: Dict[int, int] = {}

    def _read(self, args, kwargs) -> None:
        """The arguments' pieces among an operator's operands are read."""
        for x in (*args, *kwargs.values()):
            for t in (x if isinstance(x, (list, tuple)) else (x,)):
                self.unread.pop(id(getattr(t, "_local_tensor", t)), None)

    @contextlib.contextmanager
    def not_counting_propagation(self):
        """While active, DTensor's sharding propagation runs uncounted: the
        operators it runs to learn a result's layout (fake tensors of the
        global shapes, a shard's size and offset on meta tensors, and the
        meta tensors of the global shapes that a strategy derived from an
        operator's decomposition runs on) are not the step's, and they run
        only the first time a signature is seen. Each of the propagator's
        entry points is wrapped: torch releases enter it at different ones
        (2.13's dispatch calls the cached ``propagate_op_sharding`` or
        ``propagate_op_sharding_non_cached`` itself)."""
        from torch.distributed.tensor import DTensor

        prop = DTensor._op_dispatcher.sharding_propagator
        names = [n for n in ("propagate", "propagate_op_sharding",
                             "propagate_op_sharding_non_cached") if hasattr(prop, n)]
        own = {n: prop.__dict__[n] for n in names if n in prop.__dict__}
        for n in names:
            setattr(prop, n, _Uncounted(getattr(prop, n), self))
        try:
            yield
        finally:
            for n in names:
                if n in own:
                    setattr(prop, n, own[n])
                else:
                    delattr(prop, n)  # back to the class's method

    def _totals(self):
        return (self.flops, self.bytes, self.ops, dict(self.log.wire), dict(self.log.counts),
                dict(self.replicated))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if self._through:  # DTensor's own dispatch of the operator
                self._through = False
                return NotImplemented
            if self.unread:
                self._read(args, kwargs)
            return self._dtensor_call(func, args, kwargs)
        if self._propagating or _is_fake(args, kwargs.values()):
            return func(*args, **kwargs)  # sharding propagation's own work
        if self.unread:
            self._read(args, kwargs)
        out = self._call(func, args, kwargs)
        results = out if isinstance(out, (list, tuple)) else (out,)
        if _is_fake(results) or _device_type(args, results) != self.device_type:
            # shape inference, or DTensor's own bookkeeping (the device mesh's
            # rank tensors are CPU tensors): not the step's work
            return out
        self._count(func, args, kwargs, out)
        kind = _C10D_KINDS.get(func._overloadpacket.__name__)
        if kind is not None and func.namespace in ("_c10d_functional", "_dtensor") \
                and not spmd.in_explicit():
            self._record(kind, func, args, out)
        return out

    @staticmethod
    def _record(kind, func, args, out) -> None:
        from torch.distributed.distributed_c10d import _resolve_process_group

        name = args[-1]
        g = _resolve_process_group(name).size()
        res = out[0] if isinstance(out, (list, tuple)) else out
        operand = args[0]
        nbytes = (operand if kind in ("all-reduce", "all-to-all") else res)
        spmd.record(kind, nbytes.numel() * nbytes.element_size(), g)

    def _run(self, func, args, kwargs):
        with self:
            self._through = True
            try:
                return func(*args, **kwargs)
            finally:
                self._through = False

    def _dtensor_call(self, func, args, kwargs):
        """``func`` on DTensors, through the memo below where it applies.

        A functional operator whose arguments are meta DTensors and meta
        tensors has results, local operators and collectives that depend only
        on its arguments' shapes, layouts and other values: the first call of
        a signature runs and records what it added to every total (and the
        most bytes it had alive at once beyond what it returns); a later call
        adds the same and makes the results' DTensors with their layouts, as
        ``_Counter`` reuses a functional meta operator's result shapes. A
        deep model repeats the same signatures layer after layer."""
        from torch.distributed.tensor import DTensor

        try:
            key = (func, _dkey(args), _dkey(tuple(sorted(kwargs.items()))))
        except TypeError:
            key = None
        if key is not None:
            functional = self._functional.get(func)
            if functional is None:
                schema = func._schema
                functional = self._functional[func] = not schema.is_mutable and bool(
                    schema.returns) and all(r.alias_info is None and str(r.type) == "Tensor"
                                            for r in schema.returns)
            if not functional:
                key = None
        if key is not None and key in self._memo:
            return self._replay(self._memo[key])
        if key is None:
            return self._dtensor_run(func, args, kwargs)
        before, live, peak = self._totals(), self.live, self.peak
        self.peak = live
        out = self._dtensor_run(func, args, kwargs)
        results = out if isinstance(out, tuple) else (out,)
        after = self._totals()
        transient = self.peak - live
        self.peak = max(peak, self.peak)
        if all(isinstance(t, DTensor) and t._local_tensor.device.type == "meta" for t in results):
            m = self.mult  # the memo keeps one call's share
            delta = tuple((after[i] - before[i]) // m for i in range(3)) + tuple(
                {k: (after[i][k] - before[i].get(k, 0)) / m for k in after[i]}
                for i in (3, 4)) + ({k: after[5][k] - before[5].get(k, 0) for k in after[5]},)
            specs = tuple((t._spec, t._local_tensor.shape, t._local_tensor.stride())
                          for t in results)
            self._memo[key] = (delta, transient, isinstance(out, tuple), specs)
        return out

    def _replay(self, entry):
        from torch.distributed.tensor import DTensor

        (flops, nbytes, ops, wire, counts, replicated), transient, many, specs = entry
        m = self.mult
        self.flops += m * flops
        self.bytes += m * nbytes
        self.ops += m * ops
        for k, v in wire.items():
            self.log.wire[k] += m * v
        for k, v in counts.items():
            self.log.counts[k] += round(m * v)
        for k, v in replicated.items():
            if v:
                self.replicated[k] = self.replicated.get(k, 0) + v
        self.peak = max(self.peak, self.live + transient)
        outs = []
        for spec, shape, stride in specs:
            local = torch.empty_strided(shape, stride, dtype=spec.tensor_meta.dtype,
                                        device="meta")
            self.track(local)
            outs.append(DTensor(local, spec, requires_grad=False))
        return tuple(outs) if many else outs[0]

    def _dtensor_run(self, func, args, kwargs):
        try:
            return self._run(func, args, kwargs)
        except _PROPAGATION_ERRORS as err:  # retried replicated, re-raised if that fails
            first = err
        from torch.distributed.tensor import DTensor, Replicate

        flat, spec = tree_flatten((args, kwargs))
        with self, torch.no_grad():
            whole = [_laid_out(x, [Replicate()] * x.device_mesh.ndim)
                     if isinstance(x, DTensor) else x for x in flat]
        # every rank holds the whole of each operand: run the operator on
        # those local tensors (no strategy needed) and call the results
        # replicated
        mesh = next(x.device_mesh for x in whole if isinstance(x, DTensor))
        largs, lkwargs = tree_unflatten(
            [x._local_tensor if isinstance(x, DTensor) else x for x in whole], spec)
        try:
            with self, torch.no_grad():
                local_out = func(*largs, **lkwargs)
        except _PROPAGATION_ERRORS as again:
            raise RuntimeError(f"{func} fails sharded ({type(first).__name__}: {first}) and "
                               f"replicated ({type(again).__name__}: {again})") from first
        by_local = {id(x._local_tensor): x for x in whole if isinstance(x, DTensor)}
        flat_local, out_spec = tree_flatten(local_out)
        out = tree_unflatten([by_local.get(id(t)) or _replicated(t, mesh)
                              if isinstance(t, torch.Tensor) else t for t in flat_local],
                             out_spec)
        name = str(func)
        self.replicated[name] = self.replicated.get(name, 0) + 1
        if name not in self.replicated_at:
            self.replicated_at[name] = _replicated_note(flat, first)
        if not func._schema.is_mutable:
            return out
        # put every written operand back in its own layout
        flat_out, out_spec = tree_flatten(out)
        with self, torch.no_grad():
            for orig, rep in zip(flat, whole):
                if rep is orig or not isinstance(orig, DTensor):
                    continue
                orig._local_tensor.copy_(_laid_out(rep, orig.placements)._local_tensor)
                flat_out = [orig if o is rep else o for o in flat_out]
        return tree_unflatten(flat_out, out_spec)


def _step_line() -> str:
    """The innermost line of the stack outside torch, this module and
    ``parallel/spmd.py``: the step's line that is running."""
    own = (os.sep + "torch" + os.sep, os.path.join("launch", "hlo_cost.py"),
           os.path.join("parallel", "spmd.py"))
    return next((f"{os.path.basename(f.filename)}:{f.lineno} {f.line}"
                 for f in reversed(traceback.extract_stack())
                 if not any(o in f.filename for o in own)), "?")


def _replicated_note(operands, err) -> str:
    """Where the operator that DTensor could not place was called from, its
    DTensor operands' shapes and placements, and DTensor's error."""
    from torch.distributed.tensor import DTensor

    where = _step_line()
    placed = [(tuple(x.shape), tuple(str(p) for p in x.placements))
              for x in operands if isinstance(x, DTensor)]
    why = str(err).splitlines()[0][:200] if str(err) else type(err).__name__
    return f"at {where}; operands {placed}; {why}"


def _replicated(local, mesh):
    """A DTensor that every rank of ``mesh`` holds whole as ``local``."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta

    spec = DTensorSpec(mesh, (Replicate(),) * mesh.ndim,
                       tensor_meta=TensorMeta(local.shape, local.stride(), local.dtype))
    return DTensor(local, spec, requires_grad=False)


def _laid_out(x, placements):
    """DTensor ``x`` redistributed to ``placements`` through DTensor's own
    local transform (its collectives are the process group's operators,
    counted as such), not ``DTensor.redistribute``, whose autograd function
    dispatches operators on DTensors of its own (which a counter in the
    middle of an operator must not see again)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._redistribute import redistribute_local_tensor

    target = DTensorSpec(x.device_mesh, tuple(placements), tensor_meta=x._spec.tensor_meta)
    local = redistribute_local_tensor(x._local_tensor, x._spec, target)
    return DTensor(local, target, requires_grad=False)


def sharded_step_costs(fn, args, shardings, mesh) -> Dict[str, Any]:
    """Per-device costs of ``fn(*args)`` with each argument laid out by its
    ``shardings`` tree over ``mesh`` (a ``launch/mesh.LeafMesh``): the
    arguments (meta tensors, or real ones on a real group) become DTensors
    and the step runs once on them. Under a fake process group when
    ``mesh`` is not bound to a group already (``spmd.bind``), the
    data-parallel axes merged into one dim where the arguments' layouts
    and the step's microbatches (its ``microbatches`` attribute, as
    ``train/steps.make_train_step`` sets it) allow (``spmd.axis_groups``).

    Returns ``flops``, ``bytes`` and ``peak_bytes`` (the most bytes alive
    at once, the pieces of the arguments that the step reads included, as
    the reference's compiled step holds the arguments ``jax.jit`` keeps:
    an unused one is pruned) per device;
    ``argument_bytes`` (one device's pieces of the arguments);
    ``collectives`` (per-device wire bytes by kind) and ``counts``
    (collectives by kind); ``ops`` (operators run on local pieces); and
    ``replicated`` (operators run on replicated operands, by name, see
    ``_ShardedCounter``) and ``replicated_at`` (where each was called); and
    ``strided`` (redistributions of a strided layout, by the step's line,
    ``_strided_redistributions``)."""
    from torch.distributed.tensor.experimental import implicit_replication

    owned = contextlib.nullcontext() if spmd.is_bound(mesh) else spmd.fake_mesh(
        mesh, spmd.axis_groups(mesh, shardings, args, getattr(fn, "microbatches", 1)))
    log = spmd.CollectiveLog()
    strided: Dict[str, int] = {}
    with owned, implicit_replication(), spmd.recording(log), _alltoall_as_one(), \
            _strided_redistributions(strided):
        dargs = tuple(spmd.distribute_tree(a, s) for a, s in zip(args, shardings))
        locals_ = [t._local_tensor if is_dtensor(t) else t
                   for t in tree_flatten(dargs)[0] if isinstance(t, torch.Tensor)]
        counter = _ShardedCounter(log, locals_[0].device.type if locals_ else "meta")
        for t in locals_:
            counter.track(t)
            counter.unread[id(t)] = t.untyped_storage().nbytes()
        arg_bytes = counter.live
        with counter.not_counting_propagation(), counter:
            out = fn(*dargs)
        del out, dargs
    return {
        "flops": int(counter.flops),
        "bytes": int(counter.bytes),
        # the pieces of arguments the step never reads stay out, alive
        # throughout: XLA prunes a jitted step's unused arguments
        "peak_bytes": int(counter.peak - sum(counter.unread.values())),
        "argument_bytes": int(arg_bytes),
        "collectives": {k: float(v) for k, v in log.wire.items()},
        "counts": dict(log.counts),
        "ops": counter.ops,
        "replicated": dict(sorted(counter.replicated.items())),
        "replicated_at": dict(sorted(counter.replicated_at.items())),
        "strided": dict(sorted(strided.items())),
    }


@contextlib.contextmanager
def _strided_redistributions(seen: Dict[str, int]):
    """While active, each redistribution from or to a strided layout
    (DTensor's ``_StridedShard``: what a view that flattens a split dim into
    the dim before it gives, and what later operators gather whole) is
    counted in ``seen`` under the step's line that asked for it, with the
    two layouts."""
    import sys

    from torch.distributed.tensor import _redistribute

    original = _redistribute.redistribute_local_tensor

    def redistribute_local_tensor(local, current_spec, target_spec, *args, **kwargs):
        layouts = (current_spec.placements, target_spec.placements)
        if any(type(p).__name__ == "_StridedShard" for pl in layouts for p in pl):
            key = f"{_step_line()}: {tuple(map(str, layouts[0]))} -> {tuple(map(str, layouts[1]))}"
            seen[key] = seen.get(key, 0) + 1
        return original(local, current_spec, target_spec, *args, **kwargs)

    holders = [m for name, m in list(sys.modules.items())
               if name.startswith("torch.distributed.tensor") and m is not None
               and getattr(m, "redistribute_local_tensor", None) is original]
    for m in holders:
        m.redistribute_local_tensor = redistribute_local_tensor
    try:
        yield
    finally:
        for m in holders:
            m.redistribute_local_tensor = original


@contextlib.contextmanager
def _alltoall_as_one():
    """DTensor's shard-to-shard redistribution on a CPU mesh runs as an
    all-gather and a chunk (gloo has no all-to-all): while this is active
    it is recorded as the all-to-all it stands for."""
    import sys

    from torch.distributed.tensor import _collective_utils as cu

    original = cu.shard_dim_alltoall

    def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        spmd.record("all-to-all", input.numel() * input.element_size(), mesh.size(mesh_dim))
        with spmd._explicit():
            return original(input, gather_dim, shard_dim, mesh, mesh_dim)

    holders = [m for name, m in list(sys.modules.items())
               if name.startswith("torch.distributed.tensor") and m is not None
               and getattr(m, "shard_dim_alltoall", None) is original]
    for m in holders:
        m.shard_dim_alltoall = shard_dim_alltoall
    try:
        yield
    finally:
        for m in holders:
            m.shard_dim_alltoall = original

"""Cost of one step: FLOPs, bytes and peak live bytes (the counterpart of
``repro/launch/hlo_cost.py``).

The reference walks the post-SPMD HLO text of a compiled step and
multiplies each while-loop body by its trip count. The port has no HLO: it
runs the step eagerly, usually on meta tensors (``launch/dryrun.py``), and
counts what is dispatched. Eager execution runs every loop iteration, so
there is no trip count to recover. ``step_costs`` counts:

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
"""

from __future__ import annotations

import weakref
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

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
        self.live = 0
        self.peak = 0
        self._alive: Dict[int, Any] = {}
        self._moves_bytes: Dict[Any, bool] = {}
        self._functional: Dict[Any, bool] = {}
        self._results: Dict[Any, Any] = {}

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
        self.ops += 1
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        moves = self._moves_bytes.get(func)
        if moves is None:
            moves = self._moves_bytes[func] = func not in _SKIP_BYTES_OPS and not func.is_view
        results = out if isinstance(out, (list, tuple)) else (out,)
        if moves:
            self.bytes += (_tensor_bytes(args) + _tensor_bytes(kwargs.values())
                           + _tensor_bytes(results))
        for t in results:
            if isinstance(t, torch.Tensor):
                self.track(t)
        return out


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

"""Recurrent binarization module (BEBR §3.2.1) in PyTorch.

Ports ``repro/core/binarize_lib.py``: the code arithmetic (affine
constants, the SDC epilogue, code and nibble packing) and the recurrent
binarizer

    b_0   = sign(W_0(f))
    f̂_t   = normalize(R_t(b_t))
    r_t   = sign(W_{t+1}(f - f̂_t))
    b_t+1 = b_t + 2^{-(t+1)} r_t

with ``W_*``/``R_*`` the MLPs linear -> batchnorm -> ReLU -> linear, in
eval mode and in train mode (``sign`` through a straight-through
estimator; batch norm on the batch's statistics, which it folds into the
running ones). The reference holds its weights as a pytree of
``(d_in, d_out)`` matrices; here they are ``nn.Linear`` modules, which
store ``w.T``: ``binarizer_from_numpy`` / ``binarizer_to_numpy``
transpose on the way in and out, and ``param_leaves`` names every
parameter by its path in the reference's tree. Batch norm keeps the
reference's op order (explicit ``bn_mean``/``bn_var`` buffers, not
``nn.BatchNorm1d``, whose running variance is unbiased and whose
momentum weighs the batch) and every matrix product runs in full
float32, as the reference does.
"""

from __future__ import annotations

import copy
import dataclasses
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import prng
from repro_torch.device import full_fp32_matmul, resolve_device


@dataclasses.dataclass(frozen=True)
class BinarizerConfig:
    """Configuration of the recurrent binarization module.

    Attributes:
      input_dim: dimension d of the incoming float embeddings.
      code_dim: m, output dimension of each binarization block.
      n_levels: u + 1 total binary vectors (base + u residual loops).
      hidden_dim: width of the MLP hidden layer (0 => single linear).
      bn_momentum: batch-norm running-stat momentum (training only).
      input_map: learnable input-alignment map P (identity-initialised).
    """

    input_dim: int
    code_dim: int
    n_levels: int = 4
    hidden_dim: int = 0
    bn_momentum: float = 0.9
    input_map: bool = False

    @property
    def total_bits(self) -> int:
        return self.code_dim * self.n_levels

    @property
    def u(self) -> int:
        return self.n_levels - 1


# ---------------------------------------------------------------------------
# Code arithmetic.
#
# bits[-1/+1] per level  <->  integer codes in [0, 2^n_levels)  <->  values.
# value = a * code + beta with a = 2^(2 - n_levels), beta = -(2 - 2^(1 - n_levels)).
# ---------------------------------------------------------------------------


def code_affine_constants(n_levels: int) -> Tuple[float, float]:
    u = n_levels - 1
    a = 2.0 ** (1 - u)
    beta = -(2.0 - 2.0 ** (-u))
    return a, beta


# Sentinel for "excluded from ranking", shared by every SDC scoring path.
SDC_NEG_INF = -1e30


def sdc_affine_epilogue(dot, code_sums, *, dim: int, n_levels: int, inv_norm=None):
    """Integer-code partial sums -> SDC scores (float32).

        <v(q), v(d)> = a^2 (c_q . c_d) + a*beta*(sum c_q + sum c_d) + D*beta^2

    The float op order is the reference's: mul, mul, add, add, then
    times ``inv_norm``. The CUDA kernel repeats it with round-to-nearest
    intrinsics, so every path gives the same bits.
    """
    a, beta = code_affine_constants(n_levels)
    scores = (
        (a * a) * dot.to(torch.float32)
        + (a * beta) * code_sums.to(torch.float32)
        + dim * (beta * beta)
    )
    if inv_norm is not None:
        scores = scores * inv_norm
    return scores


def pack_codes(bits: torch.Tensor) -> torch.Tensor:
    """[-1,+1] bits [..., n_levels, m] -> integer codes [..., m] (int8).

    Level 0 (the base vector) is the MSB so that the affine identity holds.
    """
    n = bits.shape[-2]
    weights = 2 ** torch.arange(n - 1, -1, -1, dtype=torch.int32, device=bits.device)
    zo = ((bits + 1.0) * 0.5).to(torch.int32)  # {0,1}
    codes = (zo.transpose(-1, -2) * weights).sum(-1, dtype=torch.int32)
    return codes.to(torch.int8)


def coarse_codes(codes: torch.Tensor, n_levels: int, coarse_levels: int) -> torch.Tensor:
    """Keep the first ``coarse_levels`` levels of an ``n_levels`` code (a right shift)."""
    if not 1 <= coarse_levels <= n_levels:
        raise ValueError(f"coarse_levels must be in [1, {n_levels}], got {coarse_levels}")
    shift = n_levels - coarse_levels
    if shift == 0:
        return codes
    return (codes >> shift).to(codes.dtype)


def unpack_codes(codes: torch.Tensor, n_levels: int) -> torch.Tensor:
    """Integer codes [..., m] -> bits [..., n_levels, m] in {-1, +1}."""
    c = codes.to(torch.int32)
    shifts = torch.arange(n_levels - 1, -1, -1, dtype=torch.int32, device=codes.device)
    planes = (c[..., None, :] >> shifts[:, None]) & 1
    return (planes * 2 - 1).to(torch.float32)


# ---------------------------------------------------------------------------
# Bit planes for the xor+popcount baseline (kernels/binary_dot): plane t of
# a code is bit n_levels-1-t (as in ``unpack_codes``), and bit j of word w
# holds dim w*32 + j. The reference keeps the words as uint32; here they are
# int32 with the same bit pattern, because torch has no popcount and its
# uint32 shifts do not run on the CPU. Words are built in int64 and cut to
# their low 32 bits.
# ---------------------------------------------------------------------------


def _low_words(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same low 32 bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _pack_bits(zo: torch.Tensor) -> torch.Tensor:
    """{0, 1} int64 [..., m] -> words [..., m/32] int32, bit j of word w = dim w*32 + j."""
    m = zo.shape[-1]
    if m % 32:
        raise ValueError(f"code_dim {m} must be a multiple of 32")
    shifts = torch.arange(32, dtype=torch.int64, device=zo.device)
    words = (zo.reshape(*zo.shape[:-1], m // 32, 32) << shifts).sum(-1)
    return _low_words(words)


def pack_bitplanes(bits: torch.Tensor) -> torch.Tensor:
    """[-1,+1] bits [..., n_levels, m] -> packed words [..., n_levels, m/32] int32.

    The words hold the reference's uint32 bit pattern (``.view(np.uint32)``
    of the numpy array gives its words). m must be a multiple of 32.
    """
    return _pack_bits(((bits + 1.0) * 0.5).to(torch.int64))


def unpack_bitplanes(packed: torch.Tensor, m: int) -> torch.Tensor:
    """Packed words [..., n_levels, m/32] (int32 or int64) -> bits [..., n_levels, m]."""
    shifts = torch.arange(32, dtype=torch.int64, device=packed.device)
    zo = ((packed.to(torch.int64) & 0xFFFFFFFF)[..., None] >> shifts) & 1
    *lead, n, words, _ = zo.shape
    return zo.reshape(*lead, n, words * 32)[..., :m].to(torch.float32) * 2 - 1


def pack_code_planes(codes: torch.Tensor, n_levels: int, chunk: int = 1 << 20) -> torch.Tensor:
    """Integer codes [..., m] -> packed bit planes [..., n_levels, m/32] int32.

    Equals ``pack_bitplanes(unpack_codes(codes, n_levels))`` word for word,
    by shifts on the integer codes, ``chunk`` rows at a time: at ten
    million 128-dim codes ``unpack_codes`` alone would be a 20 GB float
    array.
    """
    *lead, m = codes.shape
    if m % 32:
        raise ValueError(f"code_dim {m} must be a multiple of 32")
    rows = codes.reshape(-1, m)
    out = torch.empty((rows.shape[0], n_levels, m // 32), dtype=torch.int32,
                      device=codes.device)
    for s in range(0, rows.shape[0], chunk):
        c = rows[s:s + chunk].to(torch.int64)
        for t in range(n_levels):
            out[s:s + chunk, t] = _pack_bits((c >> (n_levels - 1 - t)) & 1)
    return out.reshape(*lead, n_levels, m // 32)


def codes_to_values(codes: torch.Tensor, n_levels: int) -> torch.Tensor:
    """Integer codes -> recurrent binary grid values b_u (float32)."""
    a, beta = code_affine_constants(n_levels)
    return codes.to(torch.float32) * a + beta


def values_to_codes(values: torch.Tensor, n_levels: int) -> torch.Tensor:
    """Grid values b_u -> integer codes (exact for on-grid values)."""
    a, beta = code_affine_constants(n_levels)
    return torch.round((values - beta) / a).to(torch.int8)


# ---------------------------------------------------------------------------
# int4 nibble packing: byte j holds dim 2j (low nibble) and dim 2j+1 (high).
# ---------------------------------------------------------------------------


def pack_codes_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """Integer codes [..., D] (values < 16, D even) -> packed uint8 [..., D//2]."""
    D = codes.shape[-1]
    if D % 2 != 0:
        raise ValueError(f"code dim {D} must be even to nibble-pack")
    c = codes.to(torch.uint8)
    return c[..., 0::2] | (c[..., 1::2] << 4)


def unpack_nibble_planes(packed: torch.Tensor):
    """Packed uint8 [..., D//2] -> (lo, hi) uint8 planes: even dims, odd dims."""
    p = packed.to(torch.uint8)
    return p & 0xF, (p >> 4) & 0xF


def unpack_codes_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """Packed uint8 [..., D//2] -> integer codes [..., D] (int8)."""
    lo, hi = unpack_nibble_planes(packed)
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * 2).to(torch.int8)


# ---------------------------------------------------------------------------
# Recurrent binarizer.
# ---------------------------------------------------------------------------


class _SteSign(torch.autograd.Function):
    """sign with the straight-through estimator: the gradient passes where
    |x| <= 1 (inclusive) and is 0 elsewhere."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        one = torch.ones((), dtype=x.dtype, device=x.device)
        return torch.where(x > 0, one, -one)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x.abs() <= 1.0, g, torch.zeros((), dtype=g.dtype, device=g.device))


def ste_sign(x: torch.Tensor) -> torch.Tensor:
    """sign(x) in {-1, +1}, 0 mapping to -1; gradient identity clipped to |x| <= 1."""
    return _SteSign.apply(x)


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    # Product then bias, as the reference's ``x @ w + b``: ``nn.Linear``'s
    # fused addmm would fold the bias into the accumulation.
    return torch.matmul(x, layer.weight.t()) + layer.bias


class MLP(nn.Module):
    """linear -> batch norm -> ReLU -> linear (hidden 0: one linear)."""

    def __init__(self, d_in: int, d_hidden: int, d_out: int, device=None, momentum: float = 0.9):
        super().__init__()
        self.hidden = d_hidden
        self.momentum = momentum
        if d_hidden > 0:
            self.inp = nn.Linear(d_in, d_hidden, device=device)
            self.bn_scale = nn.Parameter(torch.ones(d_hidden, device=device))
            self.bn_bias = nn.Parameter(torch.zeros(d_hidden, device=device))
            self.register_buffer("bn_mean", torch.zeros(d_hidden, device=device))
            self.register_buffer("bn_var", torch.ones(d_hidden, device=device))
            self.out = nn.Linear(d_hidden, d_out, device=device)
        else:
            self.out = nn.Linear(d_in, d_out, device=device)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Eval mode normalises by the running statistics. Train mode
        normalises by the batch's mean and biased variance and replaces the
        running ones by ``m * running + (1 - m) * batch`` (the reference's
        ``_apply_mlp``)."""
        if self.hidden <= 0:
            return _linear(self.out, x)
        h = _linear(self.inp, x)
        if train:
            mean = torch.mean(h, dim=0)
            var = torch.mean(torch.square(h - mean), dim=0)  # jnp.var: biased, two-pass
            m = self.momentum
            with torch.no_grad():
                self.bn_mean = m * self.bn_mean + (1 - m) * mean
                self.bn_var = m * self.bn_var + (1 - m) * var
        else:
            mean, var = self.bn_mean, self.bn_var
        h = (h - mean) * torch.rsqrt(var + 1e-5)
        h = h * self.bn_scale + self.bn_bias
        h = torch.relu(h)
        return _linear(self.out, h)


class RecurrentBinarizer(nn.Module):
    """``W[t]``: binarization MLP t (d -> m), t in [0, n_levels);
    ``R[t]``: reconstruction MLP t (m -> d), t in [0, n_levels - 1);
    ``P``: the optional input-alignment map (``cfg.input_map``)."""

    def __init__(self, cfg: BinarizerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        n, h = cfg.n_levels, cfg.hidden_dim
        m = cfg.bn_momentum
        self.W = nn.ModuleList(
            [MLP(cfg.input_dim, h, cfg.code_dim, device, m) for _ in range(n)]
        )
        self.R = nn.ModuleList(
            [MLP(cfg.code_dim, h, cfg.input_dim, device, m) for _ in range(n - 1)]
        )
        self.P: Optional[nn.Parameter] = None
        if cfg.input_map:
            self.P = nn.Parameter(torch.eye(cfg.input_dim, device=device))


def init_binarizer(
    cfg: BinarizerConfig, key: torch.Tensor, device="cuda"
) -> RecurrentBinarizer:
    """A binarizer with the reference's initialisation from ``key``
    (``prng.key``): the reference's keys and draws, so the weights are
    its own (``prng.normal``'s bound).

    ``split(key, 2 n)`` gives W[t] key t and R[t] key n + t; an MLP with a
    hidden layer splits its key between its two linears, and a linear
    draws ``normal(split(key)[0], (d_in, d_out)) * sqrt(2 / d_in)``, the
    scale rounded to float32 first. Biases 0, BN scale 1 / bias 0,
    running mean 0 / var 1.
    """
    device = resolve_device(device)
    model = RecurrentBinarizer(cfg, device)
    n = cfg.n_levels
    keys = prng.split(key, 2 * n)
    mlps = [(model.W[t], keys[t]) for t in range(n)]
    mlps += [(model.R[t], keys[n + t]) for t in range(n - 1)]
    with torch.no_grad():
        for mlp, k in mlps:
            linears = [(mlp.out, k)]
            if mlp.hidden > 0:
                k_in, k_out = prng.split(k)
                linears = [(mlp.inp, k_in), (mlp.out, k_out)]
            for lin, kl in linears:
                d_out, d_in = lin.weight.shape
                scale = np.sqrt(np.float32(2.0 / d_in))
                w = prng.normal(prng.split(kl)[0], (d_in, d_out), mul=scale, device=device)
                lin.weight.copy_(w.t())
                lin.bias.zero_()
    return model.eval()


def _l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps)


def binarize(
    model: RecurrentBinarizer, f: torch.Tensor, train: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recurrent binarization of ``f`` [batch, input_dim].

    Returns (bits [batch, n_levels, code_dim] in {-1, +1}, b_u [batch,
    code_dim] the recurrent binary embedding). Eval mode runs without
    autograd. Train mode records the graph (the STE carries the gradient
    through every sign) and updates the model's running batch-norm
    statistics in place: the reference returns them as ``new_state``.
    Products run in full float32 (TF32 is switched off for the process).
    """
    full_fp32_matmul()
    with torch.set_grad_enabled(train and torch.is_grad_enabled()):
        n = model.cfg.n_levels
        if model.P is not None:
            f = _l2norm(f @ model.P)
        b = ste_sign(model.W[0](f, train))
        levels: List[torch.Tensor] = [b]
        acc = b
        for t in range(n - 1):
            recon = _l2norm(model.R[t](acc, train))
            resid = _l2norm(f) - recon
            r = ste_sign(model.W[t + 1](resid, train))
            levels.append(r)
            acc = acc + (2.0 ** -(t + 1)) * r
        return torch.stack(levels, dim=-2), acc


def binarize_eval(model: RecurrentBinarizer, f: torch.Tensor) -> torch.Tensor:
    """Inference helper: returns only the recurrent binary embedding b_u."""
    return binarize(model, f)[1]


def _frozen_copy(model: RecurrentBinarizer) -> RecurrentBinarizer:
    """An eval-mode copy of ``model`` that nothing trains: the weights an
    encode closure serves, fixed when it is made, as the reference's jit
    closes over its arrays."""
    return copy.deepcopy(model).eval().requires_grad_(False)


def _model_device(model: RecurrentBinarizer) -> torch.device:
    return next(model.parameters()).device


def _eager_encode(model: RecurrentBinarizer):
    device = _model_device(model)

    def encode(e):
        x = torch.as_tensor(e, dtype=torch.float32, device=device)
        return pack_codes(binarize(model, x)[0])

    return encode


def make_eager_encode_fn(model: RecurrentBinarizer):
    """The plain version of ``make_encode_fn``: the same codes, op by op.

    Float embeddings [B, dim] (numpy or a tensor, moved to the model's
    device) -> codes [B, code_dim] int8 on that device, from a copy of
    ``model``'s weights taken now: training the model afterwards does not
    move the codes. On a card every call issues the forward's some 150
    launches from the calling thread.
    """
    return _eager_encode(_frozen_copy(model))


def make_encode_fn(model: RecurrentBinarizer):
    """Serving ``EncodeFn`` (the reference's jitted encode): float
    embeddings [B, dim] -> codes [B, code_dim] int8, over a copy of
    ``model``'s weights taken now, so later training does not move them.

    On a CUDA model each batch shape's forward is captured once as a CUDA
    graph (``CapturedEncode``) and every call replays it: one graph launch
    and two copies instead of the forward's some 150 launches. On a CPU
    model the closure runs eagerly (``make_eager_encode_fn``). Accepts
    numpy arrays or tensors; the codes come back on the model's device.
    """
    model = _frozen_copy(model)
    if _model_device(model).type != "cuda":
        return _eager_encode(model)
    return CapturedEncode(model)


class CapturedEncode:
    """The encode as one CUDA-graph replay per batch shape.

    A shape's first call captures the forward (after one eager warm-up
    call that sets up the libraries outside the capture) on the closure's
    own stream, in ``thread_local`` capture mode, so that serving threads
    synchronising on their events meanwhile do not break it. Every call
    then copies the batch into the graph's static input, replays the graph
    and returns a clone of its static output, all on that stream under one
    lock: replicas share the closure, and the static tensors belong to
    whichever call holds the lock. The caller's current stream waits for
    the clone. A capture that fails raises; nothing falls back to eager
    (and PyTorch's CUDA generator stays registered with the aborted
    capture, so the process's later random draws on the card fail: treat
    it as fatal). ``captures`` counts the shapes captured, ``replays`` the
    calls.
    """

    def __init__(self, model: RecurrentBinarizer):
        self._model = model
        self._device = _model_device(model)
        self._stream = torch.cuda.Stream(self._device)
        self._lock = threading.Lock()
        self._graphs: Dict[tuple, tuple] = {}
        self.captures = 0
        self.replays = 0

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        return pack_codes(binarize(self._model, x)[0])

    def _capture(self, shape: tuple):
        """(graph, static input, static output) of the forward at ``shape``;
        runs on the closure's stream."""
        static_in = torch.zeros(shape, dtype=torch.float32, device=self._device)
        self._forward(static_in)
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            static_out = self._forward(static_in)
        finally:
            graph.capture_end()
        self.captures += 1
        return graph, static_in, static_out

    def __call__(self, e) -> torch.Tensor:
        x = torch.as_tensor(e, dtype=torch.float32)
        if x.dim() != 2 or x.shape[1] != self._model.cfg.input_dim:
            raise ValueError(f"embeddings {tuple(x.shape)} are not [B, "
                             f"{self._model.cfg.input_dim}]")
        if x.shape[0] == 0:
            return torch.empty((0, self._model.cfg.code_dim), dtype=torch.int8,
                               device=self._device)
        caller = torch.cuda.current_stream(self._device)
        with self._lock:
            self._stream.wait_stream(caller)
            with torch.cuda.stream(self._stream):
                entry = self._graphs.get(tuple(x.shape))
                if entry is None:
                    entry = self._graphs[tuple(x.shape)] = self._capture(tuple(x.shape))
                graph, static_in, static_out = entry
                static_in.copy_(x)
                graph.replay()
                out = static_out.clone()
            caller.wait_stream(self._stream)
            self.replays += 1
        # The caching allocator must not hand either block to its own
        # stream's next call while the other stream may still use it.
        if x.is_cuda:
            x.record_stream(self._stream)
        out.record_stream(caller)
        return out


# ---------------------------------------------------------------------------
# Weight conversion to and from the reference's (params, bn_state) pytree.
#
# ``jax.tree_util`` flattens dictionaries by sorted key and lists in order,
# so the reference's leaves come as
#
#     params: [P,] R[0..n-2], W[0..n-1]    (each MLP: bn_bias, bn_scale,
#                                           in.b, in.w, out.b, out.w;
#                                           without a hidden layer: out.b, out.w)
#     state:  R[0..n-2], W[0..n-1]          (each: bn_mean, bn_var; none
#                                           without a hidden layer)
#
# (42 parameters and 14 statistics for n_levels 4 with a hidden layer). The
# optimizer sums its global norm in this order, and checkpoints store it.
# ---------------------------------------------------------------------------


def _mlp_leaf_shapes(d_in: int, d_hidden: int, d_out: int):
    if d_hidden <= 0:
        return [("out.b", (d_out,)), ("out.w", (d_in, d_out))]
    return [
        ("bn_bias", (d_hidden,)), ("bn_scale", (d_hidden,)),
        ("in.b", (d_hidden,)), ("in.w", (d_in, d_hidden)),
        ("out.b", (d_out,)), ("out.w", (d_hidden, d_out)),
    ]


def _state_leaf_shapes(d_hidden: int):
    if d_hidden <= 0:
        return []
    return [("bn_mean", (d_hidden,)), ("bn_var", (d_hidden,))]


def leaf_layout(cfg: BinarizerConfig) -> List[tuple]:
    """(tree, group, index, leaf name, reference shape) of every leaf, in the
    reference's tree-leaf order: the parameters, then the statistics."""
    n, h, d, m = cfg.n_levels, cfg.hidden_dim, cfg.input_dim, cfg.code_dim
    out = []
    if cfg.input_map:
        out.append(("params", "P", 0, "P", (d, d)))
    for t in range(n - 1):
        out += [("params", "R", t, name, s) for name, s in _mlp_leaf_shapes(m, h, d)]
    for t in range(n):
        out += [("params", "W", t, name, s) for name, s in _mlp_leaf_shapes(d, h, m)]
    for t in range(n - 1):
        out += [("state", "R", t, name, s) for name, s in _state_leaf_shapes(h)]
    for t in range(n):
        out += [("state", "W", t, name, s) for name, s in _state_leaf_shapes(h)]
    return out


_MODULE_NAMES = {"in.w": ("inp", "weight"), "in.b": ("inp", "bias"),
                 "out.w": ("out", "weight"), "out.b": ("out", "bias")}


def _module_leaf(model: RecurrentBinarizer, group: str, t: int, name: str) -> torch.Tensor:
    if group == "P":
        return model.P
    mlp = getattr(model, group)[t]
    if name in _MODULE_NAMES:
        layer, attr = _MODULE_NAMES[name]
        return getattr(getattr(mlp, layer), attr)
    return getattr(mlp, name)


def _leaves(model: RecurrentBinarizer, tree: str) -> Dict[str, torch.Tensor]:
    return {
        "P" if group == "P" else f"{group}/{t}/{name.replace('.', '/')}":
            _module_leaf(model, group, t, name)
        for tr, group, t, name, _ in leaf_layout(model.cfg) if tr == tree
    }


def param_leaves(model: RecurrentBinarizer) -> Dict[str, torch.Tensor]:
    """The model's parameters by reference path (``"W/0/in/w"``, ``"P"``),
    in the reference's tree-leaf order. A ``w`` leaf is the module's
    ``weight``, the transpose of the reference's array."""
    return _leaves(model, "params")


def state_leaves(model: RecurrentBinarizer) -> Dict[str, torch.Tensor]:
    """The running batch-norm statistics by reference path (``"R/0/bn_mean"``),
    in the reference's tree-leaf order. Train mode replaces these tensors,
    so read them anew after a step."""
    return _leaves(model, "state")


def numpy_leaves(model: RecurrentBinarizer) -> List[np.ndarray]:
    """Every leaf as a float32 numpy array in ``leaf_layout`` order, linear
    weights as the reference's ``(d_in, d_out)``."""
    out = []
    for _, group, t, name, _ in leaf_layout(model.cfg):
        leaf = _module_leaf(model, group, t, name).detach()
        out.append((leaf.t() if name.endswith(".w") else leaf).cpu().numpy().copy())
    return out


def nest_leaves(cfg: BinarizerConfig, leaves: List[Any]):
    """Leaves in ``leaf_layout`` order -> the reference's ``(params, state)`` tree."""
    n = cfg.n_levels
    params: Dict = {"W": [{} for _ in range(n)], "R": [{} for _ in range(n - 1)]}
    state: Dict = {"W": [{} for _ in range(n)], "R": [{} for _ in range(n - 1)]}
    for (tree, group, t, name, _), leaf in zip(leaf_layout(cfg), leaves):
        if group == "P":
            params["P"] = leaf
            continue
        node = (params if tree == "params" else state)[group][t]
        if "." in name:
            sub, name = name.split(".")
            node = node.setdefault(sub, {})
        node[name] = leaf
    return params, state


def binarizer_to_numpy(model: RecurrentBinarizer):
    """The inverse of ``binarizer_from_numpy``: the reference's ``(params,
    bn_state)`` tree of float32 numpy arrays, linear weights as ``(d_in,
    d_out)``."""
    return nest_leaves(model.cfg, numpy_leaves(model))


def _load_mlp(mlp: MLP, params: Dict[str, Any], state: Dict[str, Any]) -> None:
    def put(dst: torch.Tensor, src, transpose=False):
        t = torch.from_numpy(np.array(src, dtype=np.float32))
        t = t.t() if transpose else t
        if tuple(t.shape) != tuple(dst.shape):
            raise ValueError(f"weight shape {tuple(t.shape)} != {tuple(dst.shape)}")
        dst.copy_(t)

    if mlp.hidden > 0:
        put(mlp.inp.weight, params["in"]["w"], transpose=True)
        put(mlp.inp.bias, params["in"]["b"])
        put(mlp.bn_scale, params["bn_scale"])
        put(mlp.bn_bias, params["bn_bias"])
        put(mlp.bn_mean, state["bn_mean"])
        put(mlp.bn_var, state["bn_var"])
    elif "in" in params:
        raise ValueError("checkpoint has a hidden layer but cfg.hidden_dim == 0")
    put(mlp.out.weight, params["out"]["w"], transpose=True)
    put(mlp.out.bias, params["out"]["b"])


def binarizer_from_numpy(
    params: Dict[str, Any], state: Dict[str, Any], cfg: BinarizerConfig, device="cuda"
) -> RecurrentBinarizer:
    """The reference's ``(params, bn_state)`` tree, as nested numpy arrays,
    -> an eval-mode ``RecurrentBinarizer`` on ``device``.

    ``params = {"W": [mlp, ...], "R": [mlp, ...] (, "P": [d, d])}`` with
    ``mlp = {"in": {"w", "b"}, "bn_scale", "bn_bias", "out": {"w", "b"}}``
    and ``state = {"W": [{"bn_mean", "bn_var"}, ...], "R": [...]}``.
    Linear weights arrive as ``(d_in, d_out)`` and are transposed.
    """
    device = resolve_device(device)
    model = RecurrentBinarizer(cfg, device)
    if len(params["W"]) != cfg.n_levels or len(params["R"]) != cfg.n_levels - 1:
        raise ValueError("params do not match cfg.n_levels")
    with torch.no_grad():
        for mlp, p, s in zip(model.W, params["W"], state["W"]):
            _load_mlp(mlp, p, s)
        for mlp, p, s in zip(model.R, params["R"], state["R"]):
            _load_mlp(mlp, p, s)
        if cfg.input_map:
            model.P.copy_(torch.from_numpy(np.array(params["P"], dtype=np.float32)))
    return model.eval()

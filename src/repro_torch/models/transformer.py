"""LM transformer family (ports ``repro/models/transformer.py``): dense
(llama3/mistral) and MoE (llama4/grok).

One config covers all five LM architectures: GQA attention with RoPE,
RMSNorm, SwiGLU FFN or top-k routed MoE, stacked [L, ...] parameters
(the reference's scan-over-layers tree, key for key, so checkpoints
interchange), the causal train forward, prefill and a KV-cache decode
step with a bfloat16 or int8 cache.

Every block is written as the reference's own expressions in its order
(attention as its einsums, not ``scaled_dot_product_attention``), so the
parity tests can hold it: softmax in float32 and cast back, the -1e30
mask, the query-chunked causal attention, MoE routing by ``jax.lax.top_k``'s
order (a stable sort: ties to the lower expert), the integer cumulative
sum for each token's slot in its expert's buffer (exact, and
deterministic on the card), and the one-hot dispatch and combine
einsums. A Python scalar that meets a low-precision tensor takes that
tensor's dtype first, as JAX's weakly typed scalars do (``new_full``).

The reference's ``remat`` (``jax.checkpoint`` of each layer) is
``torch.utils.checkpoint`` of each layer while gradients are recorded.
Its ``constrain`` hooks are GSPMD sharding constraints, applied where the
reference applies them: under a sharded step (``parallel/spmd.py``) they
redistribute the residual stream, on one device they are identities. The
projections (``spmd.matmul``), the heads' split (``spmd.split_dim``), the
attention split by query heads (``spmd.by_heads``, ``decode_by_heads``),
the cache's writes (``spmd.write_at``) and the MoE's one-hots, dispatch,
experts and combine (``spmd.one_hot``, ``einsum``, ``weight_einsum``)
are plain products, reshapes, calls and slice writes on one device and
place DTensors where DTensor cannot by itself. A decode cache is a dictionary of tensors and a
host integer ``length`` (the reference's int32 scalar): ``decode_step``
writes the new token's keys and values into the cache's tensors in place
and returns the cache with ``length`` advanced, so a step reads nothing
back from the device.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import full_fp32_matmul, is_dtensor, resolve_device
from repro_torch.models.recsys.embedding import embedding_lookup, tree_from_numpy
from repro_torch.parallel import spmd

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    # MoE (n_experts = 0 => dense SwiGLU)
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    rope_theta: float = 500000.0
    dtype: Any = torch.bfloat16
    # training-time knobs
    microbatches: int = 1
    remat: bool = True
    # activation sharding of the reference's scan carry (GSPMD; no effect here)
    activation_sharding: Optional[str] = "seq"
    # query-chunked attention; 0 = single-shot
    attn_chunk: int = 1024
    # MoE routing-group length: tokens are routed in fixed groups of this
    # many tokens (0 = one group per batch row)
    moe_group: int = 0
    # KV cache dtype: torch.bfloat16 | torch.int8 (per-token scales)
    kv_cache_dtype: Any = torch.bfloat16

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab
        attn = d * self.n_heads * self.head_dim + 2 * d * self.n_kv_heads * self.head_dim
        attn += self.n_heads * self.head_dim * d
        if self.is_moe:
            ffn = self.n_experts * 3 * d * f + d * self.n_experts  # experts + router
        else:
            ffn = 3 * d * f
        per_layer = attn + ffn + 2 * d
        return self.n_layers * per_layer + v * d + d  # embed (tied out) + final norm

    def active_param_count(self) -> int:
        if not self.is_moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_like = self.param_count() - self.n_layers * self.n_experts * 3 * d * f
        return dense_like + self.n_layers * self.top_k * 3 * d * f


# ---------------------------------------------------------------------------
# Primitives.
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    var = torch.mean(torch.square(x.to(torch.float32)), -1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on split halves. x: [..., S, H, hd]; positions: [..., S]."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    angles = positions[..., None].to(torch.float32) * freqs  # [..., S, hd/2]
    cos = torch.cos(angles)[..., None, :].to(x.dtype)
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _init(generator, shape, dtype, device, scale=None):
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    return (torch.randn(shape, generator=generator, device=device) * s).to(dtype)


def init_params(cfg: TransformerConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Params:
    """Stacked [L, ...] parameters, the reference's tree and keys: weights
    N(0, 1) / sqrt(fan_in) (the embedding N(0, 1) * 0.02) drawn in float32
    from ``generator`` (on ``device``) and cast to ``cfg.dtype``, norms
    ones. On the meta device (no generator needed) it gives the shapes only."""
    device = resolve_device(device)
    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.dtype

    def w(shape, scale=None):
        return _init(generator, shape, dt, device, scale)

    layer = {
        "attn_norm": torch.ones((L, d), dtype=dt, device=device),
        "wq": w((L, d, H * hd)),
        "wk": w((L, d, KV * hd)),
        "wv": w((L, d, KV * hd)),
        "wo": w((L, H * hd, d)),
        "ffn_norm": torch.ones((L, d), dtype=dt, device=device),
    }
    if cfg.is_moe:
        E = cfg.n_experts
        layer.update(router=w((L, d, E)), w_gate=w((L, E, d, f)), w_up=w((L, E, d, f)),
                     w_down=w((L, E, f, d)))
    else:
        layer.update(w_gate=w((L, d, f)), w_up=w((L, d, f)), w_down=w((L, f, d)))
    return {
        "embed": w((cfg.vocab, d), scale=0.02),
        "final_norm": torch.ones((d,), dtype=dt, device=device),
        "layers": layer,
    }


def transformer_from_numpy(params: Params, device="cuda") -> Params:
    """The reference's ``init_params`` tree as numpy arrays -> the same tree
    of tensors, each leaf of its own dtype (bfloat16 bit for bit)."""
    return tree_from_numpy(params, None, device)


# ---------------------------------------------------------------------------
# Attention / FFN / MoE blocks (one layer).
# ---------------------------------------------------------------------------


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(.., token) symmetric int8: x [..., T, hd] -> (q int8, scale f32).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    scale = amax / amax.new_full((), 127.0) + amax.new_full((), 1e-8)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _causal_chunk_attn(qh, kh, vh, q_offset, S_kv, chunk, dtype):
    """Query-chunked causal attention. qh [B, KV, G, S, hd]; kh/vh [B, KV,
    T, hd]. Each chunk materialises only [B, KV, G, C, T] logits; causal
    with absolute positions (q_offset)."""
    S = qh.shape[3]
    kpos = torch.arange(S_kv, device=qh.device)
    ctxs = []
    for i in range(S // chunk):
        q = qh[:, :, :, i * chunk:(i + 1) * chunk]
        logits = torch.einsum("bkgqh,bkth->bkgqt", q, kh)
        qpos = q_offset + i * chunk + torch.arange(chunk, device=qh.device)
        causal = kpos[None, :] <= qpos[:, None]
        logits = torch.where(causal, logits, -1e30)
        probs = torch.softmax(logits.to(torch.float32), -1).to(dtype)
        ctxs.append(torch.einsum("bkgqt,bkth->bkgqh", probs, vh))
    return torch.cat(ctxs, dim=3)


def _attend(qt, kh, vh, cfg: TransformerConfig, mask, dtype):
    """Causal attention of query heads ``qt`` [B, H, S, hd] with their
    key/value heads ``kh``/``vh`` [B, KV, S, hd] (GQA via head grouping) ->
    the context [B, S, H * hd]; query chunking bounds the logits working set
    at [.., chunk, S]."""
    B, _, S, hd = qt.shape
    qh = qt.reshape(B, kh.shape[1], -1, S, hd)
    if cfg.attn_chunk and S > cfg.attn_chunk and S % cfg.attn_chunk == 0 and mask is None:
        ctx = _causal_chunk_attn(qh, kh, vh, 0, S, cfg.attn_chunk, dtype)
    else:
        logits = torch.einsum("bkgqh,bkth->bkgqt", qh, kh)
        causal = torch.tril(torch.ones((S, S), dtype=torch.bool, device=qt.device))
        if mask is not None:
            causal = causal & mask
        logits = torch.where(causal, logits, -1e30)
        probs = torch.softmax(logits.to(torch.float32), -1).to(dtype)
        ctx = torch.einsum("bkgqt,bkth->bkgqh", probs, vh)
    return ctx.permute(0, 3, 1, 2, 4).reshape(B, S, -1)


def _decode_attend(qt, keys, vals, t0, softmax, length):
    """One decode step's attention of query heads ``qt`` [B, H, S, hd] over
    the cache's key/value heads ``keys``/``vals`` [B, KV, T, hd] at positions
    ``t0`` .. ``t0 + T - 1`` (those past ``length`` masked) -> the context
    [B, S, H * hd]; ``softmax`` normalises float32 logits over the positions."""
    B, H, S, hd = qt.shape
    KV, T = keys.shape[1], keys.shape[2]
    qg = qt.reshape(B, KV, H // KV * S, hd)
    logits = torch.einsum("bkqh,bkth->bkqt", qg, keys)
    valid = torch.arange(t0, t0 + T, device=qt.device) <= length
    logits = torch.where(valid, logits, -1e30)
    probs = softmax(logits.to(torch.float32)).to(qt.dtype)
    ctx = torch.einsum("bkqt,bkth->bkqh", probs, vals)
    return ctx.reshape(B, KV, H // KV, S, hd).permute(0, 3, 1, 2, 4).reshape(B, S, H * hd)


def _attention(lp, x, positions, cfg: TransformerConfig, mask=None, kv_cache=None):
    """x: [B, S, d]. ``kv_cache``: optional dict with k/v [B, KV, T, hd]
    (views into the stacked cache) and ``length`` — decode mode writes the
    new keys and values at ``length`` and attends to the cache. Under a
    sharded step the attention runs split by query heads (``spmd.by_heads``,
    ``spmd.decode_by_heads``)."""
    B, S, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = spmd.shared_input(x)  # gathered once for the three projections
    q = spmd.split_dim(spmd.matmul(x, lp["wq"]), 2, (H, hd))
    k = spmd.split_dim(spmd.matmul(x, lp["wk"]), 2, (KV, hd))
    v = spmd.split_dim(spmd.matmul(x, lp["wv"]), 2, (KV, hd))
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    q = q * q.new_full((), hd ** -0.5)
    groups = H // KV

    if kv_cache is not None:
        length = kv_cache["length"]
        k_new = k.transpose(1, 2)  # [B, KV, S, hd]
        v_new = v.transpose(1, 2)
        ck, cv = kv_cache["k"], kv_cache["v"]
        new_cache = dict(kv_cache, length=length + S)
        if "k_scale" in kv_cache:
            kq, ks = _quantize_kv(k_new)
            vq, vs = _quantize_kv(v_new)
            spmd.write_at(ck, 2, length, kq)
            spmd.write_at(cv, 2, length, vq)
            spmd.write_at(kv_cache["k_scale"], 2, length, ks)
            spmd.write_at(kv_cache["v_scale"], 2, length, vs)
            keys = ck.to(q.dtype) * kv_cache["k_scale"].to(q.dtype)
            vals = cv.to(q.dtype) * kv_cache["v_scale"].to(q.dtype)
        else:
            spmd.write_at(ck, 2, length, k_new.to(ck.dtype))
            spmd.write_at(cv, 2, length, v_new.to(cv.dtype))
            keys, vals = ck.to(q.dtype), cv.to(q.dtype)
        ctx = spmd.decode_by_heads(functools.partial(_decode_attend, length=length),
                                   q.transpose(1, 2), keys, vals, groups)
        return spmd.matmul(ctx, lp["wo"]), new_cache

    # training / prefill: causal attention, GQA via head grouping
    attend = functools.partial(_attend, cfg=cfg, mask=mask, dtype=x.dtype)
    ctx = spmd.by_heads(attend, q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), groups)
    return spmd.matmul(ctx, lp["wo"]), None


def _dense_ffn(lp, x):
    x = spmd.shared_input(x)  # gathered once for the gate and up products
    gate = F.silu(spmd.matmul(x, lp["w_gate"]))
    up = spmd.matmul(x, lp["w_up"])
    return spmd.matmul(gate * up, lp["w_down"])


def _route_topk(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the experts: a stable descending sort, so
    ties go to the lower expert index (``torch.topk`` orders them otherwise);
    on a sharded step on each rank's own tokens (``spmd.rowwise``)."""
    def topk(p):
        vals, idx = torch.sort(p, dim=-1, descending=True, stable=True)
        return vals[..., :k], idx[..., :k]

    return spmd.rowwise(topk, probs, k, k)


def _moe_ffn(lp, x, cfg: TransformerConfig):
    """Grouped dense-dispatch top-k MoE (GShard-style einsum routing): each
    routing group (a batch row, or ``moe_group`` tokens) has its own
    capacity C = max(int(capacity_factor * S * k / E), 4); a token's slot
    past C is dropped. Returns (out [B, S, d], Switch aux loss).

    Under a sharded step the dispatch and the combine run split as the
    experts are (``spmd.one_hot``, ``spmd.split_as``, ``spmd.einsum``):
    where the experts are split (expert parallel), a rank dispatches to its
    own experts only and its combine is a partial sum; where their hidden
    dim is split (tensor parallel inside the experts), a rank dispatches a
    slice of every token's features, the experts gather them, and the
    combine stays split over the features."""
    B0, S0, d = x.shape
    x = spmd.whole_dims(x, (1,))  # a split sequence is gathered first
    if cfg.moe_group and S0 > cfg.moe_group and S0 % cfg.moe_group == 0:
        x = spmd.reshape(x, (B0 * S0 // cfg.moe_group, cfg.moe_group, d))
    B, S, _ = x.shape
    E, k = cfg.n_experts, cfg.top_k
    logits = spmd.matmul(x, lp["router"])  # [B, S, E]
    probs = torch.softmax(logits.to(torch.float32), -1)
    gate_vals, gate_idx = _route_topk(probs, k)  # [B, S, k]
    gate_vals = gate_vals / (torch.sum(gate_vals, -1, keepdim=True) + 1e-9)

    cap = max(int(cfg.capacity_factor * S * k / E), 4)
    # position of each (token, slot) within its expert's per-group buffer
    onehot = spmd.one_hot(gate_idx, E, torch.int32)  # [B, S, k, E]
    flat = onehot.reshape(B, S * k, E)
    pos_in_expert = (torch.cumsum(flat, dim=1, dtype=torch.int32) - flat).reshape(B, S, k, E)
    pos = torch.sum(pos_in_expert * onehot, -1, dtype=torch.int32)  # [B, S, k]
    keep = pos < cap
    # its gradient, a partial sum where the combine is split, reduced here
    gate_vals = spmd.grad_as(torch.where(keep, gate_vals, 0.0))

    # dispatch [B, S, k, E, C] one-hot -> combine via einsums
    disp = (spmd.one_hot(gate_idx, E, x.dtype, lp["w_gate"], 0)[..., None]
            * spmd.one_hot(torch.where(keep, pos, cap), cap + 1, x.dtype)[..., None, :])[..., :cap]
    disp_comb = disp * gate_vals[..., None, None].to(x.dtype)
    expert_in = spmd.einsum("bsd,bskec->becd", spmd.split_as(x, -1, lp["w_gate"], 2), disp)
    expert_in = spmd.whole_dims(expert_in, (-1,))  # [B, E, C, d]
    # (a partial sum where the tokens are too few to split: decode at batch 1)
    gate = spmd.reduced(spmd.weight_einsum("becd,edf->becf", expert_in, lp["w_gate"]))
    up = spmd.reduced(spmd.weight_einsum("becd,edf->becf", expert_in, lp["w_up"]))
    act = F.silu(gate) * up
    # with the experts' hidden dim split (w_down's rows), each rank holds a
    # partial sum: scattered over d, so the combine runs split, not whole
    expert_out = spmd.partial_scattered(spmd.weight_einsum("becf,efd->becd", act, lp["w_down"]),
                                        -1)
    # the combine as one product over (expert, slot): a token's k slots meet
    # k distinct experts, so summing them first is exact
    out = spmd.einsum("bsec,becd->bsd", torch.sum(disp_comb, 2), expert_out)

    # load-balancing auxiliary loss (Switch-style)
    me = spmd.reduced(torch.mean(probs, dim=(0, 1)))  # means over split tokens reduced here
    ce = spmd.reduced(torch.mean(spmd.one_hot(gate_idx[..., 0], E, torch.float32), dim=(0, 1)))
    aux = E * torch.sum(me * ce)
    return spmd.reshape(out, (B0, S0, d)), aux


def _layer(lp, x, positions, cfg: TransformerConfig, kv_cache=None, constrain=None):
    h, new_cache = _attention(lp, rms_norm(x, lp["attn_norm"]), positions, cfg,
                              kv_cache=kv_cache)
    x = x + spmd.laid_out_as(h, x)
    if constrain is not None:  # Megatron-SP: the residual stream after each add
        x = constrain(x)
    if cfg.is_moe:
        h, aux = _moe_ffn(lp, rms_norm(x, lp["ffn_norm"]), cfg)
    else:
        h, aux = _dense_ffn(lp, rms_norm(x, lp["ffn_norm"])), 0.0
    x = x + spmd.laid_out_as(h, x)
    if constrain is not None:
        x = constrain(x)
    return x, aux, new_cache


def _input_layout(x):
    """With no constraint given (prefill, decode): a constraint that keeps
    the residual stream of a sharded step laid out as the embedded tokens
    are, as GSPMD propagates the input's layout; None on one device."""
    if not is_dtensor(x):
        return None
    layout = x.placements
    return lambda y: y.redistribute(y.device_mesh, layout)


def _layer_params(params: Params):
    """The stacked [L, ...] leaves as L per-layer dictionaries (one
    ``unbind`` a leaf, so the backward stacks the layers' gradients once)."""
    stacked = {k: v.unbind(0) for k, v in params["layers"].items()}
    n_layers = len(next(iter(stacked.values())))
    return [{k: v[i] for k, v in stacked.items()} for i in range(n_layers)]


# ---------------------------------------------------------------------------
# Forward passes.
# ---------------------------------------------------------------------------


def backbone(params: Params, tokens, cfg: TransformerConfig,
             constrain=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The trunk: tokens [B, S] -> (hidden [B, S, d], aux). ``constrain``
    (a sharding constraint) pins the residual stream before each layer, or
    after each residual add with ``activation_sharding="seq_residual"``, as
    in the reference; an identity on one device."""
    full_fp32_matmul()
    embed = params["embed"]
    tokens = torch.as_tensor(tokens, device=embed.device)
    S = tokens.shape[1]
    x = embedding_lookup(embed, tokens).to(cfg.dtype)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    if constrain is None:
        constrain = _input_layout(x)
    inner = constrain if cfg.activation_sharding == "seq_residual" else None
    for lp in _layer_params(params):
        if constrain is not None and inner is None:
            x = constrain(x)
        if remat:
            x, a, _ = checkpoint(_layer, lp, x, positions, cfg, None, inner,
                                 use_reentrant=False)
        else:
            x, a, _ = _layer(lp, x, positions, cfg, constrain=inner)
        aux = aux + a
    return rms_norm(x, params["final_norm"]), aux / cfg.n_layers


def forward(params: Params, tokens, cfg: TransformerConfig,
            constrain=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward: tokens [B, S] -> (logits [B, S, V], aux loss)."""
    x, aux = backbone(params, tokens, cfg, constrain=constrain)
    logits = spmd.matmul(x, params["embed"].T.to(cfg.dtype))
    return logits, aux


def lm_loss(params: Params, tokens, labels, cfg: TransformerConfig,
            constrain=None) -> torch.Tensor:
    logits, aux = forward(params, tokens, cfg, constrain=constrain)
    if is_dtensor(logits):  # a sharded step: the vocabulary stays sharded
        return torch.mean(spmd.class_nll(logits, labels.long())) + 0.01 * aux
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    labels = torch.as_tensor(labels, device=logp.device).long()
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    return torch.mean(nll) + 0.01 * aux


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int, dtype=None,
                  device="cuda") -> Dict[str, Any]:
    """Stacked cache: k/v [L, B, KV, T, hd] zeros and ``length`` 0 (a host
    int). An int8 dtype adds per-token scale planes [L, B, KV, T, 1] f32."""
    dtype = cfg.kv_cache_dtype if dtype is None else dtype
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    cache = {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "length": 0,
    }
    if dtype == torch.int8:
        sshape = shape[:-1] + (1,)
        cache["k_scale"] = torch.zeros(sshape, dtype=torch.float32, device=device)
        cache["v_scale"] = torch.zeros(sshape, dtype=torch.float32, device=device)
    return cache


def decode_step(params: Params, token, cache: Dict[str, Any],
                cfg: TransformerConfig) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step. token: [B] int. Writes the token's keys and values
    into ``cache`` in place; returns (logits [B, V], the cache with
    ``length`` advanced by one)."""
    full_fp32_matmul()
    embed = params["embed"]
    token = torch.as_tensor(token, device=embed.device)
    x = embedding_lookup(embed, token)[:, None, :].to(cfg.dtype)  # [B, 1, d]
    length = int(cache["length"])
    pos = torch.full((1, 1), length, dtype=torch.int32, device=x.device)
    planes = [p for p in ("k", "v", "k_scale", "v_scale") if p in cache]
    constrain = _input_layout(x)
    for i, lp in enumerate(_layer_params(params)):
        lc = {p: cache[p][i] for p in planes}
        lc["length"] = length
        if constrain is not None:
            x = constrain(x)
        x, _, _ = _layer(lp, x, pos, cfg, kv_cache=lc)
    x = rms_norm(x, params["final_norm"])
    logits = spmd.matmul(x, embed.T.to(cfg.dtype))[:, 0, :]
    return logits, dict(cache, length=length + 1)


def prefill(params: Params, tokens, cfg: TransformerConfig) -> torch.Tensor:
    """Prefill forward: last-position logits [B, V]. The unembed runs on
    the final position only — never materialises [B, S, V]."""
    x, _ = backbone(params, tokens, cfg)
    return spmd.matmul(x[:, -1, :], params["embed"].T.to(cfg.dtype))

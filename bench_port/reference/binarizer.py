"""The recurrent binarizer's encode (BEBR §3.2.1) in plain PyTorch.

    b_0   = sign(W_0(f))
    f̂_t   = normalize(R_t(b_t))
    r_t   = sign(W_{t+1}(normalize(f) - f̂_t))
    b_t+1 = b_t + 2^{-(t+1)} r_t

Each MLP is linear -> batch norm on its running statistics -> ReLU ->
linear, in eval mode; sign maps 0 to -1. A code packs the levels' bits,
level 0 the most significant. Products run in float32 with TF32 off
unless ``tf32=True`` asks for the lower precision (the control): then
both operands of every product are rounded to TF32's 10 mantissa bits
first, as TF32 tensor cores take them, on any device.

The weights come as ``(params, state)`` trees of numpy arrays, linear
weights ``(d_in, d_out)``; they are held transposed, as a linear layer
holds them, so that a product here calls the same matrix routine.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List

import numpy as np
import torch


@contextlib.contextmanager
def no_tf32():
    """Float32 products in full float32 for the block: the process's TF32
    switches off, restored after."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest TF32 value (10 mantissa bits,
    ties to even), still held as float32."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + 1e-12)


class _MLP:
    def __init__(self, p: Dict[str, Any], s: Dict[str, Any], device):
        def put(a, transpose=False):
            a = np.asarray(a, dtype=np.float32)
            return torch.from_numpy(np.ascontiguousarray(a.T if transpose else a)).to(device)

        self.hidden = "in" in p
        if self.hidden:
            self.w_in, self.b_in = put(p["in"]["w"], True), put(p["in"]["b"])
            self.scale, self.bias = put(p["bn_scale"]), put(p["bn_bias"])
            self.mean, self.var = put(s["bn_mean"]), put(s["bn_var"])
        self.w_out, self.b_out = put(p["out"]["w"], True), put(p["out"]["b"])

    def __call__(self, x: torch.Tensor, tf32: bool) -> torch.Tensor:
        def product(a, w):
            return torch.matmul(to_tf32(a), to_tf32(w).t()) if tf32 else torch.matmul(a, w.t())

        if not self.hidden:
            return product(x, self.w_out) + self.b_out
        h = product(x, self.w_in) + self.b_in
        h = (h - self.mean) * torch.rsqrt(self.var + 1e-5)
        h = torch.relu(h * self.scale + self.bias)
        return product(h, self.w_out) + self.b_out


class Binarizer:
    """Eval-mode encode of float embeddings [B, dim] into integer codes [B, m]."""

    def __init__(self, params: Dict[str, Any], state: Dict[str, Any], n_levels: int,
                 device="cuda"):
        self.n_levels = n_levels
        self.W = [_MLP(p, s, device) for p, s in zip(params["W"], state["W"])]
        self.R = [_MLP(p, s, device) for p, s in zip(params["R"], state["R"])]
        if len(self.W) != n_levels or len(self.R) != n_levels - 1:
            raise ValueError("weights do not match n_levels")

    def encode(self, f: torch.Tensor, tf32: bool = False) -> torch.Tensor:
        with torch.no_grad(), no_tf32():
            pre: List[torch.Tensor] = [self.W[0](f, tf32)]
            acc = torch.where(pre[0] > 0, 1.0, -1.0)
            for t in range(self.n_levels - 1):
                recon = _l2norm(self.R[t](acc, tf32))
                pre.append(self.W[t + 1](_l2norm(f) - recon, tf32))
                acc = acc + (2.0 ** -(t + 1)) * torch.where(pre[-1] > 0, 1.0, -1.0)
            codes = torch.zeros(pre[0].shape, dtype=torch.int32, device=f.device)
            for t, x in enumerate(pre):
                codes += (x > 0).to(torch.int32) << (self.n_levels - 1 - t)
            return codes.to(torch.int8)

"""Peaks of the chip and the work a request needs, counted from shapes.

The peaks are NVIDIA's data-sheet figures for one H100 SXM5 80GB at its
700 W limit (dense, without sparsity). A card set below 700 W runs below
them; every run prints the card's power limit beside its numbers.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
FP32_FLOPS_PER_S = 67e12  # outside the tensor cores: the encode runs with TF32 off


def binarizer_flops(cfg: dict) -> int:
    """Float32 FLOPs of one query's encode: the products of its n_levels
    binarization MLPs (d -> m) and n_levels - 1 reconstruction MLPs
    (m -> d), each linear -> hidden -> linear; elementwise work is left out."""
    d, m, n, h = cfg["input_dim"], cfg["code_dim"], cfg["n_levels"], cfg["hidden_dim"]

    def mlp(d_in, d_out):
        return 2 * (d_in * h + h * d_out) if h else 2 * d_in * d_out

    return n * mlp(d, m) + (n - 1) * mlp(m, d)


def least_time_s(nbytes: float, int8_ops: float) -> float:
    """The least time the chip needs for a kernel's work: the larger of its
    bytes over HBM bandwidth and its int8 operations over the int8 peak."""
    return max(nbytes / HBM_BYTES_PER_S, int8_ops / INT8_OPS_PER_S)


def query_need_s(cfg: dict, search_ops_per_query: float) -> float:
    """Seconds of the chip's peak one query needs: its encode's FLOPs at the
    float32 peak plus its search's int8 operations at the int8 peak."""
    return binarizer_flops(cfg) / FP32_FLOPS_PER_S + search_ops_per_query / INT8_OPS_PER_S

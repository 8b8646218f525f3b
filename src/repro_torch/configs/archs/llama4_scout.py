"""llama4-scout-17b-a16e: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 [hf:meta-llama/Llama-4-Scout-17B-16E]."""
import torch

from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="llama4-scout-17b-a16e", n_layers=48, d_model=5120, n_heads=40,
    n_kv_heads=8, d_ff=8192, vocab=202048, head_dim=128,
    n_experts=16, top_k=1, capacity_factor=1.25,
    rope_theta=500000.0, dtype=torch.bfloat16, microbatches=4,
    remat=True, attn_chunk=512, kv_cache_dtype=torch.bfloat16,
    moe_group=2048,
)

SMOKE = TransformerConfig(
    name="llama4-scout-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=512, head_dim=16,
    n_experts=4, top_k=1, dtype=torch.float32, microbatches=1,
    remat=False, attn_chunk=0,
)

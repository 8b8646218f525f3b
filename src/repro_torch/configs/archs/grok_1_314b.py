"""grok-1-314b: 64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072,
MoE 8 experts top-2 [hf:xai-org/grok-1]."""
import torch

from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="grok-1-314b", n_layers=64, d_model=6144, n_heads=48,
    n_kv_heads=8, d_ff=32768, vocab=131072, head_dim=128,
    n_experts=8, top_k=2, capacity_factor=1.25,
    rope_theta=10000.0, dtype=torch.bfloat16, microbatches=4,
    remat=True, attn_chunk=512, kv_cache_dtype=torch.bfloat16,
    moe_group=2048,
)

SMOKE = TransformerConfig(
    name="grok-1-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=512, head_dim=16,
    n_experts=4, top_k=2, dtype=torch.float32, microbatches=1,
    remat=False, attn_chunk=0,
)

"""mistral-large-123b: 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768 [hf:mistralai/Mistral-Large-Instruct-2407]."""
import torch

from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="mistral-large-123b", n_layers=88, d_model=12288, n_heads=96,
    n_kv_heads=8, d_ff=28672, vocab=32768, head_dim=128,
    rope_theta=1000000.0, dtype=torch.bfloat16, microbatches=4,
    remat=True, attn_chunk=512, kv_cache_dtype=torch.int8,
)

SMOKE = TransformerConfig(
    name="mistral-large-123b-smoke", n_layers=2, d_model=96, n_heads=6,
    n_kv_heads=2, d_ff=192, vocab=512, head_dim=16,
    dtype=torch.float32, microbatches=1, remat=False, attn_chunk=0,
)

"""llama3-405b: 126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256
[arXiv:2407.21783]."""
import torch

from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="llama3-405b", n_layers=126, d_model=16384, n_heads=128,
    n_kv_heads=8, d_ff=53248, vocab=128256, head_dim=128,
    rope_theta=500000.0, dtype=torch.bfloat16, microbatches=8,
    remat=True, attn_chunk=512, kv_cache_dtype=torch.int8,
)

SMOKE = TransformerConfig(
    name="llama3-405b-smoke", n_layers=2, d_model=128, n_heads=8,
    n_kv_heads=2, d_ff=256, vocab=512, head_dim=16,
    dtype=torch.float32, microbatches=1, remat=False, attn_chunk=0,
)

"""llama3.2-1b: 16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256
[hf:meta-llama/Llama-3.2-1B]."""
import torch

from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="llama3.2-1b", n_layers=16, d_model=2048, n_heads=32,
    n_kv_heads=8, d_ff=8192, vocab=128256, head_dim=64,
    rope_theta=500000.0, dtype=torch.bfloat16, microbatches=1,
    remat=True, attn_chunk=1024, kv_cache_dtype=torch.bfloat16,
)

SMOKE = TransformerConfig(
    name="llama3.2-1b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
    dtype=torch.float32, microbatches=1, remat=False, attn_chunk=0,
)

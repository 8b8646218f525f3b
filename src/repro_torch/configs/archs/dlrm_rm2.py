"""dlrm-rm2: 13 dense, 26 sparse, embed 64, bot 13-512-256-64,
top 512-512-256-1, dot interaction [arXiv:1906.00091]."""
from repro_torch.models.recsys.dlrm import DLRMConfig

CONFIG = DLRMConfig(
    name="dlrm-rm2", n_dense=13, n_sparse=26, embed_dim=64,
    bot_mlp=(13, 512, 256, 64), top_mlp_hidden=(512, 512, 256, 1),
    table_vocab=1_048_576,
)

SMOKE = DLRMConfig(
    name="dlrm-rm2-smoke", n_dense=13, n_sparse=26, embed_dim=16,
    bot_mlp=(13, 64, 32, 16), top_mlp_hidden=(64, 32, 1),
    table_vocab=1000,
)

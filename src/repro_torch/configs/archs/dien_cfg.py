"""dien: embed 18, seq 100, gru 108, MLP 200-80, AUGRU [arXiv:1809.03672]."""
from repro_torch.models.recsys.dien import DIENConfig

CONFIG = DIENConfig(
    name="dien", embed_dim=18, seq_len=100, gru_dim=108, mlp=(200, 80),
    item_vocab=524_288, cate_vocab=8_192,
)

SMOKE = DIENConfig(
    name="dien-smoke", embed_dim=8, seq_len=20, gru_dim=24, mlp=(32, 16),
    item_vocab=500, cate_vocab=20,
)

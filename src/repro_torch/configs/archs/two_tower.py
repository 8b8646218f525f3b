"""two-tower-retrieval: embed 256, towers 1024-512-256, dot similarity,
sampled softmax [RecSys'19 YouTube]. The paper's native EBR architecture."""
from repro_torch.models.recsys.two_tower import TwoTowerConfig

CONFIG = TwoTowerConfig(
    name="two-tower-retrieval", embed_dim=256, tower_mlp=(1024, 512, 256),
    user_vocab=2_097_152, item_vocab=2_097_152, hist_len=32,
)

SMOKE = TwoTowerConfig(
    name="two-tower-smoke", embed_dim=32, tower_mlp=(64, 32),
    user_vocab=1000, item_vocab=1000, hist_len=8,
)

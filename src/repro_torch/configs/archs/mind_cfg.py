"""mind: embed_dim=64, 4 interests, 3 capsule iters [arXiv:1904.08030]."""
from repro_torch.models.recsys.mind import MINDConfig

CONFIG = MINDConfig(
    name="mind", embed_dim=64, n_interests=4, capsule_iters=3,
    item_vocab=1_048_576, hist_len=50,
)

SMOKE = MINDConfig(
    name="mind-smoke", embed_dim=16, n_interests=2, capsule_iters=2,
    item_vocab=1000, hist_len=10,
)

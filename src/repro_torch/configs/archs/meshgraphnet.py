"""meshgraphnet: 15 layers, d_hidden=128, sum aggregator, 2-layer MLPs
[arXiv:2010.03409]. Per-shape input dims come from the reference's configs/cells.py."""
from repro_torch.models.gnn import GNNConfig

CONFIG = GNNConfig(
    name="meshgraphnet", n_layers=15, d_hidden=128, mlp_layers=2,
    aggregator="sum", d_out=3,
)

SMOKE = GNNConfig(
    name="meshgraphnet-smoke", n_layers=3, d_hidden=16, mlp_layers=2,
    aggregator="sum", d_node_in=8, d_edge_in=4, d_out=3,
)

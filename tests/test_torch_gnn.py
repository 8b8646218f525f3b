"""MeshGraphNet in the PyTorch port (``repro_torch/models/gnn.py``, its
config and the GNN steps) against the JAX reference, on the reference's
weights (as numpy, through ``gnn_from_numpy``) and batches, on the CPU.

Tolerances (float32):
  * ``forward``: 1e-5 of the largest output, with the sum and the max
    aggregator, with and without an edge mask (segment sums add each
    node's edges in the reference's order);
  * ``mse_loss`` with and without a node mask: 1e-5 relative;
  * one ``gnn_train_step``: the loss and gradient norm 1e-5 relative,
    Adam's moments within 1e-4 of each leaf's largest entry, the
    parameters within 1e-5 of each leaf's largest entry;
  * ``gnn_infer_step`` as ``forward``; ``param_count`` exactly.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.archs import meshgraphnet as RC  # noqa: E402
from repro.data import synthetic as RS  # noqa: E402
from repro.models import gnn as R  # noqa: E402
from repro.train import optim as RO  # noqa: E402
from repro.train import steps as RST  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs.archs import meshgraphnet as PC  # noqa: E402
from repro_torch.models import gnn as P  # noqa: E402
from repro_torch.train import optim as PO  # noqa: E402
from repro_torch.train import steps as PST  # noqa: E402
from repro_torch.train.checkpoint import flatten_tree  # noqa: E402

TOL = 1e-5
KEYS = ("node_feat", "edge_feat", "senders", "receivers", "targets")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: a step is hundreds of small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _world(aggregator="sum", masks=False, seed=0, n_nodes=64, n_edges=256, **kw):
    rcfg = dataclasses.replace(RC.SMOKE, aggregator=aggregator, **kw)
    pcfg = dataclasses.replace(PC.SMOKE, aggregator=aggregator, **kw)
    params = _np(R.init_params(jax.random.PRNGKey(seed), rcfg))
    batch = _np(RS.gnn_batch(seed, n_nodes, n_edges, rcfg))
    if masks:
        rng = np.random.default_rng(seed)
        batch["edge_mask"] = rng.random(n_edges) < 0.8
        batch["node_mask"] = rng.random(n_nodes) < 0.7
        # a node no edge reaches: its max aggregate is empty (-inf -> 0)
        batch["receivers"] = np.where(batch["receivers"] == 5, 6, batch["receivers"])
    return params, batch, rcfg, pcfg


def _err(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    return float(np.abs(got.astype(np.float64) - want).max()) / max(float(np.abs(want).max()),
                                                                   1e-30)


@pytest.mark.parametrize("masks", [False, True])
@pytest.mark.parametrize("aggregator", ["sum", "max"])
def test_forward_and_loss_match_the_reference(aggregator, masks):
    params, batch, rcfg, pcfg = _world(aggregator, masks)
    tree = P.gnn_from_numpy(params, "cpu")
    tb = _t(batch)
    em = batch.get("edge_mask")
    want = R.forward(params, *(batch[k] for k in KEYS[:4]), edge_mask=em, cfg=rcfg)
    got = P.forward(tree, *(tb[k] for k in KEYS[:4]), edge_mask=tb.get("edge_mask"), cfg=pcfg)
    assert got.shape == (64, 3) and _err(got, want) <= TOL
    want = R.mse_loss(params, *(batch[k] for k in KEYS), node_mask=batch.get("node_mask"),
                      edge_mask=em, cfg=rcfg)
    got = P.mse_loss(tree, *(tb[k] for k in KEYS), node_mask=tb.get("node_mask"),
                     edge_mask=tb.get("edge_mask"), cfg=pcfg)
    assert abs(float(got) - float(want)) <= TOL * abs(float(want))
    infer = PST.gnn_infer_step(pcfg)(tree, tb)
    assert _err(infer, R.forward(params, *(batch[k] for k in KEYS[:4]), edge_mask=em,
                                 cfg=rcfg)) <= TOL


@pytest.mark.parametrize("masks", [False, True])
@pytest.mark.parametrize("aggregator", ["sum", "max"])
def test_gnn_train_step_matches_the_reference(aggregator, masks):
    params, batch, rcfg, pcfg = _world(aggregator, masks, seed=1)
    radam = RO.AdamConfig(lr=3e-4, clip_norm=1.0)
    padam = PO.AdamConfig(lr=3e-4, clip_norm=1.0)
    rp, ropt, rm = jax.jit(RST.gnn_train_step(rcfg, radam))(params, RO.adam_init(params), batch)
    tree = P.gnn_from_numpy(params, "cpu")
    pp, popt, pm = PST.gnn_train_step(pcfg, padam)(tree, PST.init_opt_state(tree), _t(batch))
    assert abs(float(pm["loss"]) - float(rm["loss"])) <= TOL * abs(float(rm["loss"]))
    assert abs(float(pm["grad_norm"]) - float(rm["grad_norm"])) <= TOL * float(rm["grad_norm"])
    for name in ("mu", "nu"):
        want = flatten_tree(_np(getattr(ropt, name)))
        got = getattr(popt, name)
        assert list(got) == list(want)
        for k in want:
            assert _err(got[k], want[k]) <= 1e-4, (name, k)
    want = flatten_tree(_np(rp))
    got = flatten_tree(pp)
    assert list(got) == list(want)
    for k in want:
        assert _err(got[k], want[k]) <= TOL, k


def test_remat_changes_no_gradient():
    """``remat`` (torch.utils.checkpoint per layer) gives the same loss
    and gradients as the plain backward, bit for bit."""
    params, batch, _, pcfg = _world("max", True)
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(pcfg, remat=remat)
        tree = P.gnn_from_numpy(params, "cpu")
        out.append(PST._value_and_grad(
            lambda p, b: P.mse_loss(p, *(b[k] for k in KEYS), node_mask=b["node_mask"],
                                    edge_mask=b["edge_mask"], cfg=cfg), tree, _t(batch)))
    assert torch.equal(out[0][0], out[1][0])
    for k in out[0][1]:
        assert torch.equal(out[0][1][k], out[1][1][k]), k


def test_segment_max_of_an_empty_segment():
    rows = torch.tensor([[1.0, -2.0], [3.0, -5.0], [-1.0, 4.0]])
    got = P.segment_max(rows, torch.tensor([0, 0, 2]), 4)
    assert torch.equal(got[0], torch.tensor([3.0, -2.0]))
    assert bool(torch.isinf(got[1]).all() and torch.isinf(got[3]).all())
    assert torch.equal(got[2], torch.tensor([-1.0, 4.0]))


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_config_and_param_count_match_the_reference(which):
    rcfg, pcfg = getattr(RC, which), getattr(PC, which)
    for f in R.GNNConfig.__dataclass_fields__:
        if f != "dtype":
            assert getattr(pcfg, f) == getattr(rcfg, f), f
    assert pcfg.param_count() == rcfg.param_count()
    tree = P.init_params(pcfg, prng.key(0, "cpu"), "cpu")
    shapes = flatten_tree(_np(R.init_params(jax.random.PRNGKey(0), rcfg)))
    flat = flatten_tree(tree)
    assert list(flat) == list(shapes)
    for k, a in shapes.items():
        assert tuple(flat[k].shape) == a.shape and flat[k].dtype == torch.float32, k
    # the reference's param_count counts ``mlp_layers`` linear layers an
    # MLP, its init_params builds mlp_layers + 1: the port keeps both
    assert len(tree["decoder"]) == pcfg.mlp_layers + 1
    assert sum(t.numel() for t in flat.values()) == sum(a.size for a in shapes.values())

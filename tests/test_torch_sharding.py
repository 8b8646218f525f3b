"""Sharding specs and sharded state of the PyTorch port
(``repro_torch/parallel/sharding.py``) against the JAX reference
(``repro/parallel/sharding.py``).

The reference runs once, in one subprocess with 512 forced host devices
(``tests/_torch_cells_ref.py``). Every spec of the port equals the
reference's ``PartitionSpec`` on (4, 2), (16, 16) and (2, 16, 16) meshes:
the five LM configs' parameters (llama4-scout's 16 experts are expert
parallel at model 16 and 2, grok-1's 8 are not at model 16), activation
constraint and caches, the four recsys trees, meshgraphnet and the batch
rules. ``shard_tree``/``gather_tree`` round-trip bit for bit, padding
included. The twins of ``test_sharded_lm_train_step_runs`` and
``test_elastic_resume_across_mesh_shapes`` start from the reference's
parameters and batches, carried over as numpy: the port gathers the
sharded state, runs its step and lays the state out again; its losses
agree with the reference's sharded runs within LOSS_RTOL (the largest
relative difference measured on the CPU was 8.8e-8, under one float32
ulp: sums in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cells_ref import run_reference  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.configs.registry import REGISTRY, get_arch  # noqa: E402
from repro_torch.launch.mesh import LeafMesh  # noqa: E402
from repro_torch.models import gnn as PG  # noqa: E402
from repro_torch.models import transformer as PTF  # noqa: E402
from repro_torch.models.recsys import dien, dlrm, mind, two_tower  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.train import checkpoint as ck  # noqa: E402
from repro_torch.train import optim, steps  # noqa: E402

torch.set_num_threads(1)
LOSS_RTOL = 2e-6
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
RECSYS = {"mind": (lambda c: mind.init_params(c, prng.key(0, "meta"), "meta"), ("item_table",), ()),
          "dlrm-rm2": (lambda c: dlrm.init_dlrm(c, prng.key(0, "meta"), "meta").tree(), (),
                       ("tables",)),
          "two-tower-retrieval": (lambda c: two_tower.init_params(c, prng.key(0, "meta"), "meta"),
                                  ("user_table", "item_table"), ()),
          "dien": (lambda c: dien.init_params(c, prng.key(0, "meta"), "meta"),
                   ("item_table", "cate_table"), ())}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharding")
    return dict(run_reference(tmp, ["specs", "runs"]), dir=tmp)


def _mesh(name, device="meta"):
    shape, axes = MESHES[name]
    return LeafMesh(shape, axes, [device] * int(np.prod(shape)))


def _spec(s: shd.Sharding):
    return [list(e) if isinstance(e, tuple) else e for e in s.spec]


def _specs(tree):
    return {k: _spec(s) for k, s in ck.flatten_tree(tree).items()}


def _port_specs(mesh):
    out = {"dp_axes": list(shd.dp_axes(mesh))}
    for arch, entry in REGISTRY.items():
        cfg = entry.config
        if entry.family == "lm":
            out[f"lm_param/{arch}"] = _specs(shd.lm_param_sharding(mesh, cfg))
            out[f"lm_activation/{arch}"] = _spec(shd.lm_activation_constraint(mesh, cfg).sharding)
            for cp in (False, True):
                cache = shd.lm_cache_sharding(mesh, cfg, context_parallel=cp)
                out[f"lm_cache/{arch}/{cp}"] = _specs(cache)
        elif entry.family == "recsys":
            init, tables, stacked = RECSYS[arch]
            tree = init(cfg)
            out[f"recsys_param/{arch}"] = _specs(
                shd.fill_param_sharding(mesh, tree, tables, stacked))
            out[f"replicate/{arch}"] = _specs(shd.replicate_like(mesh, tree))
        else:
            tree = PG.init_params(cfg, prng.key(0, "meta"), "meta")
            out[f"gnn_param/{arch}"] = _specs(shd.gnn_param_sharding(mesh, tree))
    for name in ("lm_batch_sharding", "recsys_table_sharding", "recsys_batch_sharding",
                 "gnn_edge_sharding", "gnn_edge_feat_sharding", "gnn_node_sharding"):
        out[name] = _spec(getattr(shd, name)(mesh))
    out["ns"] = _spec(shd.ns(mesh, None, ("data",), "model"))
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_every_spec_equals_the_reference(ref, mesh_name):
    want = ref["specs"][mesh_name]
    got = _port_specs(_mesh(mesh_name))
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name


def test_moe_branches():
    """Expert parallel exactly when the experts divide ``model``."""
    scout, grok = get_arch("llama4-scout-17b-a16e").config, get_arch("grok-1-314b").config
    big = _mesh("16x16")
    small = LeafMesh((8, 2), ("data", "model"), ["meta"] * 16)
    assert (scout.n_experts, grok.n_experts) == (16, 8)
    assert shd.lm_param_sharding(big, scout)["layers"]["w_gate"].spec == (None, "model", "data",
                                                                          None)
    assert shd.lm_param_sharding(big, grok)["layers"]["w_gate"].spec == (None, None, "data",
                                                                         "model")
    assert shd.lm_param_sharding(small, grok)["layers"]["w_gate"].spec == (None, "model", "data",
                                                                           None)


def test_activation_constraint_is_a_checked_identity():
    mesh = _mesh("4x2")
    constrain = shd.lm_activation_constraint(mesh, get_arch("llama3.2-1b").smoke_config)
    x = torch.randn(3, 5, 7)
    assert constrain(x) is x
    with pytest.raises(ValueError, match="more entries"):
        constrain(torch.randn(3, 5))


def test_shard_shapes_pad_by_ceiling_division():
    mesh = _mesh("16x16")
    s = shd.Sharding(mesh, (("data", "model"), None))
    assert s.shard_shape((1000, 3)) == (4, 3)  # 1000 over 256 leaves: 3.9 -> 4
    assert s.shard_bytes((1000, 3), torch.float32) == 48
    assert shd.Sharding(mesh, ("model",)).shard_shape((7, 5, 2)) == (1, 5, 2)
    with pytest.raises(ValueError, match="twice"):
        shd.Sharding(mesh, ("data", ("model", "data")))
    with pytest.raises(ValueError, match="no axis"):
        shd.Sharding(mesh, ("pod",))


@pytest.mark.parametrize("mesh_name", ["4x2", "2x16x16"])
def test_shard_tree_round_trip(mesh_name):
    mesh = _mesh(mesh_name, "cpu")
    g = torch.Generator().manual_seed(0)
    dp = shd.dp_axes(mesh)
    tree = {"w": torch.randn((10, 7), generator=g),
            "layers": [torch.randn((3, 9, 5), generator=g).to(torch.bfloat16),
                       torch.randint(0, 9, (11,), generator=g, dtype=torch.int32)],
            "mask": torch.rand((13, 2), generator=g) > 0.5,
            "step": 4}
    sh = {"w": shd.ns(mesh, dp, "model"),
          "layers": [shd.ns(mesh, None, "model", dp), shd.ns(mesh, dp + ("model",))],
          "mask": shd.ns(mesh), "step": shd.ns(mesh)}
    sharded = shd.shard_tree(tree, sh)
    assert sharded["step"] == 4
    for key, leaf in ck.flatten_tree(sharded).items():
        if key.endswith("['step']"):
            continue
        spec = ck.flatten_tree(sh)[key]
        assert len(leaf.pieces) == mesh.n_leaves
        assert all(tuple(p.shape) == spec.shard_shape(leaf.shape) for p in leaf.pieces)
        assert set(leaf.leaf_bytes()) == {spec.shard_bytes(leaf.shape, leaf.dtype)}
    assert sum(sum(v.leaf_bytes()) for k, v in ck.flatten_tree(sharded).items()
               if k != "['step']") == mesh.n_leaves * shd.tree_leaf_bytes(tree, sh)
    # every leaf holds its rows and columns of "w", zero-padded past the end
    w, spec = sharded["w"], sh["w"]
    rows, cols = spec.shard_shape(w.shape)
    positions = np.ndindex(*mesh.shape)
    for pos, piece in zip(positions, w.pieces):
        i, j = spec.piece_index(pos)
        want = torch.zeros((rows, cols))
        part = tree["w"][i * rows:(i + 1) * rows, j * cols:(j + 1) * cols]
        want[:part.shape[0], :part.shape[1]] = part
        assert torch.equal(piece, want), pos
    back = shd.gather_tree(sharded, "cpu")
    for a, b in zip(ck.flatten_tree(back).values(), ck.flatten_tree(tree).values()):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b


# ---------------------------------------------------------------------------
# The reference's sharded-state tests, on the port.
# ---------------------------------------------------------------------------


def _params(ref_dir):
    cfg = get_arch("llama3.2-1b").smoke_config
    like = PTF.init_params(cfg, prng.key(0, "cpu"), device="cpu")
    arrays = np.load(ref_dir / "ref.json.params.npz")
    return cfg, ck.unflatten_tree(like, [torch.from_numpy(arrays[k])
                                         for k in ck.flatten_tree(like)])


def _batches(ref_dir):
    arrays = np.load(ref_dir / "ref.json.batches.npz")
    return [{k: torch.from_numpy(arrays[f"{i}/{k}"]) for k in ("tokens", "labels")}
            for i in range(4)]


def _layout(mesh, cfg):
    psh = shd.lm_param_sharding(mesh, cfg)
    flat = ck.flatten_tree(psh)
    opt_sh = optim.AdamState(step=shd.ns(mesh), mu=dict(flat), nu=dict(flat))
    bsh = {"tokens": shd.lm_batch_sharding(mesh), "labels": shd.lm_batch_sharding(mesh)}
    return psh, opt_sh, bsh


def _sharded_steps(step, mesh, cfg, params, opt, batches):
    """``step`` over state laid out on ``mesh``: returns the gathered state and the losses."""
    psh, opt_sh, bsh = _layout(mesh, cfg)
    p, o = shd.shard_tree(params, psh), shd.shard_tree(opt, opt_sh)
    losses = []
    for batch in batches:
        p, o, metrics = shd.run_gathered(step, (p, o, shd.shard_tree(batch, bsh)), "cpu",
                                         (psh, opt_sh, None))
        losses.append(float(metrics["loss"]))
    return shd.gather_tree(p, "cpu"), shd.gather_tree(o, "cpu"), losses


def test_sharded_lm_train_step_runs(ref):
    cfg, params = _params(ref["dir"])
    batch = _batches(ref["dir"])[0]
    step = steps.lm_train_step(cfg, optim.AdamConfig(lr=1e-3))
    _, _, losses = _sharded_steps(step, _mesh("4x2", "cpu"), cfg, params,
                                  steps.init_opt_state(params), [batch, batch])
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses, ref["runs"]["sharded_step"], rtol=LOSS_RTOL)


def test_elastic_resume_across_mesh_shapes(ref, tmp_path):
    """Save a sharded train state from (4, 2), restore it on (2, 2), one step."""
    cfg, params = _params(ref["dir"])
    batches = _batches(ref["dir"])
    step = steps.lm_train_step(cfg, optim.AdamConfig(lr=1e-3))
    params, opt, losses = _sharded_steps(step, _mesh("4x2", "cpu"), cfg, params,
                                         steps.init_opt_state(params), batches[:3])
    ck.save(str(tmp_path), 3, steps.train_state_tree(params, opt))
    _, fresh = _params(ref["dir"])
    (params, opt), start = ck.restore(str(tmp_path), steps.train_state_tree(
        fresh, steps.init_opt_state(fresh)))
    params, opt = steps.train_state_from_tree((params, opt))
    small = LeafMesh((2, 2), ("data", "model"), ["cpu"] * 4)
    _, _, resumed = _sharded_steps(step, small, cfg, params, opt, [batches[start]])
    assert start == 3 == ref["runs"]["elastic"]["start"] and opt.step == 3
    np.testing.assert_allclose(losses + resumed, ref["runs"]["elastic"]["losses"],
                               rtol=LOSS_RTOL)

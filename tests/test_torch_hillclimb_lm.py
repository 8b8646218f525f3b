"""The LM family's sharded step (``repro_torch/models/transformer.py`` on
``repro_torch/parallel/spmd.py``) against the JAX reference's GSPMD
records, at 2 layers and the production widths, and with values over a
gloo group.

Both packages' hillclimb builders run with ``configs/cells.lm_cell`` set to
2 layers: llama3-405b train_4k's 12 variants (``baseline`` also on
2x16x16), grok-1 prefill_32k's two, and llama3-405b's decode_32k and
prefill_32k cells as the dry run builds them. The reference compiles them
with GSPMD in one subprocess (``tests/_torch_hillclimb_ref.py``); the port
counts rank 0 of a fake process group on meta tensors. Held:

  * FLOPs a device equal the reference's for every train variant and for
    decode (each the whole step's over the device count: nothing runs
    twice); at most the reference's for the prefill cells, where GSPMD runs
    the projections over the whole batch on every data shard (llama: 4.8x
    the whole step's share; the port's is that share; grok's within 0.1%
    of it, its 8 experts' dispatch split over the features on the 16 model
    shards);
  * wire a device at most the reference's (whose CPU compile moves the
    bf16 weights as float32);
  * no operator replicated;
  * the peak at most twice the reference's.

Eight gloo ranks (``LeafMesh((2, 4))``: 8 query heads and 2 key/value
heads over a model axis of 4) run SMOKE llama's train step (sequence
sharded, chunked attention, 2 microbatches, remat), prefill and 6 decode
steps over a bf16 and an int8 cache laid out by positions (the decode
cell's layout) and by batch only, and SMOKE grok's prefill with routing
groups: loss, gradients and logits equal the unsharded ones within float32
reduction-order tolerances. Two MoE variants (``MOE``) run the same way:
SMOKE llama4-scout with 6 query heads, which the model axis of 4 does not
divide (split by hand, 2 or 1 a shard; 4 experts, expert parallel), its
train step, prefill and decode over caches laid out by positions, by batch
and by positions over the data axis (long_500k's layout); and SMOKE grok
with 2 experts, fewer than the model shards (tensor parallel inside the
experts), its train step and prefill, both with routing groups. The reference runs the same steps on the same
weights and layouts under GSPMD over 8 host devices, and the gloo ranks'
results equal its too: the loss within 1e-5 relative, each gradient leaf
and the prefill and float-cache logits within 1e-5 of their largest
magnitude (float32 sums in other orders), the int8-cache logits within
5e-3 of each row's largest (``tests/test_torch_transformer.py``'s bound:
a float32 difference can round a cache entry to the next int8 step).
"""

import dataclasses
import math
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_hillclimb_ref import LM_ARCH, run_reference  # noqa: E402
from repro_torch.configs import cells as cells_mod  # noqa: E402
from repro_torch.configs.archs import grok_1_314b, llama3_405b, llama4_scout  # noqa: E402
from repro_torch.launch import hillclimb as hc  # noqa: E402
from repro_torch.launch import hlo_cost  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.parallel import spmd  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
N_LAYERS = 2
LLAMA = sorted(hc.VARIANTS["llama405b_train"])
GROK = sorted(hc.VARIANTS["grok_prefill"])
WANTED = [["llama405b_train", "*", False], ["grok_prefill", "*", False],
          [LM_ARCH, "decode_32k", False], [LM_ARCH, "prefill_32k", False],
          ["llama405b_train", "baseline", True]]
EXACT = ([f"llama405b_train|{v}|16x16" for v in LLAMA] + ["llama405b_train|baseline|2x16x16",
                                                           f"{LM_ARCH}|decode_32k|16x16"])
AT_MOST = [f"grok_prefill|{v}|16x16" for v in GROK] + [f"{LM_ARCH}|prefill_32k|16x16"]
ALL = EXACT + AT_MOST


def _at_depth(n_layers):
    """``configs/cells.lm_cell`` building every LM cell at ``n_layers``."""
    lm_cell = cells_mod.lm_cell
    return lambda cfg, shape_id, mesh: lm_cell(dataclasses.replace(cfg, n_layers=n_layers),
                                               shape_id, mesh)


def _cell_args(cell, variant, multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod, devices=["meta"] * (512 if multi_pod else 256))
    if cell == LM_ARCH:
        spec = cells_mod.lm_cell(llama3_405b.CONFIG, variant, mesh)
        return (spec.fn, spec.in_shardings, spec.abstract_args), mesh
    return hc.VARIANTS[cell][variant](mesh), mesh


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(tmp_path_factory.mktemp("hillclimb_lm"), WANTED, n_layers=N_LAYERS)


@pytest.fixture(scope="module")
def port():
    torch.set_num_threads(1)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cells_mod, "lm_cell", _at_depth(N_LAYERS))
        for key in ALL:
            cell, variant, mesh_name = key.split("|")
            (fn, shardings, args), mesh = _cell_args(cell, variant, mesh_name == "2x16x16")
            out[key] = hc._measure(fn, shardings, args, mesh)
            if key == f"{LM_ARCH}|prefill_32k|16x16":
                out["prefill whole"] = hlo_cost.step_costs(fn, *args)["flops"]
            if cell == "grok_prefill":
                out[key + " whole"] = hlo_cost.step_costs(fn, *args)["flops"]
    return out


@pytest.mark.parametrize("key", EXACT)
def test_flops_equal_the_reference(ref, port, key):
    assert port[key]["ok"]
    assert port[key]["flops"] == ref[key]["flops"]


@pytest.mark.parametrize("key", AT_MOST)
def test_prefill_flops_at_most_the_reference(ref, port, key):
    assert port[key]["flops"] <= ref[key]["flops"]
    if key.startswith(LM_ARCH):  # the whole step's share: nothing runs twice
        assert port[key]["flops"] == port["prefill whole"] // 256
        assert ref[key]["flops"] > 4.7 * port[key]["flops"]
    else:  # the whole step's share but the router's columns (8 over 16 shards)
        assert port[key]["flops"] <= 1.001 * port[key + " whole"] / 256
        assert ref[key]["flops"] == 148_240_997_548_032


@pytest.mark.parametrize("key", ALL)
def test_wire_at_most_the_reference(ref, port, key):
    assert port[key]["wire_bytes"] <= ref[key]["wire_bytes"]


def test_residual_constraint_variants_equal(ref, port):
    """sp_residual pins the residual stream after each add to the layout
    no_seq_sharding pins it to before each layer (the batch split, the
    sequence whole): the reference reads the two alike, and so does the
    port, whose residual adds take the stream's layout by hand."""
    for rec in (ref, port):
        a, b = (rec[f"llama405b_train|{v}|16x16"] for v in ("no_seq_sharding", "sp_residual"))
        assert (a["flops"], a["wire_bytes"]) == (b["flops"], b["wire_bytes"])


@pytest.mark.parametrize("key", ALL)
def test_nothing_replicated(port, key):
    assert port[key]["replicated"] == {}, port[key]["replicated_at"]


@pytest.mark.parametrize("key", ALL)
def test_peak_at_most_twice_the_reference(ref, port, key):
    print(f"{key}: peak {port[key]['peak_gib']:.3f} GiB, reference {ref[key]['peak_gib']:.3f}")
    assert port[key]["peak_gib"] <= 2 * ref[key]["peak_gib"]


@pytest.mark.parametrize("n,groups", [(8, 16), (3, 6), (4, 2), (2, 3), (5, 4), (1, 7)])
def test_kv_for_heads(n, groups):
    """The key/value heads a rank's query heads use, for every rank's run
    of ``n`` heads: head h of the run pairs with key/value head h // groups."""
    H = 4 * max(n, groups) * n * groups
    KV = H // groups
    k = torch.arange(KV, dtype=torch.float32).reshape(1, KV, 1, 1).expand(2, KV, 3, 4)
    for h0 in range(0, H, n):
        kl, vl = spmd._kv_for_heads(k, k + 0.5, h0, n, groups)
        per = n // kl.shape[1]
        got = kl[0, :, 0, 0].repeat_interleave(per)
        assert got.tolist() == [h // groups for h in range(h0, h0 + n)]
        assert torch.equal(vl, kl + 0.5)


# ---------------------------------------------------------------------------
# Values over 8 gloo ranks, and the reference over 8 host devices.
# ---------------------------------------------------------------------------

B, S, T, STEPS = 4, 32, 16, 6
# the MoE variants, as both scripts build them: 6 query heads over the model
# axis of 4 (split by hand, 2 or 1 a shard) with 4 experts (expert
# parallel), and 2 experts (tensor parallel inside the experts)
MOE = {"scout": dataclasses.replace(llama4_scout.SMOKE, n_heads=6, n_kv_heads=2, attn_chunk=8,
                                    microbatches=2, remat=True, moe_group=8),
       "grok2": dataclasses.replace(grok_1_314b.SMOKE, n_experts=2, microbatches=2, remat=True,
                                    moe_group=8)}

# the world's weights (flat "<model>/<leaf>" arrays) as a model's tree
_TREE = """
def tree(world, name, wrap):
    p = name + "/layers/"
    return {"embed": wrap(world[name + "/embed"]), "final_norm": wrap(world[name + "/final_norm"]),
            "layers": {k[len(p):]: wrap(v) for k, v in world.items() if k.startswith(p)}}
"""

_REF = _TREE + """
import dataclasses, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs.archs import grok_1_314b, llama3_405b, llama4_scout
from repro.models import transformer as tf
from repro.parallel import sharding as shd
from repro.train import steps

world, out_path = dict(np.load(sys.argv[1])), sys.argv[2]
mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
cfg = dataclasses.replace(llama3_405b.SMOKE, attn_chunk=8, microbatches=2, remat=True)
grok = dataclasses.replace(grok_1_314b.SMOKE, moe_group=8)
moe = {"scout": dataclasses.replace(llama4_scout.SMOKE, n_heads=6, n_kv_heads=2, attn_chunk=8,
                                    microbatches=2, remat=True, moe_group=8),
       "grok2": dataclasses.replace(grok_1_314b.SMOKE, n_experts=2, microbatches=2, remat=True,
                                    moe_group=8)}
params, gparams = tree(world, "llama", jnp.asarray), tree(world, "grok", jnp.asarray)
tokens, steps_tok = world["tokens"], world["steps_tok"]
batch = {"tokens": tokens, "labels": world["labels"]}
dp = shd.dp_axes(mesh)
tok_sh = shd.lm_batch_sharding(mesh)
layouts = {"positions": shd.ns(mesh, None, dp, None, "model", None),
           "batch": shd.ns(mesh, None, dp, None, None, None),
           "long": shd.ns(mesh, None, None, None, dp, None)}
res = {}


def train(prefix, c, p):
    constrain = shd.lm_activation_constraint(mesh, c)
    loss_fn = lambda p, b: tf.lm_loss(p, b["tokens"], b["labels"], c, constrain=constrain)
    loss, grads = jax.jit(lambda p, b: steps._accumulate_grads(loss_fn, p, b, c.microbatches),
                          in_shardings=(shd.lm_param_sharding(mesh, c),
                                        {"tokens": tok_sh, "labels": tok_sh}))(p, batch)
    res[prefix + "loss"] = loss
    res[prefix + "grad/['embed']"], res[prefix + "grad/['final_norm']"] = (grads["embed"],
                                                                         grads["final_norm"])
    res.update({f"{prefix}grad/['layers']/['{k}']": g for k, g in grads["layers"].items()})


def decode(prefix, c, p, names):
    param_sh = shd.lm_param_sharding(mesh, c)
    for dtype in (jnp.bfloat16, jnp.int8):
        for name in names:
            spec = layouts[name]
            cache = tf.init_kv_cache(c, tokens.shape[0], int(world["T"]), dtype)
            cache_sh = {k: spec for k in cache if k != "length"}
            cache_sh["length"] = shd.ns(mesh)
            step = jax.jit(lambda p, t, cc: tf.decode_step(p, t, cc, c))
            dparams, out = jax.device_put(p, param_sh), []
            for t in range(steps_tok.shape[0]):  # each step's cache laid out again
                logits, cache = step(dparams, jax.device_put(steps_tok[t], shd.ns(mesh, dp)),
                                     jax.device_put(cache, cache_sh))
                out.append(logits)
            res[f"{prefix}decode/{jnp.dtype(dtype).name}/{name}"] = jnp.stack(out)
        if prefix:  # the same steps on one device
            cache, out = tf.init_kv_cache(c, tokens.shape[0], int(world["T"]), dtype), []
            step = jax.jit(lambda p, t, cc: tf.decode_step(p, t, cc, c))
            for t in range(steps_tok.shape[0]):
                logits, cache = step(p, steps_tok[t], cache)
                out.append(logits)
            res[f"{prefix}decode/{jnp.dtype(dtype).name}/u"] = jnp.stack(out)


with mesh:
    train("", cfg, params)
    for name, c, p in (("prefill", cfg, params), ("grok", grok, gparams)) + tuple(
            (f"{m}/prefill", c, tree(world, m, jnp.asarray)) for m, c in moe.items()):
        res[name] = jax.jit(steps.lm_prefill_step(c), in_shardings=(
            shd.lm_param_sharding(mesh, c), {"tokens": tok_sh}))(p, {"tokens": tokens})
    decode("", cfg, params, ("positions", "batch"))
    for m, c in moe.items():
        train(f"{m}/", c, tree(world, m, jnp.asarray))
    decode("scout/", moe["scout"], tree(world, "scout", jnp.asarray), tuple(layouts))
np.savez(out_path, **{k: np.asarray(v, np.float32) for k, v in res.items()})
"""

_RANK = _TREE + r"""
import dataclasses, sys
import numpy as np, torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs.archs import grok_1_314b, llama3_405b, llama4_scout
from repro_torch.launch.mesh import LeafMesh
from repro_torch.models import transformer as tf
from repro_torch.parallel import sharding as shd, spmd
from repro_torch.train import steps

torch.set_num_threads(1)
rank, addr, world_path, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
world = dict(np.load(world_path))
dist.init_process_group("gloo", init_method=addr, world_size=8, rank=rank)
res = {}
try:
    mesh = LeafMesh((2, 4), ("data", "model"), ["cpu"] * 8)
    cfg = dataclasses.replace(llama3_405b.SMOKE, attn_chunk=8, microbatches=2, remat=True)
    grok = dataclasses.replace(grok_1_314b.SMOKE, moe_group=8)
    moe = {"scout": dataclasses.replace(llama4_scout.SMOKE, n_heads=6, n_kv_heads=2,
                                        attn_chunk=8, microbatches=2, remat=True, moe_group=8),
           "grok2": dataclasses.replace(grok_1_314b.SMOKE, n_experts=2, microbatches=2,
                                        remat=True, moe_group=8)}
    params, gparams = tree(world, "llama", torch.from_numpy), tree(world, "grok", torch.from_numpy)
    mparams = {m: tree(world, m, torch.from_numpy) for m in moe}
    tokens, labels, steps_tok = (torch.from_numpy(world[k])
                                 for k in ("tokens", "labels", "steps_tok"))
    B, T, STEPS = tokens.shape[0], int(world["T"]), steps_tok.shape[0]
    dp = shd.dp_axes(mesh)
    batch_sh = {"tokens": shd.lm_batch_sharding(mesh), "labels": shd.lm_batch_sharding(mesh)}
    batch = {"tokens": tokens, "labels": labels}
    layouts = {"positions": shd.ns(mesh, None, dp, None, "model", None),
               "batch": shd.ns(mesh, None, dp, None, None, None),
               "long": shd.ns(mesh, None, None, None, dp, None)}

    def grads_fn(c):
        constrain = shd.lm_activation_constraint(mesh, c)
        loss_fn = lambda p, b: tf.lm_loss(p, b["tokens"], b["labels"], c, constrain=constrain)
        return lambda p, b: steps._accumulate_grads(loss_fn, p, b, c.microbatches)

    def decode(c, params, cache, sharded):
        out = []
        for t in range(STEPS):
            tok = steps_tok[t]
            if sharded:
                tok = spmd.distribute(tok, shd.ns(mesh, dp))
            logits, cache = tf.decode_step(params, tok, cache, c)
            out.append(logits.full_tensor() if sharded else logits)
        return torch.stack(out)

    def prefill(c):
        return lambda p, b: steps.lm_prefill_step(c)(p, b)

    # (prefix, config, parameters, decode layouts) of each model
    models = [("", cfg, params, ("positions", "batch")), ("scout/", moe["scout"],
              mparams["scout"], tuple(layouts)), ("grok2/", moe["grok2"], mparams["grok2"], ())]
    if rank == 0:  # unsharded
        for prefix, c, p, names in models:
            loss, grads = grads_fn(c)(p, batch)
            res[f"{prefix}loss/u"] = loss
            res.update({f"{prefix}grad/{k}/u": g for k, g in grads.items()})
            for dtype in (torch.bfloat16, torch.int8) if names else ():
                cache = tf.init_kv_cache(c, B, T, dtype, device="cpu")
                res[f"{prefix}decode/{dtype}/u"] = decode(c, p, cache, False)
        res["prefill/u"] = steps.lm_prefill_step(cfg)(params, {"tokens": tokens})
        res["grok/u"] = steps.lm_prefill_step(grok)(gparams, {"tokens": tokens})
        for m, c in moe.items():
            res[f"{m}/prefill/u"] = steps.lm_prefill_step(c)(mparams[m], {"tokens": tokens})
    with spmd.bind(mesh):
        for prefix, c, p, names in models:
            param_sh = shd.lm_param_sharding(mesh, c)
            loss, grads = spmd.run(grads_fn(c), (p, batch), (param_sh, batch_sh))
            res[f"{prefix}loss/s"] = loss.full_tensor()
            res.update({f"{prefix}grad/{k}/s": g.full_tensor() for k, g in grads.items()})
            dparams = spmd.distribute_tree(p, param_sh)
            for dtype in (torch.bfloat16, torch.int8) if names else ():
                for name in names:
                    cache = tf.init_kv_cache(c, B, T, dtype, device="cpu")
                    cache_sh = {k: layouts[name] for k in cache if k != "length"}
                    cache_sh["length"] = shd.ns(mesh)
                    with implicit_replication():
                        res[f"{prefix}decode/{dtype}/{name}"] = decode(
                            c, dparams, spmd.distribute_tree(cache, cache_sh), True)
        for name, c, p in (("prefill", cfg, params), ("grok", grok, gparams)) + tuple(
                (f"{m}/prefill", c, mparams[m]) for m, c in moe.items()):
            res[f"{name}/s"] = spmd.run(prefill(c), (p, {"tokens": tokens}),
                                        (shd.lm_param_sharding(mesh, c),
                                         {"tokens": batch_sh["tokens"]})).full_tensor()
    if rank == 0:
        np.savez(out_path, **{k: v.detach().to(torch.float32).numpy() for k, v in res.items()})
finally:
    dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _generator_params(cfg, seed):
    """An LM tree of ``cfg``'s shapes drawn from ``torch.Generator(seed)``:
    each weight N(0, 1) / sqrt(fan_in) (the embedding's times 0.02) in the
    order wq, wk, wv, wo, router, w_gate, w_up, w_down, embed; norms ones.
    These are the arrays this file's world has always held (the weights
    are handed to both packages, so their stream is immaterial); with the
    reference's stream instead (``prng.key(3)`` for scout) the reference's
    own GSPMD decode over the long_500k layout departs from its unsharded
    decode by 4.4e-4 of the largest logit (a bfloat16 cache entry rounded
    the other way), while the port's sharded decode stays within 3.5e-6 of
    its unsharded one."""
    from repro_torch.models import transformer as tf

    g = torch.Generator().manual_seed(seed)
    tree = tf.init_params(cfg, device="meta")
    names = ["wq", "wk", "wv", "wo", "router", "w_gate", "w_up", "w_down"]

    def draw(shape, scale=None):
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
        return (torch.randn(shape, generator=g) * s).to(cfg.dtype)

    layers = {k: torch.ones(v.shape, dtype=cfg.dtype) for k, v in tree["layers"].items()}
    for k in names:
        if k in layers:
            layers[k] = draw(tuple(tree["layers"][k].shape))
    return {"embed": draw(tuple(tree["embed"].shape), 0.02), "layers": layers,
            "final_norm": torch.ones(tree["final_norm"].shape, dtype=cfg.dtype)}


def _world(path):
    """SMOKE llama's, SMOKE grok's and the two MoE variants' (``MOE``)
    weights from seeded generators (``_generator_params``), the tokens,
    labels and decode tokens from a seeded numpy generator."""
    from repro_torch.train.checkpoint import flatten_tree

    world = {}
    for name, cfg, seed in (("llama", llama3_405b.SMOKE, 1), ("grok", grok_1_314b.SMOKE, 2)) + tuple(
            (name, cfg, seed) for seed, (name, cfg) in enumerate(MOE.items(), 3)):
        params = _generator_params(cfg, seed)
        for key, leaf in flatten_tree(params).items():
            world[f"{name}/" + key.replace("['", "").replace("']", "")] = leaf.numpy()
    rng = np.random.default_rng(0)
    vocab = llama3_405b.SMOKE.vocab
    world["tokens"] = rng.integers(0, vocab, (B, S)).astype(np.int32)
    world["labels"] = rng.integers(0, vocab, (B, S)).astype(np.int32)
    world["steps_tok"] = rng.integers(0, vocab, (STEPS, B)).astype(np.int32)
    world["T"] = np.asarray(T)
    np.savez(path, **world)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lm_world") / "world.npz")
    _world(path)
    return path


def _run(procs):
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]


@pytest.fixture(scope="module")
def gloo(world, tmp_path_factory):
    """The gloo ranks' results: ``<name>/u`` unsharded, ``<name>/s`` and the
    decode layouts sharded."""
    out = str(tmp_path_factory.mktemp("lm_gloo") / "rank0.npz")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    addr = f"tcp://127.0.0.1:{_free_port()}"
    _run([subprocess.Popen([sys.executable, "-c", _RANK, str(r), addr, world, out], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
          for r in range(8)])
    return dict(np.load(out))


@pytest.fixture(scope="module")
def gspmd(world, tmp_path_factory):
    """The reference's results of the same steps under GSPMD."""
    out = str(tmp_path_factory.mktemp("lm_gspmd") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    _run([subprocess.Popen([sys.executable, "-c", textwrap.dedent(_REF), world, out], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)])
    return dict(np.load(out))


def _close(got, want, rtol):
    """Equal within ``rtol`` of the largest magnitude (float32 sums in
    another order: the sharded step reduces over ranks)."""
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def test_sharded_train_step_equals_unsharded(gloo):
    np.testing.assert_allclose(gloo["loss/s"], gloo["loss/u"], rtol=1e-6)
    names = sorted(k[len("grad/"):-2] for k in gloo if k.startswith("grad/") and k.endswith("/u"))
    assert len(names) == 11  # embed, final norm and the 9 stacked layer leaves
    for name in names:
        got, want = gloo[f"grad/{name}/s"], gloo[f"grad/{name}/u"]
        assert np.abs(want).max() > 0, name
        _close(got, want, 1e-5)


@pytest.mark.parametrize("arch", ["prefill", "grok"])
def test_sharded_prefill_equals_unsharded(gloo, arch):
    _close(gloo[f"{arch}/s"], gloo[f"{arch}/u"], 1e-5)


@pytest.mark.parametrize("layout", ["positions", "batch"])
@pytest.mark.parametrize("dtype", ["torch.bfloat16", "torch.int8"])
def test_sharded_decode_equals_unsharded(gloo, layout, dtype):
    """Six steps over a cache of 16 positions (4 a model shard in the
    decode cell's layout: the steps cross a shard's edge), each step's
    logits."""
    _close(gloo[f"decode/{dtype}/{layout}"], gloo[f"decode/{dtype}/u"], 1e-5)


def test_sharded_train_step_equals_the_reference(gloo, gspmd):
    np.testing.assert_allclose(gloo["loss/s"], gspmd["loss"], rtol=1e-5)
    names = sorted(k[len("grad/"):] for k in gspmd if k.startswith("grad/"))
    assert names == sorted(k[len("grad/"):-2] for k in gloo
                           if k.startswith("grad/") and k.endswith("/s"))
    for name in names:
        _close(gloo[f"grad/{name}/s"], gspmd[f"grad/{name}"], 1e-5)


@pytest.mark.parametrize("arch", ["prefill", "grok"])
def test_sharded_prefill_equals_the_reference(gloo, gspmd, arch):
    _close(gloo[f"{arch}/s"], gspmd[arch], 1e-5)


@pytest.mark.parametrize("layout", ["positions", "batch"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_sharded_decode_equals_the_reference(gloo, gspmd, layout, dtype):
    got, want = gloo[f"decode/torch.{dtype}/{layout}"], gspmd[f"decode/{dtype}/{layout}"]
    if dtype == "int8":
        row_max = np.abs(want).max(-1, keepdims=True)
        assert bool((np.abs(got - want) <= 5e-3 * row_max).all())
    else:
        _close(got, want, 1e-5)


def _grad_names(res, prefix, tag=""):
    return sorted(k[len(prefix + "grad/"):len(k) - len(tag)] for k in res
                  if k.startswith(prefix + "grad/") and k.endswith(tag))


@pytest.mark.parametrize("model", sorted(MOE))
def test_moe_sharded_train_step_equals_unsharded(gloo, model):
    """The MoE variants' train step (2 microbatches, remat, chunked
    attention, routing groups of 8): loss and every gradient leaf, the
    router's and the experts' included."""
    p = model + "/"
    np.testing.assert_allclose(gloo[p + "loss/s"], gloo[p + "loss/u"], rtol=1e-6)
    names = _grad_names(gloo, p, "/u")
    assert len(names) == 12  # embed, final norm and the 10 stacked layer leaves
    for name in names:
        got, want = gloo[f"{p}grad/{name}/s"], gloo[f"{p}grad/{name}/u"]
        assert np.abs(want).max() > 0, name
        _close(got, want, 1e-5)


@pytest.mark.parametrize("model", sorted(MOE))
def test_moe_sharded_train_step_equals_the_reference(gloo, gspmd, model):
    p = model + "/"
    np.testing.assert_allclose(gloo[p + "loss/s"], gspmd[p + "loss"], rtol=1e-5)
    names = _grad_names(gspmd, p)
    assert names == _grad_names(gloo, p, "/s")
    for name in names:
        _close(gloo[f"{p}grad/{name}/s"], gspmd[f"{p}grad/{name}"], 1e-5)


@pytest.mark.parametrize("model", sorted(MOE))
def test_moe_sharded_prefill_equals_unsharded(gloo, model):
    _close(gloo[f"{model}/prefill/s"], gloo[f"{model}/prefill/u"], 1e-5)


@pytest.mark.parametrize("model", sorted(MOE))
def test_moe_sharded_prefill_equals_the_reference(gloo, gspmd, model):
    _close(gloo[f"{model}/prefill/s"], gspmd[f"{model}/prefill"], 1e-5)


def _row_close(got, want, rtol):
    """Equal within ``rtol`` of each row's largest magnitude."""
    row_max = np.abs(want).max(-1, keepdims=True)
    assert bool((np.abs(got - want) <= rtol * row_max).all())


@pytest.mark.parametrize("layout", ["positions", "batch", "long"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_moe_sharded_decode_equals_unsharded(gloo, layout, dtype):
    """The expert-parallel variant's six decode steps over a cache laid out
    by positions over the model axis (the decode cell's layout), by batch
    only, and by positions over the data axis (long_500k's layout), against
    the same steps unsharded. Both caches are held to the int8 bound: a
    float32 difference can round a cache entry to the next bfloat16 step as
    well, and does here in the reference itself (its unsharded and GSPMD
    logits differ by 6.4e-5 of the largest over the bfloat16 cache; the
    next test holds each side to the reference's own within 1e-5)."""
    got, unsharded = (gloo[f"scout/decode/torch.{dtype}/{k}"] for k in (layout, "u"))
    _row_close(got, unsharded, 5e-3)


@pytest.mark.parametrize("layout", ["positions", "batch", "long"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_moe_sharded_decode_equals_the_reference(gloo, gspmd, layout, dtype):
    """The sharded steps against the reference's under GSPMD, and the
    unsharded ones against the reference's on one device: within the float
    bound for the bfloat16 cache, the int8 bound for the int8 one."""
    pairs = [(gloo[f"scout/decode/torch.{dtype}/{layout}"], gspmd[f"scout/decode/{dtype}/{layout}"]),
             (gloo[f"scout/decode/torch.{dtype}/u"], gspmd[f"scout/decode/{dtype}/u"])]
    for got, want in pairs:
        if dtype == "int8":
            _row_close(got, want, 5e-3)
        else:
            _close(got, want, 1e-5)

"""Fault-tolerant checkpoints of the PyTorch port (``repro_torch/train/
checkpoint.py``): the reference's layout (a manifest with a CRC32 per
array, an atomic tmp-dir rename, ``keep_last``, a ``LATEST`` pointer,
bfloat16 as a uint16 view), its behaviour, and a training run saved at
step 5 and resumed that ends where the uninterrupted run ends (the
reference's ``tests/test_system.py::test_training_is_restart_reproducible``).
Either package restores the other's directory of a ``TrainState``.
"""

import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as RC  # noqa: E402
import repro.core.losses as RL  # noqa: E402
from repro.train import checkpoint as rck  # noqa: E402
from repro_torch import prng  # noqa: E402
import repro_torch.core as PC  # noqa: E402
from repro_torch.core import binarize_lib as PB  # noqa: E402
from repro_torch.core import losses as PL  # noqa: E402
from repro_torch.core import trainer as PT  # noqa: E402
from repro_torch.data import synthetic as PS  # noqa: E402
from repro_torch.train import checkpoint as ck  # noqa: E402


def _tree():
    return {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "nested": {"b": torch.ones(5, dtype=torch.bfloat16) * 1.5,
                   "c": np.array(7, np.int32)},
        "seq": [torch.zeros(2, dtype=torch.int64), np.arange(3, dtype=np.float32)],
    }


def _leaves(tree):
    return [leaf for _, leaf in ck._flatten_with_paths(tree)]


def test_roundtrip_bfloat16_and_manifest(tmp_path):
    t = _tree()
    path = ck.save(str(tmp_path), 3, t)
    restored, step = ck.restore(str(tmp_path), t)
    assert step == 3
    for a, b in zip(_leaves(t), _leaves(restored)):
        assert type(a) is type(b)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            np.testing.assert_array_equal(a, b)
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    assert manifest["step"] == 3
    assert manifest["arrays"]["['nested']/['b']"]["dtype"] == "bfloat16"
    stored = np.load(os.path.join(path, manifest["arrays"]["['nested']/['b']"]["file"]))
    assert stored.dtype == np.uint16
    assert open(os.path.join(str(tmp_path), "LATEST")).read() == "step_0000000003"
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]


def test_keys_are_the_references(tmp_path):
    """The port writes the reference's keys, so the reference restores a
    tree the port saved, and the other way round."""
    t = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
         "n": {"b": np.ones(4, np.int32)}, "s": [np.zeros(2, np.float32)]}
    flat, _ = jax.tree_util.tree_flatten_with_path(t)
    assert [k for k, _ in ck._flatten_with_paths(t)] == [
        "/".join(str(p) for p in path) for path, _ in flat]
    ck.save(str(tmp_path / "port"), 1, t)
    back, step = rck.restore(str(tmp_path / "port"), t)
    assert step == 1
    rck.save(str(tmp_path / "ref"), 2, jax.tree_util.tree_map(jnp.asarray, t))
    back2, _ = ck.restore(str(tmp_path / "ref"), t)
    for x, y, z in zip(jax.tree_util.tree_leaves(t), jax.tree_util.tree_leaves(back),
                       jax.tree_util.tree_leaves(back2)):
        np.testing.assert_array_equal(x, np.asarray(y))
        np.testing.assert_array_equal(x, z)


def test_latest_and_keep_last(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        ck.save(str(tmp_path), s, t, keep_last=2)
    assert ck.latest_step(str(tmp_path)) == 5
    assert len([d for d in os.listdir(tmp_path) if d.startswith("step_")]) == 2
    assert ck.latest_step(str(tmp_path / "absent")) is None
    with pytest.raises(FileNotFoundError):
        ck.restore(str(tmp_path / "absent"), t)


def test_non_blocking_save(tmp_path):
    t = _tree()
    path = ck.save(str(tmp_path), 9, t, blocking=False)
    for _ in range(500):
        if ck.latest_step(str(tmp_path)) == 9:
            break
        time.sleep(0.01)
    assert path.endswith("step_0000000009")
    _, step = ck.restore(str(tmp_path), t)
    assert step == 9


def test_detects_corruption_and_missing_arrays(tmp_path):
    t = _tree()
    path = ck.save(str(tmp_path), 1, t)
    target = os.path.join(path, "arr_00000.npy")
    arr = np.load(target)
    arr.flat[0] += 1
    np.save(target, arr)
    with pytest.raises(IOError, match="CRC"):
        ck.restore(str(tmp_path), t)
    with pytest.raises(KeyError, match="missing"):
        ck.restore(str(tmp_path), {"other": np.zeros(1)})


def test_skips_torn_write(tmp_path):
    t = _tree()
    ck.save(str(tmp_path), 1, t)
    os.makedirs(tmp_path / "step_0000000009")  # a preempted writer's dir, no manifest
    assert ck.latest_step(str(tmp_path)) == 1
    _, step = ck.restore(str(tmp_path), t)
    assert step == 1


DIM, CODE = 64, 32


def _cfg():
    return PC.TrainConfig(
        binarizer=PC.BinarizerConfig(input_dim=DIM, code_dim=CODE, n_levels=2, hidden_dim=32),
        queue=PL.QueueConfig(length=256, dim=CODE, top_k=8),
    )


def test_training_is_restart_reproducible(tmp_path):
    """10 steps uninterrupted, against 5 steps, save, restore, 5 more: the
    same parameters, queue and step, bit for bit on one device (the
    reference test allows atol 1e-6)."""
    cfg = _cfg()
    docs, _, _ = PS.clustered_corpus(1, 800, 8, DIM)
    gen = PS.pair_batches(docs, 42, 32, device="cpu")
    hist = [next(gen) for _ in range(10)]

    st = PC.init_train_state(cfg, prng.key(0, "cpu"), "cpu")
    for a, p in hist:
        st, _ = PC.train_step(st, a, p, cfg)

    st2 = PC.init_train_state(cfg, prng.key(0, "cpu"), "cpu")
    for a, p in hist[:5]:
        st2, _ = PC.train_step(st2, a, p, cfg)
    ck.save(str(tmp_path), 5, PT.train_state_to_numpy(st2))
    tree, step = ck.restore(str(tmp_path), PT.train_state_to_numpy(st2))
    assert step == 5
    st3 = PT.train_state_from_numpy(tree, cfg, "cpu")
    assert st3.step == 5 and st3.opt_state.step == 5 and st3.queue["filled"] == 160
    for a, p in hist[5:]:
        st3, _ = PC.train_step(st3, a, p, cfg)
    for x, y in zip(PB.numpy_leaves(st.model), PB.numpy_leaves(st3.model)):
        np.testing.assert_array_equal(x, y)
    assert torch.equal(st.queue["buf"], st3.queue["buf"]) and st3.step == 10


def test_restores_a_reference_train_state(tmp_path):
    """A reference ``TrainState`` checkpoint restores into the port's
    ``TrainStateArrays`` template and converts to the same state."""
    rcfg = RC.TrainConfig(
        binarizer=RC.BinarizerConfig(input_dim=DIM, code_dim=CODE, n_levels=2, hidden_dim=32),
        queue=RL.QueueConfig(length=256, dim=CODE, top_k=8))
    st = RC.init_train_state(jax.random.PRNGKey(0), rcfg)
    rck.save(str(tmp_path), 0, st)
    template = PT.train_state_to_numpy(
        PC.init_train_state(_cfg(), prng.key(0, "cpu"), "cpu"))
    tree, _ = ck.restore(str(tmp_path), template)
    pst = PT.train_state_from_numpy(tree, _cfg(), "cpu")
    for x, y in zip(jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, st)),
                    jax.tree_util.tree_leaves(PT.train_state_to_numpy(pst))):
        np.testing.assert_array_equal(np.asarray(x), y)

"""Digest-cached binarizer checkpoints in the PyTorch port
(``repro_torch/launch/binarizer_cache.py``), the claims of the reference's
``tests/test_binarizer_cache.py`` on the port's own training, and the
package tag that keeps the two packages' caches apart.

A hit must be bit-identical to the run that wrote it, anything that shaped
the weights must move the digest, and a corrupt file must be treated as a
miss. The same (corpus, config, steps, batch, seed) trains other weights
in each package (and on each device type), so their digests differ; each
still reads the other's archive by explicit path.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as RC  # noqa: E402
import repro.core.losses as RL  # noqa: E402
from repro.launch import binarizer_cache as RBC  # noqa: E402
from repro.train import optim as RO  # noqa: E402
from repro_torch import prng  # noqa: E402
import repro_torch.core as PC  # noqa: E402
from repro_torch.core import binarize_lib as PB  # noqa: E402
from repro_torch.core import losses as PL  # noqa: E402
from repro_torch.launch import binarizer_cache as PBC  # noqa: E402
from repro_torch.train import optim as PO  # noqa: E402

DIM, CODE, LEVELS = 16, 8, 2


def _cfg(hidden=16):
    return PC.TrainConfig(
        binarizer=PC.BinarizerConfig(input_dim=DIM, code_dim=CODE, n_levels=LEVELS,
                                     hidden_dim=hidden),
        queue=PL.QueueConfig(length=64, dim=CODE, top_k=4),
        adam=PO.AdamConfig(lr=2e-3, clip_norm=5.0),
    )


def _ref_cfg(hidden=16):
    return RC.TrainConfig(
        binarizer=RC.BinarizerConfig(input_dim=DIM, code_dim=CODE, n_levels=LEVELS,
                                     hidden_dim=hidden),
        queue=RL.QueueConfig(length=64, dim=CODE, top_k=4),
        adam=RO.AdamConfig(lr=2e-3, clip_norm=5.0),
    )


def _docs(seed=0, n=64):
    return np.random.default_rng(seed).normal(size=(n, DIM)).astype(np.float32)


def _train(tmp_path, **kw):
    return PBC.trained_binarizer(_docs(), _cfg(), steps=3, batch=16, cache_dir=str(tmp_path),
                                 device="cpu", **kw)


def _same_weights(a, b):
    for x, y in zip(PB.numpy_leaves(a), PB.numpy_leaves(b)):
        np.testing.assert_array_equal(x, y)


def test_second_call_is_a_bit_identical_cache_hit(tmp_path):
    first = _train(tmp_path)
    assert first.trained is True and os.path.exists(first.path)
    second = _train(tmp_path)
    assert second.trained is False
    assert (second.digest, second.path) == (first.digest, first.path)
    _same_weights(first.model, second.model)
    assert not second.model.training
    codes = PB.make_encode_fn(second.model)(_docs()[:8])
    assert torch.equal(codes, PB.make_encode_fn(first.model)(_docs()[:8]))


def test_training_is_deterministic_and_moves_the_weights(tmp_path):
    a = _train(tmp_path / "a")
    b = _train(tmp_path / "b")
    assert a.trained and b.trained
    _same_weights(a.model, b.model)
    init = PB.init_binarizer(_cfg().binarizer, prng.key(0, "cpu"), "cpu")
    assert any(not np.array_equal(x, y)
               for x, y in zip(PB.numpy_leaves(a.model), PB.numpy_leaves(init)))


def test_every_training_knob_moves_the_digest():
    docs, cfg = _docs(), _cfg()
    base = dict(steps=3, batch=16, seed=0, device="cpu")
    d0 = PBC.checkpoint_digest(docs, cfg, **base)
    assert PBC.checkpoint_digest(docs, cfg, **base) == d0
    for var in (dict(base, steps=4), dict(base, batch=8), dict(base, seed=1),
                dict(base, device="cuda")):
        assert PBC.checkpoint_digest(docs, cfg, **var) != d0
    assert PBC.checkpoint_digest(_docs(1), cfg, **base) != d0
    assert PBC.checkpoint_digest(docs, _cfg(hidden=8), **base) != d0


def test_package_tag_keeps_the_caches_apart():
    """The configs' reprs are equal, so only the tag tells the digests apart."""
    docs = _docs()
    assert repr(_cfg()) == repr(_ref_cfg())
    ref = RBC.checkpoint_digest(docs, _ref_cfg(), steps=3, batch=16, seed=0)
    for device in ("cpu", "cuda"):
        assert PBC.checkpoint_digest(docs, _cfg(), steps=3, batch=16, seed=0,
                                     device=device) != ref


def test_each_package_reads_the_others_file_by_path(tmp_path):
    port = _train(tmp_path / "port")
    ref = RBC.trained_binarizer(_docs(), _ref_cfg(), steps=3, batch=16,
                                cache_dir=str(tmp_path / "ref"))
    assert os.path.basename(port.path) != os.path.basename(ref.path)
    # the reference's loader reads the port's archive
    params, state = RBC._load(port.path, _ref_cfg(), 0)
    ref_leaves = jax.tree_util.tree_leaves((params, state))
    for x, y in zip(PB.numpy_leaves(port.model), ref_leaves):
        np.testing.assert_array_equal(x, np.asarray(y))
    # the port's loader reads the reference's archive
    loaded = PBC.load_checkpoint(ref.path, _cfg().binarizer, device="cpu")
    for x, y in zip(PB.numpy_leaves(loaded), jax.tree_util.tree_leaves((ref.params,
                                                                       ref.bn_state))):
        np.testing.assert_array_equal(x, np.asarray(y))


@pytest.mark.parametrize("damage", ["garbage", "truncated", "wrong_config"])
def test_corrupt_checkpoint_is_retrained_not_trusted(tmp_path, damage):
    first = _train(tmp_path)
    if damage == "garbage":
        with open(first.path, "wb") as f:
            f.write(b"not an npz archive")
    elif damage == "truncated":
        data = open(first.path, "rb").read()
        with open(first.path, "wb") as f:
            f.write(data[: len(data) // 2])
    else:
        # an archive of another config's leaves under this digest's name
        other = PB.init_binarizer(_cfg(hidden=8).binarizer, prng.key(1, "cpu"),
                                  "cpu")
        PBC._save(first.path, other)
    again = _train(tmp_path)
    assert again.trained is True
    _same_weights(first.model, again.model)
    assert _train(tmp_path).trained is False


def test_serve_driver_trainer_routes_through_the_cache(tmp_path, monkeypatch):
    from repro_torch.launch import serve

    docs, cfg = _docs(), _cfg()
    state = serve.train_binarizer(docs, cfg, steps=3, batch=16, cache_dir=str(tmp_path),
                                  device="cpu")
    assert state.trained is True and state.path is not None
    again = serve.train_binarizer(docs, cfg, steps=3, batch=16, cache_dir=str(tmp_path),
                                  device="cpu")
    assert again.trained is False
    assert serve.encode_codes(again.model, docs[:4]).shape == (4, CODE)
    # no cache_dir: $REPRO_BEBR_CACHE
    monkeypatch.setenv(PBC.CACHE_ENV, str(tmp_path / "env"))
    assert PBC.resolve_cache_dir() == str(tmp_path / "env")
    via_env = serve.train_binarizer(docs, cfg, steps=3, batch=16, device="cpu")
    assert via_env.path.startswith(str(tmp_path / "env"))
    monkeypatch.delenv(PBC.CACHE_ENV)
    assert PBC.resolve_cache_dir() == os.path.expanduser("~/.cache/repro-bebr")

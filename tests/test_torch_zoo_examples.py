"""The port's three remaining examples on the CPU (``--device cpu``), each
at a few steps: ``examples/train_two_tower_e2e_torch.py`` (two-tower
training with a checkpoint, the catalog's embeddings, the binarizer on
query-item pairs, FlatSDC at k = 100 and the three quality figures),
``examples/quickstart_torch.py`` (FlatFloat beside FlatSDC, recall@10)
and ``examples/compat_upgrade_torch.py`` (BC training, then the live
two-replica migration: both replicas end on v2, nothing lost, compat
dispatches). At these few steps the figures are checked for range and
structure only, and every model an example trains for having moved from
its initial weights (``training``, what phase 11 also holds to a falling
loss); ``chip_smoke.py`` phase 11 holds the card's figures at
the defaults against the reference's (``reference_figures/zoo_examples.py``).
The ``gpu`` case runs the two-tower example on the card.
"""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: training steps are many small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_trained(out, models):
    assert sorted(out["training"]) == sorted(models)
    for p in out["training"].values():
        assert p["moved"] and np.isfinite(p["loss_before"]) and np.isfinite(p["loss_after"])


def test_two_tower_e2e_on_cpu(tmp_path, capsys):
    from repro_torch.train import checkpoint as ck

    out = _example("train_two_tower_e2e_torch").main(
        ["--device", "cpu", "--steps", "50", "--binarizer-steps", "20", "--ckpt",
         str(tmp_path / "ck")])
    text = capsys.readouterr().out
    assert text.startswith("model: 5.3M params")
    assert "step 50: loss=" in text and "binary index: 0.7 MiB (float: 9.8 MiB)" in text
    assert "top-10 in the user's taste group: float=" in text
    assert text.rstrip().endswith("done.")
    for k in ("group_float", "group_bebr", "cover"):
        assert 0.0 <= out[k] <= 1.0
    _assert_trained(out, ["two_tower", "binarizer"])
    assert ck.latest_step(str(tmp_path / "ck")) == 50


def test_quickstart_on_cpu(capsys):
    out = _example("quickstart_torch").main(["--device", "cpu", "--steps", "5"])
    text = capsys.readouterr().out
    assert "float index:   19.5 MiB" in text and "BEBR  index:    1.3 MiB" in text
    assert out["recall_float"] == 1.0  # the corpus is the reference's; exact float search
    assert 0.0 <= out["recall_bebr"] <= 1.0
    _assert_trained(out, ["binarizer"])


def test_compat_upgrade_on_cpu(capsys):
    out = _example("compat_upgrade_torch").main(["--device", "cpu", "--steps", "5",
                                                 "--bc-steps", "5"])
    text = capsys.readouterr().out
    assert "<- regression!" in text and "zero results lost." in text
    assert out["swapped"] == 2 and out["finals"] == ["v2", "v2"] and out["lost"] == 0
    assert out["compat_dispatches"] >= 1
    for k in ("old_old", "naive", "compat", "mixed_v1", "mixed_v2"):
        assert 0.0 <= out[k] <= 1.0
    _assert_trained(out, ["v1", "v2_bc"])


@pytest.mark.parametrize("name", ["train_two_tower_e2e_torch", "quickstart_torch",
                                  "compat_upgrade_torch"])
def test_examples_refuse_a_device_they_do_not_have(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = ["--ckpt", str(tmp_path / "ck")] if name.startswith("train") else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main(argv)
    assert not (tmp_path / "ck").exists()


@pytest.mark.gpu
def test_two_tower_e2e_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.sdc import sdc as sdc_mod

    before = sdc_mod.sdc_topk.launches
    out = _example("train_two_tower_e2e_torch").main(["--steps", "50", "--ckpt",
                                                      str(tmp_path / "ck")])
    assert sdc_mod.sdc_topk.launches - before == 1
    assert 0.0 <= out["cover"] <= 1.0

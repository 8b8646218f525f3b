"""``examples/serve_bebr_torch.py``: the distributed engine demo on the port.

On the CPU (``--device cpu``): the flat path end to end, trained for a few
steps into a temporary checkpoint cache, with the autotuner's plans in a
temporary tune cache; the merged top-10 agrees with the exact single
search. The ``gpu`` case runs ``--index hnsw`` on the card.
"""

import importlib.util
import os

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example():
    spec = importlib.util.spec_from_file_location(
        "serve_bebr_torch", os.path.join(ROOT, "examples", "serve_bebr_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: training and the eager encode are many small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_example_flat_path_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_BEBR_CACHE", str(tmp_path / "tune"))
    out = _example().main(["--device", "cpu", "--steps", "2", "--ckpt-cache",
                           str(tmp_path / "ckpt"), "--autotune", "--chaos", "r1.search.fail@1",
                           "--probe-every", "0.05"])
    text = capsys.readouterr().out
    assert out["agreement"] == 1.0, text
    assert out["stats"]["requests"] == 16 and out["stats"]["failovers"] >= 1
    assert out["block_plan"]["scan"].source == "inert-backend"
    assert out["block_plan"]["rerank"].source == "tuned"
    assert "index bytes: 3.4 MiB vs float 48.8 MiB" in text
    assert [p.name.split("-")[0] for p in (tmp_path / "ckpt").iterdir()] == ["binarizer"]
    assert len(list((tmp_path / "tune").iterdir())) == 1


def test_example_refuses_a_device_it_does_not_have():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example().main(["--steps", "1"])


@pytest.mark.gpu
def test_example_hnsw_on_card(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setenv("REPRO_BEBR_CACHE", str(tmp_path / "tune"))
    out = _example().main(["--index", "hnsw", "--steps", "20", "--ckpt-cache",
                           str(tmp_path / "ckpt"), "--autotune"])
    assert out["agreement"] >= 0.9 and out["stats"]["requests"] == 16
    assert out["block_plan"]["scan"].source == "tuned"

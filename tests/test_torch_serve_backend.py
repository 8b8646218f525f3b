"""The port's serve CLI takes the reference CLI's ``--backend`` flag
(``repro/launch/serve.py``): auto, pallas and xla are accepted and mapped
to the port's SDC backends (``CLI_BACKENDS``: auto, cuda, torch);
interpret, Pallas's interpreter, which has no CUDA counterpart, is refused
with a message. On the CPU an ``xla`` run serves the default run's ids, and
``pallas`` raises before anything runs, as every entry point does without
the card.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve  # noqa: E402

CLI = ["--device", "cpu", "--docs", "400", "--queries", "16", "--dim", "32", "--code-dim", "16",
       "--batch", "8", "--rounds", "1", "--steps", "0"]


def test_backend_names_are_the_reference_clis():
    assert serve.CLI_BACKENDS == {"auto": "auto", "pallas": "cuda", "xla": "torch"}


@pytest.mark.parametrize("backend", ["auto", "pallas", "interpret", "xla"])
def test_argparse_takes_each_choice(monkeypatch, backend):
    """Each of the reference's choices parses; the run stops at the first
    use of the parsed flags (``cli_builder`` never reached)."""
    seen = {}

    def stop(device):
        seen["device"] = device
        raise KeyboardInterrupt

    monkeypatch.setattr(serve, "resolve_device", stop)
    if backend == "interpret":
        with pytest.raises(SystemExit):
            serve.main(CLI + ["--backend", backend])
        assert "device" not in seen
        return
    with pytest.raises(KeyboardInterrupt):
        serve.main(CLI + ["--backend", backend])
    assert seen["device"] == "cpu"


def test_interpret_is_refused_with_a_message(capsys):
    with pytest.raises(SystemExit):
        serve.main(CLI + ["--backend", "interpret"])
    err = capsys.readouterr().err
    assert "--backend interpret" in err and "no CUDA counterpart" in err


def test_unknown_backend_is_refused():
    with pytest.raises(SystemExit):
        serve.main(CLI + ["--backend", "cuda"])


def test_pallas_raises_off_the_card():
    with pytest.raises(ValueError, match="backend 'cuda' needs CUDA tensors"):
        serve.main(CLI + ["--backend", "pallas"])


def test_xla_serves_the_default_runs_ids(tmp_path):
    runs = {b: serve.main(CLI + ["--ckpt-cache", str(tmp_path), "--backend", b])
            for b in ("auto", "xla")}
    assert len(runs["auto"].results) == len(runs["xla"].results) == 2
    for (sa, ia), (sx, ix) in zip(runs["auto"].results, runs["xla"].results):
        assert ia.shape == (8, 10)
        assert torch.equal(ia, ix) and torch.equal(sa, sx)


def test_pallas_and_auto_raise_without_a_card_on_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for backend in ("pallas", "auto"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--docs", "10", "--backend", backend])

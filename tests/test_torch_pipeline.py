"""``repro_torch/data/pipeline.py``'s ``PrefetchLoader``, a verbatim copy of
the reference's pure-Python module, held to the reference tests' three
behaviours (``tests/test_pipeline_hlocost.py``) and to the reference's
own loader on the same producers: order and content, the backup producer
on a straggler, errors surfaced to the consumer; and the port's synthetic
batches through it, on the step they were drawn for."""

import time

import pytest

torch = pytest.importorskip("torch")

from repro.data.pipeline import PrefetchLoader as RefLoader  # noqa: E402
from repro_torch.configs.archs import dien_cfg  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.data.pipeline import PrefetchLoader  # noqa: E402


@pytest.mark.parametrize("cls", [PrefetchLoader, RefLoader])
def test_prefetch_preserves_order_and_content(cls):
    loader = cls(lambda step: step * 10, depth=3)
    got = [next(loader) for _ in range(5)]
    loader.close()
    assert got == [0, 10, 20, 30, 40]


@pytest.mark.parametrize("cls", [PrefetchLoader, RefLoader])
def test_prefetch_backup_on_straggler(cls):
    calls = {"n": 0}

    def slow_then_fast(step):
        calls["n"] += 1
        if calls["n"] == 1:
            time.sleep(0.6)  # primary stalls on the first batch
        return step

    loader = cls(slow_then_fast, depth=1, deadline_s=0.15)
    first = next(loader)
    assert first == 0  # backup produced step 0 deterministically
    assert loader.timeouts == 1
    loader.close()


@pytest.mark.parametrize("cls", [PrefetchLoader, RefLoader])
def test_prefetch_propagates_errors(cls):
    def bad(step):
        raise ValueError("boom")

    loader = cls(bad, depth=1)
    with pytest.raises(ValueError, match="boom"):
        next(loader)
    loader.close()


def test_prefetch_of_synthetic_batches_from_a_start_step():
    cfg = dien_cfg.SMOKE
    loader = PrefetchLoader(lambda i: synthetic.dien_batch(i, 4, cfg, "cpu"), depth=2,
                            start_step=5)
    try:
        for step in range(5, 8):
            got, want = next(loader), synthetic.dien_batch(step, 4, cfg, "cpu")
            assert got.keys() == want.keys()
            assert all(torch.equal(got[k], want[k]) for k in want)
    finally:
        loader.close()
    assert not loader._thread.is_alive()

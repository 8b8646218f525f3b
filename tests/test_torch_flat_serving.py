"""The flat serving slice of the PyTorch port, end to end, against the reference.

Small size: ``clustered_corpus(0, 2000, 32, 64)``, code_dim 32, n_levels 4,
on the CPU. The corpus must be bit-identical; with the reference's codes
handed over, ``FlatSDC.search`` must give the reference's ids and scores;
``ServingPipeline`` must give what ``serve_sequential`` gives, in FIFO
order; the shed policy must shed.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import binarize_lib as RB  # noqa: E402
from repro.data import synthetic as RS  # noqa: E402
from repro.index import flat as RF  # noqa: E402
from repro_torch.core import binarize_lib as PB  # noqa: E402
from repro_torch.data import synthetic as PS  # noqa: E402
from repro_torch.index import flat as PF  # noqa: E402
from repro_torch.launch import serve as PSV  # noqa: E402
from repro_torch.launch import serving as PSERV  # noqa: E402

DIM, CODE, LEVELS, K = 64, 32, 4, 10


@pytest.fixture(scope="module")
def slice_data():
    docs, queries, gt = RS.clustered_corpus(0, 2000, 32, DIM)
    rcfg = RB.BinarizerConfig(input_dim=DIM, code_dim=CODE, n_levels=LEVELS, hidden_dim=2 * DIM)
    params, state = RB.init_binarizer(jax.random.PRNGKey(0), rcfg)
    enc = RB.make_encode_fn(params, state, rcfg)
    d_codes, q_codes = np.array(enc(docs)), np.array(enc(queries))
    pcfg = PB.BinarizerConfig(input_dim=DIM, code_dim=CODE, n_levels=LEVELS, hidden_dim=2 * DIM)
    weights = (jax.tree_util.tree_map(np.array, params),
               jax.tree_util.tree_map(np.array, state), pcfg)
    model = PB.binarizer_from_numpy(*weights, device="cpu")
    return dict(docs=docs, queries=queries, gt=gt, d_codes=d_codes, q_codes=q_codes,
                model=model, weights=weights)


@pytest.mark.parametrize("args", [(0, 2000, 32, DIM), (3, 500, 7, 16, 8, 0.3, 0.1, 1.5)])
def test_corpus_bit_identical(args):
    for a, b in zip(RS.clustered_corpus(*args), PS.clustered_corpus(*args)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("packed", [False, True])
def test_flat_sdc_matches_reference_flat_sdc(slice_data, packed):
    d_codes, q_codes = slice_data["d_codes"], slice_data["q_codes"]
    ref = RF.FlatSDC.build(jnp.asarray(d_codes), LEVELS, packed=packed, backend="interpret")
    rv, ri = ref.search(jnp.asarray(q_codes), K)
    # the reference's codes and inverse norms handed over: bit-identical
    handed = PF.FlatSDC(codes=torch.from_numpy(np.array(ref.codes)),
                        inv_norm=torch.from_numpy(np.array(ref.inv_norm)),
                        n_levels=LEVELS, packed=packed)
    v, i = handed.search(q_codes, K)
    assert np.array_equal(np.asarray(rv).view(np.uint32), v.numpy().view(np.uint32))
    assert np.array_equal(np.asarray(ri), i.numpy())
    # built by the port from the same codes: its own inverse norms (within
    # one ulp of the reference's) give the reference's ids
    built = PF.FlatSDC.build(d_codes, LEVELS, packed=packed, device="cpu")
    assert torch.equal(built.codes, handed.codes)
    bv, bi = built.search(q_codes, K)
    assert np.array_equal(np.asarray(ri), bi.numpy())
    np.testing.assert_allclose(bv.numpy(), np.asarray(rv), rtol=1e-6)
    assert built.nbytes() == ref.nbytes() and built.code_dim == ref.code_dim


def test_flat_float_matches_reference(slice_data):
    docs, queries = slice_data["docs"], slice_data["queries"]
    rv, ri = RF.FlatFloat.build(jnp.asarray(docs)).search(jnp.asarray(queries), K)
    index = PF.FlatFloat.build(docs, device="cpu")
    v, i = index.search(queries, K, chunk=300)
    assert np.array_equal(np.asarray(ri), i.numpy())
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), rtol=1e-5, atol=1e-6)
    assert index.nbytes() == docs.nbytes


def test_encoded_slice_gives_reference_ids(slice_data):
    """Port encode of the reference's weights -> port index -> the reference's ids."""
    d = PSV.encode_codes(slice_data["model"], slice_data["docs"], batch=512)
    q = PB.make_encode_fn(slice_data["model"])(slice_data["queries"])
    n_diff = int((d.numpy() != slice_data["d_codes"]).sum()) + int(
        (q.numpy() != slice_data["q_codes"]).sum())
    assert n_diff <= 1e-4 * (d.numel() + q.numel())
    if n_diff == 0:
        ref = RF.FlatSDC.build(jnp.asarray(slice_data["d_codes"]), LEVELS, backend="xla")
        _, ri = ref.search(jnp.asarray(slice_data["q_codes"]), K)
        _, i = PF.FlatSDC.build(d, LEVELS, device="cpu").search(q, K)
        assert np.array_equal(np.asarray(ri), i.numpy())


@pytest.mark.parametrize("packed", [False, True])
def test_pipeline_bit_identical_to_sequential_fifo(slice_data, packed):
    index = PF.FlatSDC.build(slice_data["d_codes"], LEVELS, packed=packed, device="cpu")
    encode = PB.make_encode_fn(slice_data["model"])
    search = lambda q: index.search(q, K)  # noqa: E731
    queries = slice_data["queries"]
    batches = [queries[i:i + 5] for i in range(0, 32, 5)]  # ragged tail of 2
    seq = PSERV.serve_sequential(encode, search, batches)
    results, stats = PSERV.serve_batches(
        encode, search, batches * 2, config=PSERV.ServingConfig(queue_depth=2))
    assert stats["requests"] == 2 * len(batches)
    for (v, i), (sv, si) in zip(results, seq * 2):
        assert torch.equal(v, sv) and torch.equal(i, si)
    # the CLI's routed run under the shed policy: shed submits are retried
    run = PSV.serve_routed(encode, search, batches, warm_batches=batches, replicas=2,
                           config=PSERV.ServingConfig(queue_depth=1, policy="shed"),
                           device="cpu")
    assert len(run.results) == len(seq) and run.stats["requests"] == len(batches)
    for (v, i), (sv, si) in zip(run.results, seq):
        assert torch.equal(v, sv) and torch.equal(i, si)


def test_shed_policy_raises_on_a_full_queue(slice_data):
    gate = threading.Event()

    def slow_encode(q):
        gate.wait(10)
        return torch.as_tensor(q).to(torch.int8)

    index = PF.FlatSDC.build(slice_data["d_codes"], LEVELS, device="cpu")
    pipe = PSERV.ServingPipeline(slow_encode, lambda q: index.search(q, K),
                                 config=PSERV.ServingConfig(queue_depth=1, policy="shed"))
    codes = slice_data["q_codes"][:4]
    try:
        tickets = [pipe.submit(codes)]  # taken by the encode stage, which blocks
        shed = 0
        for _ in range(6):
            try:
                tickets.append(pipe.submit(codes))
            except PSERV.RequestShed:
                shed += 1
        assert shed >= 1 and pipe.shed_count == shed
    finally:
        gate.set()
        pipe.close()
    for t in tickets:
        v, i = t.result(timeout=10)
        assert i.shape == (4, K)


def test_device_sync_hook_is_a_no_op_on_cpu():
    t = torch.zeros(3)
    assert PSERV._record_ready(t, t) is None
    PSERV._wait_ready(None)


def test_serve_cli_runs_on_cpu(capsys, tmp_path):
    PSV.main(["--device", "cpu", "--docs", "600", "--queries", "24", "--dim", "32",
              "--code-dim", "16", "--batch", "8", "--rounds", "2", "--packed", "--steps", "0",
              "--ckpt-cache", str(tmp_path)])
    out = capsys.readouterr().out
    for tag in ("[data]", "[index] flat:", "[serve] recall@10:", "[serve] sequential:",
                "[serve] routed (1 replica(s), round-robin):", "[train] trained (", "on CPU"):
        assert tag in out, (tag, out)


def test_serve_cli_loads_a_reference_checkpoint(tmp_path, capsys):
    from repro.launch import binarizer_cache as RC

    rcfg = RB.BinarizerConfig(input_dim=32, code_dim=16, n_levels=LEVELS, hidden_dim=64)
    params, state = RB.init_binarizer(jax.random.PRNGKey(1), rcfg)
    path = str(tmp_path / "b.npz")
    RC._save(path, params, state)
    PSV.main(["--device", "cpu", "--docs", "300", "--queries", "8", "--dim", "32",
              "--code-dim", "16", "--rounds", "1", "--ckpt", path])
    out = capsys.readouterr().out
    assert f"loaded {path}" in out and "[train]" not in out


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
def test_flat_slice_on_card_matches_cpu(slice_data, packed):
    dev = _card()
    cpu = PF.FlatSDC.build(slice_data["d_codes"], LEVELS, packed=packed, device="cpu")
    card = PF.FlatSDC(codes=cpu.codes.to(dev), inv_norm=cpu.inv_norm.to(dev),
                      n_levels=LEVELS, packed=packed)
    v, i = cpu.search(slice_data["q_codes"], K)
    cv, ci = card.search(slice_data["q_codes"], K)
    assert cv.device.type == "cuda"
    assert torch.equal(cv.cpu(), v) and torch.equal(ci.cpu(), i)
    built = PF.FlatSDC.build(slice_data["d_codes"], LEVELS, packed=packed)
    assert built.codes.device.type == "cuda" and torch.equal(built.codes.cpu(), cpu.codes)
    assert torch.equal(built.inv_norm.cpu(), cpu.inv_norm)  # same bits on both devices
    bv, bi = built.search(slice_data["q_codes"], K)
    assert torch.equal(bv.cpu(), v) and torch.equal(bi.cpu(), i)


@pytest.mark.gpu
def test_pipeline_on_card_bit_identical_to_sequential(slice_data):
    dev = _card()
    from repro_torch.kernels.sdc import sdc as PSDC

    model = PB.binarizer_from_numpy(*slice_data["weights"], device=dev)
    index = PF.FlatSDC.build(slice_data["d_codes"], LEVELS, device=dev)
    encode = PB.make_encode_fn(model)
    search = lambda q: index.search(q, K)  # noqa: E731
    queries = slice_data["queries"]
    batches = [queries[i:i + 8] for i in range(0, 32, 8)]
    seq = PSERV.serve_sequential(encode, search, batches)
    before = PSDC.sdc_topk.launches
    results, _ = PSERV.serve_batches(encode, search, batches)
    assert PSDC.sdc_topk.launches == before + len(batches)
    for (v, i), (sv, si) in zip(results, seq):
        assert v.device.type == "cuda"
        assert torch.equal(v, sv) and torch.equal(i, si)

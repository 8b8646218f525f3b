"""The plain reference against the port on the CPU at a tiny size: the
same codes from the same floats and weights, norms within an ulp, and the
same answers from both index kinds."""

import numpy as np
import pytest
import torch

from bench_port.tests._tiny import tiny_config
from bench_port import weights as weights_lib
from bench_port.corpus import Corpus
from bench_port.reference import bigranular as ref_bigranular, flat as ref_flat, sdc
from bench_port.reference.binarizer import Binarizer

from repro_torch.core.binarize_lib import (BinarizerConfig, binarizer_from_numpy,
                                           make_encode_fn)
from repro_torch.index.flat import BiGranularFlat, FlatSDC
from repro_torch.kernels.sdc import ref as port_ref

CASES = {"web": "web-flat.q64-c8", "video": "video-bigr.q64-c8"}


def _setup(cell, seed=1234567890123):
    cfg, _ = tiny_config(cell)
    params, state = weights_lib.make(cfg, seed, "cpu")
    model = binarizer_from_numpy(params, state, BinarizerConfig(
        input_dim=cfg["input_dim"], code_dim=cfg["code_dim"], n_levels=cfg["n_levels"],
        hidden_dim=cfg["hidden_dim"]), device="cpu")
    corpus = Corpus(cfg, seed, "cpu")
    docs = torch.cat([corpus.docs(c) for c in range(corpus.n_chunks)])
    return cfg, (params, state), model, docs


@pytest.mark.parametrize("case", CASES)
def test_reference_encode_equals_the_port(case):
    cfg, weights, model, docs = _setup(CASES[case])
    port = make_encode_fn(model)(docs)
    ref = Binarizer(*weights, n_levels=cfg["n_levels"], device="cpu").encode(docs)
    assert torch.equal(port, ref)
    # the codes use every level: a random binarizer still spreads them
    assert len(torch.unique(ref)) == 2 ** cfg["n_levels"]


@pytest.mark.parametrize("levels", [2, 4])
def test_reference_norms_within_an_ulp_of_the_port(levels):
    codes = torch.randint(0, 2**levels, (5000, 64), dtype=torch.int8,
                          generator=torch.Generator().manual_seed(levels))
    ref, port = sdc.inv_norms(codes, levels), port_ref.doc_inv_norms(codes, levels)
    ulp = torch.abs(torch.nextafter(ref, torch.tensor(np.inf)) - ref)
    assert torch.all(torch.abs(ref - port) <= ulp)


def _chunks(cfg, codes, kind):
    for s in range(0, codes.shape[0], cfg["chunk"]):
        yield s, kind.index_arrays(cfg, codes[s:s + cfg["chunk"]])


@pytest.mark.parametrize("case", CASES)
def test_reference_search_equals_the_port(case):
    cfg, weights, model, docs = _setup(CASES[case])
    codes = make_encode_fn(model)(docs)
    q = codes[torch.arange(0, codes.shape[0], 97)[:64]]
    if cfg["index"] == "flat":
        port = FlatSDC.build(codes, cfg["n_levels"], packed=True, device="cpu").search(q, cfg["k"])
        kind = ref_flat
    else:
        index = BiGranularFlat.build(codes.numpy(), cfg["n_levels"], packed=True, device="cpu",
                                     coarse_levels=cfg["coarse_levels"], k_coarse=cfg["k_coarse"])
        port = index.search(q, cfg["k"])
        kind = ref_bigranular
    search = kind.Search(cfg, q)
    for s, arrays in _chunks(cfg, codes, kind):
        search.add(s, arrays)
    ref_s, ref_ids, _ = search.result()
    port_s, port_ids = port
    assert torch.equal(ref_ids, port_ids.long())
    assert torch.allclose(ref_s, port_s, rtol=3e-7, atol=0)

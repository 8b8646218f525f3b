"""Seeded initial trees and batches of the port against the reference's, on
the CPU.

For every arch id's SMOKE config, the launcher's initial tree from seed 0
(``prng.key(0)`` against ``PRNGKey(0)``) equals the reference's leaf by
leaf within ``prng.normal``'s bound (``NORMAL_ULPS``; measured: every
element bit-equal); so does a bfloat16 LM tree (llama3.2-1b SMOKE at the
full config's dtype), compared after the cast, and the binarizer at the
serve CLI's width (256 -> 128 x 4 levels, hidden 512) from the CLI's
seed 0, the upgrade's seed 7 and the two-tower example's seed 1. Each
family's batches at steps 0 and 7: integer leaves equal, float leaves
within the bound.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_arch as ref_arch  # noqa: E402
from repro.core import binarize_lib as RB  # noqa: E402
from repro.core import losses as RL  # noqa: E402
from repro.core import trainer as RTR  # noqa: E402
from repro.launch import train as RT  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import binarize_lib as PB  # noqa: E402
from repro_torch.core import losses as PL  # noqa: E402
from repro_torch.core import trainer as PTRN  # noqa: E402
from repro_torch.launch import train as PT  # noqa: E402
from repro_torch.train import checkpoint as PCK  # noqa: E402
from repro_torch.train import steps as PST  # noqa: E402

ARCHS = ["llama3-405b", "llama3.2-1b", "mistral-large-123b", "llama4-scout-17b-a16e",
         "grok-1-314b", "meshgraphnet", "dlrm-rm2", "two-tower-retrieval", "mind", "dien"]
NORMAL_ULPS = 1  # prng.normal's bound (tests/test_torch_prng.py); measured here: 0


def _bits(a) -> np.ndarray:
    """A float leaf as its integer bits (bfloat16 as int16), widened to int64."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().astype(np.int64)
        a = a.numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16).astype(np.int64)
    return a.view(np.int32).astype(np.int64) if a.dtype == np.float32 else a.astype(np.int64)


def _hold(got, want, key):
    """Integer leaves equal; float leaves within NORMAL_ULPS. Returns the
    number of elements that are not bit-equal."""
    g = got.detach() if isinstance(got, torch.Tensor) else torch.as_tensor(got)
    w = np.asarray(want)
    assert tuple(g.shape) == w.shape, key
    if not (g.is_floating_point() or w.dtype.name == "bfloat16"):
        assert np.array_equal(g.numpy(), w), key
        return 0
    d = np.abs(_bits(g) - _bits(w))
    assert d.max(initial=0) <= NORMAL_ULPS, (key, int(d.max()))
    return int((d != 0).sum())


def _port_tree(params, opt):
    return PCK.flatten_tree(PST.train_state_tree(params, opt)[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_init_and_batches_equal_the_reference(arch):
    rparams, _, rbatch = RT._build(arch, True, 16)
    pparams, _, pbatch = PT._build(arch, True, 16, "cpu")
    want = PCK.flatten_tree(jax.tree_util.tree_map(np.asarray, rparams))
    got = _port_tree(pparams, PST.init_opt_state(pparams))
    assert list(got) == list(want)
    off = sum(_hold(got[k], want[k], k) for k in want)
    n = sum(np.asarray(w).size for w in want.values())
    print(f"{arch}: {n - off} of {n} initial elements bit-equal")
    for step in (0, 7):
        rb, pb = rbatch(step), pbatch(step)
        assert sorted(rb) == sorted(pb)
        for k in rb:
            assert pb[k].dtype == {np.dtype("int32"): torch.int32, np.dtype("bool"): torch.bool,
                                   np.dtype("float32"): torch.float32}[np.asarray(rb[k]).dtype]
            _hold(pb[k], rb[k], (step, k))


def test_bfloat16_lm_init_equals_the_reference():
    from repro.models import transformer as RTF
    from repro_torch.configs.registry import get_arch as port_arch
    from repro_torch.models import transformer as PTF

    rcfg = dataclasses.replace(ref_arch("llama3.2-1b").smoke_config, dtype=jnp.bfloat16)
    pcfg = dataclasses.replace(port_arch("llama3.2-1b").smoke_config, dtype=torch.bfloat16)
    want = PCK.flatten_tree(jax.tree_util.tree_map(np.asarray, RTF.init_params(
        jax.random.PRNGKey(0), rcfg)))
    got = PCK.flatten_tree(PTF.init_params(pcfg, prng.key(0, "cpu"), "cpu"))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == torch.bfloat16, k
        _hold(got[k], want[k], k)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_cli_binarizer_init_equals_the_reference(seed):
    dim = 256
    bcfg = RB.BinarizerConfig(input_dim=dim, code_dim=128, n_levels=4, hidden_dim=2 * dim)
    pcfg = PB.BinarizerConfig(input_dim=dim, code_dim=128, n_levels=4, hidden_dim=2 * dim)
    ref = RTR.init_train_state(jax.random.PRNGKey(seed), RTR.TrainConfig(
        binarizer=bcfg, queue=RL.QueueConfig(length=64, dim=128, top_k=8)))
    port = PTRN.init_train_state(PTRN.TrainConfig(
        binarizer=pcfg, queue=PL.QueueConfig(length=64, dim=128, top_k=8)),
        prng.key(seed, "cpu"), "cpu")
    want = jax.tree_util.tree_leaves((ref.params, ref.bn_state))
    for model in (port.model, port.m_model):
        got = PB.numpy_leaves(model)
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            _hold(torch.from_numpy(g), w, i)

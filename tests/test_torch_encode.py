"""The serving encode of the PyTorch port (``binarize_lib.make_encode_fn``)
against the reference's jitted one.

The reference's ``make_encode_fn`` is ``jax.jit`` over the arrays it closes
over: the codes it serves are fixed when it is made. The port's closure
holds its own eval-mode copy of the weights, taken when it is made, so
training the model in place afterwards does not move them. On a CPU model
it runs eagerly; on a card it replays one captured CUDA graph a batch
shape, held bit for bit against its plain version, the eager twin
``make_eager_encode_fn`` (the ``gpu`` cases, and ``chip_smoke.py`` phase
8e at the serving shapes).

The eager twin equals the reference's jitted encode exactly at these
sizes: both compute the same float32 products, and a code could differ
only where a pre-sign activation rounds to the other side of zero, which
these seeded inputs do not reach (``test_torch_binarizer.py`` bounds such
flips at 1e-4 of the entries at the CLI's width).
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import binarize_lib as RB  # noqa: E402
from repro_torch.core import binarize_lib as PB  # noqa: E402

DIM, CODE, HIDDEN = 64, 32, 128


def _weights(levels, seed=0):
    """The reference's initial weights with seeded batch-norm state, and
    both packages' configs."""
    kw = dict(input_dim=DIM, code_dim=CODE, n_levels=levels, hidden_dim=HIDDEN)
    rcfg, pcfg = RB.BinarizerConfig(**kw), PB.BinarizerConfig(**kw)
    params, state = RB.init_binarizer(jax.random.PRNGKey(seed), rcfg)
    params = jax.tree_util.tree_map(np.array, params)
    state = jax.tree_util.tree_map(np.array, state)
    rng = np.random.default_rng(seed + 1)
    for s in state["W"] + state["R"]:
        s["bn_mean"] = (0.1 * rng.normal(size=s["bn_mean"].shape)).astype(np.float32)
        s["bn_var"] = rng.uniform(0.5, 2.0, size=s["bn_var"].shape).astype(np.float32)
    return rcfg, pcfg, params, state


def _embeddings(n, seed=2):
    return np.random.default_rng(seed).normal(size=(n, DIM)).astype(np.float32)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _perturb(model):
    """Train-like in-place changes to every weight and statistic."""
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.5 * torch.randn(p.shape, generator=torch.Generator().manual_seed(9)
                                     ).to(p.device))
        for b in model.buffers():
            b.mul_(1.5)


@pytest.mark.parametrize("make", ["make_encode_fn", "make_eager_encode_fn"])
def test_encode_keeps_the_weights_it_was_made_with(make):
    _, pcfg, params, state = _weights(4)
    model = PB.binarizer_from_numpy(params, state, pcfg, device="cpu")
    f = _embeddings(256)
    encode = getattr(PB, make)(model)
    before = encode(f)
    _perturb(model)
    assert torch.equal(encode(f), before)
    # the perturbation does move the codes of a closure made afterwards
    assert not torch.equal(getattr(PB, make)(model)(f), before)


@pytest.mark.parametrize("levels", [1, 2, 4])
def test_eager_twin_equals_the_reference_jitted_encode(levels):
    rcfg, pcfg, params, state = _weights(levels, seed=levels)
    f = _embeddings(512, seed=10 + levels)
    ref = np.asarray(RB.make_encode_fn(jax.tree_util.tree_map(jnp.asarray, params),
                                       jax.tree_util.tree_map(jnp.asarray, state), rcfg)(f))
    model = PB.binarizer_from_numpy(params, state, pcfg, device="cpu")
    for make in (PB.make_eager_encode_fn, PB.make_encode_fn):
        got = make(model)(f)
        assert got.dtype == torch.int8 and got.shape == (512, CODE)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_cpu_encode_stays_eager():
    _, pcfg, params, state = _weights(2)
    model = PB.binarizer_from_numpy(params, state, pcfg, device="cpu")
    encode = PB.make_encode_fn(model)
    assert not isinstance(encode, PB.CapturedEncode)
    assert encode(_embeddings(0)).shape == (0, CODE)


def _card_model(levels=4, seed=0):
    _, pcfg, params, state = _weights(levels, seed)
    return PB.binarizer_from_numpy(params, state, pcfg, device=_card())


@pytest.mark.gpu
def test_captured_encode_is_bit_identical_to_eager_on_card():
    torch.backends.cuda.matmul.allow_tf32 = False
    model = _card_model()
    captured, eager = PB.make_encode_fn(model), PB.make_eager_encode_fn(model)
    assert isinstance(captured, PB.CapturedEncode)
    shapes = (1, 7, 64, 64, 100, 4096, 7)
    for i, b in enumerate(shapes):
        f = _embeddings(b, seed=20 + i)
        for x in (f, torch.from_numpy(f).cuda()):
            got = captured(x)
            assert got.device.type == "cuda" and got.dtype == torch.int8
            assert torch.equal(got, eager(x)), b
    assert captured.captures == len(set(shapes))
    assert captured.replays == 2 * len(shapes)
    assert captured(_embeddings(0)).shape == (0, CODE)


@pytest.mark.gpu
def test_captured_encode_keeps_its_weights_on_card():
    model = _card_model()
    captured = PB.make_encode_fn(model)
    f = _embeddings(64)
    before = captured(f)
    _perturb(model)
    assert torch.equal(captured(f), before)


@pytest.mark.gpu
def test_threads_sharing_one_captured_encode_get_their_own_codes():
    """Four threads (replicas) share one closure, each on its own batch and
    shape, interleaved many times; every call returns its own batch's codes."""
    model = _card_model()
    captured, eager = PB.make_encode_fn(model), PB.make_eager_encode_fn(model)
    batches = [torch.from_numpy(_embeddings(b, seed=30 + t)).cuda()
               for t, b in enumerate((64, 64, 16, 33))]
    want = [eager(b) for b in batches]
    errors = []

    def worker(t):
        try:
            for _ in range(50):
                if not torch.equal(captured(batches[t]), want[t]):
                    errors.append(t)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    assert captured.replays == 200


_FAILED_CAPTURE = """
import numpy as np, torch
from repro_torch import prng
from repro_torch.core import binarize_lib as PB

cfg = PB.BinarizerConfig(input_dim=64, code_dim=32, n_levels=4, hidden_dim=128)
model = PB.init_binarizer(cfg, prng.key(0, "cuda"), "cuda")
captured = PB.make_encode_fn(model)
real = PB.binarize

def syncing_binarize(m, x, train=False):
    out = real(m, x, train)
    float(out[1].sum())  # a host read: illegal while the stream captures
    return out

PB.binarize = syncing_binarize
try:
    captured(np.zeros((8, 64), np.float32))
except RuntimeError as e:
    print("raised:", str(e).splitlines()[0])
else:
    raise SystemExit("the capture did not fail")
"""


@pytest.mark.gpu
def test_a_failed_capture_raises():
    """A forward that reads the device while the stream captures raises; it
    does not fall back to eager. In its own process: an aborted capture
    leaves PyTorch's CUDA generator registered with it, so later random
    draws on the card in that process fail."""
    import os
    import subprocess
    import sys

    _card()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run([sys.executable, "-c", _FAILED_CAPTURE], env=env, cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "raised:" in out.stdout, out.stdout + out.stderr

"""Gradient compression of the PyTorch port (``repro_torch/train/compression.py``)
against the JAX reference (``repro/train/compression.py``).

Seeded numpy inputs go through both; every quantized payload, scale and
new error is bit-identical in float32: normal data, an all-zero tensor
(scale 1e-12), exact .5 ties (round half to even), bfloat16 gradients
(upcast to float32 before the error is added) and bfloat16 input to
``quantize_int8`` itself. The reference's own two claims
(``tests/test_train_substrate.py``) hold on the port. ``compressed_psum``
runs over 8 gloo CPU processes against the reference's 8-device
``shard_map`` (one subprocess with 8 forced host devices, as
``tests/test_engine_distributed.py`` runs it): each rank's payload, scale
and new error exact; the mean, a sum of 8 float32 values in another
order, within 4 ulps of its magnitude.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.train import compression as RC  # noqa: E402
from repro_torch.train import compression as PC  # noqa: E402

torch.set_num_threads(1)
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RANKS, WIDTH = 8, 64
MEAN_ULPS = 4


def _bits_equal(port: torch.Tensor, ref) -> bool:
    ref = np.asarray(ref).reshape(-1)
    port = port.detach().reshape(-1)
    if port.dtype == torch.bfloat16:
        return ref.dtype.name == "bfloat16" and np.array_equal(
            port.view(torch.int16).numpy(), ref.view(np.int16))
    return port.numpy().dtype == ref.dtype and np.array_equal(
        port.numpy().view(np.uint8), ref.view(np.uint8))


def _ties() -> np.ndarray:
    # max 127 -> scale 1 + 1e-12 == 1.0 in float32, so x / scale == x: the
    # halves round to even
    return np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5, -126.5],
                    np.float32)


CASES = {
    "normal": lambda rng: rng.normal(size=(1000,)).astype(np.float32),
    "matrix": lambda rng: (rng.normal(size=(64, 33)) * 1e-3).astype(np.float32),
    "zeros": lambda rng: np.zeros((7, 5), np.float32),
    "ties": lambda rng: _ties(),
    "tiny": lambda rng: (rng.normal(size=(300,)) * 1e-30).astype(np.float32),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_quantize_bit_exact(case):
    x = CASES[case](np.random.default_rng(0))
    q, s = PC.quantize_int8(torch.from_numpy(x))
    rq, rs = RC.quantize_int8(jnp.asarray(x))
    assert _bits_equal(q, rq) and _bits_equal(s, rs)
    assert _bits_equal(PC.dequantize_int8(q, s), RC.dequantize_int8(rq, rs))
    if case == "zeros":
        assert float(s) == np.float32(1e-12) and not q.any()
    if case == "ties":
        assert q.tolist() == [127, 0, 2, 2, 0, -2, -2, 4, 126, -126]


def test_quantize_bfloat16_input_bit_exact():
    x = np.random.default_rng(1).normal(size=(513,)).astype(np.float32)
    rx = jnp.asarray(x, jnp.bfloat16)
    px = torch.from_numpy(np.asarray(rx).view(np.int16).copy()).view(torch.bfloat16)
    q, s = PC.quantize_int8(px)
    rq, rs = RC.quantize_int8(rx)
    assert s.dtype == torch.bfloat16 and _bits_equal(q, rq) and _bits_equal(s, rs)


def _tree(rng, dtype=np.float32):
    return {"w": rng.normal(size=(32, 16)).astype(dtype),
            "layers": [{"b": (rng.normal(size=(16,)) * 0.01).astype(dtype)},
                       {"b": np.zeros((16,), dtype)}]}


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


@pytest.mark.parametrize("bf16", [False, True])
def test_compress_with_feedback_bit_exact_over_rounds(bf16):
    rng = np.random.default_rng(2)
    err_p = PC.init_error_feedback(_to_torch(_tree(rng)))
    err_r = RC.init_error_feedback(jax.tree_util.tree_map(jnp.asarray, _tree(rng)))
    for e, re_ in zip(_leaves(err_p), _leaves(err_r)):
        assert e.dtype == torch.float32 and _bits_equal(e, re_)
    for _ in range(4):
        g = _tree(rng)
        if bf16:
            g_r = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), g)
            g_p = jax.tree_util.tree_map(lambda a: torch.from_numpy(
                np.asarray(a).view(np.int16).copy()).view(torch.bfloat16), g_r)
        else:
            g_r, g_p = jax.tree_util.tree_map(jnp.asarray, g), _to_torch(g)
        q, s, err_p = PC.compress_with_feedback(g_p, err_p)
        rq, rs, err_r = RC.compress_with_feedback(g_r, err_r)
        assert jax.tree_util.tree_structure(q) == jax.tree_util.tree_structure(rq)
        for a, b in zip(_leaves(q) + _leaves(s) + _leaves(err_p),
                        _leaves(rq) + _leaves(rs) + _leaves(err_r)):
            assert _bits_equal(a, b)
        assert all(e.dtype == torch.float32 for e in _leaves(err_p))


def test_int8_quantize_roundtrip_bound():
    """The reference's claim (tests/test_train_substrate.py), on its inputs."""
    x = torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(0), (1000,))))
    q, s = PC.quantize_int8(x)
    err = torch.max(torch.abs(PC.dequantize_int8(q, s) - x))
    assert float(err) <= float(s) * 0.5 + 1e-6


def test_error_feedback_unbiased_over_time():
    """The reference's claim: with error feedback the accumulated compressed
    signal tracks the accumulated true signal (the residual stays bounded)."""
    g_true = torch.from_numpy(
        np.array(jax.random.normal(jax.random.PRNGKey(1), (256,)) * 0.1))
    e = torch.zeros(256)
    total = torch.zeros(256)
    for _ in range(50):
        corrected = g_true + e
        q, s = PC.quantize_int8(corrected)
        deq = PC.dequantize_int8(q, s)
        e = corrected - deq
        total = total + deq
    drift = torch.max(torch.abs(total - 50 * g_true))
    assert float(drift) <= float(torch.max(torch.abs(g_true + e)) / 127.0 * 2 + 1e-4)


# ---------------------------------------------------------------------------
# compressed_psum: 8 gloo processes against the reference's 8-device shard_map.
# ---------------------------------------------------------------------------

_REFERENCE = """
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.train import compression as comp

inp = np.load(sys.argv[1])
mesh = jax.make_mesh((8,), ("data",))

def sync(g, e):
    q, s, _ = comp.compress_with_feedback({"g": g}, {"g": e})
    mean, new_e = comp.compressed_psum({"g": g}, {"g": e}, "data")
    return mean["g"], new_e["g"], q["g"], s["g"][None]

f = shard_map(sync, mesh=mesh, in_specs=(P("data"), P("data")),
              out_specs=(P(), P("data"), P("data"), P("data")), check_rep=False)
with mesh:
    mean, new_e, q, s = f(jnp.asarray(inp["g"]), jnp.asarray(inp["e"]))
np.savez(sys.argv[2], mean=np.asarray(mean), new_e=np.asarray(new_e), q=np.asarray(q),
         s=np.asarray(s))
"""

_RANK = """
import sys
import numpy as np, torch
import torch.distributed as dist
from repro_torch.train import compression as comp

torch.set_num_threads(1)
rank, world = int(sys.argv[1]), int(sys.argv[2])
addr, inp, out = sys.argv[3:6]
dist.init_process_group("gloo", init_method=addr, world_size=world, rank=rank)
try:
    data = np.load(inp)
    g = torch.from_numpy(data["g"][rank:rank + 1].copy())
    e = torch.from_numpy(data["e"][rank:rank + 1].copy())
    q, s, _ = comp.compress_with_feedback({"g": g}, {"g": e})
    mean, new_e = comp.compressed_psum({"g": g}, {"g": e})
    np.savez(out, mean=mean["g"].numpy(), new_e=new_e["g"].numpy(), q=q["g"].numpy(),
             s=s["g"].numpy()[None])
finally:
    dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_compressed_psum_matches_the_reference_shard_map(tmp_path):
    rng = np.random.default_rng(3)
    g = rng.normal(size=(RANKS, WIDTH)).astype(np.float32)
    g[5] *= 40.0  # one rank's scale far from the others'
    e = (rng.normal(size=(RANKS, WIDTH)) * 0.01).astype(np.float32)
    np.savez(tmp_path / "in.npz", g=g, e=e)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref = subprocess.Popen([sys.executable, "-c", textwrap.dedent(_REFERENCE),
                            str(tmp_path / "in.npz"), str(tmp_path / "ref.npz")],
                           env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    addr = f"tcp://127.0.0.1:{_free_port()}"
    ranks = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), str(RANKS), addr,
                               str(tmp_path / "in.npz"), str(tmp_path / f"rank{r}.npz")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(RANKS)]
    for p in [ref] + ranks:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-3000:]
    want = np.load(tmp_path / "ref.npz")
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(RANKS)]
    for r in range(RANKS):
        for name in ("q", "s", "new_e"):
            a, b = got[r][name], want[name][r:r + 1]
            assert a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8)), \
                (r, name)
        # the mean of 8 dequantized payloads, summed in another order
        ulp = np.spacing(np.abs(want["mean"]).max())
        assert np.abs(got[r]["mean"] - want["mean"]).max() <= MEAN_ULPS * ulp
        assert np.array_equal(got[r]["mean"], got[0]["mean"])  # every rank the same
    # the reference test's bound on the mean's error (here of the corrected gradients)
    assert np.abs(got[0]["mean"][0] - (g + e).mean(0)).max() <= np.abs(g + e).max() / 127.0 + 1e-5

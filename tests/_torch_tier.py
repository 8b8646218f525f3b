"""Shared fixtures of the serving-tier parity tests (``tests/test_torch_{clock,
faults,router,version_routing,swap,autoscale}.py``).

The tier is pure Python over ``launch/serving.py``, so each parity case
runs one scenario twice: over the reference's modules with the
reference's closures (JAX on the CPU, ``backend="xla"``), and over the
port's modules with the port's CPU closures, on the same numpy codes,
and compares what comes out bit for bit. ``REF`` and ``PORT`` name the
two sides; a scenario takes one of them.

Imported by those test files only after ``pytest.importorskip("torch")``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.index import kmeans as RK
from repro.kernels.sdc import ref as RR
from repro.launch import autoscale as RA
from repro.launch import clock as RC
from repro.launch import faults as RF
from repro.launch import lifecycle as RL
from repro.launch import proxy as RP
from repro.launch import serving as RS
from repro_torch.index import kmeans as PK
from repro_torch.kernels.sdc import ref as PR
from repro_torch.launch import autoscale as PA
from repro_torch.launch import clock as PC
from repro_torch.launch import faults as PF
from repro_torch.launch import lifecycle as PL
from repro_torch.launch import proxy as PP
from repro_torch.launch import serving as PS

LEVELS = 4

REF = types.SimpleNamespace(
    name="ref", autoscale=RA, clock=RC, faults=RF, lifecycle=RL, proxy=RP, serving=RS,
    array=np.asarray, build_kw=dict(backend="xla"))
PORT = types.SimpleNamespace(
    name="port", autoscale=PA, clock=PC, faults=PF, lifecycle=PL, proxy=PP, serving=PS,
    array=torch.as_tensor, build_kw=dict(device="cpu"))
SIDES = (REF, PORT)

# The reference's lifecycle test parameters, per family (backend/device
# come from the side's ``build_kw``).
BUILDER_PARAMS = {
    "flat": dict(k=10),
    "ivf": dict(k=10, nlist=8, nprobe=4, kmeans_iters=3, seed=1),
    "hnsw": dict(k=10, M=8, ef_construction=24, ef=24, beam=8, seed=0),
}

#: The router stats a deterministic scenario fixes exactly.
DETERMINISTIC_STATS = ("replicas", "retired_replicas", "router", "healthy", "requests",
                       "queries", "shed", "failovers", "revivals", "states",
                       "compat_dispatches", "deadline_expired", "watchdog_stalls", "degraded",
                       "effort_level")


def host(x):
    """A result array as numpy, from JAX, torch or numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def same(a, b) -> bool:
    """Bit identity of two arrays (float scores compared as their bits)."""
    a, b = host(a), host(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.kind == "f":
        return np.array_equal(a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}"))
    return np.array_equal(a, b)


def same_results(want, got) -> bool:
    """Two result lists equal pair for pair (``None`` for a missed deadline)."""
    if len(want) != len(got):
        return False
    for w, g in zip(want, got):
        if (w is None) != (g is None):
            return False
        if w is not None and not (same(w[0], g[0]) and same(w[1], g[1])):
            return False
    return True


def det_stats(stats: dict) -> dict:
    """The deterministic part of ``QueryRouter.stats()``, with per-replica
    requests, generations and states."""
    out = {k: stats[k] for k in DETERMINISTIC_STATS}
    out["per_replica"] = [(s["replica"], s["requests"], s["generation"], s["state"],
                           s["version"]) for s in stats["per_replica"]]
    return out


def batches(side, n=6, width=4):
    """Identity-replica batches: batch i is ``width`` copies of i."""
    return [side.array(np.full((width,), i, dtype=np.int64)) for i in range(n)]


def identity_replica(side, tag, calls=None, fail_after=None):
    """(encode, search) whose output encodes the input batch; ``calls``
    records (tag, batch) per scan; ``fail_after=N`` wraps the pair in a
    ``FaultInjector`` whose scans raise from scan call N on."""

    def encode(x):
        return x

    def search(c):
        if calls is not None:
            calls.append((tag, int(host(c).ravel()[0])))
        return c * 2, c + 1

    if fail_after is None:
        return encode, search
    return side.faults.FaultInjector(
        encode, search, side.faults.FaultPlan.fail_after(fail_after), name=f"r{tag}").pair


def check_identity(results, n, width=4):
    assert len(results) == n
    for i, (vals, ids) in enumerate(results):
        assert np.array_equal(host(vals), np.full((width,), 2 * i))
        assert np.array_equal(host(ids), np.full((width,), i + 1))


def code_corpus(n=600, q=24, dim=32, seed=0):
    rng = np.random.default_rng(seed)
    cd = rng.integers(0, 2**LEVELS, (n, dim)).astype(np.int8)
    cq = rng.integers(0, 2**LEVELS, (q, dim)).astype(np.int8)
    return cd, cq


def code_batches(side, cq, width=8):
    return [side.array(cq[i:i + width]) for i in range(0, cq.shape[0], width)]


def hand_over_reference_inputs(monkeypatch, seed):
    """Make the port's builds bit-comparable with the reference's: they take
    the reference's inverse norms (the port's root is correctly rounded,
    the reference's XLA ``rsqrt`` may differ by one ulp) and the
    reference's k-means++ picks for ``seed``."""
    def doc_inv_norms(codes, n_levels):
        inv = RR.doc_inv_norms(jnp.asarray(codes.cpu().numpy()), n_levels)
        return torch.from_numpy(np.array(inv)).to(codes.device)

    def kmeans_pp_init(key, x, k):
        init = RK.kmeans_pp_init(jax.random.PRNGKey(seed), jnp.asarray(x.cpu().numpy()), k)
        return torch.from_numpy(np.array(init)).to(x.device)

    monkeypatch.setattr(PR, "doc_inv_norms", doc_inv_norms)
    monkeypatch.setattr(PK, "kmeans_pp_init", kmeans_pp_init)


def make_builder(side, kind, **extra):
    params = dict(BUILDER_PARAMS[kind], **extra)
    return side.lifecycle.make_builder(kind, **params, **side.build_kw)


def index_closure(side, kind, cd, **extra):
    """The side's ``kind`` index over ``cd`` through its lifecycle builder."""
    snap = side.lifecycle.CorpusSnapshot(codes=cd, n_levels=LEVELS)
    return make_builder(side, kind, **extra).build(snap)


def error_of(fn, *args, **kwargs):
    """(type name, message) of what ``fn`` raises."""
    try:
        fn(*args, **kwargs)
    except Exception as e:  # noqa: BLE001 - the test compares whatever is raised
        return type(e).__name__, str(e)
    raise AssertionError(f"{fn} raised nothing")

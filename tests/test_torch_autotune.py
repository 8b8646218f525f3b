"""The port's block-plan autotuner (``launch/autotune.py``) against the
reference's contract (``tests/test_autotune.py``) and the reference itself.

A cache hit reloads exactly the plan the first caller swept, every
signature knob moves the digest, and a corrupt or stale entry is re-tuned,
never trusted. Plans change launch geometry only: any plan, tuned or not,
gives bit-identical scores and ids.

On the CPU the scan has no kernel (its plan is inert, source
"inert-backend"), so the cache cases sweep the rerank, which both backends
sweep. The ``gpu`` cases sweep the card's scan geometry: every candidate
bit-identical to the default, each launching its own grid
(``sdc_topk.last_geometry``), a tuned plan reaching the flat path and the
engine's leaves, an illegal geometry refused.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.sdc import rerank as RR  # noqa: E402
from repro.launch import autotune as RA  # noqa: E402
from repro_torch.index.flat import FlatSDC  # noqa: E402
from repro_torch.kernels.sdc import ref as PREF  # noqa: E402
from repro_torch.kernels.sdc import sdc as PS  # noqa: E402
from repro_torch.kernels.sdc.defaults import BlockPlan, default_plan, plan_for  # noqa: E402
from repro_torch.kernels.sdc.ops import sdc_search_backend  # noqa: E402
from repro_torch.kernels.sdc.rerank import sdc_rerank_gathered  # noqa: E402
from repro_torch.launch import autotune  # noqa: E402

M, N, LEVELS = 16, 64, 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _codes(seed=0, n=N, m=M, q=4):
    rng = np.random.default_rng(seed)
    hi = 2 ** LEVELS
    cd = torch.from_numpy(rng.integers(0, hi, size=(n, m)).astype(np.int8))
    cq = torch.from_numpy(rng.integers(0, hi, size=(q, m)).astype(np.int8))
    return cd, cq


def _tune(kind="rerank", cache_dir=None, **kw):
    kw.setdefault("code_dim", M)
    kw.setdefault("n_shard", N)
    kw.setdefault("k", 8)
    kw.setdefault("n_levels", LEVELS)
    kw.setdefault("sample_q", 2)
    kw.setdefault("reps", 1)
    kw.setdefault("device", "cpu")
    return autotune.tuned_block_plan(kind, cache_dir=cache_dir, **kw)


def test_second_call_is_a_cache_hit(tmp_path):
    first = _tune(cache_dir=str(tmp_path))
    assert first.tuned is True
    assert first.plan.source == "tuned"
    second = _tune(cache_dir=str(tmp_path))
    assert second.tuned is False
    assert second.plan.source == "cache"
    assert second.digest == first.digest
    assert second.path == first.path
    assert second.plan.blocks() == first.plan.blocks()


def test_replicas_sharing_a_cache_dir_share_one_plan(tmp_path):
    plans = [_tune(cache_dir=str(tmp_path)) for _ in range(3)]
    assert [p.tuned for p in plans] == [True, False, False]
    assert len({p.plan.blocks() for p in plans}) == 1
    assert len({p.path for p in plans}) == 1


def test_every_signature_knob_moves_the_digest():
    base = dict(code_dim=M, n_shard=N, packed=False, k=4, backend="torch")
    d0 = autotune.plan_digest("scan", **base)
    assert autotune.plan_digest("scan", **base) == d0
    for var in (
        dict(base, code_dim=2 * M),
        dict(base, n_shard=2 * N),
        dict(base, packed=True),
        dict(base, k=8),
        dict(base, backend="cuda"),
    ):
        assert autotune.plan_digest("scan", **var) != d0
    assert autotune.plan_digest("rerank", **base) != d0


@pytest.mark.parametrize("kind", ["scan", "rerank", "gather"])
@pytest.mark.parametrize("backend", ["cuda", "torch", "pallas"])
def test_plan_digest_equals_the_reference(kind, backend):
    sig = dict(code_dim=128, n_shard=10_000_037, packed=True, k=160, backend=backend)
    assert autotune.plan_digest(kind, **sig) == RA.plan_digest(kind, **sig)


def test_corrupt_plan_is_retuned_not_trusted(tmp_path):
    first = _tune(cache_dir=str(tmp_path))
    with open(first.path, "w") as f:
        f.write("not json {")
    again = _tune(cache_dir=str(tmp_path))
    assert again.tuned is True
    assert again.path == first.path


def test_stale_signature_is_retuned(tmp_path):
    first = _tune(cache_dir=str(tmp_path))
    with open(first.path) as f:
        payload = json.load(f)
    payload["signature"]["n_shard"] = N + 1  # drifted world
    with open(first.path, "w") as f:
        json.dump(payload, f)
    again = _tune(cache_dir=str(tmp_path))
    assert again.tuned is True


@pytest.mark.parametrize("field,value", [("block_q", "wat"), ("block_n", 0),
                                         ("block_n", True), ("block_q", None)])
def test_corrupt_blocks_are_retuned(tmp_path, field, value):
    first = _tune(cache_dir=str(tmp_path))
    with open(first.path) as f:
        payload = json.load(f)
    payload[field] = value
    with open(first.path, "w") as f:
        json.dump(payload, f)
    again = _tune(cache_dir=str(tmp_path))
    assert again.tuned is True
    with open(again.path) as f:
        assert isinstance(json.load(f)[field], int)


def test_env_var_override_is_honored(tmp_path, monkeypatch):
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path))
    tp = _tune(cache_dir=None)
    assert tp.path.startswith(str(tmp_path))


def test_explicit_cache_dir_beats_env(tmp_path, monkeypatch):
    env_dir, arg_dir = tmp_path / "env", tmp_path / "arg"
    monkeypatch.setenv(autotune.CACHE_ENV, str(env_dir))
    tp = _tune(cache_dir=str(arg_dir))
    assert tp.path.startswith(str(arg_dir))
    assert not env_dir.exists()


def test_unsweepable_signatures_short_circuit(tmp_path):
    # the plain path has no kernel (as the reference's "xla"); gather's
    # geometry is corpus-fixed (the card's case is below)
    for kind in ("scan", "gather"):
        inert = _tune(kind, cache_dir=str(tmp_path))
        assert inert.plan.source == "inert-backend"
        assert inert.plan.blocks() == default_plan(kind).blocks()
        assert inert.path is None and inert.tuned is False
    assert not list(tmp_path.iterdir())


def test_sweep_payload_records_paired_timings(tmp_path):
    # tuned is the min over all candidates INCLUDING the default, so it
    # can never exceed default; every candidate's time is kept
    tp = _tune(cache_dir=str(tmp_path))
    with open(tp.path) as f:
        payload = json.load(f)
    assert payload["default_ms"] is not None and payload["tuned_ms"] is not None
    assert payload["tuned_ms"] <= payload["default_ms"]
    assert payload["default_blocks"] == list(default_plan("rerank").blocks())
    grid = autotune.candidate_grid("rerank", code_dim=M, n_shard=N, packed=False, k=8)
    assert [(c["block_q"], c["block_n"]) for c in payload["candidates"]] == grid
    assert payload["candidates"][0]["ms"] == payload["default_ms"]
    assert min(c["ms"] for c in payload["candidates"]) == payload["tuned_ms"]
    assert payload["signature"]["backend"] == "torch" and payload["sweep_s"] > 0


def test_candidate_grid_leads_with_the_default():
    for kind in ("scan", "rerank", "gather"):
        grid = autotune.candidate_grid(kind, code_dim=M, n_shard=N, packed=False, k=4)
        assert grid[0] == default_plan(kind).blocks()
        assert len(grid) == len(set(grid))


@pytest.mark.parametrize("k", [1, 4, 8, 40, 160])
def test_rerank_candidate_grid_equals_the_reference(k):
    kw = dict(code_dim=128, n_shard=10_000, packed=False, k=k)
    assert autotune.candidate_grid("rerank", **kw) == RA.candidate_grid("rerank", **kw)
    assert autotune.candidate_grid("gather", **kw) == RA.candidate_grid("gather", **kw)


def test_any_plan_is_bit_identical_through_the_scan(tmp_path):
    cd, cq = _codes()
    inv = torch.ones(N)
    ref_s, ref_i = sdc_search_backend(cq, cd, inv, n_levels=LEVELS, k=4)
    tuned = _tune("scan", cache_dir=str(tmp_path), k=4)
    for plan in (tuned.plan, BlockPlan("scan", 8, 256, "tuned")):
        s, i = sdc_search_backend(cq, cd, inv, n_levels=LEVELS, k=4, block_plan=plan)
        assert torch.equal(s, ref_s) and torch.equal(i, ref_i)


def test_plan_is_bit_identical_through_flat_index():
    cd, cq = _codes(seed=3)
    index = FlatSDC.build(cd, n_levels=LEVELS, device="cpu")
    ref_s, ref_i = index.search(cq, 4)
    s, i = index.search(cq, 4, block_plan=BlockPlan("scan", 8, 128, "tuned"))
    assert torch.equal(s, ref_s) and torch.equal(i, ref_i)


def _candidates(seed, n=N, q=4, kp=8):
    rng = np.random.default_rng(seed)
    return np.stack([rng.choice(n, size=kp, replace=False) for _ in range(q)]).astype(np.int32)


def test_rerank_grouping_is_bit_identical():
    cd, cq = _codes(seed=5)
    inv = np.ones(N, np.float32)
    cand = _candidates(7)
    ref_s, ref_i = sdc_rerank_gathered(cq, cd.numpy(), inv, cand, n_levels=LEVELS, k=4, group=1)
    for group in (4, 8, 32):
        s, i = sdc_rerank_gathered(cq, cd.numpy(), inv, cand, n_levels=LEVELS, k=4, group=group)
        assert torch.equal(s, ref_s) and torch.equal(i, ref_i)


def test_rerank_plans_tuned_by_each_package_give_the_reference_ids(tmp_path):
    """Each package tunes its rerank plan; the ids and scores each plan
    serves are the same, and the reference's own."""
    cd, cq = _codes(seed=11, n=200)
    inv = PREF.doc_inv_norms(cd, LEVELS).numpy()
    cand = _candidates(12, n=200, kp=40)
    kw = dict(code_dim=M, n_shard=200, packed=False, k=40, n_levels=LEVELS, sample_q=2, reps=1)
    port = autotune.tuned_block_plan("rerank", cache_dir=str(tmp_path / "p"), device="cpu",
                                     **kw).plan
    ref = RA.tuned_block_plan("rerank", cache_dir=str(tmp_path / "r"), backend="xla", **kw).plan
    want_s, want_i = RR.sdc_rerank_gathered(jnp.asarray(cq.numpy()), cd.numpy(), inv, cand,
                                            n_levels=LEVELS, k=10, group=ref.block_n,
                                            backend="xla")
    s, i = sdc_rerank_gathered(cq, cd.numpy(), inv, cand, n_levels=LEVELS, k=10,
                               group=port.block_n)
    np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))


def test_plan_for_selects_by_kind():
    scan = BlockPlan("scan", 8, 256, "tuned")
    rerank = BlockPlan("rerank", 1, 8, "tuned")
    assert plan_for(None, "scan") is None
    assert plan_for(scan, "scan") is scan
    assert plan_for(scan, "rerank") is None  # single plan, other kind
    mapping = {"scan": scan, "rerank": rerank}
    assert plan_for(mapping, "rerank") is rerank
    assert plan_for(mapping, "gather") is None
    with pytest.raises(ValueError, match="kind"):
        plan_for({"scan": rerank}, "scan")  # mislabeled entry


def test_shape_errors_carry_the_offending_shapes():
    from repro_torch.kernels.sdc.ops import sdc_search

    cd, cq = _codes()
    inv = torch.ones(N)
    with pytest.raises(ValueError, match=r"query dim"):
        # packed flag promised half-width codes but got full-width ones
        sdc_search_backend(cq, cd, inv, n_levels=LEVELS, k=4, packed=True)
    with pytest.raises(ValueError, match="'scan' plan"):
        sdc_search(cq, cd, inv, n_levels=LEVELS, k=4, block_plan=BlockPlan("rerank", 1, 8))


def _cli(args, cache):
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--docs", "2000",
           "--queries", "32", "--steps", "20", "--batch", "16", "--rounds", "1",
           "--ckpt-cache", str(cache / "ckpt"), *args]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_cli_autotune_persists_then_reloads_the_plans(tmp_path):
    args = ["--autotune", "--tune-cache", str(tmp_path / "tune"), "--coarse-levels", "2",
            "--k-coarse", "40"]
    first = _cli(args, tmp_path)
    assert "[tune] scan: block_q=128 block_n=512 (inert-backend)" in first
    assert "[tune] rerank: block_q=1 " in first and "(tuned, swept now)" in first
    (plan_file,) = (tmp_path / "tune").iterdir()
    payload = json.loads(plan_file.read_text())
    assert payload["signature"] == {"kind": "rerank", "code_dim": 128, "n_shard": 2000,
                                    "packed": False, "k": 40, "backend": "torch"}
    assert payload["sample_q"] == 16
    second = _cli(args, tmp_path)
    assert "(cache)" in second and "swept now" not in second
    recall = [ln for ln in second.splitlines() if ln.startswith("[serve] recall@10")]
    assert recall and recall == [ln for ln in first.splitlines()
                                 if ln.startswith("[serve] recall@10")]


# ---------------------------------------------------------------------------
# On the card: the scan's launch geometry.
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_corpus(n, D=128, packed=False, q=64, seed=0):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = torch.randint(0, 16, (n, D), generator=gen, device=dev, dtype=torch.int8)
    qc = torch.randint(0, 16, (q, D), generator=gen, device=dev, dtype=torch.int8)
    index = FlatSDC.build(d, 4, packed=packed, device=dev)
    return index, qc


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n,k", [(300_007, 10), (50_021, 160), (3_001, 10)])
def test_every_scan_candidate_is_bit_identical_on_card(tmp_path, packed, n, k):
    index, q = _card_corpus(n, packed=packed)
    default = index.search(q, k)
    geometry = PS.sdc_topk.last_geometry
    assert geometry == PS.scan_geometry(q.shape[0], n, 128, packed, k, q.device)
    grid = autotune.candidate_grid("scan", code_dim=128, n_shard=n, packed=packed, k=k,
                                   backend="cuda", sample_q=q.shape[0], device=q.device)
    launched = []
    for bq, bn in grid:
        s, i = index.search(q, k, block_plan=BlockPlan("scan", bq, bn, "tuned"))
        assert torch.equal(s, default[0]) and torch.equal(i, default[1]), (bq, bn)
        launched.append(PS.sdc_topk.last_geometry)
    assert launched[0] == geometry  # the default plan launches the default grid
    assert len(set(launched)) == len(launched)  # no grid timed twice
    tp = autotune.tuned_block_plan("scan", code_dim=128, n_shard=n, packed=packed, k=k,
                                   cache_dir=str(tmp_path), sample_q=q.shape[0], reps=3)
    payload = json.loads(open(tp.path).read())
    assert [(c["block_q"], c["block_n"]) for c in payload["candidates"]] == grid
    assert [tuple(c["launched"]) for c in payload["candidates"]] == launched
    assert payload["tuned_ms"] <= payload["default_ms"]
    again = autotune.tuned_block_plan("scan", code_dim=128, n_shard=n, packed=packed, k=k,
                                      cache_dir=str(tmp_path), sample_q=q.shape[0])
    assert again.tuned is False and again.plan.blocks() == tp.plan.blocks()


@pytest.mark.gpu
def test_a_plan_reaches_the_launch_on_card():
    index, q = _card_corpus(200_003)
    index.search(q, 10)
    default = PS.sdc_topk.last_geometry
    index.search(q, 10, block_plan=BlockPlan("scan", 4, 4096, "tuned"))
    assert PS.sdc_topk.last_geometry == (4, -(-200_003 // 4096), 4096) != default
    index.search(q[:3], 10, block_plan=BlockPlan("scan", 16, 4096, "tuned"))
    assert PS.sdc_topk.last_geometry[0] == 3  # queries per block cut to Q


@pytest.mark.gpu
def test_a_plan_reaches_the_engine_leaves_on_card():
    from repro_torch.index import engine as PEN
    from repro_torch.launch import mesh as PM

    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(1)
    d = torch.randint(0, 16, (4 * 50_000, 64), generator=gen, device=dev, dtype=torch.int8)
    q = torch.randint(0, 16, (16, 64), generator=gen, device=dev, dtype=torch.int8)
    mesh = PM.make_host_mesh((2, 2), devices=[dev] * 4)
    plain = PEN.engine_search_from_snapshot(mesh, d, 4, k=10)
    plan = {"scan": BlockPlan("scan", 8, 1024, "tuned")}
    tuned = PEN.engine_search_from_snapshot(mesh, d, 4, k=10, block_plan=plan)
    want = plain(q)
    PS.sdc_topk.launches = 0
    got = tuned(q)
    assert PS.sdc_topk.launches == 4
    assert PS.sdc_topk.last_geometry == (8, -(-50_000 // 1024), 1024)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("blocks,match", [
    ((0, 4096), "1 to 16 queries"), ((17, 4096), "1 to 16 queries"),
    ((8, 1000), "multiple of 256"), ((8, 0), "multiple of 256"),
    ((8, 256), "slices"), ((8.0, 4096), "ints"),
])
def test_an_illegal_geometry_raises_on_card(blocks, match):
    index, q = _card_corpus(100_003)
    k = 160  # a slice covers at least 8k = 1,280 documents
    with pytest.raises(ValueError, match=match) as err:
        index.search(q, k, block_plan=BlockPlan("scan", *blocks))
    assert "N=100003" in str(err.value) and "k=160" in str(err.value)


@pytest.mark.gpu
def test_unswept_signatures_on_card(tmp_path):
    _card()
    for kind, kw, source in (("scan", dict(code_dim=300), "unfused-route"),
                             ("scan", dict(k=5000), "unfused-route"),
                             ("gather", {}, "fixed-geometry")):
        kw = {"code_dim": 128, "n_shard": 10_000, "k": 10, **kw}
        tp = autotune.tuned_block_plan(kind, cache_dir=str(tmp_path), **kw)
        assert tp.plan.source == source and tp.path is None and not tp.tuned
    assert not list(tmp_path.iterdir())

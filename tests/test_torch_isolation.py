"""The PyTorch port stands alone and runs on the card unless asked otherwise.

Importing every module of ``repro_torch`` must load neither ``jax`` nor
the reference package ``repro``; entry points default to the card and
raise when there is none (no silent fall back to the CPU). The one entry
point that does not is the dry run (``launch/dryrun.py``, and
``launch/hillclimb.py`` on the same cost model): it runs on the meta
device by design, over a fake process group, as the reference's runs on
fake host devices, and touches no card and no CPU data.
"""

import os
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.core import binarize_lib as PB  # noqa: E402
from repro_torch.data import synthetic as PS  # noqa: E402
from repro_torch.configs.archs import dlrm_rm2  # noqa: E402
from repro_torch.index import engine as PEN  # noqa: E402
from repro_torch.index import ivf as PI  # noqa: E402
from repro_torch.index import kmeans as PK  # noqa: E402
from repro_torch.index.flat import (  # noqa: E402
    BiGranularFlat,
    FlatBitwise,
    FlatFloat,
    FlatSDC,
    flat_search_from_snapshot,
)
from repro_torch.kernels.binary_dot import kernel as PBD  # noqa: E402
from repro_torch.kernels.binary_dot import ops as PBO  # noqa: E402
from repro_torch.kernels.dot_interact import kernel as PDI  # noqa: E402
from repro_torch.kernels.dot_interact import ops as PDO  # noqa: E402
from repro_torch.kernels.sdc import gather as PG  # noqa: E402
from repro_torch.kernels.sdc import ops as PO  # noqa: E402
from repro_torch.kernels.sdc import rerank as PRK  # noqa: E402
from repro_torch.kernels.sdc import sdc as PSDC  # noqa: E402
from repro_torch.launch import autoscale as PA  # noqa: E402
from repro_torch.launch import lifecycle as PL  # noqa: E402
from repro_torch.launch import proxy as PP  # noqa: E402
from repro_torch.launch import mesh as PM  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.recsys import dlrm as PD  # noqa: E402
from repro_torch.models.recsys import embedding as PE  # noqa: E402
from repro_torch.train import steps as PT  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), "modules;", "foreign:", bad)
assert not bad, bad
assert len(names) >= 12, names
for name in ("repro_torch.index.engine", "repro_torch.launch.mesh",
             "repro_torch.launch.lifecycle", "repro_torch.launch.clock",
             "repro_torch.launch.faults", "repro_torch.launch.proxy",
             "repro_torch.launch.autoscale", "repro_torch.core.losses",
             "repro_torch.core.trainer", "repro_torch.train.optim",
             "repro_torch.train.checkpoint", "repro_torch.launch.binarizer_cache",
             "repro_torch.launch.autotune", "repro_torch.launch.train",
             "repro_torch.train.steps", "repro_torch.configs.registry",
             "repro_torch.data.pipeline", "repro_torch.models.recsys.two_tower",
             "repro_torch.models.recsys.mind", "repro_torch.models.recsys.dien",
             "repro_torch.configs.archs.two_tower", "repro_torch.configs.archs.mind_cfg",
             "repro_torch.configs.archs.dien_cfg", "repro_torch.models.transformer",
             "repro_torch.models.gnn", "repro_torch.models.sampler",
             "repro_torch.configs.archs.llama3_2_1b", "repro_torch.configs.archs.meshgraphnet",
             "repro_torch.train.compression", "repro_torch.parallel.sharding",
             "repro_torch.configs.cells", "repro_torch.launch.hlo_cost",
             "repro_torch.launch.dryrun", "repro_torch.launch.hillclimb",
             "repro_torch.parallel.spmd"):
    assert name in names, name
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    return env


def test_port_imports_neither_jax_nor_the_reference():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "foreign: []" in out.stdout


def test_port_example_imports_neither_jax_nor_the_reference():
    code = (
        "import importlib.util, sys\n"
        "spec = importlib.util.spec_from_file_location('ex', 'examples/serve_bebr_torch.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("example", ["train_two_tower_e2e_torch", "quickstart_torch",
                                     "compat_upgrade_torch"])
def test_zoo_examples_import_neither_jax_nor_the_reference(example):
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('ex', 'examples/{example}.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_zoo_entry_points_default_to_the_card(tmp_path):
    """The training launcher, the zoo's initialisers and batches take the
    card by default and raise without one; ``--device cpu`` runs."""
    from repro_torch.configs.archs import dien_cfg, mind_cfg, two_tower
    from repro_torch.launch import train as PTRN
    from repro_torch.models.recsys import dien as PDN
    from repro_torch.models.recsys import mind as PMD
    from repro_torch.models.recsys import two_tower as PTT

    calls = {
        "tt init": lambda: PTT.init_params(two_tower.SMOKE, prng.key(0, "cpu")),
        "mind init": lambda: PMD.init_params(mind_cfg.SMOKE, prng.key(0, "cpu")),
        "dien init": lambda: PDN.init_params(dien_cfg.SMOKE, prng.key(0, "cpu")),
        "tt batch": lambda: PS.tt_batch(0, 4, two_tower.SMOKE),
        "mind batch": lambda: PS.mind_batch(0, 4, mind_cfg.SMOKE),
        "dien batch": lambda: PS.dien_batch(0, 4, dien_cfg.SMOKE),
        "tree": lambda: PE.tree_from_numpy({"w": np.zeros(3)}),
    }
    args = ["--arch", "mind", "--steps", "2", "--ckpt-every", "1",
            "--ckpt-dir", str(tmp_path / "ck")]
    if torch.cuda.is_available():
        assert calls["tt batch"]()["hist_ids"].device.type == "cuda"
        return
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    for arch in ("dlrm-rm2", "two-tower-retrieval", "mind", "dien"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PTRN.main(["--arch", arch, *args[2:]])
    assert not (tmp_path / "ck").exists()  # nothing trained or written
    assert sorted(PTRN.main(args + ["--device", "cpu"])["losses"]) == [1, 2]


def test_lm_and_gnn_entry_points_default_to_the_card(tmp_path):
    """The LM and GNN initialisers, batches, caches and launcher runs take
    the card by default and raise without one; ``--device cpu`` runs."""
    from repro_torch.configs.archs import llama3_2_1b, meshgraphnet
    from repro_torch.launch import train as PTRN
    from repro_torch.models import gnn as PGN
    from repro_torch.models import transformer as PTF

    calls = {
        "lm init": lambda: PTF.init_params(llama3_2_1b.SMOKE, prng.key(0, "cpu")),
        "gnn init": lambda: PGN.init_params(meshgraphnet.SMOKE, prng.key(0, "cpu")),
        "lm batch": lambda: PS.lm_batch(0, 2, 8, 256),
        "gnn batch": lambda: PS.gnn_batch(0, 8, 16, meshgraphnet.SMOKE),
        "kv cache": lambda: PTF.init_kv_cache(llama3_2_1b.SMOKE, 1, 8),
    }
    if torch.cuda.is_available():
        assert calls["lm batch"]()["tokens"].device.type == "cuda"
        return
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    for arch in ("llama3.2-1b", "meshgraphnet"):
        args = ["--arch", arch, "--steps", "1", "--ckpt-dir", str(tmp_path / arch)]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PTRN.main(args)
        assert not (tmp_path / arch).exists()
        assert sorted(PTRN.main(args + ["--device", "cpu"])["losses"]) == [1]
    # the full configs' shapes need no card and no memory
    assert PTF.init_params(llama3_2_1b.CONFIG, device="meta")["embed"].is_meta


def test_autotune_and_encode_default_to_the_card():
    from repro_torch.launch import autotune as PAT

    cfg = PB.BinarizerConfig(input_dim=16, code_dim=8, n_levels=2, hidden_dim=8)
    model = PB.init_binarizer(cfg, prng.key(0, "cpu"), "cpu")
    assert not isinstance(PB.make_encode_fn(model), PB.CapturedEncode)
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PAT.tuned_block_plan("scan", code_dim=32, n_shard=100)


def test_chip_smoke_imports_no_jax_and_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs for real there")
    code = (
        "import runpy, sys\n"
        "sys.argv = ['chip_smoke.py']\n"
        "try:\n"
        "    runpy.run_path('chip_smoke.py', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    code = e.code\n"
        "else:\n"
        "    code = 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "sys.exit(code)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode not in (0, None), out.stdout + out.stderr
    assert '"ok": true' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_entry_points_default_to_the_card():
    codes = np.random.default_rng(0).integers(0, 16, (50, 32)).astype(np.int8)
    cfg = PB.BinarizerConfig(input_dim=16, code_dim=8, n_levels=2, hidden_dim=8)
    if torch.cuda.is_available():
        index = FlatSDC.build(codes, 4)
        assert index.codes.device.type == "cuda" and index.inv_norm.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FlatSDC.build(codes, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FlatFloat.build(codes.astype(np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PB.init_binarizer(cfg, prng.key(0, "cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PS.clustered_corpus_torch(0, 10, 2, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--docs", "10"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PB.binarizer_from_numpy({"W": [], "R": []}, {"W": [], "R": []}, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PI.build_ivf(codes, n_levels=4, nlist=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PK.kmeans(codes.astype(np.float32), k=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--index", "ivf", "--docs", "10"])


def test_new_entry_points_default_to_the_card():
    codes = np.random.default_rng(0).integers(0, 16, (50, 32)).astype(np.int8)
    cfg = dlrm_rm2.SMOKE
    rr = {"coarse_levels": 2, "k_coarse": 8}
    if torch.cuda.is_available():
        index = FlatBitwise.build(codes, 4)
        assert index.packed.device.type == "cuda"
        assert PS.dlrm_batch(0, 4, cfg)["dense"].device.type == "cuda"
        bigr = BiGranularFlat.build(codes, 4, coarse_levels=2, k_coarse=8)
        assert bigr.coarse.codes.device.type == "cuda" and isinstance(bigr.fine_codes, np.ndarray)
        for build in (flat_search_from_snapshot, PI.ivf_search_from_snapshot):
            kw = dict(nlist=4, nprobe=2) if build is PI.ivf_search_from_snapshot else {}
            for rerank in (None, rr):
                v, i = build(codes, 4, k=5, rerank=rerank, **kw)(codes[:3])
                assert v.device.type == "cuda" and i.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FlatBitwise.build(codes, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PD.init_dlrm(cfg, prng.key(0, "cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PD.dlrm_from_numpy({"tables": np.zeros((26, 1000, 16), np.float32)}, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PS.dlrm_batch(0, 4, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PE.mlp_params(prng.key(0, "cpu"), (4, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PE.init_table(prng.key(0, "cpu"), PE.TableConfig(10, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BiGranularFlat.build(codes, 4, coarse_levels=2, k_coarse=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PRK.fine_inv_norms(codes, 4)
    for rerank in (None, rr):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            flat_search_from_snapshot(codes, 4, k=5, rerank=rerank)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PI.ivf_search_from_snapshot(codes, 4, k=5, nlist=4, nprobe=2, rerank=rerank)
    for index in ("flat", "ivf"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--index", index, "--docs", "10", "--coarse-levels", "2",
                        "--k-coarse", "8"])


def test_engine_and_builders_default_to_the_card():
    codes = np.random.default_rng(0).integers(0, 16, (64, 32)).astype(np.int8)
    snap = PL.CorpusSnapshot(codes, 4)
    if torch.cuda.is_available():
        mesh = PM.make_host_mesh((1,), ("data",))
        assert mesh.devices[0].type == "cuda"
        v, i = PEN.engine_search_from_snapshot(mesh, snap, k=5, shard_axes=("data",))(codes[:3])
        assert v.device.type == "cuda" and i.device.type == "cuda"
        v, i = PL.make_builder("flat", k=5).build(snap)(codes[:3])
        assert v.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="need 4 devices, have 0"):
        PM.make_host_mesh()
    with pytest.raises(RuntimeError, match=r"need 8 devices \(2 replicas x 4\), have 0"):
        PM.make_replica_meshes(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PEN.flat_engine_inputs_from_snapshot(codes, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PEN.sharded_graph_from_snapshot(codes, 4, n_leaves=2)
    for kind in ("flat", "ivf", "hnsw"):
        kw = dict(nlist=4, nprobe=2) if kind == "ivf" else {}
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PL.make_builder(kind, k=5, **kw).build(snap)


def test_routed_tier_defaults_to_the_card():
    """The routed CLI, the autoscaler's scale-up builds and ``make_builder``
    run on the card by default, and raise without one unless asked for the
    CPU; a tier spec loads anywhere (its builder resolves no device)."""
    codes = np.random.default_rng(0).integers(0, 16, (64, 32)).astype(np.int8)
    snap = PL.CorpusSnapshot(codes, 4, "v1")
    spec = PA.TierSpec(min_replicas=1, max_replicas=2, build_params={"k": 5},
                       cooldown_s=0.0, window_s=1.0, tick_s=1.0)
    assert spec.make_index_builder().device == "cuda"

    def scale_up(**kw):
        router = PP.QueryRouter(PP.ReplicaSet([(lambda q: q, lambda q: (q, q))]))
        scaler = PA.Autoscaler(router, spec, snapshot=snap, encode_fn=lambda q: q,
                               canary=codes[:2], pressure_fn=lambda: 1.0, **kw)
        try:
            return scaler.tick(), router.states()
        finally:
            router.close()

    assert scale_up(device="cpu") == ("scale-up", {0: "healthy", 1: "healthy"})
    assert PL.make_builder("flat", k=5, device="cpu").build(snap)(codes[:2])[0].shape == (2, 5)
    if torch.cuda.is_available():
        assert scale_up()[0] == "scale-up"
        v, _ = PL.make_builder("flat", k=5).build(snap)(codes[:2])
        assert v.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scale_up()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PL.make_builder("flat", k=5).build(snap)
    for extra in ([], ["--replicas", "2", "--chaos", "r1.fail@0"], ["--swap-after", "1"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--docs", "10", *extra])


@pytest.mark.gpu
def test_new_kernels_on_card_never_reach_the_plain_versions(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

    def plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(PBD, "binary_dot_ref", plain)
    monkeypatch.setattr(PDI, "dot_interact_torch", plain)
    dev = torch.device("cuda")
    planes = torch.randint(-2**31, 2**31 - 1, (300, 4, 4), dtype=torch.int32, device=dev)
    before = PBD.binary_dot.launches, PDI.dot_interact.launches
    v, i = PBO.binary_dot_search(planes[:5], planes, m=128, k=3)
    inter = PDO.dot_interaction(torch.randn((9, 27, 64), device=dev))
    torch.cuda.synchronize()
    assert (PBD.binary_dot.launches, PDI.dot_interact.launches) == (before[0] + 1, before[1] + 1)
    assert v.shape == (5, 3) and bool(((i >= 0) & (i < 300)).all())
    assert inter.shape == (9, 351) and bool(torch.isfinite(inter).all())


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
def test_gather_on_card_never_reaches_the_plain_version(monkeypatch, masked):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

    def plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(PG, "sdc_gather_topk_torch", plain)
    dev = torch.device("cuda")
    lists = torch.randint(0, 16, (4, 300, 64), device=dev).to(torch.int8)
    inv = torch.ones((4, 300), device=dev)
    ids = torch.arange(1200, dtype=torch.int32, device=dev).reshape(4, 300)
    q = torch.randint(0, 16, (3, 64), device=dev).to(torch.int8)
    probes = torch.tensor([[0, 1], [2, 3], [3, 0]], dtype=torch.int32, device=dev)
    mask = torch.ones((3, 2, 300), device=dev) if masked else None
    before = PG.sdc_gather_topk.launches
    v, i = PG.sdc_gather_topk(q, lists, inv, ids, probes, n_levels=4, k=5, cand_mask=mask)
    torch.cuda.synchronize()
    assert PG.sdc_gather_topk.launches == before + 1
    assert v.device.type == "cuda" and (i >= 0).all()


@pytest.mark.gpu
def test_bigranular_closures_on_card_never_reach_the_plain_versions(monkeypatch):
    """Both snapshot closures in bi-granular mode, with a device fine tier
    and a host one: every scan and rerank launches a kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

    def plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    for module, name in ((PG, "sdc_gather_topk_torch"), (PRK, "sdc_gather_topk_torch"),
                         (PSDC, "sdc_topk_torch"), (PO, "sdc_topk_torch"),
                         (PRK, "sdc_rerank_torch")):
        monkeypatch.setattr(module, name, plain)
    dev = torch.device("cuda")
    codes = torch.randint(0, 16, (3000, 64), device=dev).to(torch.int8)
    q = codes[:5]
    rr = {"coarse_levels": 2, "k_coarse": 40}
    for fine in (codes, codes.cpu().numpy()):
        launches = PSDC.sdc_topk.launches, PG.sdc_gather_topk.launches
        out = [flat_search_from_snapshot(fine, 4, k=10, packed=True, rerank=rr)(q),
               PI.ivf_search_from_snapshot(fine, 4, k=10, nlist=8, nprobe=4, rerank=rr)(q)]
        torch.cuda.synchronize()
        # flat: one scan and one rerank; IVF: a gather scan and a rerank
        assert (PSDC.sdc_topk.launches, PG.sdc_gather_topk.launches) == (launches[0] + 1,
                                                                         launches[1] + 3)
        for v, i in out:
            assert v.device.type == "cuda" and bool(((i >= 0) & (i < 3000)).all())


def test_training_entry_points_default_to_the_card(tmp_path):
    """``init_train_state``, ``trained_binarizer``, ``serve.train_binarizer``,
    ``serve.bc_train_binarizer`` and the CLI's training and upgrade runs
    take the card by default and raise without one."""
    from repro_torch.core import losses as PLS
    from repro_torch.core import trainer as PTR
    from repro_torch.launch import binarizer_cache as PBC

    cfg = PTR.TrainConfig(binarizer=PB.BinarizerConfig(input_dim=16, code_dim=8, n_levels=2,
                                                       hidden_dim=8),
                          queue=PLS.QueueConfig(length=32, dim=8, top_k=4))
    docs = np.random.default_rng(0).normal(size=(64, 16)).astype(np.float32)
    old = PB.init_binarizer(cfg.binarizer, prng.key(0, "cpu"), "cpu")
    calls = {
        "init_train_state": lambda: PTR.init_train_state(cfg, prng.key(0, "cpu")),
        "trained_binarizer": lambda: PBC.trained_binarizer(docs, cfg, steps=1, batch=8,
                                                           cache_dir=str(tmp_path)),
        "train_binarizer": lambda: serve.train_binarizer(docs, cfg, steps=1, batch=8,
                                                         cache_dir=str(tmp_path)),
        "bc_train_binarizer": lambda: serve.bc_train_binarizer(old, docs, docs, cfg, steps=1,
                                                               batch=8),
    }
    if torch.cuda.is_available():
        assert calls["init_train_state"]().queue["buf"].device.type == "cuda"
        return
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    for extra in (["--steps", "1"], ["--replicas", "2", "--upgrade-after", "1"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--docs", "10", "--ckpt-cache", str(tmp_path), *extra])
    assert not list(tmp_path.iterdir())  # nothing trained or written


def _cli(args, cache):
    """The CLI on the CPU in a subprocess, on one intra-op thread (its
    training steps are thousands of small ops, which oversubscribed cores
    slow many times over)."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--docs", "2000",
           "--queries", "32", "--steps", "30", "--ckpt-cache", str(cache), *args]
    env = dict(_env(), OMP_NUM_THREADS="1")
    out = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_cli_trains_then_loads_the_cached_checkpoint(tmp_path):
    first = _cli([], tmp_path)
    assert "[train] binarizer 512 bits (16x compression), 30 steps" in first
    assert "[train] trained (" in first
    second = _cli([], tmp_path)
    assert "[train] loaded cached checkpoint (" in second
    digest = first.split("[train] trained (")[1].split(")")[0]
    assert f"loaded cached checkpoint ({digest})" in second
    assert [p.name for p in tmp_path.iterdir()] == [f"binarizer-{digest}.npz"]
    recall = [line for line in second.splitlines() if line.startswith("[serve] recall@10")]
    assert recall and "BEBR=" in recall[0]


def test_cli_runs_the_upgrade(tmp_path):
    out = _cli(["--replicas", "2", "--upgrade-after", "4", "--batch", "16"], tmp_path)
    assert "[upgrade] backbone drift + bc-training v2 binarizer (30 steps)" in out
    line = [ln for ln in out.splitlines() if ln.startswith("[upgrade] v1 -> v2 migration")]
    assert line and "final replica versions ['v2', 'v2']" in line[0], out
    assert "(zero results lost)" in out and "BEBR[v1=" in out


def test_cli_refuses_swap_and_upgrade_together(capsys):
    with pytest.raises(SystemExit):
        serve.main(["--swap-after", "2", "--upgrade-after", "2", "--device", "cpu"])
    assert "mutually exclusive" in capsys.readouterr().err


def test_cpu_only_when_asked():
    codes = np.random.default_rng(0).integers(0, 16, (50, 32)).astype(np.int8)
    index = FlatSDC.build(codes, 4, device="cpu")
    assert index.codes.device.type == "cpu"
    v, i = index.search(codes[:3], 5)
    assert i.device.type == "cpu" and (i[:, 0] >= 0).all()
    docs, queries, gt = PS.clustered_corpus_torch(0, 100, 4, 8, device="cpu")
    assert docs.shape == (100, 8) and queries.shape == (4, 8) and gt.shape == (4,)
    assert torch.allclose(docs.norm(dim=-1), torch.ones(100), atol=1e-5)


def test_dry_run_is_the_meta_device_entry_point(tmp_path):
    """The dry run needs no card: its cells' arguments are meta tensors,
    its step runs on them, and CUDA is never initialised."""
    code = (
        "import sys, torch\n"
        "from repro_torch.launch import dryrun\n"
        "from repro_torch.configs.registry import build_cell\n"
        "from repro_torch.launch.mesh import make_production_mesh\n"
        "cell = build_cell('mind', 'serve_p99', make_production_mesh(devices=['meta'] * 256))\n"
        "assert all(t.is_meta for t in cell.abstract_args[1].values())\n"
        f"dryrun.main(['--arch', 'mind', '--shape', 'serve_p99', '--out', {str(tmp_path / 'd.json')!r}])\n"
        "assert not torch.cuda.is_initialized()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "1/1 cells OK" in out.stdout

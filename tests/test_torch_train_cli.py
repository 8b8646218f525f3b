"""The port's training launcher (``python -m repro_torch.launch.train``) on
the CPU, for all ten archs (five LM, meshgraphnet, four recsys) at their
SMOKE configs:

  * 4 steps with a checkpoint every 2; a run killed after step 2 and
    resumed from its checkpoint repeats the unbroken run bit for bit
    (each step's loss, and every array of the step-4 checkpoint);
  * checkpoint interchange: the reference's ``(params, opt_state)``
    after one of its steps, saved by its ``train/checkpoint.py``,
    restores into the port's tree exactly and the port's launcher
    resumes from it; the port's next checkpoint restores into the
    reference's tree exactly, and the reference steps on from it;
  * a bfloat16 LM tree (the full configs' dtype) checkpointed by either
    package restores into the other's bit for bit;
  * the reference's log lines and the module entry point in a subprocess.
The ``gpu`` case runs the launcher on the card (resume bit-identical,
``dot_interact`` launched once a dlrm-rm2 step).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.registry import get_arch as ref_arch  # noqa: E402
from repro.train import checkpoint as RCK  # noqa: E402
from repro.train import optim as RO  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.launch import train as PTR  # noqa: E402
from repro_torch.train import checkpoint as PCK  # noqa: E402
from repro_torch.train import steps as PST  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["llama3-405b", "llama3.2-1b", "mistral-large-123b", "llama4-scout-17b-a16e",
         "grok-1-314b", "meshgraphnet", "dlrm-rm2", "two-tower-retrieval", "mind", "dien"]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: training steps are many small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(ckpt_dir, step):
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    return {f: np.load(os.path.join(path, f)) for f in sorted(os.listdir(path))
            if f.endswith(".npy")}


def _run(args, capsys):
    out = PTR.main(args)
    return out, capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_resume_repeats_the_unbroken_run(arch, tmp_path, capsys):
    base = ["--arch", arch, "--device", "cpu", "--ckpt-every", "2"]
    whole, text = _run(base + ["--steps", "4", "--ckpt-dir", str(tmp_path / "a")], capsys)
    assert "step 1: loss=" in text and "[ckpt] step 2" in text and "[ckpt] step 4" in text
    assert text.rstrip().endswith("done.")
    first, _ = _run(base + ["--steps", "2", "--ckpt-dir", str(tmp_path / "b")], capsys)
    resumed, text = _run(base + ["--steps", "4", "--ckpt-dir", str(tmp_path / "b"),
                                 "--resume"], capsys)
    assert "[resume] from step 2" in text and "step 3: loss=" in text
    assert sorted(resumed["losses"]) == [3, 4]
    for i in (1, 2):
        assert torch.equal(first["losses"][i], whole["losses"][i])
    for i in (3, 4):
        assert torch.equal(resumed["losses"][i], whole["losses"][i])
    a, b = _arrays(tmp_path / "a", 4), _arrays(tmp_path / "b", 4)
    assert list(a) == list(b)
    for f in a:
        np.testing.assert_array_equal(a[f], b[f])
    assert all(np.isfinite(float(v)) for v in whole["losses"].values())
    assert sorted(whole["grad_norms"]) == [1, 2, 3, 4]
    assert all(np.isfinite(float(v)) and float(v) > 0 for v in whole["grad_norms"].values())


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_interchange_with_the_reference(arch, tmp_path, capsys):
    from repro.data import synthetic as RS
    from repro.models import gnn, transformer
    from repro.models.recsys import dien, dlrm, mind, two_tower
    from repro.train import steps as RST

    entry = ref_arch(arch)
    cfg = entry.smoke_config
    # the reference launcher's batches: 16 rows of 128 tokens, a graph of
    # 256 nodes and 1,024 edges, 16 examples
    mod, batch_fn, step_fn = {
        "lm": (transformer, lambda i, b, c: RS.lm_batch(i, b, 128, c.vocab), RST.lm_train_step),
        "gnn": (gnn, lambda i, b, c: RS.gnn_batch(i, 256, 1024, c), RST.gnn_train_step),
        "dlrm-rm2": (dlrm, RS.dlrm_batch, RST.dlrm_train_step),
        "two-tower-retrieval": (two_tower, RS.tt_batch, RST.tt_train_step),
        "mind": (mind, RS.mind_batch, RST.mind_train_step),
        "dien": (dien, RS.dien_batch, RST.dien_train_step),
    }[arch if entry.family == "recsys" else entry.family]
    adam = RO.AdamConfig(lr=3e-4, clip_norm=1.0)
    step = jax.jit(step_fn(cfg, adam))
    params = mod.init_params(jax.random.PRNGKey(0), cfg)
    params, opt, _ = step(params, RO.adam_init(params), batch_fn(0, 16, cfg))
    ref_dir = str(tmp_path / "ckpt")
    RCK.save(ref_dir, 1, (params, opt))

    # the reference's checkpoint restores into the port's tree, exactly
    p_params, _, _ = PTR._build(arch, True, 16, "cpu")
    target = PST.train_state_tree(p_params, PST.init_opt_state(p_params))
    restored, at = PCK.restore(ref_dir, target)
    assert at == 1
    want = PCK.flatten_tree((jax.tree_util.tree_map(np.asarray, params),
                             jax.tree_util.tree_map(np.asarray, opt)))
    got = PCK.flatten_tree(restored)
    assert list(want) == list(got)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else np.asarray(got[k])
        np.testing.assert_array_equal(g, want[k])

    # the port's launcher resumes from it and checkpoints step 2 ...
    out, text = _run(["--arch", arch, "--device", "cpu", "--steps", "2", "--ckpt-every", "2",
                      "--ckpt-dir", ref_dir, "--resume"], capsys)
    assert "[resume] from step 1" in text and "[ckpt] step 2" in text
    # ... which the reference restores into its own tree, exactly, and steps on from
    (r_params, r_opt), at = RCK.restore(ref_dir, (params, opt))
    assert at == 2 and int(r_opt.step) == 2
    mine = PCK.flatten_tree(PST.train_state_tree(out["params"], out["opt_state"]))
    theirs = PCK.flatten_tree((r_params, r_opt))
    assert list(mine) == list(theirs)
    for k in mine:
        m = mine[k].detach().numpy() if isinstance(mine[k], torch.Tensor) else mine[k]
        np.testing.assert_array_equal(np.asarray(m), np.asarray(theirs[k]))
    _, _, metrics = step(r_params, r_opt, batch_fn(2, 16, cfg))
    assert np.isfinite(float(metrics["loss"]))


def test_bfloat16_lm_checkpoint_interchanges(tmp_path):
    """A bfloat16 LM tree and its Adam state (llama3.2-1b SMOKE at the full
    config's dtype): the reference's checkpoint restores into the port's
    tree bit for bit, as bfloat16 tensors, and the port's into the
    reference's."""
    import dataclasses

    import jax.numpy as jnp

    from repro.models import transformer as RT
    from repro_torch.models import transformer as PT

    rcfg = dataclasses.replace(ref_arch("llama3.2-1b").smoke_config, dtype=jnp.bfloat16)
    params = RT.init_params(jax.random.PRNGKey(3), rcfg)
    opt = RO.adam_init(params)
    opt = opt._replace(step=opt.step + 5, mu=jax.tree_util.tree_map(
        lambda p: p.astype(jnp.float32) * 0.5, params))
    RCK.save(str(tmp_path / "ref"), 5, (params, opt))
    from repro_torch.configs.registry import get_arch as port_arch

    pcfg = dataclasses.replace(port_arch("llama3.2-1b").smoke_config, dtype=torch.bfloat16)
    tree = PT.init_params(pcfg, prng.key(0, "cpu"), "cpu")
    restored, at = PCK.restore(str(tmp_path / "ref"),
                               PST.train_state_tree(tree, PST.init_opt_state(tree)))
    assert at == 5
    p_params, p_opt = PST.train_state_from_tree(restored)
    assert p_opt.step == 5
    want = PCK.flatten_tree(jax.tree_util.tree_map(np.asarray, params))
    for k, t in PCK.flatten_tree(p_params).items():
        assert t.dtype == torch.bfloat16, k
        np.testing.assert_array_equal(t.view(torch.int16).numpy(), want[k].view(np.int16))
    PCK.save(str(tmp_path / "port"), 6, PST.train_state_tree(p_params, p_opt._replace(step=6)))
    (r_params, r_opt), at = RCK.restore(str(tmp_path / "port"), (params, opt))
    assert at == 6 and int(r_opt.step) == 6
    for a, b in zip(jax.tree_util.tree_leaves((params, opt.mu, opt.nu)),
                    jax.tree_util.tree_leaves((r_params, r_opt.mu, r_opt.nu))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8), np.asarray(b).view(np.uint8))


def test_module_entry_point_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "dlrm-rm2", "--device",
           "cpu", "--steps", "4", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path / "ck")]
    out = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("step 1: loss=") and lines[-1] == "done."
    assert "[ckpt] step 4" in lines
    assert PCK.latest_step(str(tmp_path / "ck")) == 4


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_on_the_card(arch, tmp_path, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.dot_interact import kernel as PK

    base = ["--arch", arch, "--ckpt-every", "2"]
    before = PK.dot_interact.launches
    whole, _ = _run(base + ["--steps", "4", "--ckpt-dir", str(tmp_path / "a")], capsys)
    assert PK.dot_interact.launches - before == (4 if arch == "dlrm-rm2" else 0)
    _run(base + ["--steps", "2", "--ckpt-dir", str(tmp_path / "b")], capsys)
    resumed, text = _run(base + ["--steps", "4", "--ckpt-dir", str(tmp_path / "b"),
                                 "--resume"], capsys)
    assert "[resume] from step 2" in text
    for i in (3, 4):
        assert torch.equal(resumed["losses"][i], whole["losses"][i])
    for k, p in PCK.flatten_tree(whole["params"]).items():
        assert p.device.type == "cuda"
        assert torch.equal(p, PCK.flatten_tree(resumed["params"])[k]), k

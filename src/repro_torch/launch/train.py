"""Training launcher for the model zoo (ports ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --steps 100 --ckpt-dir build/ckpt [--resume] [--smoke|--full] [--device cpu]

Runs the arch's train step on one device (the card unless ``--device
cpu``), with:
  * synthetic batches that are a pure function of the step
    (``data/synthetic.py``), so a resumed run repeats the unbroken one;
  * periodic atomic checkpoints in the reference's layout and keys
    (``train/checkpoint.py``: the tree ``(params, AdamState)``), and resume
    from the newest valid one: a checkpoint either package writes
    restores into the other;
  * the reference's log lines: ``step N: loss=...``, ``[ckpt] step N``,
    ``[resume] from step N``, ``done.``.

Every reference arch id is ported: the LM family (a batch of ``--batch``
rows of ``LM_SEQ`` = 128 tokens), the GNN family (a graph of
``GNN_NODES`` = 256 nodes and ``GNN_EDGES`` = 1,024 edges a step,
whatever ``--batch``) and the recsys family (``--batch`` examples), as
the reference's launcher builds them. ``main`` returns the parameters,
the optimizer state and each step's loss and gradient norm (tensors on
the device, the loss read only at the log lines), for callers that check
a run.
"""

from __future__ import annotations

import argparse
import time

from repro_torch import prng
from repro_torch.configs.registry import get_arch
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optim, steps


ADAM = optim.AdamConfig(lr=3e-4, clip_norm=1.0)
LM_SEQ = 128
GNN_NODES, GNN_EDGES = 256, 1024


def zoo(arch_id: str):
    """(init_params(cfg, key, device), train step builder, batch fn(step,
    batch, cfg, device)) of an arch."""
    entry = get_arch(arch_id)
    if entry.family == "lm":
        from repro_torch.models import transformer

        return (transformer.init_params, steps.lm_train_step,
                lambda i, batch, cfg, dev: synthetic.lm_batch(i, batch, LM_SEQ, cfg.vocab, dev))
    if entry.family == "gnn":
        from repro_torch.models import gnn

        return (gnn.init_params, steps.gnn_train_step,
                lambda i, batch, cfg, dev: synthetic.gnn_batch(i, GNN_NODES, GNN_EDGES, cfg, dev))
    family = entry.config.name
    if "dlrm" in family:
        from repro_torch.models.recsys import dlrm

        return ((lambda cfg, gen, dev: dlrm.init_dlrm(cfg, gen, dev).tree()),
                steps.dlrm_train_step, synthetic.dlrm_batch)
    if "two-tower" in family:
        from repro_torch.models.recsys import two_tower

        return two_tower.init_params, steps.tt_train_step, synthetic.tt_batch
    if "mind" in family:
        from repro_torch.models.recsys import mind

        return mind.init_params, steps.mind_train_step, synthetic.mind_batch
    from repro_torch.models.recsys import dien

    return dien.init_params, steps.dien_train_step, synthetic.dien_batch


def _build(arch_id: str, smoke: bool, batch: int, device="cuda"):
    """(params, step_fn, batch_fn) for ``arch_id``: the reference's
    initialisation from ``prng.key(0)`` on ``device``, Adam at
    lr 3e-4 clipped at 1.0 (``ADAM``), batches of ``batch`` examples."""
    entry = get_arch(arch_id)
    cfg = entry.smoke_config if smoke else entry.config
    device = resolve_device(device)
    init, step_builder, batch_of = zoo(arch_id)
    params = init(cfg, prng.key(0, device), device)
    return params, step_builder(cfg, ADAM), lambda i: batch_of(i, batch, cfg, device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--device", default="cuda",
                    help="the card (default; raises without one) or cpu")
    args = ap.parse_args(argv)

    params, step_fn, batch_fn = _build(args.arch, args.smoke, args.batch, args.device)
    opt_state = steps.init_opt_state(params)
    start = 0
    if args.resume and args.ckpt_dir:
        latest = ckpt_lib.latest_step(args.ckpt_dir)
        if latest is not None:
            tree, start = ckpt_lib.restore(args.ckpt_dir,
                                           steps.train_state_tree(params, opt_state), latest)
            del params, opt_state
            params, opt_state = steps.train_state_from_tree(tree)
            print(f"[resume] from step {start}")

    losses, grad_norms = {}, {}
    t0 = time.time()
    for i in range(start, args.steps):
        batch = batch_fn(i)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses[i + 1], grad_norms[i + 1] = metrics["loss"], metrics["grad_norm"]
        if (i + 1) % 10 == 0 or i == start:
            loss = float(metrics["loss"])
            dt = time.time() - t0
            print(f"step {i+1}: loss={loss:.4f} ({dt:.1f}s)", flush=True)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            ckpt_lib.save(args.ckpt_dir, i + 1, steps.train_state_tree(params, opt_state))
            print(f"[ckpt] step {i+1}", flush=True)
    print("done.")
    return {"params": params, "opt_state": opt_state, "losses": losses,
            "grad_norms": grad_norms}


if __name__ == "__main__":
    main()

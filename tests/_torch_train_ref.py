"""The JAX reference launcher's seeded SMOKE trajectories, for the port's tests
and for ``chip_smoke.py`` (which runs without JAX).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_torch_train_ref.py

rewrites ``tests/_torch_train_ref.json``: for each of the ten arch ids,
the loss of each of ``STEPS`` steps of ``repro/launch/train.py`` (its
``_build`` at SMOKE, ``PRNGKey(0)``, batches of 16, the jitted step) and
a summary of every final parameter leaf (checkpoint key: shape, sum, sum
of squares and the first ``HEAD`` values of the flattened leaf). The
port's launcher, seeded alike (``prng.key(0)``), is held to these on the
CPU (tests/test_torch_seeded_train.py) and on the card (chip_smoke.py).
JAX is imported only to run the reference.
"""

from __future__ import annotations

import json
import os

import numpy as np

ARCHS = ["llama3-405b", "llama3.2-1b", "mistral-large-123b", "llama4-scout-17b-a16e",
         "grok-1-314b", "meshgraphnet", "dlrm-rm2", "two-tower-retrieval", "mind", "dien"]
STEPS, BATCH, HEAD = 5, 16, 8
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_train_ref.json")


def reference_run(arch: str, steps: int = STEPS):
    """(losses [steps] float, final parameters {checkpoint key: numpy array})
    of the reference launcher's loop for ``arch`` at SMOKE."""
    import jax

    from repro.launch import train as RT
    from repro.train import optim as RO
    from repro_torch.train.checkpoint import flatten_tree

    params, step_fn, batch_fn = RT._build(arch, True, BATCH)
    opt = RO.adam_init(params)
    step = jax.jit(step_fn)
    losses = []
    for i in range(steps):
        params, opt, metrics = step(params, opt, batch_fn(i))
        losses.append(float(metrics["loss"]))
    return losses, flatten_tree(jax.tree_util.tree_map(np.asarray, params))


def leaf_summary(a: np.ndarray) -> dict:
    a = np.asarray(a, np.float64)
    return {"shape": list(a.shape), "sum": float(a.sum()), "sq": float((a * a).sum()),
            "head": a.reshape(-1)[:HEAD].tolist()}


def load() -> dict:
    with open(PATH) as f:
        return json.load(f)


def main() -> None:
    out = {}
    for arch in ARCHS:
        losses, params = reference_run(arch)
        out[arch] = {"losses": losses,
                     "leaves": {k: leaf_summary(v) for k, v in params.items()}}
        print(arch, " ".join(f"{x:.6f}" for x in losses), flush=True)
    with open(PATH, "w") as f:
        json.dump({"steps": STEPS, "batch": BATCH, "archs": out}, f, indent=1)
        f.write("\n")
    print("wrote", PATH)


if __name__ == "__main__":
    main()

"""``run.py`` without a card: it exits with an error and prints no result."""

import os
import subprocess
import sys

from bench_port.tests._tiny import CHECKOUT


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "web-flat.q64-c8",
                          "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
                         cwd=CHECKOUT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_forbidden_modules_are_named_by_whole_top_level_names():
    sys.path.insert(0, str(CHECKOUT / "bench_port"))
    try:
        import run
    finally:
        sys.path.pop(0)
    assert run.loaded_forbidden(["repro_torch.index.flat", "numpy", "jaxtyping"]) == []
    assert run.loaded_forbidden(["repro.index.flat", "jax.numpy", "flax"]) == ["flax", "jax",
                                                                               "repro"]

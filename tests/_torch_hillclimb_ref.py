"""The JAX reference's hillclimb records (``repro/launch/hillclimb.py``'s
``_measure``) of a few variants, dumped to JSON by one subprocess with 512
forced host devices (the device count locks at JAX's first use, so the
test process stays single-device). Used by ``tests/test_torch_hillclimb.py``.

Each record is the reference's ``_measure`` output without ``compile_s``,
keyed ``cell|variant|mesh``.
"""

import json
import os
import subprocess
import sys
import textwrap

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

_SCRIPT = r"""
import json, sys
from repro.launch import hillclimb as hc
from repro.launch.mesh import make_production_mesh

out_path, wanted = sys.argv[1], json.loads(sys.argv[2])
out = {}
for cell, variant, multi_pod in wanted:
    mesh = make_production_mesh(multi_pod=multi_pod)
    fn, shardings, abstract = hc.VARIANTS[cell][variant](mesh)
    res = hc._measure(fn, shardings, abstract, mesh, mesh.devices.size)
    res.pop("compile_s")
    out[f"{cell}|{variant}|{'2x16x16' if multi_pod else '16x16'}"] = res
out["variants"] = {c: sorted(v) for c, v in hc.VARIANTS.items()}
with open(out_path, "w") as f:
    json.dump(out, f)
"""


def run_reference(tmp_path, wanted) -> dict:
    """The reference's records of ``wanted``, a list of (cell, variant,
    multi_pod), plus ``variants``: each cell's variant names."""
    out = os.path.join(str(tmp_path), "hillclimb_ref.json")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_SCRIPT), out,
                           json.dumps(wanted)],
                          capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out) as f:
        return json.load(f)

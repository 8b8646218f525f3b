"""The slice as a whole: ``python -m repro_torch.launch.train --arch A --steps 5``
against the reference launcher, for all ten arch ids at SMOKE on the CPU.

Both runs start from seed 0 (``prng.key(0)`` / ``PRNGKey(0)``: the same
initial trees and the same batches, bit for bit) and take five Adam steps
(lr 3e-4, clip 1.0). Every SMOKE config is float32. Held: each step's
loss within ``LOSS_RTOL`` of the reference's and every final parameter
within ``PARAM_ATOL`` of it. Measured on this CPU: losses within 4.6e-7
relative, parameters within 2.3e-5 (llama3-405b's SMOKE config the
widest). Both launchers run in this process, the port's through its
``main`` as ``tests/test_torch_train_cli.py`` runs it.

The committed reference trajectories (``tests/_torch_train_ref.json``,
which ``chip_smoke.py`` holds the card's runs to) are checked against
the reference run here, so a change in the reference shows.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_train_ref as REF  # noqa: E402

from repro_torch.launch import train as PTR  # noqa: E402
from repro_torch.train import checkpoint as PCK  # noqa: E402
from repro_torch.train import steps as PST  # noqa: E402

LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def committed():
    return REF.load()


@pytest.mark.parametrize("arch", REF.ARCHS)
def test_five_step_trajectory_equals_the_reference(arch, committed, capsys):
    want_losses, want_params = REF.reference_run(arch)
    out = PTR.main(["--arch", arch, "--device", "cpu", "--steps", str(REF.STEPS),
                    "--batch", str(REF.BATCH)])
    assert capsys.readouterr().out.rstrip().endswith("done.")
    got_losses = [float(out["losses"][i]) for i in range(1, REF.STEPS + 1)]
    np.testing.assert_allclose(got_losses, want_losses, rtol=LOSS_RTOL, atol=0)
    got = PCK.flatten_tree(PST.train_state_tree(out["params"], out["opt_state"])[0])
    assert list(got) == list(want_params)
    worst = 0.0
    for k, w in want_params.items():
        g = got[k].detach().to(torch.float64).numpy()
        assert g.shape == w.shape and got[k].dtype == torch.float32, k
        worst = max(worst, float(np.abs(g - w).max()))
    print(f"{arch}: losses within {max(abs(a / b - 1) for a, b in zip(got_losses, want_losses)):.2e}"
          f" relative, parameters within {worst:.2e}")
    assert worst <= PARAM_ATOL
    # the committed trajectory is this reference run's
    ref = committed["archs"][arch]
    np.testing.assert_allclose(ref["losses"], want_losses, rtol=1e-6)
    assert list(ref["leaves"]) == list(want_params)
    for k, w in want_params.items():
        s = REF.leaf_summary(w)
        assert s["shape"] == ref["leaves"][k]["shape"]
        np.testing.assert_allclose(ref["leaves"][k]["head"], s["head"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(ref["leaves"][k]["sum"], s["sum"], atol=1e-6 * w.size)

"""Public name of the DLRM dot interaction (ports
``repro/kernels/dot_interact/ops.py::dot_interaction``).

The reference's wrapper pads B to its blocks and has ``interpret`` and
``use_kernel=False`` options for where Pallas cannot run. The port's
kernel masks the ragged edge of B itself and a CPU tensor takes its plain
version, so none of those options carries over: ``dot_interaction`` is
``kernel.dot_interact``. A caller that wants the Gram-matrix form passes
``ref.dot_interact_ref`` as ``DLRM.forward(interact_fn=...)``.
"""

from repro_torch.kernels.dot_interact.kernel import dot_interact as dot_interaction

__all__ = ["dot_interaction"]

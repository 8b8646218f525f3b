"""The dry-run cells of the PyTorch port (``repro_torch/configs/cells.py``,
``registry.build_cell``/``all_cells``) against the JAX reference's
(``repro/configs/cells.py``).

The reference builds all 40 (arch x shape) cells on both production meshes
once, in one subprocess with 512 forced host devices
(``tests/_torch_cells_ref.py``). For each of the 80 (cell, mesh) pairs the
port's cell, on ``make_production_mesh(devices=["meta"] * n)``, has the
reference's arch, kind and ``meta`` (key for key), its arguments' shapes
and dtypes, and its ``in_shardings`` specs, leaf by leaf. Two leaves map
by kind, not value: Adam's ``step`` and the decode cache's ``length`` are
host ints (0) in the port and int32 scalars in the reference; and the
port's Adam moments, dictionaries keyed by ``checkpoint.flatten_tree``,
are nested back into the parameters' layout before the comparison.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_cells_ref import run_reference  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.checkpoint import flatten_tree, unflatten_tree  # noqa: E402

torch.set_num_threads(1)
MESHES = {"16x16": False, "2x16x16": True}
HOST_INTS = (".step", "['length']")  # the port's host ints: int32 scalars in the reference
PAIRS = [(a, s, m) for a, s in registry.all_cells() for m in MESHES]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(tmp_path_factory.mktemp("cells"), ["cells"])["cells"]


def _nested(args, params):
    """``args`` with an ``AdamState``'s flat moments nested as ``params``."""
    return tuple(optim.AdamState(a.step, unflatten_tree(params, a.mu.values()),
                                 unflatten_tree(params, a.nu.values()))
                 if isinstance(a, optim.AdamState) else a for a in args)


def _spec(s):
    return [list(e) if isinstance(e, tuple) else e for e in s.spec]


def test_all_cells_are_the_reference_list():
    assert len(PAIRS) == 80 and len(set(registry.all_cells())) == 40
    assert {e.arch_id for e in registry.REGISTRY.values()} == {a for a, _ in
                                                               registry.all_cells()}


@pytest.mark.parametrize("arch,shape,mesh_name", PAIRS)
def test_cell_equals_the_reference(ref, arch, shape, mesh_name):
    want = ref[f"{arch}|{shape}|{mesh_name}"]
    multi = MESHES[mesh_name]
    mesh = make_production_mesh(multi_pod=multi, devices=["meta"] * (512 if multi else 256))
    cell = registry.build_cell(arch, shape, mesh)
    assert (cell.arch, cell.shape, cell.kind, cell.meta) == (want["arch"], shape, want["kind"],
                                                              want["meta"])
    params = cell.abstract_args[0]
    args = flatten_tree(_nested(cell.abstract_args, params))
    shardings = flatten_tree(_nested(cell.in_shardings, params))
    assert list(args) == list(want["args"]) and list(shardings) == list(want["shardings"])
    for key, leaf in args.items():
        if isinstance(leaf, torch.Tensor):
            assert leaf.is_meta, key
            got = [list(leaf.shape), str(leaf.dtype).removeprefix("torch.")]
        else:
            assert key.endswith(HOST_INTS) and leaf == 0, key
            got = [[], "int32"]
        assert got == want["args"][key], key
    for key, s in shardings.items():
        assert s.mesh is mesh and _spec(s) == want["shardings"][key], key


def test_build_cell_refuses_unknown_shapes():
    mesh = make_production_mesh(devices=["meta"] * 256)
    with pytest.raises(KeyError, match="has shapes"):
        registry.build_cell("mind", "train_4k", mesh)
    with pytest.raises(KeyError, match="unknown arch"):
        registry.build_cell("bert", "train_4k", mesh)

"""Adam, global-norm clipping and the schedules of the PyTorch port against
the JAX reference (``repro/train/optim.py``).

The same gradients go through both for several steps. Tolerances: rtol
1e-6 on the parameters and moments (float32 rounding of a few
elementwise ops; ``jnp.sqrt`` and ``torch.sqrt`` may round apart by an
ulp), 1e-6 on the global norm (sums in other orders), 1e-6 absolute on
the schedules (``np.cos`` against ``jnp.cos`` in float32).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.train import optim as RO  # noqa: E402
from repro_torch.train import optim as PO  # noqa: E402

RTOL = 1e-6


def _trees(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2)}
    return {k: (scale * rng.normal(size=s)).astype(np.float32) for k, s in shapes.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def test_global_norm_and_clip_agree():
    g = _trees(0, scale=10.0)
    assert float(PO.global_norm(_t(g))) == pytest.approx(float(RO.global_norm(_j(g))), rel=RTOL)
    for max_norm in (1.0, 1e6):
        ref = RO.clip_by_global_norm(_j(g), max_norm)
        got = PO.clip_by_global_norm(_t(g), max_norm)
        for k in g:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=RTOL)
    clipped = PO.clip_by_global_norm(_t(g), 1.0)
    assert float(PO.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)


@pytest.mark.parametrize("cfg_kw", [
    dict(lr=0.1, clip_norm=0.0),
    dict(lr=2e-3, clip_norm=5.0),
    dict(lr=0.02, clip_norm=1.0, weight_decay=0.01),
    dict(lr=2e-3, clip_norm=5.0, schedule="cosine"),
])
def test_adam_update_agrees_over_steps(cfg_kw):
    kw = dict(cfg_kw)
    rsched = psched = None
    if kw.pop("schedule", None) == "cosine":
        rsched = RO.cosine_schedule(6, warmup=2, floor=0.05)
        psched = PO.cosine_schedule(6, warmup=2, floor=0.05)
    rcfg = RO.AdamConfig(schedule=rsched, **kw)
    pcfg = PO.AdamConfig(schedule=psched, **kw)
    params = _trees(1)
    rp, pp = _j(params), _t(params)
    rs, ps = RO.adam_init(rp), PO.adam_init(pp)
    assert ps.step == 0 and all(float(v.abs().sum()) == 0 for v in ps.mu.values())
    for step in range(6):
        g = _trees(10 + step, scale=3.0)
        rp, rs = RO.adam_update(_j(g), rs, rp, rcfg)
        pp, ps = PO.adam_update(_t(g), ps, pp, pcfg)
        assert ps.step == int(rs.step)
        for k in params:
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(rp[k]), rtol=RTOL, atol=1e-7)
            np.testing.assert_allclose(ps.mu[k].numpy(), np.asarray(rs.mu[k]), rtol=RTOL)
            np.testing.assert_allclose(ps.nu[k].numpy(), np.asarray(rs.nu[k]), rtol=RTOL)


def test_adam_matches_the_closed_form():
    """The reference test's numpy Adam, two steps."""
    cfg = PO.AdamConfig(lr=0.1, b1=0.9, b2=0.999, eps=1e-8, clip_norm=0.0)
    p = {"w": torch.tensor([1.0, -2.0, 3.0])}
    g = {"w": torch.tensor([0.5, -0.5, 1.0])}
    st = PO.adam_init(p)
    p1, st1 = PO.adam_update(g, st, p, cfg)
    p2, _ = PO.adam_update(g, st1, p1, cfg)
    w, m, v = np.array([1.0, -2.0, 3.0]), np.zeros(3), np.zeros(3)
    gn = np.array([0.5, -0.5, 1.0])
    for t in (1, 2):
        m = 0.9 * m + 0.1 * gn
        v = 0.999 * v + 0.001 * gn**2
        w = w - 0.1 * (m / (1 - 0.9**t)) / (np.sqrt(v / (1 - 0.999**t)) + 1e-8)
    np.testing.assert_allclose(p2["w"].numpy(), w, rtol=1e-5)


def test_schedules_agree():
    for total, warmup, floor in ((100, 10, 0.0), (300, 30, 0.05), (7, 0, 0.2)):
        r, p = RO.cosine_schedule(total, warmup, floor), PO.cosine_schedule(total, warmup, floor)
        for step in (0, 1, warmup, warmup + 1, total // 2, total - 1, total, total + 5):
            got = p(step)
            assert isinstance(got, np.float32)
            assert float(got) == pytest.approx(float(r(jnp.asarray(step))), abs=1e-6)
    assert float(PO.constant_schedule()(3)) == float(RO.constant_schedule()(jnp.asarray(3))) == 1.0
    s = PO.cosine_schedule(100, warmup=10)
    assert float(s(0)) == 0.0 and float(s(10)) == pytest.approx(1.0)
    assert float(s(100)) == pytest.approx(0.0, abs=1e-6)


def test_adam_converges_on_quadratic():
    cfg = PO.AdamConfig(lr=0.1, clip_norm=5.0)
    x = torch.tensor([5.0, -3.0], requires_grad=True)
    target = torch.tensor([1.0, 2.0])
    st = PO.adam_init({"x": x})
    for _ in range(300):
        (g,) = torch.autograd.grad(torch.sum((x - target) ** 2), [x])
        new, st = PO.adam_update({"x": g}, st, {"x": x}, cfg)
        with torch.no_grad():
            x.copy_(new["x"])
    np.testing.assert_allclose(x.detach().numpy(), [1.0, 2.0], atol=1e-2)

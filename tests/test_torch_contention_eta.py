"""The port's contention + ETA pass against the JAX package, on the CPU.

The same lanes, made with numpy from a seed, go through

* ``ContentionModel.rates_seq`` (the engines' reference),
* the JAX module ``repro.kernels.contention_eta`` (its jitted float64
  ``rates``/``fused`` and its Pallas ``fused_pallas`` in interpret mode),
* the port's ``repro_torch.kernels.contention_eta`` (on the CPU: the plain
  versions of the Hopper kernel).

The float64 results must agree bit for bit. ``rates_seq`` sums with the
builtin ``sum()``, which since CPython 3.12 compensates (Neumaier), while
the JAX kernels add left to right; so the port follows ``sum()`` by default
(bit-identical to ``rates_seq``) and adds left to right with
``compensated=False`` (bit-identical to the JAX kernels). The float32
variant must agree with ``fused_pallas`` within 2e-6 relative: both add
left to right in float32, but XLA may contract or reorder an operation,
which moves a result by an ulp or two.

This jax has no ``jax.experimental.enable_x64``, which the JAX module
imports, so the module reports itself unavailable here. The tests load a
private copy of it with that name pointed at ``jax.enable_x64``; the
package's own module is left as it is.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.experimental  # noqa: E402

from repro.runtime.contention import ContentionModel  # noqa: E402
from repro.runtime.contention import DeviceModel as JaxDeviceModel  # noqa: E402

from repro_torch.kernels import contention_eta as ce  # noqa: E402
from repro_torch.runtime.contention import DeviceModel  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src" / "repro" / "kernels"
F32_RTOL = 2e-6
MS = [1, 2, 15, 16, 17, 129, 2048]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps these tests
    from taking every core from wall-clock tests in other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jce():
    """A private copy of the JAX module, loaded where ``enable_x64`` can be
    imported from ``jax.experimental``."""
    had = hasattr(jax.experimental, "enable_x64")
    if not had:
        jax.experimental.enable_x64 = jax.enable_x64
    try:
        spec = importlib.util.spec_from_file_location(
            "_jax_contention_eta_copy", SRC / "contention_eta.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        if not had:
            del jax.experimental.enable_x64
    assert mod.available()
    return mod


# regimes: (device fields, u range, ns range, mf range); each fires a
# different set of the three branches once a group has a few lanes
REGIMES = {
    "light": (dict(n_units=1e6, l2_pressure=0.0), (0.2, 0.4), (30.0, 40.0),
              (0.01, 0.02)),
    "capped": (dict(n_units=68.0), (0.2, 4.0), (5.0, 40.0), (0.05, 0.9)),
    "hetero": (dict(n_units=40.0, bubble=0.17, l2_pressure=0.013),
               (0.2, 4.0), (5.0, 40.0), (0.05, 0.9)),
}


def lanes(m, regime, seed=0):
    fields, ur, nr, fr = REGIMES[regime]
    rng = np.random.default_rng(1000 * seed + m)
    dev = dict(n_units=68.0, bubble=0.18, l2_pressure=0.09)
    dev.update(fields)
    cols = [rng.uniform(*r, m).tolist() for r in (ur, nr, fr, (0.1, 8.0))]
    return dev, cols


def branches(dev, u, ns, mf):
    """Which of the three branches of the pass fire on these lanes."""
    m = len(u)
    total = sum(u)
    scale = dev["n_units"] / total if total > dev["n_units"] else 1.0
    gain = (1.0 - dev["bubble"] / m) / (1.0 - dev["bubble"])
    s = [min(1.0, min(a * scale, n) / n * gain) for a, n in zip(u, ns)]
    used = sum(a * n for a, n in zip(s, ns))
    budget = dev["n_units"] * (1.0 + dev["bubble"] * (1.0 - 1.0 / m))
    if used > budget:
        s = [a * (budget / used) for a in s]
    phi = sum(f * a for f, a in zip(mf, s)) * (
        1.0 + dev["l2_pressure"] * max(m - 1, 0))
    return (total > dev["n_units"], used > budget, phi > 1.0)


def test_the_cases_fire_each_branch_and_leave_it():
    seen = [set(), set(), set()]
    for regime in REGIMES:
        for m in MS:
            dev, (u, ns, mf, _) = lanes(m, regime)
            for i, fired in enumerate(branches(dev, u, ns, mf)):
                seen[i].add(fired)
    assert seen == [{True, False}] * 3


@pytest.mark.parametrize("regime", sorted(REGIMES))
@pytest.mark.parametrize("m", MS)
def test_f64_rates_and_fused_bit_exact(jce, m, regime):
    dev, (u, ns, mf, rem) = lanes(m, regime)
    cm = ContentionModel(JaxDeviceModel(**dev))
    ours_dm = DeviceModel(**dev)
    ref = cm.rates_seq(list(u), list(ns), list(mf))
    # the port's default follows rates_seq (this interpreter's sum())
    assert ce.rates(ours_dm, u, ns, mf, device="cpu") == ref
    rate, eta = ce.fused(ours_dm, 123.456, u, ns, mf, rem, device="cpu")
    want = [r if r > 1e-6 else 1e-6 for r in ref]
    assert rate.tolist() == want
    assert eta.tolist() == [123.456 + a / b for a, b in zip(rem, want)]
    # left-to-right sums: the JAX f64 kernels' bits
    assert ce.rates(ours_dm, u, ns, mf, device="cpu",
                    compensated=False) == jce.rates(cm.device, u, ns, mf)
    got = ce.fused(ours_dm, 123.456, u, ns, mf, rem, device="cpu",
                   compensated=False)
    for a, b in zip(got, jce.fused(cm.device, 123.456, u, ns, mf, rem)):
        assert np.array_equal(a, b)


def test_builtin_sum_compensates_on_this_interpreter(jce):
    """Why the two sums exist: a 129-lane group already tells them apart
    (on CPython 3.12 and later)."""
    dev, (u, ns, mf, _) = lanes(129, "capped")
    cm = ContentionModel(JaxDeviceModel(**dev))
    plain = ce.rates(DeviceModel(**dev), u, ns, mf, device="cpu",
                     compensated=False)
    assert ce.SUM_IS_COMPENSATED == (sum([0.1] * 10) == 1.0)
    if ce.SUM_IS_COMPENSATED:
        assert plain != cm.rates_seq(list(u), list(ns), list(mf))
        assert jce.rates(cm.device, u, ns, mf) == plain


@pytest.mark.parametrize("regime", sorted(REGIMES))
@pytest.mark.parametrize("m", MS)
def test_f32_matches_fused_pallas(jce, m, regime):
    dev, (u, ns, mf, rem) = lanes(m, regime)
    jdm = JaxDeviceModel(**dev)
    want = jce.fused_pallas(jdm, 7.25, u, ns, mf, rem, interpret=True)
    got = ce.fused_f32(DeviceModel(**dev), 7.25, u, ns, mf, rem,
                       device="cpu")
    for a, b in zip(got, want):
        assert a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=F32_RTOL, atol=0)


def test_counts_and_empty_groups():
    ce.fused.counts.reset()
    ce.fused_f32.counts.reset()
    dm = DeviceModel()
    assert ce.rates(dm, [], [], [], device="cpu") == []
    assert all(a.size == 0 for a in ce.fused(dm, 0.0, [], [], [], [],
                                             device="cpu"))
    ce.rates(dm, [1.0], [2.0], [0.5], device="cpu")
    ce.fused_f32(dm, 0.0, [1.0], [2.0], [0.5], [1.0], device="cpu")
    assert ce.fused.counts.plain_calls == 1
    assert ce.fused_f32.counts.plain_calls == 1
    assert ce.fused.counts.launches == ce.fused_f32.counts.launches == 0
    assert ce.rates.counts is ce.fused.counts


def test_hetero_device_model_fields_reach_the_pass(jce):
    """A second device model must give its own numbers (no constant is
    baked into the pass)."""
    dev, (u, ns, mf, _) = lanes(33, "hetero")
    base = dict(dev, n_units=68.0, bubble=0.18, l2_pressure=0.09)
    a = ce.rates(DeviceModel(**dev), u, ns, mf, device="cpu")
    b = ce.rates(DeviceModel(**base), u, ns, mf, device="cpu")
    assert a != b
    cm = ContentionModel(dataclasses.replace(JaxDeviceModel(), **dev))
    assert a == cm.rates_seq(list(u), list(ns), list(mf))

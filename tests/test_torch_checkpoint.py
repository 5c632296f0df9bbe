"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's.

The port writes scheduler state with its own MessagePack codec and
parameter trees without JAX's tree utilities; both must give the
reference's files. Held here:

- the codec gives ``msgpack.packb``'s bytes and ``msgpack.unpackb``'s
  objects, over hypothesis-drawn trees and at the edge of every int and
  length encoding;
- the same seeded scenario (a fault and a reconfigure) run to the same
  point in both packages saves byte-identical scheduler-state files, and
  each package, loading the other's file, reproduces the other's placement;
- parameter files cross in both directions: leaf bytes (bf16 as 16-bit
  words) and ``manifest.json`` identical, a reduced smollm-135m and a
  reduced ResNet18 (through ``cnn_params_from_jax``) equal to
  ``params_from_jax`` of the same tree;
- twins of the reference's checkpoint tests (tests/test_system.py,
  tests/test_reconfigure.py, tests/test_chaos.py) on the port.
"""
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
msgpack = pytest.importorskip("msgpack")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.api as ref_api  # noqa: E402
import repro.checkpoint as ref_ckpt  # noqa: E402
import repro_torch.api as api  # noqa: E402
import repro_torch.checkpoint as ckpt  # noqa: E402
from repro.configs import get_reduced as ref_get_reduced  # noqa: E402
from repro.core.scheduler import DarisScheduler as RefScheduler  # noqa: E402
from repro.core.scheduler import SchedulerConfig as RefSchedCfg  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.serving import profiles as ref_profiles  # noqa: E402
from repro.serving import requests as ref_requests  # noqa: E402
from repro_torch.chaos import ChaosPlan, ChaosState  # noqa: E402
from repro_torch.checkpoint._msgpack import packb, unpackb  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core.scheduler import (DarisScheduler,  # noqa: E402
                                        SchedulerConfig)
from repro_torch.models import (build_model, cnn_params_from_jax,  # noqa: E402
                                params_from_jax)
from repro_torch.serving import profiles as port_profiles  # noqa: E402
from repro_torch.serving import requests as port_requests  # noqa: E402
from repro_torch.serving.profiles import device  # noqa: E402
from repro_torch.serving.requests import table2_taskset  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ codec
def _same_as_msgpack(obj):
    want = msgpack.packb(obj)
    got = packb(obj)
    assert got == want
    assert repr(unpackb(got)) == repr(msgpack.unpackb(want))
    assert packb(unpackb(got)) == got


_scalars = (st.none() | st.booleans()
            | st.integers(min_value=-2 ** 63, max_value=2 ** 64 - 1)
            | st.floats(allow_nan=True, allow_infinity=True)
            | st.text(max_size=40))
_trees = st.recursive(
    _scalars,
    lambda inner: (st.lists(inner, max_size=20)
                   | st.lists(inner, max_size=20).map(tuple)
                   | st.dictionaries(st.text(max_size=8), inner,
                                     max_size=20)),
    max_leaves=60)


@settings(max_examples=300, deadline=None, derandomize=True)
@given(_trees)
def test_codec_is_msgpack_over_drawn_trees(obj):
    _same_as_msgpack(obj)


_INT_EDGES = [0, 1, 127, 128, 255, 256, 2 ** 16 - 1, 2 ** 16, 2 ** 32 - 1,
              2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129, -2 ** 15,
              -2 ** 15 - 1, -2 ** 31, -2 ** 31 - 1, -2 ** 63]


@pytest.mark.parametrize("x", _INT_EDGES)
def test_codec_int_encodings_are_msgpack_s(x):
    _same_as_msgpack(x)
    _same_as_msgpack(float(x))


@pytest.mark.parametrize("n", [0, 15, 16, 31, 32, 255, 256, 2 ** 16 - 1,
                               2 ** 16])
def test_codec_length_encodings_are_msgpack_s(n):
    _same_as_msgpack("x" * n)
    _same_as_msgpack("é" * (n // 2))          # lengths count utf-8 bytes
    _same_as_msgpack(list(range(n)))
    _same_as_msgpack(tuple(range(n)))
    _same_as_msgpack({f"k{i}": i for i in range(n)})


def test_codec_subclasses_and_refusals():
    # numpy's float64 is a float, bool is checked before int: as msgpack
    _same_as_msgpack([np.float64(2.5), True, False, -0.0, math.inf])
    for bad in (np.int64(3), {1, 2}, b"raw", object()):
        with pytest.raises(TypeError):
            packb(bad)
    with pytest.raises(OverflowError):
        packb(2 ** 64)
    with pytest.raises(ValueError, match="strict_map_key"):
        unpackb(msgpack.packb({1: 2}))
    with pytest.raises(ValueError, match="extra data"):
        unpackb(msgpack.packb(1) + b"\x00")
    with pytest.raises(ValueError, match="ends early"):
        unpackb(msgpack.packb("abc")[:-1])


# ----------------------------------------------- scheduler state, twins
def _elastic(m, horizon=2500.0, **hooks):
    """tests/test_reconfigure.py's ``_elastic_server`` in package ``m``
    (``ref_api`` or ``api``)."""
    requests, profiles = ((ref_requests, ref_profiles) if m is ref_api
                          else (port_requests, port_profiles))
    cfg = (m.ServerConfig.sim().tasks(requests.table2_taskset("resnet18"))
           .contexts(6).oversubscribe(6.0).device(profiles.device())
           .horizon_ms(horizon).seed(0))
    for name, args in hooks.items():
        getattr(cfg, name)(*args[0], **args[1])
    return cfg.build()


FAULT_AND_RECONFIGURE = dict(
    fail_context_at=((0, 700.0), {}),
    reconfigure_at=((1600.0,), dict(n_contexts=4, oversubscription=3.0)))


def _sched(nc=4, os_=4.0, ns=1, **kw):
    return DarisScheduler(
        table2_taskset("resnet18"),
        SchedulerConfig(n_contexts=nc, n_streams=ns, oversubscription=os_,
                        **kw), device())


def _ref_sched(nc=4, os_=4.0, ns=1, **kw):
    return RefScheduler(
        ref_requests.table2_taskset("resnet18"),
        RefSchedCfg(n_contexts=nc, n_streams=ns, oversubscription=os_,
                    **kw), ref_profiles.device())


def assert_same_placement(a, b):
    """Everything a checkpoint restores, and the lane topology it
    implies, equal between schedulers ``a`` and ``b``."""
    assert b.migrations == a.migrations
    assert len(b.contexts) == len(a.contexts)
    for ca, cb in zip(a.contexts, b.contexts):
        assert (ca.index, ca.alive, ca.n_streams) == \
            (cb.index, cb.alive, cb.n_streams)
        assert ca.units == cb.units
    for ta, tb in zip(a.tasks, b.tasks):
        assert (ta.name, ta.ctx, ta.fixed_ctx) == \
            (tb.name, tb.ctx, tb.fixed_ctx)
        assert ta.mret.task_mret() == tb.mret.task_mret()
        for sa, sb in zip(ta.mret.stages, tb.mret.stages):
            assert list(sa.window) == list(sb.window)
    assert sorted(b.lanes) == sorted(a.lanes)
    live_lanes = {ln[0] for ln in b.free_lanes()}
    assert live_lanes == {c.index for c in b.contexts if c.alive}
    assert (b.cfg.n_contexts, b.cfg.n_streams, b.cfg.oversubscription) == \
        (a.cfg.n_contexts, a.cfg.n_streams, a.cfg.oversubscription)


def test_checkpoint_roundtrip_through_fault_and_reconfigure(tmp_path):
    """Twin of test_reconfigure.py's test of the same name."""
    srv = _elastic(api, **FAULT_AND_RECONFIGURE)
    srv.run()
    a = srv.scheduler
    assert a.migrations > 0
    path = str(tmp_path / "sched.msgpack")
    ckpt.save_scheduler_state(a, path)
    b = _sched(nc=6, os_=6.0)
    ckpt.load_scheduler_state(b, path)
    assert_same_placement(a, b)


def test_both_packages_write_the_same_file_and_read_each_other_s(tmp_path):
    """The same seeded scenario in both packages, saved at the same point:
    byte-identical files; each package's scheduler restored from the other
    package's file places work as the other's did."""
    ref_srv = _elastic(ref_api, **FAULT_AND_RECONFIGURE)
    port_srv = _elastic(api, **FAULT_AND_RECONFIGURE)
    ref_srv.run()
    port_srv.run()
    ref_path = ref_srv.save_state(str(tmp_path / "ref.msgpack"))
    port_path = port_srv.save_state(str(tmp_path / "port.msgpack"))
    blob = open(port_path, "rb").read()
    assert blob == open(ref_path, "rb").read()
    assert msgpack.unpackb(blob) == unpackb(blob)

    port_from_ref = _sched(nc=6, os_=6.0)
    ckpt.load_scheduler_state(port_from_ref, ref_path)
    assert_same_placement(ref_srv.scheduler, port_from_ref)
    ref_from_port = _ref_sched(nc=6, os_=6.0)
    ref_ckpt.load_scheduler_state(ref_from_port, port_path)
    assert_same_placement(port_srv.scheduler, ref_from_port)


def test_restored_servers_run_alike_in_both_packages(tmp_path):
    """A server of each package restored from the same file (the cold
    run's learned state) serves the next run identically: decision logs
    and response times equal."""
    cold = _elastic(api, horizon=800.0)
    cold.run()
    path = cold.save_state(str(tmp_path / "warm.msgpack"))
    runs = []
    for m in (ref_api, api):
        srv = _elastic(m, horizon=800.0)
        srv.load_state(path)
        metrics = srv.run()
        runs.append(([x.hex() for p in sorted(metrics.response_ms)
                      for x in metrics.response_ms[p]],
                     metrics.completed, metrics.missed))
    assert runs[0] == runs[1]
    assert sum(runs[1][1].values()) > 0


def test_server_save_load_state(tmp_path):
    """Twin of test_reconfigure.py's test of the same name."""
    srv = _elastic(api, horizon=1500.0,
                   reconfigure_at=((800.0,), dict(n_contexts=3)))
    srv.run()
    path = str(tmp_path / "srv.msgpack")
    srv.save_state(path)
    srv2 = (api.ServerConfig.sim().tasks(table2_taskset("resnet18"))
            .contexts(6).oversubscribe(6.0).device(device())
            .horizon_ms(1500.0).seed(0).build())
    srv2.load_state(path)
    for ta, tb in zip(srv.scheduler.tasks, srv2.scheduler.tasks):
        assert ta.ctx == tb.ctx
    assert srv2.scheduler.migrations == srv.scheduler.migrations


def test_load_scheduler_state_raises_on_stage_count_mismatch(tmp_path):
    """Twin of test_reconfigure.py's test: the message is the
    reference's."""
    path = str(tmp_path / "s.msgpack")
    ckpt.save_scheduler_state(_sched(), path)
    errs = []
    for load, b in ((ckpt.load_scheduler_state, DarisScheduler(
            table2_taskset("resnet18"),
            SchedulerConfig(n_contexts=4, no_staging=True), device())),
                    (ref_ckpt.load_scheduler_state, RefScheduler(
            ref_requests.table2_taskset("resnet18"),
            RefSchedCfg(n_contexts=4, no_staging=True),
            ref_profiles.device()))):
        with pytest.raises(ValueError, match="shape mismatch") as ei:
            load(b, path)
        errs.append(str(ei.value))
    assert errs[0] == errs[1]


def test_load_scheduler_state_raises_on_stream_count_mismatch(tmp_path):
    """Twin of test_reconfigure.py's test: a constructor-built context's
    lane table can't be resized at restore."""
    path = str(tmp_path / "s.msgpack")
    ckpt.save_scheduler_state(_sched(nc=4, ns=2), path)
    errs = []
    for load, b in ((ckpt.load_scheduler_state, _sched(nc=4, ns=1)),
                    (ref_ckpt.load_scheduler_state, _ref_sched(nc=4, ns=1))):
        with pytest.raises(ValueError,
                           match="shape mismatch for context") as ei:
            load(b, path)
        errs.append(str(ei.value))
    assert errs[0] == errs[1]


def test_scheduler_checkpoint_roundtrip(tmp_path):
    """Twin of test_system.py's test of the same name (the reference's
    ``SimEngine`` shim is not ported: the run goes through the facade)."""
    srv = (api.ServerConfig.sim().tasks(table2_taskset("resnet18"))
           .contexts(4).streams(1).oversubscribe(2.0).device(device())
           .horizon_ms(1500.0).seed(0).build())
    srv.run()
    sched = srv.scheduler
    path = str(tmp_path / "sched.msgpack")
    ckpt.save_scheduler_state(sched, path)
    sched2 = _sched(nc=4, os_=2.0)
    ckpt.load_scheduler_state(sched2, path)
    for a, b in zip(sched.tasks, sched2.tasks):
        assert a.ctx == b.ctx
        assert a.mret.task_mret() == pytest.approx(b.mret.task_mret())


def test_checkpoint_io_chaos(tmp_path):
    """Twin of test_chaos.py's test of the same name."""
    specs = [api.TaskSpec(name=n, period_ms=p, priority=prio,
                          stages=[api.StageProfile(f"{n}/s0", t, n_sat=1.0,
                                                   mem_frac=0.0,
                                                   overhead_ms=0.0)])
             for n, prio, t, p in (("hp", api.HP, 4.0, 40.0),
                                   ("lp0", api.LP, 6.0, 60.0),
                                   ("lp1", api.LP, 5.0, 50.0))]
    srv = (api.ServerConfig.sim().tasks(specs).contexts(2).streams(1)
           .oversubscribe(2.0)
           .device(api.DeviceModel(n_units=4.0, bubble=0.0, l2_pressure=0.0))
           .horizon_ms(100.0).phase_offsets(False).noise(0.0).seed(0)
           .build())
    srv.run()
    path = str(tmp_path / "s.msgpack")
    ch = ChaosState(ChaosPlan(seed=0, io_error_rate=1.0, io_max_retries=2))
    with pytest.raises(OSError, match="chaos"):
        ckpt.save_scheduler_state(srv.scheduler, path, chaos=ch)
    assert not os.path.exists(path)
    ch2 = ChaosState(ChaosPlan(seed=0, io_error_rate=0.4, io_max_retries=4))
    ckpt.save_scheduler_state(srv.scheduler, path, chaos=ch2)
    ckpt.load_scheduler_state(srv.scheduler, path)   # round-trips


# ---------------------------------------------------------- parameter files
def _as_bits(a):
    """A leaf's bytes as integers of its width (bf16 as uint16)."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        a = t.numpy()
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[a.dtype.itemsize])


def _leaves(tree):
    return [leaf for _, leaf in ckpt.ckpt._flatten_with_path(tree)]


def _mixed_ref_tree():
    """The reduced smollm-135m's parameters (JAX init, seed 0) with half
    the leaves in bf16, plus a list, a tuple, int and scalar leaves and
    keys whose sorted order is not their insertion order."""
    params = ref_build_model(ref_get_reduced("smollm-135m")).init_params(0)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    leaves = [a.astype(jnp.bfloat16) if i % 2 else a
              for i, a in enumerate(leaves)]
    tree = jax.device_get(jax.tree_util.tree_unflatten(treedef, leaves))
    tree["zz_extra"] = {
        "b": [np.arange(3, dtype=np.int32), (np.float32(2.0),
                                             np.ones((2, 2), np.float32))],
        "10": np.zeros(1, np.int64), "9": np.eye(2)}
    return tree


def test_reference_params_file_loads_into_the_port(tmp_path):
    """A file of the reference (``repro.checkpoint.save_pytree``) loads
    into a template of the port's tensors: each leaf equals
    ``params_from_jax`` of the same tree, bit for bit, in its dtype."""
    tree = _mixed_ref_tree()
    ref_ckpt.save_pytree(tree, str(tmp_path / "ref"), step=3)
    want = params_from_jax(tree, device="cpu")
    template = jax.tree_util.tree_map(
        lambda a: torch.zeros(a.shape, dtype=a.dtype), want)
    got = ckpt.load_pytree(template, str(tmp_path / "ref"))
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for g, w in zip(_leaves(got), _leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(_as_bits(g), _as_bits(w))
    # a numpy template gets what the reference's load_pytree returns
    back = ckpt.load_pytree(tree, str(tmp_path / "ref"))
    want = ref_ckpt.load_pytree(tree, str(tmp_path / "ref"))
    for g, w in zip(_leaves(back), jax.tree_util.tree_leaves(want)):
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype
        np.testing.assert_array_equal(_as_bits(g), _as_bits(w))


def test_port_params_file_loads_in_the_reference(tmp_path):
    """The port's file of the same tree: ``manifest.json`` byte-identical
    to the reference's, the same leaf bytes, and it loads through the
    reference's ``load_pytree``."""
    tree = _mixed_ref_tree()
    ref_ckpt.save_pytree(tree, str(tmp_path / "ref"), step=3)
    port_tree = params_from_jax(tree, device="cpu")
    ckpt.save_pytree(port_tree, str(tmp_path / "port"), step=3)
    assert (tmp_path / "port.ckpt" / "manifest.json").read_bytes() == \
        (tmp_path / "ref.ckpt" / "manifest.json").read_bytes()
    got = ref_ckpt.load_pytree(tree, str(tmp_path / "port"))
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(_as_bits(g), _as_bits(w))
    with np.load(tmp_path / "port.ckpt" / "data.npz") as a, \
            np.load(tmp_path / "ref.ckpt" / "data.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes() and \
                a[k].shape == b[k].shape


def test_reference_cnn_file_loads_through_cnn_params_from_jax(tmp_path):
    """A reduced ResNet18 (width 8) saved by the reference loads through a
    numpy template and ``cnn_params_from_jax`` into the port's layouts:
    equal to ``cnn_params_from_jax`` of the reference's tree, and the
    port's model with those weights gives the same output."""
    from test_torch_cnn import reference
    tree = jax.device_get(reference("resnet18").params)
    ref_ckpt.save_pytree(tree, str(tmp_path / "rn18"))
    template = jax.tree_util.tree_map(np.zeros_like, tree)
    loaded = cnn_params_from_jax(
        ckpt.load_pytree(template, str(tmp_path / "rn18")), device="cpu")
    want = cnn_params_from_jax(tree, device="cpu")
    for g, w in zip(_leaves(loaded), _leaves(want)):
        assert g.shape == w.shape and g.stride() == w.stride()
        np.testing.assert_array_equal(_as_bits(g), _as_bits(w))
    from repro_torch.models import BUILDERS
    model = BUILDERS["resnet18"](width=8, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 32, 32, 3)).astype(np.float32))
    torch.testing.assert_close(model.forward(loaded, x),
                               model.forward(want, x), rtol=0, atol=0)


def test_params_checkpoint_roundtrip(tmp_path):
    """Twin of test_system.py's test of the same name, on the port's
    reduced smollm-135m, and in bf16."""
    m = build_model(get_reduced("smollm-135m"), device="cpu")
    for dtype in (None, torch.bfloat16):
        params = m.init_params(0)
        if dtype is not None:
            params = jax.tree_util.tree_map(lambda t: t.to(dtype), params)
        ckpt.save_pytree(params, str(tmp_path / "p"), step=7)
        zeros = jax.tree_util.tree_map(torch.zeros_like, params)
        restored = ckpt.load_pytree(zeros, str(tmp_path / "p"))
        for a, b in zip(_leaves(params), _leaves(restored)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(_as_bits(a), _as_bits(b))
        manifest = json.loads(
            (tmp_path / "p.ckpt" / "manifest.json").read_text())
        assert manifest["step"] == 7


# ------------------------------------------------ atomic pytree saves
def _tiny_tree():
    return {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": np.zeros(3, np.float32)}


def test_save_pytree_overwrite_leaves_no_debris(tmp_path):
    tree = _tiny_tree()
    p = str(tmp_path / "ck")
    ckpt.save_pytree(tree, p, step=1)
    tree2 = {k: v + 1 for k, v in tree.items()}
    ckpt.save_pytree(tree2, p, step=2)      # exercises the .old sidestep
    leftovers = [q.name for q in tmp_path.iterdir() if q.name != "ck.ckpt"]
    assert leftovers == []
    out = ckpt.load_pytree({k: np.zeros_like(v) for k, v in tree.items()}, p)
    np.testing.assert_array_equal(out["w"], tree2["w"])


def test_load_pytree_falls_back_to_old_sidestep(tmp_path):
    tree = _tiny_tree()
    p = str(tmp_path / "ck")
    final = ckpt.save_pytree(tree, p, step=1)
    os.rename(final, final + ".old")        # simulate the crash window
    out = ckpt.load_pytree({k: np.zeros_like(v) for k, v in tree.items()}, p)
    np.testing.assert_array_equal(out["w"], tree["w"])


def test_save_pytree_keeps_old_until_swap_when_final_missing(tmp_path,
                                                             monkeypatch):
    tree = _tiny_tree()
    p = str(tmp_path / "ck")
    final = ckpt.save_pytree(tree, p, step=1)
    os.rename(final, final + ".old")          # crash #1: only .old left
    (tmp_path / "ck.tmpDEAD").mkdir()         # crash #2 debris: staging
    real_rename = os.rename
    seen = []

    def spy(a, b):
        # at the moment staging swaps to final, .old must still exist
        if str(b).endswith(".ckpt"):
            seen.append((tmp_path / "ck.ckpt.old").exists())
        real_rename(a, b)

    monkeypatch.setattr(os, "rename", spy)
    ckpt.save_pytree({k: v + 5 for k, v in tree.items()}, p, step=2)
    monkeypatch.undo()
    assert seen == [True]                     # invariant held at swap
    assert not (tmp_path / "ck.tmpDEAD").exists()
    assert [q.name for q in tmp_path.iterdir()] == ["ck.ckpt"]
    out = ckpt.load_pytree({k: np.zeros_like(v) for k, v in tree.items()}, p)
    np.testing.assert_array_equal(out["w"], tree["w"] + 5)


def test_save_pytree_recovers_from_stale_old_dir(tmp_path):
    tree = _tiny_tree()
    p = str(tmp_path / "ck")
    ckpt.save_pytree(tree, p, step=1)
    stale = tmp_path / "ck.ckpt.old"
    stale.mkdir()
    (stale / "junk").write_text("x")
    tree2 = {k: v * 2 for k, v in tree.items()}
    ckpt.save_pytree(tree2, p, step=2)
    assert not stale.exists()
    out = ckpt.load_pytree({k: np.zeros_like(v) for k, v in tree.items()}, p)
    np.testing.assert_array_equal(out["b"], tree2["b"])


def test_load_pytree_keeps_tensor_devices_and_checks_shapes(tmp_path):
    """Each restored tensor lands on its template leaf's device with the
    manifest's dtype; a shape mismatch fails as in the reference."""
    tree = {"w": torch.arange(6.0).reshape(2, 3).to(torch.bfloat16),
            "n": [torch.tensor([1, 2], dtype=torch.int32)]}
    ckpt.save_pytree(tree, str(tmp_path / "t"))
    out = ckpt.load_pytree({"w": torch.zeros(2, 3), "n": [torch.zeros(2)]},
                           str(tmp_path / "t"))
    assert out["w"].dtype == torch.bfloat16 and out["w"].device.type == "cpu"
    assert out["n"][0].dtype == torch.int32
    torch.testing.assert_close(out["w"], tree["w"], rtol=0, atol=0)
    with pytest.raises(AssertionError):
        ckpt.load_pytree({"w": torch.zeros(3, 2), "n": [torch.zeros(2)]},
                         str(tmp_path / "t"))


def test_none_is_an_empty_subtree_as_in_jax(tmp_path):
    """``None`` holds no leaf, in the manifest and on load, as in JAX's
    flatten order."""
    tree = {"b": np.ones(2, np.float32), "a": None,
            "c": [None, np.zeros(1, np.float32)]}
    ckpt.save_pytree(tree, str(tmp_path / "port"))
    ref_ckpt.save_pytree(tree, str(tmp_path / "ref"))
    assert (tmp_path / "port.ckpt" / "manifest.json").read_bytes() == \
        (tmp_path / "ref.ckpt" / "manifest.json").read_bytes()
    out = ckpt.load_pytree(tree, str(tmp_path / "ref"))
    assert out["a"] is None and out["c"][0] is None
    np.testing.assert_array_equal(out["c"][1], tree["c"][1])

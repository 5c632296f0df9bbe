"""The port's cluster layer against the JAX package's, bit for bit.

Twin of tests/test_cluster.py. ``repro_torch.cluster`` is a copy of
``repro.cluster``; the facade's cluster branches (``ServerConfig.cluster``,
``fail_device_at``, ``reconfigure_at(n_gpus=...)``, the cluster validation)
are written by the port. Every scenario below runs through both packages:
decision logs, ``summary()`` dicts, snapshots and every response time (as
float hex) must be identical, and the port must show what the reference
test asserts. Scheduler-level checks run the same calls on both packages'
``ClusterScheduler`` and compare what they observe.

Port-only: the heap engine against ``engine("epoch", device="cpu")`` at
its default threshold and at ``DARIS_EPOCH_KERNEL_MIN=1`` (every
rate-group through the contention kernel's plain version), and a reduced
64-device fleet (8 devices, 300 ms) in parity with the reference.
"""
import dataclasses
import importlib
import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_cuda import diurnal_trace  # noqa: E402


def _package(name):
    ns = types.SimpleNamespace(name=name)
    for attr, mod in (("api", "api"), ("cluster", "cluster"),
                      ("profiles", "serving.profiles"),
                      ("requests", "serving.requests"),
                      ("sched", "core.scheduler"),
                      ("batching", "core.batching"),
                      ("contention", "runtime.contention"),
                      ("backend", "runtime.backend"),
                      ("engine_core", "runtime.engine_core")):
        setattr(ns, attr, importlib.import_module(f"{name}.{mod}"))
    return ns


REF, PORT = _package("repro"), _package("repro_torch")
HP, LP = PORT.api.HP, PORT.api.LP


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def canon(x):
    """Floats as hex (NaN included), keys as strings: equality is bit
    equality."""
    if isinstance(x, float):
        return x.hex()
    if isinstance(x, dict):
        return {str(k): canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [canon(v) for v in x]
    return x


def spec(m, name, period=40.0, priority=LP, t_alone=2.0, batch_gain=1.0):
    return m.api.TaskSpec(
        name=name, period_ms=period, priority=priority,
        stages=[m.api.StageProfile(name=f"{name}/s{j}", t_alone_ms=t_alone,
                                   n_sat=20.0, mem_frac=0.3,
                                   batch_gain=batch_gain)
                for j in (0, 1)])


def rn18(m, load_scale=1.0):
    return m.requests.table2_taskset("resnet18", load_scale=load_scale)


def cluster_cfg(m, n_gpus, specs, horizon=800.0, nc=4, os_=4.0, **kw):
    return (m.api.ServerConfig.cluster(n_gpus, **kw)
            .tasks(specs)
            .contexts(nc).streams(1).oversubscribe(os_)
            .device(m.profiles.device())
            .horizon_ms(horizon).seed(0).record_decisions())


def outcome(srv, metrics, pre_snapshot):
    """What a run must reproduce bit for bit; the snapshots without the
    backend's class name, which names the engine."""
    snaps = [{k: v for k, v in s.items() if k != "backend"}
             for s in (pre_snapshot, srv.snapshot())]
    return {"decisions": srv.decisions, "summary": canon(metrics.summary()),
            "response_ms": canon(metrics.response_ms),
            "snapshots": canon(snaps)}


# --------------------------------------------------------------- scenarios
# name -> (unbuilt config of package m, check of the port's run); the
# checks are the reference tests' assertions
def _fail_ctx_tuple(m):
    return (cluster_cfg(m, 2, rn18(m, 0.4), horizon=600.0, nc=2, os_=2.0)
            .fail_context_at((0, 0), 200.0))


def _check_fail_ctx_tuple(srv, m):
    assert m.faults == 1 and m.missed[HP] == 0
    assert not srv.scheduler.contexts[(0, 0)].alive


def _fail_dev1(m):
    return cluster_cfg(m, 4, rn18(m, 0.5), horizon=1200.0).fail_device_at(
        1, 400.0)


def _check_fail_dev1(srv, m):
    assert m.faults == 1 and m.missed[HP] == 0
    assert len(srv.scheduler.workers[1].tasks) == 0
    assert m.migrations > 0
    assert 1 not in srv.scheduler.live_devices()
    assert all(t.ctx[0] != 1 for t in srv.scheduler.tasks)


def _fail_dev0(m):
    return cluster_cfg(m, 4, rn18(m, 0.5), horizon=1200.0).fail_device_at(
        0, 300.0)


def _check_fail_dev0(srv, m):
    dead = sum(m.per_device[0]["completed"].values())
    assert all(sum(s["completed"].values()) > dead
               for d, s in m.per_device.items() if d != 0)


def _cross_device_admission(m):
    return cluster_cfg(m, 2, [spec(m, f"lp{i}", period=6.0, t_alone=2.5)
                              for i in range(8)],
                       horizon=400.0, nc=1, os_=1.0)


def _check_cross_device_admission(srv, m):
    assert m.migrations > 0
    assert {t.ctx[0] for t in srv.scheduler.tasks} == {0, 1}


def _unminted_ctx_fault(m):
    return (cluster_cfg(m, 2, rn18(m, 0.4), horizon=500.0, nc=2, os_=2.0)
            .scale_out_at(100.0).fail_context_at((0, 5), 300.0))


def _check_no_fault_some_completed(srv, m):
    assert m.faults == 0
    assert sum(m.completed.values()) > 0


def _ctx_fault_on_dead_device(m):
    return (cluster_cfg(m, 2, rn18(m, 0.4), horizon=500.0, nc=2, os_=2.0)
            .reconfigure_at(150.0, n_gpus=1).fail_context_at((1, 0), 300.0))


def _escalating_ctx_fault_last_survivor(m):
    return (cluster_cfg(m, 1, rn18(m, 0.4), horizon=500.0, nc=1, os_=1.0)
            .fail_context_at((0, 0), 200.0)
            .reconfigure_at(400.0, n_contexts=2))


def _check_last_survivor(srv, m):
    _check_no_fault_some_completed(srv, m)
    assert srv.scheduler.live_devices() == [0]


def _fault_on_last_survivor(m):
    return (cluster_cfg(m, 2, rn18(m, 0.4), horizon=500.0, nc=2, os_=2.0)
            .reconfigure_at(150.0, n_gpus=1).fail_device_at(0, 300.0))


def _escalated_fault_after_shrink(m):
    return (cluster_cfg(m, 2, [spec(m, f"lp{i}", period=120.0, t_alone=25.0)
                               for i in range(4)],
                        horizon=600.0, nc=2, os_=2.0)
            .reconfigure_at(150.0, n_contexts=1)
            .fail_context_at((0, 2), 152.0))


def _check_escalated_fault_after_shrink(srv, m):
    assert 0 not in srv.scheduler.live_devices()
    assert sum(m.completed.values()) > 0
    assert sum(m.completed.values()) == sum(
        len(v) for v in m.response_ms.values())


def _grow(m):
    return cluster_cfg(m, 2, rn18(m, 0.5), horizon=1000.0).reconfigure_at(
        300.0, n_gpus=4)


def _check_grow(srv, m):
    assert m.reconfigures == 1 and m.missed[HP] == 0
    assert len(srv.scheduler.live_devices()) == 4
    late = {d for d in m.per_device if d >= 2}
    assert late and all(sum(m.per_device[d]["completed"].values()) > 0
                        for d in late)


def _shrink(m):
    return cluster_cfg(m, 4, rn18(m, 0.4), horizon=1000.0).reconfigure_at(
        300.0, n_gpus=2)


def _check_shrink(srv, m):
    assert len(srv.scheduler.live_devices()) == 2 and m.missed[HP] == 0
    assert all(t.ctx[0] in (0, 1) for t in srv.scheduler.tasks)


def _autoscale(m):
    return cluster_cfg(m, 1, rn18(m), horizon=1500.0).autoscale(
        0.2, 0.6, check_every_ms=200.0, min_contexts=1, max_contexts=4,
        cooldown_ms=300.0)


def _check_autoscale(srv, m):
    assert m.reconfigures > 0
    assert len(srv.scheduler.workers) > 1


def _per_device_reshape(m):
    return cluster_cfg(m, 2, rn18(m, 0.4)).reconfigure_at(
        300.0, n_contexts=6, oversubscription=6.0)


def _check_per_device_reshape(srv, m):
    assert m.missed[HP] == 0
    for d in srv.scheduler.live_devices():
        assert len(srv.scheduler.workers[d].live_contexts()) == 6


def _snapshot(m):
    return cluster_cfg(m, 2, rn18(m, 0.5), horizon=500.0)


def _check_snapshot(srv, m):
    snap = srv.snapshot()
    assert set(snap["devices"]) == {0, 1}
    assert all(s["alive"] and s["live_contexts"] == 4
               for s in snap["devices"].values())
    assert snap["resp_hp"]["p99"] >= snap["resp_hp"]["p50"] > 0.0
    s = m.summary()
    assert set(s["per_device"]) == {"0", "1"}
    assert s["resp_hp_p99"] == s["resp_hp"]["p99"]


def _nothing_completes(m):
    return (m.api.ServerConfig.cluster(2)
            .task(spec(m, "idle"), arrival=m.api.TraceArrival([]))
            .contexts(2).streams(1).oversubscribe(2.0)
            .device(m.profiles.device()).horizon_ms(50.0).seed(0)
            .record_decisions())


def _check_nothing_completes(srv, m):
    s = m.summary()
    assert set(s["per_device"]) == {"0", "1"} and s["transfers"] == 0


def _hetero_rn18(m):
    """benchmarks/perf_engine.py's cluster_rn18_4gpu, at a short horizon."""
    return cluster_cfg(m, 4, rn18(m), horizon=400.0,
                       device_models=["a100", "a100", "v100", "v100"])


def _check_hetero(srv, m):
    assert sum(m.per_device[d]["completed"][HP] for d in m.per_device) > 0
    assert m.completed[HP] > 0


def _batching(m):
    """Cluster batching through the facade: Table II ResNet18 at full load
    on two GPUs, releases coalescing per model."""
    return cluster_cfg(m, 2, rn18(m), horizon=500.0).batching(max_batch=4)


def _check_batching(srv, m):
    assert any(b > 1 for b in m.batch_hist)


def _transfer(m):
    """Table II ResNet18 at full load on one GPU grown to three: the
    global re-place moves jobs that hold state on their old device, and
    their next stage pays ``transfer_ms``."""
    return cluster_cfg(m, 1, rn18(m), horizon=600.0,
                       transfer_ms=1.5).reconfigure_at(200.0, n_gpus=3)


def _check_transfer(srv, m):
    assert srv.scheduler.transfers > 0
    assert m.summary()["transfers"] == srv.scheduler.transfers


def _fleet(m, n_dev=8, horizon=300.0):
    """benchmarks/perf_engine.py's fleet_64dev_diurnal cut to ``n_dev``
    devices and ``horizon`` ms: 3 two-stage LP services a device."""
    specs = [spec(m, f"svc{i:03d}", period=24.0)
             for i in range(n_dev * 3)]
    cfg = cluster_cfg(m, n_dev, specs, horizon=horizon)
    for i, s in enumerate(specs):
        cfg.arrival(s.name, m.api.TraceArrival(diurnal_trace(
            np.random.default_rng(9000 + i), 1.0 / 24.0, horizon)))
    return cfg


def _check_fleet(srv, m):
    assert len(srv.scheduler.workers) == 8
    assert sum(m.completed.values()) > 200


SCENARIOS = {
    "fail_context_tuple_key": (_fail_ctx_tuple, _check_fail_ctx_tuple),
    "fail_device_replaces_hp_first": (_fail_dev1, _check_fail_dev1),
    "fail_device_survivors_continue": (_fail_dev0, _check_fail_dev0),
    "cross_device_admission": (_cross_device_admission,
                               _check_cross_device_admission),
    "unminted_context_fault_skipped": (_unminted_ctx_fault,
                                       _check_no_fault_some_completed),
    "context_fault_on_dead_device": (_ctx_fault_on_dead_device,
                                     _check_no_fault_some_completed),
    "escalating_fault_last_survivor": (_escalating_ctx_fault_last_survivor,
                                       _check_last_survivor),
    "device_fault_last_survivor": (_fault_on_last_survivor,
                                   _check_last_survivor),
    "escalated_fault_after_shrink": (_escalated_fault_after_shrink,
                                     _check_escalated_fault_after_shrink),
    "grow_whole_gpus": (_grow, _check_grow),
    "shrink_whole_gpus": (_shrink, _check_shrink),
    "autoscale_whole_gpus": (_autoscale, _check_autoscale),
    "per_device_reshape": (_per_device_reshape, _check_per_device_reshape),
    "snapshot_and_summary": (_snapshot, _check_snapshot),
    "nothing_completes": (_nothing_completes, _check_nothing_completes),
    "heterogeneous_rn18_4gpu": (_hetero_rn18, _check_hetero),
    "batching": (_batching, _check_batching),
    "transfer_charge": (_transfer, _check_transfer),
    "fleet_8dev_300ms": (_fleet, _check_fleet),
}
# the engine sweep's share: a device fault, a context fault escalated to
# a device, whole-GPU grow (with transfers) and shrink, heterogeneous
# devices, batching and the fleet
ENGINE_SWEEP = ("fail_device_replaces_hp_first", "shrink_whole_gpus",
                "escalated_fault_after_shrink", "heterogeneous_rn18_4gpu",
                "batching", "transfer_charge", "fleet_8dev_300ms")


def run(name, m, engine="heap"):
    cfg = SCENARIOS[name][0](m)
    if m is PORT and engine == "epoch":
        cfg = cfg.engine("epoch", device="cpu")
    else:
        cfg = cfg.engine(engine)
    srv = cfg.build()
    pre = srv.snapshot()
    metrics = srv.run()
    return srv, metrics, outcome(srv, metrics, pre)


_REFERENCE = {}


def reference(name):
    """The JAX package's heap engine, run live once per scenario."""
    if name not in _REFERENCE:
        _REFERENCE[name] = run(name, REF)[2]
    return _REFERENCE[name]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_cluster_matches_reference_bit_for_bit(name):
    srv, metrics, ours = run(name, PORT)
    SCENARIOS[name][1](srv, metrics)
    assert ours == reference(name)


@pytest.mark.parametrize("threshold", [None, "1"], ids=["default", "min1"])
@pytest.mark.parametrize("name", ENGINE_SWEEP)
def test_epoch_engine_matches_heap_on_cluster(name, threshold, monkeypatch):
    """``engine("epoch", device="cpu")`` on a cluster gives the heap
    engine's bits; at threshold 1 every rate-group goes through the
    contention kernel's plain version, each device's own model."""
    from repro_torch.kernels import contention_eta as ce
    if threshold is not None:
        monkeypatch.setenv("DARIS_EPOCH_KERNEL_MIN", threshold)
    ce.fused.counts.reset()
    srv, _, ours = run(name, PORT, "epoch")
    assert isinstance(srv.backend, PORT.api.CudaEpochSimBackend)
    assert ours == reference(name)
    if threshold == "1":
        assert ce.fused.counts.plain_calls > 0
    else:
        assert ce.fused.counts.plain_calls == 0


def test_epoch_hooks_every_worker_after_scale_out():
    """The epoch engine's lazy work_done flush reaches each worker,
    also the GPUs a whole-GPU scale-out adds mid-run."""
    srv = _grow(PORT).engine("epoch", device="cpu").build()
    srv.run()
    assert len(srv.scheduler.workers) == 4
    hook = srv.backend._sync_ctx
    assert all(w.work_sync == hook for w in srv.scheduler.workers.values())
    assert srv.backend._n_workers == 4


def test_heterogeneous_groups_reach_the_kernel_with_their_device(
        monkeypatch):
    """Each rate-group's contention pass gets its own device's model
    (n_units, bubble, l2_pressure) on a heterogeneous fleet."""
    from repro_torch.kernels import contention_eta as ce
    monkeypatch.setenv("DARIS_EPOCH_KERNEL_MIN", "1")
    seen = set()
    rates = ce.rates

    def spy(device_model, *a, **kw):
        seen.add(dataclasses.astuple(device_model))
        return rates(device_model, *a, **kw)
    monkeypatch.setattr(ce, "rates", spy)
    srv = _hetero_rn18(PORT).engine("epoch", device="cpu").build()
    srv.run()
    want = {dataclasses.astuple(w.contention.device)
            for w in srv.scheduler.workers.values()}
    assert len(want) == 2 and seen == want


# ------------------------------------------------- single-GPU equivalence
def test_one_gpu_cluster_is_bit_identical_to_single():
    def single(m):
        return (m.api.ServerConfig.sim().tasks(m.requests.table2_taskset(
                    "resnet18"))
                .contexts(6).streams(1).oversubscribe(6.0)
                .device(m.profiles.device()).horizon_ms(600.0).seed(0)
                .record_decisions())
    runs = {}
    for m in (REF, PORT):
        for kind, cfg in (("single", single(m)),
                          ("cluster", cluster_cfg(
                              m, 1, m.requests.table2_taskset("resnet18"),
                              horizon=600.0, nc=6, os_=6.0))):
            runs[m.name, kind] = cfg.build().run()
    one, clustered = runs["repro_torch", "single"], runs["repro_torch",
                                                         "cluster"]
    for f in ("completed", "missed", "rejected", "migrations"):
        assert getattr(one, f) == getattr(clustered, f)
    assert canon(one.response_ms) == canon(clustered.response_ms)
    assert canon(clustered.summary()) == canon(
        runs["repro", "cluster"].summary())


def _placements(m, n_gpus, device_models=None, dnn="resnet18"):
    specs = m.requests.table2_taskset(dnn)
    sched = m.cluster.ClusterScheduler(
        list(specs), m.sched.SchedulerConfig(n_contexts=4, n_streams=1,
                                             oversubscription=4.0),
        n_gpus=n_gpus, device_models=device_models)
    return sched, [(t.name, t.ctx, t.fixed_ctx) for t in sched.tasks]


def test_one_gpu_cluster_placement_matches_single():
    specs = PORT.requests.table2_taskset("unet")
    single = PORT.sched.DarisScheduler(
        list(specs), PORT.sched.SchedulerConfig(n_contexts=4, n_streams=1,
                                                oversubscription=4.0))
    _, placed = _placements(PORT, 1, dnn="unet")
    for ts, (name, ctx, fixed) in zip(single.tasks, placed):
        assert (name, ctx, fixed) == (ts.name, (0, ts.ctx), ts.fixed_ctx)
    assert placed == _placements(REF, 1, dnn="unet")[1]


# ------------------------------------------------------------ construction
def test_workers_share_one_namespace():
    sched = PORT.cluster.ClusterScheduler(
        [spec(PORT, "a"), spec(PORT, "b")],
        PORT.sched.SchedulerConfig(n_contexts=2), n_gpus=3)
    for w in sched.workers.values():
        assert w.lanes is sched.lanes and w.queues is sched.queues
        assert w.active_jobs is sched.active_jobs
    assert len(sched.lanes) == 6
    assert {k[0][0] for k in sched.lanes} == {0, 1, 2}


def test_hp_first_placement_spreads_devices():
    sched, placed = _placements(PORT, 4)
    hp = {d: sum(1 for t in w.tasks if t.priority == HP)
          for d, w in sched.workers.items()}
    assert max(hp.values()) - min(hp.values()) <= 1
    assert all(t.fixed_ctx for t in sched.tasks if t.priority == HP)
    assert placed == _placements(REF, 4)[1]


def test_heterogeneous_placement_prefers_fast_devices():
    models = ["a100", "v100", "rtx2080ti", "l4"]
    sched, placed = _placements(PORT, 4, models)
    n = {d: len(w.tasks) for d, w in sched.workers.items()}
    assert n[0] > n[1] > n[2] >= n[3]
    assert placed == _placements(REF, 4, models)[1]


def test_device_presets_resolve():
    c = PORT.cluster
    assert {k: dataclasses.asdict(v) for k, v in c.DEVICE_PRESETS.items()} \
        == {k: dataclasses.asdict(v)
            for k, v in REF.cluster.DEVICE_PRESETS.items()}
    assert c.resolve_device("a100").speed == pytest.approx(2.1)
    assert c.resolve_device("rtx2080ti").bubble == PORT.profiles.device(
    ).bubble
    dm = PORT.api.DeviceModel(n_units=10.0, name="custom", speed=3.0)
    assert c.resolve_device(dm) is dm
    for m in (REF, PORT):
        with pytest.raises(ValueError, match="unknown device preset"):
            m.cluster.resolve_device("h100000")


# every case of the reference's test_validation, and the pattern its error
# must match (None: a legal plan); the message must be the reference's,
# word for word
VALIDATION = {
    "n_gpus_zero": (lambda m: m.api.ServerConfig.cluster(0).task(
        spec(m, "a")).build(), "n_gpus"),
    "negative_transfer": (lambda m: m.api.ServerConfig.cluster(
        2, transfer_ms=-1.0).task(spec(m, "a")).build(), "transfer_ms"),
    "empty_device_models": (lambda m: m.api.ServerConfig.cluster(
        2, device_models=[]).task(spec(m, "a")).build(), "non-empty"),
    "fail_device_needs_cluster": (lambda m: m.api.ServerConfig.sim().task(
        spec(m, "a")).fail_device_at(0, 10.0).build(), "fail_device_at"),
    "n_gpus_needs_cluster": (lambda m: m.api.ServerConfig.sim().task(
        spec(m, "a")).reconfigure_at(10.0, n_gpus=2).build(), "n_gpus"),
    "bare_int_context_key": (lambda m: m.api.ServerConfig.cluster(2).task(
        spec(m, "a")).fail_context_at(0, 10.0).build(),
        r"\(device, context\) tuple"),
    "context_device_out_of_range": (lambda m: m.api.ServerConfig.cluster(
        2).task(spec(m, "a")).fail_context_at((5, 0), 10.0).build(),
        "out of range"),
    "context_index_out_of_range": (lambda m: m.api.ServerConfig.cluster(
        2).task(spec(m, "a")).fail_context_at((0, 9), 10.0).build(),
        "context 9 out of range"),
    "one_gpu_device_fault": (lambda m: m.api.ServerConfig.cluster(1).task(
        spec(m, "a")).fail_device_at(0, 10.0).build(), "1-GPU cluster"),
    "one_gpu_fault_after_grow": (lambda m: m.api.ServerConfig.cluster(
        1).task(spec(m, "a")).reconfigure_at(5.0, n_gpus=2).fail_device_at(
        0, 10.0).build(), None),
    "one_context_escalation": (lambda m: m.api.ServerConfig.cluster(1).task(
        spec(m, "a")).contexts(1).fail_context_at((0, 0), 10.0).build(),
        "1-context cluster"),
    "one_context_after_grow": (lambda m: m.api.ServerConfig.cluster(
        1).task(spec(m, "a")).contexts(1).reconfigure_at(5.0, n_gpus=2)
        .fail_context_at((0, 0), 10.0).build(), None),
    "grown_device_id": (lambda m: m.api.ServerConfig.cluster(4).task(
        spec(m, "a")).reconfigure_at(100.0, n_gpus=6).fail_device_at(
        5, 200.0).build(), None),
    "shrink_keeps_range_check": (lambda m: m.api.ServerConfig.cluster(
        4).task(spec(m, "a")).reconfigure_at(100.0, n_gpus=2)
        .fail_device_at(9, 200.0).build(), "out of range"),
    "shrink_then_regrow": (lambda m: m.api.ServerConfig.cluster(4).task(
        spec(m, "a")).reconfigure_at(100.0, n_gpus=2).reconfigure_at(
        200.0, n_gpus=4).fail_device_at(5, 300.0).build(), None),
    "monotone_shrink": (lambda m: m.api.ServerConfig.cluster(4).task(
        spec(m, "a")).reconfigure_at(300.0, n_gpus=3).reconfigure_at(
        600.0, n_gpus=2).fail_device_at(9, 800.0).build(), "out of range"),
    "scale_out_mints_contexts": (lambda m: m.api.ServerConfig.cluster(
        2).task(spec(m, "a")).contexts(2).scale_out_at(100.0)
        .fail_context_at((0, 2), 500.0).build(), None),
    "reshape_and_n_gpus_together": (lambda m: m.api.ServerConfig.cluster(
        2).task(spec(m, "a")).reconfigure_at(10.0, n_gpus=3, n_contexts=4)
        .build(), "separate events"),
    "n_gpus_below_one": (lambda m: m.api.ServerConfig.cluster(2).task(
        spec(m, "a")).reconfigure_at(10.0, n_gpus=0).build(),
        "n_gpus >= 1"),
}


def _raised(build):
    try:
        build()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("case", sorted(VALIDATION))
def test_validation_messages_match_reference(case):
    build, pattern = VALIDATION[case]
    got = _raised(lambda: build(PORT))
    assert got == _raised(lambda: build(REF))
    if pattern is None:
        assert got is None
    else:
        assert got is not None and re.search(pattern, got)


def test_cluster_scheduler_cls_refused():
    class Custom(PORT.sched.DarisScheduler):
        pass
    with pytest.raises(ValueError, match="scheduler_cls"):
        (PORT.api.ServerConfig.cluster(2).task(spec(PORT, "a"))
         .scheduler_cls(Custom).build())


def test_cluster_checkpoint_not_ported(tmp_path):
    """Twin of test_cluster.py's ``test_cluster_checkpoint_unsupported``:
    both packages refuse to checkpoint a cluster, with the same messages,
    and write nothing."""
    for m in (REF, PORT):
        srv = cluster_cfg(m, 2, [spec(m, "a")], horizon=100.0).build()
        errs = []
        for call in (srv.save_state, srv.load_state):
            with pytest.raises(NotImplementedError, match="cluster") as ei:
                call(str(tmp_path / "cluster.ckpt"))
            errs.append(str(ei.value))
        if m is REF:
            want = errs
    assert errs == want
    assert list(tmp_path.iterdir()) == []


# --------------------------------------------- scheduler-level twin checks
def _all_failed(m):
    sched = m.cluster.ClusterScheduler(
        [spec(m, "a")], m.sched.SchedulerConfig(n_contexts=1), n_gpus=1)
    with pytest.raises(RuntimeError, match="last live device"):
        sched.fail_device(0, 0.0)
    return sched.live_devices()


def _escalation(m):
    sched = m.cluster.ClusterScheduler(
        [spec(m, "a")], m.sched.SchedulerConfig(n_contexts=1), n_gpus=2)
    sched.fail_context((0, 0), now=0.0)
    assert 0 not in sched.live_devices()
    return [t.ctx for t in sched.tasks]


def _transfer_charging(m):
    sched = m.cluster.ClusterScheduler(
        [spec(m, "a")], m.sched.SchedulerConfig(n_contexts=1), n_gpus=2,
        transfer_ms=3.0)
    task = sched.tasks[0]
    job = sched.on_release(task, 0.0)
    home = task.ctx
    inst = sched.next_for_lane(home, 0.0)
    seen = [inst.transfer_ms, job.job_id in sched._state_dev]
    inst.lane = (home, 0)
    seen.append(sched.on_stage_finish(inst, 1.0, 1.0))
    seen.append(sched._state_dev[job.job_id] == home[0])
    other = next(c.index for c in sched.live_contexts()
                 if c.index[0] != home[0])
    inst2 = sched.queues[home].pop()
    job.ctx = other
    sched.queues[other].push(inst2)
    inst3 = sched.next_for_lane(other, 2.0)
    seen += [inst3 is inst2, inst3.transfer_ms, sched.transfers]
    sched.queues[other].push(inst3)
    inst4 = sched.next_for_lane(other, 3.0)
    seen += [inst4 is inst3, inst4.transfer_ms, sched.transfers,
             sched._state_dev[job.job_id] == home[0]]
    assert seen == [0.0, False, None, True, True, 3.0, 1, True, 3.0, 2, True]
    return seen


def _migration_eta(m):
    sched = m.cluster.ClusterScheduler(
        [spec(m, "a")], m.sched.SchedulerConfig(n_contexts=2), n_gpus=2,
        transfer_ms=5.0)
    src = (0, 0)
    base = sched.workers[1].predicted_finish((1, 0), 0.0)
    out = [base, sched.migration_eta((1, 0), 0.0, src)]
    job = sched.on_release(sched.tasks[0], 0.0)
    out.append(sched.migration_eta((1, 0), 0.0, src, job))
    sched._state_dev[job.job_id] = 0
    out.append(sched.migration_eta((1, 0), 0.0, src, job))
    home = sched.workers[0].predicted_finish((0, 1), 0.0)
    out += [home, sched.migration_eta((0, 1), 0.0, src, job)]
    assert out[1] == pytest.approx(base) and out[2] == pytest.approx(base)
    assert out[3] == pytest.approx(base + 5.0)
    assert out[5] == pytest.approx(home)
    return out


def _predicted_finish(m):
    fast = m.api.DeviceModel(speed=2.0, name="fast")
    sched = m.cluster.ClusterScheduler(
        [spec(m, "a", period=40.0)], m.sched.SchedulerConfig(n_contexts=1),
        n_gpus=1, device_models=[fast])
    task = sched.tasks[0]
    assert sched.on_release(task, 0.0) is not None
    k = task.ctx
    inst = sched.next_for_lane(k, 0.0)
    inst.lane = (k, 0)
    sched.lanes[(k, 0)] = inst
    w = sched.workers[0]
    mret_dev = inst.smret.value() * inst.cost_b / fast.speed
    inst.work_done = 0.8 * mret_dev
    ns = max(w.contexts[k].n_streams, 1)
    got = w.predicted_finish(k, 0.0)
    assert got == pytest.approx(0.2 * mret_dev / ns)
    return got


def _retired_key_fault(m):
    sched = m.cluster.ClusterScheduler(
        [spec(m, "a")], m.sched.SchedulerConfig(n_contexts=2), n_gpus=2)
    sched.reconfigure(0.0, n_contexts=1)
    out = [sched.fault_cancel_keys((0, 0))]
    sched.fail_context((0, 0), now=1.0)
    out += [0 in sched.live_devices(), sched.workers[0].contexts[(0, 2)].alive,
            sorted(sched.fault_cancel_keys((0, 2)))]
    sched.fail_context((0, 2), now=2.0)
    out.append(0 in sched.live_devices())
    assert out == [[(0, 0)], True, True, [(0, 0), (0, 1), (0, 2)], False]
    return out


def _unknown_key(m):
    sched = m.cluster.ClusterScheduler(
        [spec(m, "a")], m.sched.SchedulerConfig(n_contexts=2), n_gpus=2)
    with pytest.raises(ValueError, match="unknown context key") as e:
        sched.fail_context((0, 99), now=0.0)
    return str(e.value)


def _cancel_keys(m):
    sched = m.cluster.ClusterScheduler(
        [spec(m, "a")], m.sched.SchedulerConfig(n_contexts=2), n_gpus=2)
    out = [sched.fault_cancel_keys((0, 0))]
    sched.fail_context((0, 0), now=0.0)
    out.append(sorted(sched.fault_cancel_keys((0, 1))))
    sched.fail_context((0, 1), now=0.0)
    out.append(sched.fault_cancel_keys((0, 1)))
    assert out == [[(0, 0)], [(0, 0), (0, 1)], [(0, 1)]]
    return out


def _reshape_cross_device_job(m):
    sched = m.cluster.ClusterScheduler(
        [spec(m, "a"), spec(m, "b")], m.sched.SchedulerConfig(n_contexts=2),
        n_gpus=2)
    task = sched.tasks[0]
    job = sched.on_release(task, 0.0)
    other = next(c.index for c in sched.live_contexts()
                 if c.index[0] != task.ctx[0])
    sched._move_task(task, other)
    info = sched.reconfigure(100.0, n_contexts=3)
    assert job.ctx == task.ctx and job in sched.active_jobs[job.ctx]
    assert info["rehomed"] >= 0
    return canon(info), job.ctx


def _home_batch_join(m):
    pol = m.batching.BatchPolicy(max_batch=8, scope="task")
    cfg = m.sched.SchedulerConfig(n_contexts=1, n_streams=1,
                                  oversubscription=1.0, batch_policy=pol)
    s = m.api.TaskSpec(
        name="lp", period_ms=9.6, priority=LP,
        stages=[m.api.StageProfile(name=f"lp/s{j}", t_alone_ms=2.4,
                                   n_sat=20.0, mem_frac=0.3, batch_gain=3.0)
                for j in (0, 1)])
    sched = m.cluster.ClusterScheduler([s], cfg, n_gpus=2)
    task = sched.tasks[0]
    home = task.ctx
    j1 = sched.on_release(task, 0.0)
    assert not sched.workers[home[0]].admits(home, task, 0.5)
    other = next(d for d in sched.live_devices() if d != home[0])
    assert any(sched.workers[other].admits(c.index, task, 0.5)
               for c in sched.workers[other].live_contexts())
    j2 = sched.on_release(task, 0.5)
    assert j2 is j1 and j1.n_inputs == 2
    assert task.ctx == home and sched.migrations == 0
    return home, j1.n_inputs


def _straggler_credit(m):
    be = m.backend
    xfer = 50.0
    specs = [spec(m, "mover", period=400.0, t_alone=10.0),
             spec(m, "bystander", period=4000.0, t_alone=100.0)]
    cfg = m.sched.SchedulerConfig(n_contexts=2, n_streams=1,
                                  oversubscription=1.0, straggler_kappa=3.0)
    narrow = m.api.DeviceModel(n_units=4.0, bubble=0.0, l2_pressure=0.0)
    sched = m.cluster.ClusterScheduler(specs, cfg, narrow, n_gpus=1)
    backend = be.SimBackend(noise_sigma=0.0)
    core = m.engine_core.EngineCore(sched, backend, horizon_ms=10_000.0)
    backend.bind(core)
    backend.start()
    lanes = {}
    for task in sched.tasks:
        job = sched.on_release(task, 0.0)
        inst = sched.next_for_lane(job.ctx, 0.0)
        if task.spec.name == "mover":
            inst.transfer_ms = xfer
        lane = (job.ctx, 0)
        inst.start_ms = 0.0
        inst.lane = lane
        sched.lanes[lane] = inst
        backend.launch(lane, inst)
        lanes[task.spec.name] = lane
    backend.running_set_changed()
    entry = backend.running[lanes["mover"]]
    rate, rem = entry[be._RATE], entry[be._REM]
    assert rate < 1.0
    base = max(3.0 * entry[be._SMRET].value() * entry[be._COST],
               entry[be._FLOOR])
    backend.now = base + (xfer + xfer / rate) / 2 - rem / rate
    backend._check_stragglers()
    survived = (core.metrics.stragglers, lanes["mover"] in backend.running)
    backend.now = base + xfer / rate - rem / rate + 1.0
    backend._check_stragglers()
    assert survived == (0, True) and core.metrics.stragglers == 1
    return rate.hex(), rem.hex()


def _stale_head_sealed(m):
    pol = m.batching.BatchPolicy(max_batch=8, scope="task")
    cfg = m.sched.SchedulerConfig(n_contexts=2, batch_policy=pol)
    sched = m.cluster.ClusterScheduler([spec(m, "lp", period=40.0)], cfg,
                                       n_gpus=2)
    task = sched.tasks[0]
    j1 = sched.on_release(task, 0.0)
    foreign = next(c.index for c in sched.workers[1].live_contexts()
                   if c.index[0] != task.ctx[0])
    j1.ctx = foreign
    w = sched.workers[task.ctx[0]]
    assert w._try_coalesce(task, 0.5) is None
    assert w._coalescer.head(task) is None
    return foreign


def _transfer_wall_share(m):
    sched = m.cluster.ClusterScheduler(
        [spec(m, "a", period=400.0, t_alone=10.0)],
        m.sched.SchedulerConfig(n_contexts=1), n_gpus=1, transfer_ms=5.0)
    task = sched.tasks[0]
    job = sched.on_release(task, 0.0)
    inst = sched.next_for_lane(job.ctx, 0.0)
    inst.transfer_ms = 5.0
    inst.work_done = 20.0
    inst.lane = (job.ctx, 0)
    sched.on_stage_finish(inst, 40.0, 40.0)
    got = task.mret.stage_mret(0)
    assert got == pytest.approx(30.0)
    return got


def _coalesce_slack(m):
    pol = m.batching.BatchPolicy(max_batch=8, scope="task")
    cfg = m.sched.SchedulerConfig(n_contexts=1, batch_policy=pol)
    fast = m.api.DeviceModel(speed=2.0, name="fast2x")
    sched = m.cluster.ClusterScheduler(
        [spec(m, "lp", period=9.6, t_alone=2.4)], cfg, n_gpus=1,
        device_models=[fast])
    task = sched.tasks[0]
    j1 = sched.on_release(task, 0.0)
    w = sched.workers[0]
    inst = w._coalescer.head(task)
    mret0 = task.mret.stage_mret(0)
    cj = m.contention.batch_cost(task.spec.stages[0], 2)
    vdl = inst.virtual_deadline_ms
    now = vdl - 0.75 * mret0 * cj
    assert now + mret0 * cj > vdl
    assert now + (mret0 / fast.speed) * cj <= vdl
    j2 = sched.on_release(task, now)
    assert j2 is j1 and j1.n_inputs == 2
    return now.hex()


def _separate_reconfigure(m):
    sched = m.cluster.ClusterScheduler(
        [spec(m, "a")], m.sched.SchedulerConfig(n_contexts=2), n_gpus=2)
    with pytest.raises(ValueError, match="separate reconfigure") as e:
        sched.reconfigure(0.0, n_gpus=3, n_contexts=4)
    return str(e.value)


def _submit_least_loaded(m):
    srv = cluster_cfg(m, 2, [spec(m, "seed", period=100.0)],
                      horizon=300.0).build()
    handles = [srv.submit(spec(m, f"one{i}", period=100.0), at_ms=10.0)
               for i in range(4)]
    srv.drain()
    assert all(h.status == h.COMPLETED for h in handles)
    devs = [h.task.ctx for h in handles]
    assert {d[0] for d in devs} == {0, 1}
    return devs, srv.decisions


SCHEDULER_CHECKS = {
    "all_devices_failed_raises": _all_failed,
    "fail_context_escalates": _escalation,
    "transfer_charged_on_cross_device_dispatch": _transfer_charging,
    "migration_eta_charges_remote_state_only": _migration_eta,
    "predicted_finish_in_device_units": _predicted_finish,
    "retired_key_fault_does_not_escalate": _retired_key_fault,
    "unknown_context_key_raises": _unknown_key,
    "fault_cancel_keys_cover_device": _cancel_keys,
    "reshape_with_cross_device_job": _reshape_cross_device_job,
    "home_batch_before_cross_gpu": _home_batch_join,
    "straggler_transfer_credit": _straggler_credit,
    "stale_foreign_head_sealed": _stale_head_sealed,
    "transfer_wall_share_out_of_mret": _transfer_wall_share,
    "coalesce_slack_device_clock": _coalesce_slack,
    "reshape_and_n_gpus_separate": _separate_reconfigure,
    "submit_lands_on_least_loaded": _submit_least_loaded,
}


@pytest.mark.parametrize("name", sorted(SCHEDULER_CHECKS))
def test_cluster_scheduler_matches_reference(name):
    check = SCHEDULER_CHECKS[name]
    assert canon(check(PORT)) == canon(check(REF))

"""The port's SchedCheck (``repro_torch.analysis.schedcheck``) against the
JAX package's.

Twin of the tests in tests/test_schedcheck.py that need no daemon config
(those that do, and the CLI, are in tests/test_torch_serve.py). The analyzer,
report model and oracle are copies; ``ServerConfig.verify()`` and the
attributes the analyzer reads are the port's facade. For every
configuration below the report's JSON must be the reference's, character
for character, and the port must show what the reference test asserts.
The differential oracle (observed HP response <= static bound; GUARANTEED
implies zero HP misses) runs over the port's simulator on the reference's
figure scenarios, rebuilt here for the port (as
``benchmarks/figure_specs_torch.py`` builds them too), and on the epoch
engine with every rate-group through the contention kernel's plain
version.
"""
import dataclasses
import importlib
import json
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")


def _package(name):
    ns = types.SimpleNamespace(name=name)
    for attr, mod in (("api", "api"), ("sc", "analysis.schedcheck"),
                      ("analyzer", "analysis.schedcheck.analyzer"),
                      ("profiles", "serving.profiles"),
                      ("requests", "serving.requests"),
                      ("contention", "runtime.contention")):
        setattr(ns, attr, importlib.import_module(f"{name}.{mod}"))
    return ns


REF, PORT = _package("repro"), _package("repro_torch")
sc = PORT.sc
HP, LP = PORT.api.HP, PORT.api.LP


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_spec(m, name, prio, stage_times, period_ms, n_sat=1.0):
    return m.api.TaskSpec(
        name=name, period_ms=period_ms, priority=prio,
        stages=[m.api.StageProfile(f"{name}/s{j}", t, n_sat=n_sat,
                                   mem_frac=0.0, overhead_ms=0.0)
                for j, t in enumerate(stage_times)])


def ideal_device(m):
    return m.api.DeviceModel(n_units=4.0, bubble=0.0, l2_pressure=0.0)


def light_cfg(m, horizon=1000.0):
    """2 tasks, 2 contexts, os=2 on the ideal device: comfortably
    schedulable, finite bounds everywhere."""
    cfg = m.api.ServerConfig.sim().horizon_ms(horizon)
    cfg.task(make_spec(m, "hp", m.api.HP, [5.0], 50.0))
    cfg.task(make_spec(m, "lp", m.api.LP, [8.0], 100.0))
    cfg.device(ideal_device(m)).contexts(2).streams(1).oversubscribe(2.0)
    cfg.phase_offsets(False).noise(0.0).seed(0)
    return cfg


def one_ctx(m, specs, horizon=500.0):
    cfg = m.api.ServerConfig.sim().horizon_ms(horizon)
    for s in specs:
        cfg.task(s)
    cfg.device(ideal_device(m)).contexts(1).streams(1).oversubscribe(1.0)
    cfg.phase_offsets(False).noise(0.0).seed(0)
    return cfg


# ------------------------------------- the reference's figure scenarios
SMOKE_HORIZON_MS = 2000.0


def _light_specs(m, n_hp=2, n_lp=2, jps=30.0):
    mk = m.profiles.make_task
    return ([mk("resnet18", priority=0, jps=jps, tag=f"-hp{i}")
             for i in range(n_hp)]
            + [mk("resnet18", priority=1, jps=jps, tag=f"-lp{i}")
               for i in range(n_lp)])


def fig4_6_light(m):
    """benchmarks/figure_specs.py: the under-loaded MPS 2x1 os=2 cell."""
    return (m.api.ServerConfig.sim().tasks(_light_specs(m))
            .contexts(2).streams(1).oversubscribe(2.0)
            .device(m.profiles.device()).horizon_ms(SMOKE_HORIZON_MS)
            .seed(0))


def fig13_light(m):
    """benchmarks/figure_specs.py: an under-loaded 2-GPU fleet."""
    specs = [dataclasses.replace(s, name=f"g{g}-{s.name}")
             for g in range(2) for s in _light_specs(m, n_hp=1, n_lp=1)]
    return (m.api.ServerConfig.cluster(2).tasks(specs)
            .contexts(2).streams(1).oversubscribe(2.0)
            .device(m.profiles.device()).horizon_ms(SMOKE_HORIZON_MS)
            .seed(0))


def fig13_fail_1of4(m):
    """benchmarks/figure_specs.py: 4 GPUs at half Table II ResNet18 load
    each, device 1 failing at 30% of the horizon."""
    specs = [dataclasses.replace(s, name=f"g{g}-{s.name}")
             for g in range(4)
             for s in m.requests.table2_taskset("resnet18", load_scale=0.5)]
    return (m.api.ServerConfig.cluster(4).tasks(specs)
            .contexts(4).streams(1).oversubscribe(4.0)
            .device(m.profiles.device()).horizon_ms(SMOKE_HORIZON_MS)
            .seed(0).fail_device_at(1, SMOKE_HORIZON_MS * 0.3))


# ------------------------------------------------ configurations analyzed
def _wcet(m):
    return one_ctx(m, [make_spec(m, "hp", m.api.HP, [60.0], 50.0)])


def _eq11(m):
    return one_ctx(m, [make_spec(m, "hp-a", m.api.HP, [40.0], 50.0),
                       make_spec(m, "hp-b", m.api.HP, [40.0], 50.0)])


def _last_ctx(m):
    return one_ctx(m, [make_spec(m, "hp", m.api.HP, [5.0], 50.0)],
                   horizon=1000.0).fail_context_at(0, 300.0)


def _brownout(m):
    plan = m.api.ChaosPlan(seed=0, brownouts=(
        m.api.Brownout(t0_ms=200.0, t1_ms=400.0, device=0,
                       slow_factor=4.0),))
    return light_cfg(m, horizon=600.0).chaos(plan)


def _cluster_fail_device(m):
    cfg = m.api.ServerConfig.cluster(2, transfer_ms=0.0)
    cfg.task(make_spec(m, "g0-hp", m.api.HP, [5.0], 50.0))
    cfg.task(make_spec(m, "g1-hp", m.api.HP, [5.0], 50.0))
    cfg.device(ideal_device(m)).contexts(1).streams(1).oversubscribe(1.0)
    cfg.horizon_ms(1000.0).phase_offsets(False).noise(0.0).seed(0)
    return cfg.fail_device_at(1, 300.0)


def _slices(m):
    return one_ctx(m, [make_spec(m, "hp", m.api.HP, [4.0, 2.0, 6.0], 60.0)])


def _check_light(rep):
    assert rep.hp_verdict == sc.GUARANTEED
    assert len(rep.epochs) == 1 and rep.epochs[0].cause == "build"
    tv = rep.task_verdicts("hp")[0]
    assert tv.binding == "wcrt-within-deadline"
    assert tv.wcrt_ms <= tv.deadline_ms and tv.slack_ms > 0
    assert math.isfinite(rep.hp_bound_ms())
    assert rep.hp_bound_ms() >= tv.solo_ms


def _check_wcet(rep):
    tv = rep.task_verdicts("hp")[0]
    assert (tv.verdict, tv.binding) == (sc.UNSCHEDULABLE,
                                        "wcet-exceeds-deadline")
    assert rep.verdict == sc.UNSCHEDULABLE
    assert rep.hp_bound_ms() > tv.deadline_ms


def _check_eq11(rep):
    assert {tv.binding for tv in rep.epochs[0].tasks} == {"eq11-overload"}
    assert rep.hp_verdict == sc.UNSCHEDULABLE


def _check_open_loop(rep):
    tv = rep.task_verdicts("hp")[0]
    assert (tv.verdict, tv.binding) == (sc.CONDITIONAL, "arrival-process")
    assert tv.wcrt_ms == math.inf and rep.hp_verdict == sc.CONDITIONAL
    assert any("open-loop" in a for a in rep.assumptions)


def _check_chaos(rep):
    tv = rep.task_verdicts("hp")[0]
    assert (tv.verdict, tv.binding) == (sc.CONDITIONAL, "chaos-fault-rate")
    assert math.isfinite(tv.wcrt_ms)


def _check_reconfigure(rep):
    assert [e.cause for e in rep.epochs] == ["build", "reconfigure"]
    assert [(e.t0_ms, e.t1_ms) for e in rep.epochs] == [(0.0, 400.0),
                                                        (400.0, 1000.0)]
    assert any("draining lanes" in a for a in rep.assumptions)


def _check_fail_ctx_scale_out(rep):
    assert [e.cause for e in rep.epochs] == ["build", "fail-context",
                                            "scale-out"]
    assert [len(e.contexts) for e in rep.epochs] == [2, 1, 2]


def _check_last_ctx(rep):
    dead = rep.epochs[-1]
    assert dead.cause == "total-failure" and dead.t1_ms == 1000.0
    assert all(tv.binding == "total-failure" for tv in dead.tasks)
    assert rep.verdict == sc.UNSCHEDULABLE


def _check_brownout(rep):
    assert [e.cause for e in rep.epochs] == ["build", "brownout-start",
                                             "brownout-end"]
    wc = [e.tasks[0].wcrt_ms for e in rep.epochs]
    assert wc[1] > wc[0]
    assert wc[2] == pytest.approx(wc[0], rel=1e-6)


def _check_cluster_fail_device(rep):
    assert [e.cause for e in rep.epochs] == ["build", "fail-device"]
    assert [{tv.device for tv in e.tasks} for e in rep.epochs] == [
        {0, 1}, {0}]


def _check_autoscale(rep):
    assert [e.cause for e in rep.epochs] == ["build"]
    assert [e.cause for e in rep.hypothetical] == ["autoscale-floor"]
    floor = max(tv.wcrt_ms for tv in rep.hypothetical[0].tasks
                if tv.priority == "HP")
    assert rep.hp_bound_ms() <= floor
    assert rep.verdict == sc.worst_verdict(
        [e.verdict for e in rep.epochs + rep.hypothetical])


def _check_slices(rep):
    tv = rep.task_verdicts("hp")[0]
    assert sum(s.vdl_ms for s in tv.stages) == pytest.approx(
        tv.deadline_ms, rel=1e-9)
    assert tv.stages[2].vdl_ms > tv.stages[0].vdl_ms > tv.stages[1].vdl_ms


def _check_guaranteed(rep):
    assert rep.hp_verdict == sc.GUARANTEED
    assert math.isfinite(rep.hp_bound_ms())


def _check_epochs(*causes):
    def check(rep):
        assert [e.cause for e in rep.epochs] == list(causes)
    return check


REPORTS = {
    "light": (light_cfg, _check_light),
    "wcet_exceeds_deadline": (_wcet, _check_wcet),
    "eq11_overload": (_eq11, _check_eq11),
    "open_loop": (lambda m: light_cfg(m).open_loop(100.0, seed=1),
                  _check_open_loop),
    "chaos_fault_rate": (lambda m: light_cfg(m).chaos(
        m.api.ChaosPlan(seed=0, stage_fault_rate=0.01)), _check_chaos),
    "reconfigure_splits_epochs": (lambda m: light_cfg(m).reconfigure_at(
        400.0, n_contexts=1, oversubscription=1.0), _check_reconfigure),
    "fail_context_and_scale_out": (lambda m: light_cfg(m).fail_context_at(
        1, 300.0).scale_out_at(600.0), _check_fail_ctx_scale_out),
    "last_context_total_failure": (_last_ctx, _check_last_ctx),
    "brownout": (_brownout, _check_brownout),
    "cluster_fail_device": (_cluster_fail_device, _check_cluster_fail_device),
    "autoscale_floor": (lambda m: light_cfg(m).autoscale(
        0.3, 0.85, min_contexts=1, max_contexts=4), _check_autoscale),
    "vdl_slices": (_slices, _check_slices),
    "fig4_6_light": (fig4_6_light, _check_guaranteed),
    "fig13_light": (fig13_light, _check_guaranteed),
    "fig13_fail_1of4": (fig13_fail_1of4,
                        _check_epochs("build", "fail-device")),
    "cluster_reconfigure_n_gpus": (lambda m: fig13_light(m).reconfigure_at(
        800.0, n_gpus=3), _check_epochs("build", "reconfigure")),
}


@pytest.mark.parametrize("name", sorted(REPORTS))
def test_report_matches_reference(name):
    build, check = REPORTS[name]
    rep = sc.analyze_config(build(PORT), label=name)
    check(rep)
    assert rep.to_json() == REF.sc.analyze_config(build(REF),
                                                  label=name).to_json()


def test_verdict_ordering():
    assert sc.worst_verdict([sc.GUARANTEED, sc.CONDITIONAL]) == \
        sc.CONDITIONAL
    assert sc.worst_verdict([sc.CONDITIONAL, sc.UNSCHEDULABLE]) == \
        sc.UNSCHEDULABLE
    assert sc.worst_verdict([]) == sc.GUARANTEED


def test_worst_speed_lower_bounds_contention_model():
    """The analyzer's independently worst-cased speed never exceeds what
    the port's contention model grants any lane, and equals the
    reference's bound, bit for bit."""
    rng = np.random.default_rng(42)
    dev = PORT.api.DeviceModel(n_units=6.0, bubble=0.3, l2_pressure=0.15)
    ref_dev = REF.api.DeviceModel(n_units=6.0, bubble=0.3, l2_pressure=0.15)
    cm = PORT.contention.ContentionModel(dev)
    for _ in range(100):
        m = int(rng.integers(1, 7))
        nsat = rng.uniform(0.5, 5.0, size=m)
        mf = rng.uniform(0.0, 0.9, size=m)
        share = rng.uniform(0.25, 4.0, size=m)
        actual = cm.rates_seq(list(share), list(nsat), list(mf))
        args = (float(share.sum()), m, float(nsat.max()), float(mf.max()))
        for i in range(m):
            lane = (float(nsat[i]), float(mf[i]), float(share[i]))
            lb = PORT.analyzer._worst_speed(dev, *lane, *args)
            assert lb <= actual[i] + 1e-12
            assert lb == REF.analyzer._worst_speed(ref_dev, *lane, *args)


# ------------------------------------------------------ differential oracle
def _oracle_fields(res):
    return (res.label, res.verdict, res.hp_verdict, res.bound_ms.hex(),
            res.observed_max_ms.hex(), res.dmr_hp.hex(), res.vacuous,
            res.violations, res.report.to_json())


ORACLE = {"light_noisy": lambda m: light_cfg(m, horizon=2000.0).noise(0.06),
          "fig4_6_light": fig4_6_light, "fig13_light": fig13_light,
          "fig13_fail_1of4": fig13_fail_1of4}


@pytest.mark.parametrize("name", sorted(ORACLE))
def test_oracle_ok_and_matches_reference(name):
    res = sc.differential_check(ORACLE[name](PORT), label=name)
    assert res.ok, res.violations
    assert res.observed_max_ms <= res.bound_ms
    assert name in res.render()
    if name != "fig13_fail_1of4":
        assert res.hp_verdict == sc.GUARANTEED and res.dmr_hp == 0.0
        assert not res.vacuous
    ref = REF.sc.differential_check(ORACLE[name](REF), label=name)
    assert _oracle_fields(res) == _oracle_fields(ref)


@pytest.mark.parametrize("name", ["light_noisy", "fig13_light"])
def test_oracle_on_the_epoch_engine_through_the_kernel(name, monkeypatch):
    """The oracle's simulation on ``engine("epoch")`` with every rate-group
    through the contention kernel (its plain version here) returns the
    heap engine's result. (fig13_fail_1of4 runs so on the card, in
    chip_smoke.py's cluster phase.)"""
    from repro_torch.kernels import contention_eta as ce
    monkeypatch.setenv("DARIS_EPOCH_KERNEL_MIN", "1")
    ce.fused.counts.reset()
    res = sc.differential_check(
        ORACLE[name](PORT).engine("epoch", device="cpu"), label=name)
    assert ce.fused.counts.plain_calls > 0
    monkeypatch.delenv("DARIS_EPOCH_KERNEL_MIN")
    heap = sc.differential_check(ORACLE[name](PORT), label=name)
    assert res.ok and _oracle_fields(res) == _oracle_fields(heap)


# ------------------------------------------------------------ facade wiring
def test_duplicate_reconfigure_events_rejected():
    errors = []
    for m in (REF, PORT):
        cfg = light_cfg(m)
        cfg.reconfigure_at(400.0, n_contexts=1)
        cfg.reconfigure_at(400.0, oversubscription=3.0)
        with pytest.raises(ValueError, match="duplicate reconfigure_at") as e:
            m.sc.analyze_config(cfg)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    ok = light_cfg(PORT)
    ok.reconfigure_at(400.0, n_contexts=1)
    ok.reconfigure_at(500.0, oversubscription=3.0)
    assert len(sc.analyze_config(ok).epochs) == 3


def test_server_config_verify_gate():
    ok = light_cfg(PORT)
    assert ok.schedcheck_report is None
    assert ok.verify() is ok
    assert ok.schedcheck_report.hp_verdict == sc.GUARANTEED
    reports = []
    for m in (REF, PORT):
        bad = _wcet(m)
        with pytest.raises(m.sc.UnschedulableError) as ei:
            bad.verify()
        assert ei.value.report.hp_verdict == sc.UNSCHEDULABLE
        bad.verify(enforce=False)          # warn-only keeps the report
        assert bad.schedcheck_report.hp_verdict == sc.UNSCHEDULABLE
        reports.append((str(ei.value), bad.schedcheck_report.to_json()))
    assert reports[0] == reports[1]
    assert issubclass(sc.UnschedulableError, ValueError)


def test_verify_on_a_realtime_config():
    """verify() analyzes a realtime configuration through the sim's
    contention model, before anything is built or calibrated."""
    specs = [make_spec(PORT, "hp", HP, [4.0, 3.0], 50.0),
             make_spec(PORT, "lp", LP, [6.0], 80.0)]
    cfg = (PORT.api.ServerConfig.realtime(device="cpu").tasks(specs)
           .contexts(2).streams(2).oversubscribe(2.0)
           .device(ideal_device(PORT)).horizon_ms(1000.0).seed(0))
    rep = cfg.verify(enforce=False).schedcheck_report
    assert rep.hp_verdict == sc.GUARANTEED
    assert any("realtime backend" in a for a in rep.assumptions)


def test_report_json_roundtrip():
    rep = sc.analyze_config(light_cfg(PORT), label="rt")
    d = json.loads(rep.to_json())
    assert d["label"] == "rt" and d["hp_verdict"] == sc.GUARANTEED
    assert len(d["epochs"]) == 1
    assert {t["task"] for t in d["epochs"][0]["tasks"]} == {"hp", "lp"}
    d2 = json.loads(sc.analyze_config(
        light_cfg(PORT).open_loop(100.0)).to_json())
    hp = [t for t in d2["epochs"][0]["tasks"] if t["task"] == "hp"][0]
    assert hp["wcrt_ms"] is None

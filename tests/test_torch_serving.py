"""The port's serving stack: decision parity with the JAX package's
simulator, sim-vs-realtime parity inside the port, and real staged LM
decode through the port's realtime backend on the CPU.

The port keeps its own copy of the scheduler stack; these tests hold that
copy to the original bit for bit (decision logs, counts and every summary
number), on a fixed-time task set, a batching scenario with stage noise and
random phase offsets, and a chaos scenario.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as ref_api  # noqa: E402
import repro_torch.api as api  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import (BUILDERS, build_model,  # noqa: E402
                                cnn_params_from_jax)
from repro_torch.runtime.backend import RealtimeBackend  # noqa: E402
from repro_torch.serving.engine import (staged_cnn_taskspec,  # noqa: E402
                                        staged_lm_taskspec)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps these tests
    from taking every core from wall-clock tests in other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_spec(mod, name, prio, stage_times, period_ms, n_sat=1.0,
              stage_prefix=None, batch_gain=1.0):
    prefix = stage_prefix or name
    return mod.TaskSpec(
        name=name, period_ms=period_ms, priority=prio,
        stages=[mod.StageProfile(f"{prefix}/s{j}", t, n_sat=n_sat,
                                 mem_frac=0.0, overhead_ms=0.0,
                                 batch_gain=batch_gain)
                for j, t in enumerate(stage_times)])


def ideal_device(mod):
    return mod.DeviceModel(n_units=4.0, bubble=0.0, l2_pressure=0.0)


# ---------------------------------------------------------------- scenarios
def fixed_time(mod, realtime=False):
    """tests/test_api.py's parity set: every completion >= 10 ms from any
    other event, so wall-clock jitter cannot reorder decisions."""
    specs = [make_spec(mod, "hp-a", mod.HP, [40.0, 25.0], 250.0),
             make_spec(mod, "lp-b", mod.LP, [55.0, 35.0], 300.0)]
    if realtime:
        cfg = mod.ServerConfig.realtime(device="cpu")
    else:
        cfg = mod.ServerConfig.sim().noise(0.0)
    return (cfg.tasks(specs).contexts(2).streams(1).oversubscribe(1.0)
            .device(ideal_device(mod)).horizon_ms(580.0)
            .phase_offsets(False).seed(0).record_decisions())


def batching(mod):
    """One model served to three LP tenants whose releases arrive together
    (a recorded trace), beside a periodic HP task, with the sim's
    lognormal stage noise and a random phase offset (so the shared RNG
    stream's draw order is part of what must match)."""
    cfg = mod.ServerConfig.sim().task(
        make_spec(mod, "hp", mod.HP, [6.0, 4.0], 40.0, n_sat=2.0))
    burst = [5.0 + 50.0 * k for k in range(40)]
    for i in range(3):
        cfg.task(make_spec(mod, f"lp{i}", mod.LP, [5.0, 5.0, 3.0], 50.0,
                           n_sat=2.0, stage_prefix="rn", batch_gain=2.5),
                 arrival=mod.TraceArrival(burst))
    return (cfg.contexts(2).streams(2).oversubscribe(2.0)
            .device(mod.DeviceModel(n_units=4.0)).batching(max_batch=4)
            .horizon_ms(2000.0).seed(3).record_decisions())


def chaos(mod):
    plan = mod.ChaosPlan(seed=7, stage_fault_rate=0.2, stall_rate=0.2,
                         stall_ms=8.0, watchdog_kappa=6.0,
                         degradation=mod.DegradationPolicy(
                             check_every_ms=50.0, brownout_enter=0.5,
                             brownout_exit=0.3, emergency_enter=0.8,
                             emergency_exit=0.4))
    specs = [make_spec(mod, "hp", mod.HP, [4.0], 40.0),
             make_spec(mod, "lp0", mod.LP, [6.0], 60.0),
             make_spec(mod, "lp1", mod.LP, [5.0], 50.0)]
    return (mod.ServerConfig.sim().tasks(specs).contexts(2).streams(1)
            .oversubscribe(2.0).device(ideal_device(mod)).horizon_ms(600.0)
            .phase_offsets(False).noise(0.0).seed(0).chaos(plan)
            .sanitize(level=1).record_decisions())


@pytest.mark.parametrize("scenario", [fixed_time, batching, chaos],
                         ids=["fixed_time", "batching", "chaos"])
def test_port_sim_matches_reference_sim_bit_for_bit(scenario):
    ref = scenario(ref_api).build()
    ours = scenario(api).build()
    m_ref, m_ours = ref.run(), ours.run()
    assert ours.decisions == ref.decisions
    assert len(ref.decisions) > 20
    assert m_ours.completed == m_ref.completed
    assert m_ours.rejected == m_ref.rejected
    assert m_ours.response_ms == m_ref.response_ms
    assert m_ours.summary() == m_ref.summary()


def test_chaos_scenario_injects_faults():
    m = chaos(api).build().run()
    assert m.chaos_faults > 0


def test_batching_scenario_coalesces():
    m = batching(api).build().run()
    assert any(b > 1 for b in m.batch_hist)


def test_sim_and_realtime_backends_make_identical_decisions():
    """Twin of tests/test_api.py's parity test through the port's own
    backends: payload-less stages run as sleeps on the realtime one."""
    sim = fixed_time(api).build()
    m_sim = sim.run()
    real = fixed_time(api, realtime=True).build()
    m_real = real.run()
    assert sim.decisions == real.decisions
    assert len(sim.decisions) > 20
    assert m_sim.completed == m_real.completed
    assert m_sim.rejected == m_real.rejected
    assert real.backend.worker_exceptions == 0


def test_realtime_engine_with_staged_lm_decode():
    """Twin of tests/test_system.py's staged-LM realtime test on the
    port's backend (CPU): one decode step per job in 4 stage programs,
    inter-stage state = hidden + KV-cache slices."""
    model = build_model(get_reduced("smollm-135m").replace(n_layers=8),
                        device="cpu")
    spec = staged_lm_taskspec(model, priority=api.HP, jps=10.0, n_stages=4,
                              prompt_len=8, batch=1, tag="-hp", device="cpu")
    srv = (api.ServerConfig.realtime(device="cpu")
           .tasks([spec])
           .contexts(2).oversubscribe(2.0)
           .device(api.DeviceModel(n_units=2.0))
           .horizon_ms(1200.0)
           .build())
    m = srv.run()
    assert m.completed[api.HP] > 0
    assert m.resp_stats(api.HP)["mean"] > 0
    assert srv.backend.worker_exceptions == 0
    times = srv.backend.stage_time_summary()
    assert sorted(times) == [s.name for s in spec.stages]
    assert all(t["n"] > 0 and t["mean_et_ms"] > 0 for t in times.values())


def test_worker_pool_counts_payload_exceptions():
    def boom(_state):
        raise RuntimeError("payload failure")
    spec = api.TaskSpec(name="bad", period_ms=50.0, priority=api.HP,
                        stages=[api.StageProfile("bad/s0", 1.0, n_sat=1.0,
                                                 mem_frac=0.0,
                                                 overhead_ms=0.0,
                                                 payload=boom)])
    srv = (api.ServerConfig.realtime(device="cpu").tasks([spec])
           .contexts(1).streams(1).oversubscribe(1.0)
           .device(ideal_device(api)).horizon_ms(120.0)
           .phase_offsets(False).build())
    srv.run()
    assert srv.backend.worker_exceptions >= 1
    assert "payload failure" in repr(srv.backend.last_worker_exception)


def test_unported_features_name_their_roadmap_item(tmp_path):
    """Nothing is refused any more: the features that named their
    ROADMAP.md item (encdec Q8.4, MLA Q8.3, gemma2's alternation Q8.6)
    build and decode one step on the CPU, an unknown family raises
    ValueError, and checkpointing (Q5), cluster serving (Q6) and verify()
    (Q7) run."""
    spec = make_spec(api, "t", api.HP, [1.0], 10.0)
    cfg = get_reduced("smollm-135m")
    for arch in ("whisper-tiny", "deepseek-v2-236b", "gemma2-27b"):
        model = build_model(get_reduced(arch), device="cpu")
        params = model.init_params(1)
        tok = torch.ones((2, 1), dtype=torch.int64)
        batch = {"tokens": tok, "cache": model.init_cache(2, 2)}
        if model.cfg.family == "encdec":
            batch["enc_out"] = model.encode(params, torch.zeros(
                (2, model.cfg.encoder_frames, model.cfg.d_model)))
        logits, cache = model.decode_step(params, batch)
        assert logits.shape == (2, 1, model.cfg.vocab_size)
        assert torch.isfinite(logits).all()
    with pytest.raises(ValueError, match="family"):
        build_model(cfg.replace(family="rnn"), device="cpu").init_params(0)
    # checkpointing (Q5), cluster serving (Q6) and verify() (Q7) are ported
    srv = api.ServerConfig.sim().task(spec).horizon_ms(50.0).build()
    srv.run()
    path = srv.save_state(str(tmp_path / "sched.msgpack"))
    again = api.ServerConfig.sim().task(spec).horizon_ms(50.0).build()
    again.load_state(path)
    assert (again.scheduler.tasks[0].mret.task_mret()
            == srv.scheduler.tasks[0].mret.task_mret())
    assert api.ServerConfig.cluster(2).task(spec).verify().build()


def test_entry_points_without_device_raise_when_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the entry points default to it")
    cfg = get_reduced("smollm-135m")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.ServerConfig.realtime()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RealtimeBackend()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.ServerConfig.sim().engine("epoch")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.ServerConfig.cluster(2).engine("epoch")
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        staged_lm_taskspec(model, priority=api.HP, jps=10.0)
    for builder in BUILDERS.values():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            builder(width=4)
    cnn = BUILDERS["resnet18"](width=4, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        staged_cnn_taskspec(cnn, priority=api.HP, jps=10.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cnn_params_from_jax({"w": np.zeros((1, 1, 3, 4), np.float32)})

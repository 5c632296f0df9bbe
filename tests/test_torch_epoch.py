"""The port's epoch engine against its heap engine and a live run of the JAX
package's epoch engine, on the CPU.

``ServerConfig.sim().engine("epoch", device="cpu")`` builds the port's
``CudaEpochSimBackend``: a copy of the JAX epoch engine whose rate-groups of
``DARIS_EPOCH_KERNEL_MIN`` lanes or more (2048 by default) go to the port's
contention pass (its plain version on the CPU). Decision logs, counts,
response times and summaries must be identical, bit for bit, to the heap
engine and to the JAX epoch engine on the same scenarios, wherever the
threshold sits. The reference is always a live run: four fixtures of
``tests/golden/engine_golden.json`` no longer match on this interpreter.
"""
import pytest

torch = pytest.importorskip("torch")

import repro.api as ref_api  # noqa: E402
import repro_torch.api as api  # noqa: E402
from repro_torch.kernels import contention_eta as ce  # noqa: E402
from test_torch_serving import batching, chaos, make_spec  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def wide(mod):
    """Many lanes on one device (4 contexts x 6 streams, twelve tasks with
    stage noise) and a brownout window: rate-groups grow past 17 lanes, and
    the brownout divides rates after the pass."""
    specs = [make_spec(mod, f"t{i:02d}", mod.HP if i < 3 else mod.LP,
                       [3.0 + (i % 4), 2.0 + (i % 3)], 12.0 + 2 * i,
                       n_sat=8.0 + i)
             for i in range(12)]
    plan = mod.ChaosPlan(seed=3, stage_fault_rate=0.02,
                         brownouts=(mod.Brownout(60.0, 160.0, device=0,
                                                 slow_factor=2.5),))
    return (mod.ServerConfig.sim().tasks(specs).contexts(4).streams(6)
            .oversubscribe(2.0).device(mod.DeviceModel(n_units=40.0))
            .horizon_ms(300.0).seed(5).chaos(plan).record_decisions())


SCENARIOS = {"batching": batching, "chaos": chaos, "wide": wide}


def run(scenario, mod, engine):
    cfg = scenario(mod)
    if mod is api and engine == "epoch":
        cfg = cfg.engine("epoch", device="cpu")
    else:
        cfg = cfg.engine(engine)
    srv = cfg.build()
    m = srv.run()
    return {"decisions": srv.decisions, "completed": m.completed,
            "rejected": m.rejected, "response_ms": m.response_ms,
            "summary": m.summary()}


@pytest.fixture(scope="module")
def reference():
    """The JAX package's epoch engine, run live once per scenario."""
    return {name: run(sc, ref_api, "epoch") for name, sc in SCENARIOS.items()}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_epoch_matches_heap_and_jax_epoch(name, reference):
    ours = run(SCENARIOS[name], api, "epoch")
    assert len(ours["decisions"]) > 20
    assert ours == run(SCENARIOS[name], api, "heap")
    assert ours == reference[name]


@pytest.mark.parametrize("threshold", [1, 3, 17])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_threshold_sweep_bit_identical(name, threshold, reference,
                                       monkeypatch):
    """Results cannot depend on where the rates_seq/kernel threshold sits;
    at 1 every rate-group goes through the port's contention pass."""
    monkeypatch.setenv("DARIS_EPOCH_KERNEL_MIN", str(threshold))
    ce.fused.counts.reset()
    assert run(SCENARIOS[name], api, "epoch") == reference[name]
    if threshold == 1:
        assert ce.fused.counts.plain_calls > 0


def test_wide_scenario_sends_groups_past_17_lanes(monkeypatch):
    monkeypatch.setenv("DARIS_EPOCH_KERNEL_MIN", "17")
    ce.fused.counts.reset()
    run(wide, api, "epoch")
    assert ce.fused.counts.plain_calls > 0


def test_epoch_engine_builds_the_kernel_backend():
    srv = batching(api).engine("epoch", device="cpu").build()
    assert isinstance(srv.backend, api.CudaEpochSimBackend)
    assert isinstance(srv.backend, api.EpochSimBackend)
    assert srv.backend.device == torch.device("cpu")
    with pytest.raises(ValueError, match="no device"):
        api.ServerConfig.sim().engine("heap", device="cpu")

"""The compiled stage (``repro_torch.serving.stage_graph``) on the CPU.

A ``StageProgram`` keeps static buffers a lane and takes three steps a call
under the lane's lock: copy in, run, copy out. On the card the run is a
CUDA graph's replay; on the CPU the eager call. These tests run that
discipline with both: the CPU's eager call, and ``CpuGraph``, which takes
the card's path (a warm-up call, the capture's launches recorded, static
outputs written in place at each replay, the recorded launches counted
again) except the capture and replay calls themselves.

- Two jobs go stage by stage through the same programs on two lanes (two
  worker threads), interleaved: each job's state (hidden and every cache
  slice, or the CNN's maps) is bit-identical to that job run alone through
  the eager stage functions; no job state shares storage with a
  program's static tensors, and overwriting those leaves every job's
  state as it was.
- Many threads on one lane: the lock keeps each call's copy in, run and
  copy out together.
- A replay adds its capture's launches (by instance and shape) once.
- The payloads still equal the reference's jitted stages: reduced
  smollm-135m within ``test_torch_model.py``'s 1e-4, a reduced ResNet18
  within ``test_torch_cnn.py``'s 2e-4 of the output's scale.
- The lanes are the process's: two programs on one lane never overlap
  (one lock a lane), two lanes run at once, a lane's programs of one
  signature share its static inputs, and a lane's captures go into its
  one graph pool (``PooledCpuGraph``, with a stand-in pool handle).
- A CPU ``RealtimeBackend`` run with real payloads splits every HP job's
  response into parts that sum to it (``hp_response_parts``).
- The card's burst (``_Burst``: its static ends, the call's output block
  and views, the nodes' values it keeps) on the CPU, with byte copies in
  place of the C launch (``ByteGraph``): a repeated LM call takes its
  entry's plan, walks no tree, makes one allocation and equals the
  functional stages bit for bit; an argument of another shape, dtype or
  layout takes an entry of its own (the byte copies would read a stale
  plan's layout wrongly); a ``Constant`` is keyed by identity and copied
  in anew; a call made ready without a lane and then taken on one equals
  ``prepare`` (entry, arguments, block layout, output), also when the
  lane that takes it is not the one it was made on.
"""
import concurrent.futures
import ctypes
import functools
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._pytree import tree_flatten, tree_unflatten  # noqa: E402

import repro.models.cnn as ref_cnn  # noqa: E402
from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving import engine as ref_engine  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels import KERNELS, _lib, reset_counts  # noqa: E402
from repro_torch.models import (BUILDERS, build_model,  # noqa: E402
                                cnn_params_from_jax, params_from_jax)
from repro_torch.serving import stage_graph  # noqa: E402
from repro_torch.serving.engine import (LmStage, lm_stage,  # noqa: E402
                                        staged_cnn_taskspec,
                                        staged_lm_taskspec)

LM_TOL = dict(rtol=1e-4, atol=1e-4)     # test_torch_model.py's
CNN_TOL = 2e-4                          # test_torch_cnn.py's, of the scale
N_STAGES, BATCH, PROMPT = 4, 2, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps these tests from taking
    every core from wall-clock tests in other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class CpuGraph(stage_graph._Graph):
    """The card's run on the CPU but for the capture and the launch: the
    capture records the launches of an eager call, and a run (the launch,
    without the burst's copy and event nodes, which PyTorch's calls stand
    in for) writes the eager call's results into the static outputs
    without counting (the wrappers' Python code never runs at a replay on
    the card)."""

    burst = None

    def _capture(self, fn, args):
        fn(*args)                                   # the warm-up call
        with _lib.recording() as self.log:
            out = fn(*args)
        self.fn, self.args = fn, args
        return out

    def run(self):
        with _lib.recording():
            new = self.fn(*self.args)
        for s, t in zip(self.flat[0], tree_flatten(new)[0]):
            s.copy_(t)
        return self.flat


class CpuGraphProgram(stage_graph.StageProgram):
    def _runner(self, device):
        return CpuGraph


class OneLaneProgram(CpuGraphProgram):
    """Every thread on one lane, as two workers on one stream are."""

    def _lane_of(self, device):
        return "one lane"


def _program(payload):
    return (payload.keywords["program"] if isinstance(
        payload, functools.partial) else payload)


def _with_program(payload, program):
    """``payload`` with ``program`` in place of its stage program (an LM
    payload's keyword, or the CNN payload itself)."""
    if isinstance(payload, functools.partial):
        return functools.partial(payload.func,
                                 **{**payload.keywords, "program": program})
    return program


def _eager(payload):
    """The payload with its functional stage function called directly (an
    LM program's ``fn`` writes its static cache copy in place)."""
    return _with_program(payload, _program(payload).functional)


# ------------------------------------------------------------------ models
@functools.lru_cache(maxsize=None)
def _lm_model():
    return build_model(get_reduced("smollm-135m").replace(n_layers=4),
                       device="cpu")


def _lm_spec():
    model = _lm_model()
    return staged_lm_taskspec(model, priority=api.HP, jps=10.0,
                              n_stages=N_STAGES, prompt_len=PROMPT,
                              batch=BATCH, device="cpu",
                              params=model.init_params(0))


def _cnn_spec(name):
    model = BUILDERS[name](width=8, device="cpu")
    return staged_cnn_taskspec(model, priority=api.HP, jps=10.0,
                               input_hw=33, batch=2, calibrate=False,
                               device="cpu")


def _job_inputs(name, vocab=None):
    """Two jobs' first-stage inputs, made different so that one job's
    result showing up in the other's state is seen."""
    rng = np.random.default_rng(5)
    if name == "smollm-135m":
        return [{"hidden": torch.from_numpy(
                    rng.integers(0, vocab, (BATCH, 1))).to(torch.int32),
                 "slices": {}} for _ in range(2)]
    return [torch.from_numpy(rng.standard_normal((2, 33, 33, 3))
                             .astype(np.float32)) for _ in range(2)]


def _spec(name):
    return _lm_spec() if name == "smollm-135m" else _cnn_spec(name)


def _leaves(state):
    return tree_flatten(state)[0]


def _statics(payloads):
    """Every static tensor the payloads' programs hold: inputs, and the
    outputs a graph's replays write."""
    out = []
    for p in payloads:
        for lane in _program(p)._lanes.values():
            out += lane.inputs
            if isinstance(lane.runner, CpuGraph):
                out += _leaves(lane.runner.out)
    return out


MODELS = ["smollm-135m", "resnet18", "unet"]
PROGRAMS = {"eager": stage_graph.StageProgram, "graph": CpuGraphProgram}


def _interleaved(name, kind):
    """Jobs A and B stage by stage on lanes X and Y (two worker threads):
    A's stage k, then B's stage k, on lane k % 2. Returns the payloads,
    the two jobs' final states and each job run alone eagerly."""
    spec = _spec(name)
    payloads = [_with_program(st.payload, PROGRAMS[kind](
        _program(st.payload).fn,
        functional=_program(st.payload).functional)) for st in spec.stages]
    vocab = _lm_model().cfg.vocab_size if name == "smollm-135m" else None
    first = _job_inputs(name, vocab)
    alone = []
    for x in first:
        for p in payloads:
            x = _eager(p)(x)
        alone.append(x)
    lanes = [concurrent.futures.ThreadPoolExecutor(1) for _ in range(2)]
    try:
        states = list(first)
        for k, p in enumerate(payloads):
            for j in range(2):
                states[j] = lanes[k % 2].submit(p, states[j]).result(
                    timeout=120)
    finally:
        for ex in lanes:
            ex.shutdown()
    return payloads, states, alone


@pytest.mark.parametrize("kind", sorted(PROGRAMS))
@pytest.mark.parametrize("name", MODELS)
def test_interleaved_jobs_equal_each_job_alone_bit_for_bit(name, kind):
    payloads, states, alone = _interleaved(name, kind)
    for got, want in zip(states, alone):
        a, b = _leaves(got), _leaves(want)
        assert len(a) == len(b) and a
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    # the two jobs differ, so neither holds the other's results
    assert not torch.equal(_leaves(states[0])[0], _leaves(states[1])[0])
    if name == "smollm-135m":
        assert sorted(states[0]["slices"]) == list(range(N_STAGES))
    # each stage ran both jobs on one lane, one set of static buffers
    assert [len(_program(p)._lanes) for p in payloads] == [1] * N_STAGES


@pytest.mark.parametrize("kind", sorted(PROGRAMS))
@pytest.mark.parametrize("name", MODELS)
def test_job_state_never_aliases_a_static_buffer(name, kind):
    payloads, states, alone = _interleaved(name, kind)
    statics = _statics(payloads)
    assert statics
    held = {t.untyped_storage().data_ptr() for t in statics}
    for state in states:
        assert not any(t.untyped_storage().data_ptr() in held
                       for t in _leaves(state))
    for t in statics:
        t.fill_(float("nan") if t.is_floating_point() else -7)
    for got, want in zip(states, alone):
        assert all(torch.equal(x, y)
                   for x, y in zip(_leaves(got), _leaves(want)))


def test_many_threads_on_one_lane_keep_their_own_results():
    """Eight threads call one program on one lane (as a ghost worker and a
    new launch share a stream), with a short switch interval: every
    result is its own input's, so no call read another's static inputs
    or outputs between its copy in and its copy out."""
    prog = OneLaneProgram(lambda x, w: {"y": (x @ w).tanh(), "x": x})
    w = torch.randn(16, 16, generator=torch.Generator().manual_seed(0))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def call(i):
            x = torch.full((4, 16), float(i))
            out = [prog(x, w) for _ in range(20)]
            want = (x @ w).tanh()
            return all(torch.equal(o["y"], want) and torch.equal(o["x"], x)
                       for o in out)
        with concurrent.futures.ThreadPoolExecutor(8) as ex:
            ok = list(ex.map(call, range(8), timeout=120))
    finally:
        sys.setswitchinterval(old)
    assert ok == [True] * 8
    assert len(prog._lanes) == 1


def test_replays_add_the_captured_launches_once_each():
    rms, dec = KERNELS["rmsnorm"].counts, KERNELS["decode_attention"].counts

    def stage(x):        # a stage whose wrappers launch three kernels
        rms.launched("block", (1, 4), "M4 D8 float32")
        dec.launched("split", (3, 1, 4), "B4 H2 KV1 Dh8 float32")
        dec.launched("combine", (2, 4), "B4 H2 KV1 Dh8 float32")
        return x * 2.0
    reset_counts()
    prog = CpuGraphProgram(stage)
    x = torch.ones(4, 8)
    for _ in range(5):
        assert torch.equal(prog(x), x * 2.0)
    # the warm-up call launched once; the capture counted nothing; each of
    # the 5 replays added its 3 launches
    assert rms.launches == 1 + 5 and dec.launches == 2 * (1 + 5)
    assert rms.by_instance == {"block": 6}
    assert dec.by_instance == {"split": 6, "combine": 6}
    assert rms.by_shape == {"block M4 D8 float32": 6}
    assert dec.by_shape == {"split B4 H2 KV1 Dh8 float32": 6,
                            "combine B4 H2 KV1 Dh8 float32": 6}
    assert dec.grids == {"split": (3, 1, 4), "combine": (2, 4)}
    g = _lib.stage_graphs.snapshot()
    assert (g["captures"], g["replays"], g["replayed_launches"]) == (1, 5, 15)
    # a second lane captures once more
    other = threading.Thread(target=prog, args=(x,))
    other.start()
    other.join(timeout=60)
    assert not other.is_alive()
    assert _lib.stage_graphs.captures == 2 and _lib.stage_graphs.replays == 6
    assert rms.launches == 6 + 2
    reset_counts()
    assert _lib.stage_graphs.snapshot() == {
        "captures": 0, "capture_s": 0.0, "pools": 0, "replays": 0,
        "replayed_launches": 0}


def test_eager_run_counts_nothing_as_a_graph():
    reset_counts()
    prog = stage_graph.StageProgram(lambda x: x + 1.0)
    prog(torch.zeros(3))
    prog(torch.zeros(3))
    assert _lib.stage_graphs.snapshot()["captures"] == 0
    assert _lib.stage_graphs.snapshot()["replays"] == 0


def test_program_refuses_arguments_that_are_not_tensors():
    prog = stage_graph.StageProgram(lambda x, n: x * n, name="scale")
    with pytest.raises(TypeError, match="scale"):
        prog(torch.ones(2), 3)


def test_realtime_backend_counts_its_stage_runs():
    """On the CPU no stage program captures: the backend's graph summary
    reads no capture and no replay beside the payload stages it ran."""
    spec = _cnn_spec("resnet18")
    srv = (api.ServerConfig.realtime(device="cpu").tasks([spec])
           .contexts(2).streams(2).oversubscribe(2.0)
           .device(api.DeviceModel(n_units=4.0)).realtime_io(input_hw=33,
                                                            batch=2)
           .horizon_ms(400.0).build())
    m = srv.run()
    g = srv.backend.graph_summary()
    assert m.completed[api.HP] > 0
    assert g["stage_runs"] >= sum(
        t["n"] for t in srv.backend.stage_time_summary().values()) > 0
    assert (g["warm_captures"], g["captures"], g["replays"]) == (0, 0, 0)


# --------------------------------------------------- against the reference
def test_lm_payloads_equal_the_reference_jitted_stages():
    """Reduced smollm-135m (4 layers, f32 cache), the reference's
    parameters: the port's payload chain (through its stage programs)
    against the reference's ``staged_lm_taskspec`` payloads (jitted)."""
    jcfg = jax_get_reduced("smollm-135m").replace(n_layers=4,
                                                   kv_cache_dtype="float32")
    jmodel = jax_build_model(jcfg)
    jspec = ref_engine.staged_lm_taskspec(jmodel, priority=api.HP, jps=10.0,
                                          n_stages=N_STAGES,
                                          prompt_len=PROMPT, batch=BATCH)
    tmodel = build_model(get_reduced("smollm-135m").replace(
        n_layers=4, kv_cache_dtype="float32"), device="cpu")
    tparams = params_from_jax(jax.device_get(jmodel.init_params(0)),
                              device="cpu")
    tspec = staged_lm_taskspec(tmodel, priority=api.HP, jps=10.0,
                               n_stages=N_STAGES, prompt_len=PROMPT,
                               batch=BATCH, device="cpu", params=tparams)
    js, ts = None, None
    for jst, tst in zip(jspec.stages, tspec.stages):
        js, ts = jst.payload(js), tst.payload(ts)
        np.testing.assert_allclose(ts["hidden"].numpy(),
                                   np.asarray(js["hidden"]), **LM_TOL)
    for i in range(N_STAGES):
        ref = jax.device_get(js["slices"][i])
        for k in ref:
            np.testing.assert_allclose(ts["slices"][i][k].float().numpy(),
                                       np.asarray(ref[k], np.float32),
                                       **LM_TOL)


def _reference_resnet18():
    """The reference's ResNet18 at width 8 with parameters drawn by numpy
    (as ``test_torch_cnn.py`` draws them: its own initialisers compile a
    program per shape)."""
    rng = np.random.default_rng(0)

    def conv_init(ctx, kh, kw, cin, cout):
        return (rng.standard_normal((kh, kw, cin, cout))
                / np.sqrt(kh * kw * cin)).astype(np.float32)

    def bn_init(ctx, c):
        return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(c)).astype(np.float32)}

    def dense_init(ctx, shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(
            np.float32)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_cnn, "conv_init", conv_init)
        mp.setattr(ref_cnn, "bn_init", bn_init)
        mp.setattr(ref_cnn, "dense_init", dense_init)
        return ref_cnn.BUILDERS["resnet18"](width=8)


def test_cnn_payloads_equal_the_reference_jitted_stages():
    ref = _reference_resnet18()
    jspec = ref_engine.staged_cnn_taskspec(ref, priority=api.HP, jps=10.0,
                                           input_hw=33, batch=2,
                                           calibrate=False)
    port = BUILDERS["resnet18"](width=8, device="cpu")
    tspec = staged_cnn_taskspec(
        port, priority=api.HP, jps=10.0, input_hw=33, batch=2,
        calibrate=False, device="cpu",
        params=cnn_params_from_jax(jax.device_get(ref.params),
                                   device="cpu"))
    x = np.random.default_rng(3).standard_normal((2, 33, 33, 3)).astype(
        np.float32)
    js, ts = jnp.asarray(x), torch.from_numpy(x)
    last = len(tspec.stages) - 1
    for i, (jst, tst) in enumerate(zip(jspec.stages, tspec.stages)):
        js, ts = jst.payload(js), tst.payload(ts)
        r = np.asarray(js)
        p = ts.numpy() if i == last else ts.numpy().transpose(0, 2, 3, 1)
        assert p.shape == r.shape
        err = float(np.abs(r - p).max()) / max(1.0, float(np.abs(r).max()))
        assert err <= CNN_TOL, (i, err)


# ------------------------------------------------------ lanes, pools, parts
class _Recorder:
    """A stage function that records its entries and exits (by program)
    and holds the lane for a moment, so that two calls that could overlap
    do."""

    def __init__(self):
        self.events, self.lock = [], threading.Lock()

    def stage(self, tag):
        def fn(x):
            with self.lock:
                self.events.append(("in", tag))
            time.sleep(0.002)
            with self.lock:
                self.events.append(("out", tag))
            return x + 1.0
        return fn


def _overlaps(events) -> int:
    inside, most = 0, 0
    for kind, _ in events:
        inside += 1 if kind == "in" else -1
        most = max(most, inside)
    return most


def test_two_programs_on_one_lane_share_one_lock():
    """Two programs of one signature, sixteen threads on one lane (as LP
    and HP stages, and a ghost worker, share a stream), with a short switch
    interval: no call of either program runs inside another's copy in, run
    and copy out, and each call returns its own input's result, though
    both programs copy into the same static inputs."""
    rec = _Recorder()
    progs = [OneLaneProgram(rec.stage(t)) for t in "AB"]

    def call(i):
        x = torch.full((3,), float(i))
        return all(torch.equal(progs[i % 2](x), x + 1.0) for _ in range(5))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with concurrent.futures.ThreadPoolExecutor(16) as ex:
            ok = list(ex.map(call, range(16), timeout=120))
    finally:
        sys.setswitchinterval(old)
    assert ok == [True] * 16
    assert _overlaps(rec.events) == 1
    assert {t for _, t in rec.events} == {"A", "B"}
    assert stage_graph.lane("one lane") is stage_graph.lane("one lane")


def test_two_lanes_run_at_once():
    """Programs on two lanes (two threads on the CPU) do not wait for each
    other: both calls are inside their stage function together."""
    both = threading.Barrier(2, timeout=30)
    progs = [stage_graph.StageProgram(lambda x: (both.wait(), x * 2.0)[1])
             for _ in range(2)]
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        outs = list(ex.map(lambda p: p(torch.ones(2)), progs, timeout=60))
    assert all(torch.equal(o, torch.full((2,), 2.0)) for o in outs)


class PooledCpuGraph(CpuGraph):
    """``CpuGraph`` whose capture takes its lane's graph pool, as the card's
    does."""

    def _capture(self, fn, args):
        self.pool = self.lane.graph_pool()
        return super()._capture(fn, args)


class PooledProgram(stage_graph.StageProgram):
    def _runner(self, device):
        return PooledCpuGraph


def test_captures_take_one_graph_pool_a_lane(monkeypatch):
    """Three programs on two lanes (two worker threads): each lane's
    captures go into that lane's one pool, made at its first capture; the
    counts name two pools for six captures."""
    made = iter(range(1000))
    monkeypatch.setattr(torch.cuda, "graph_pool_handle",
                        lambda: (0, 1000 + next(made)))
    reset_counts()
    progs = [PooledProgram(lambda x, k=k: x + k) for k in range(3)]
    lanes = [concurrent.futures.ThreadPoolExecutor(1) for _ in range(2)]
    try:
        for ex in lanes:
            for _ in range(2):
                for p in progs:
                    ex.submit(p, torch.zeros(2)).result(timeout=60)
        pools = [ex.submit(lambda: stage_graph.lane(
            threading.get_ident()).pool).result(timeout=60) for ex in lanes]
    finally:
        for ex in lanes:
            ex.shutdown()
    g = _lib.stage_graphs.snapshot()
    assert g["captures"] == 6 and g["replays"] == 12 and g["pools"] == 2
    assert pools[0] != pools[1]
    assert sorted(_lib.stage_graphs.pool_ids()) == sorted(pools)
    for p in progs:
        assert {st.runner.pool for st in p._lanes.values()} == set(pools)
    assert stage_graph.pool_reserved_bytes([]) == 0
    reset_counts()
    assert _lib.stage_graphs.snapshot()["pools"] == 0


def _served(name):
    if name == "smollm-135m":
        model = _lm_model()
        specs = [staged_lm_taskspec(model, priority=p, jps=10.0,
                                    n_stages=N_STAGES, prompt_len=PROMPT,
                                    batch=BATCH, device="cpu", tag=t,
                                    params=model.init_params(0))
                 for p, t in ((api.HP, "-hp"), (api.LP, "-lp"))]
        io = {}
    else:
        model = BUILDERS[name](width=8, device="cpu")
        specs = [staged_cnn_taskspec(model, priority=p, jps=20.0,
                                     input_hw=33, batch=2, calibrate=False,
                                     device="cpu", tag=t)
                 for p, t in ((api.HP, "-hp"), (api.LP, "-lp"))]
        io = dict(input_hw=33, batch=2)
    cfg = (api.ServerConfig.realtime(device="cpu").tasks(specs).contexts(2)
           .streams(2).oversubscribe(2.0)
           .device(api.DeviceModel(n_units=4.0)).horizon_ms(500.0))
    if io:
        cfg = cfg.realtime_io(**io)
    srv = cfg.build()
    return srv, srv.run()


@pytest.mark.parametrize("name", ["resnet18", "smollm-135m"])
def test_hp_response_parts_sum_to_each_response(name):
    """A CPU ``RealtimeBackend`` run with real payloads: every completed HP
    job has its parts (release -> first launch; a stage's hand-off, stream
    wait, device, notice and gap), none negative, one launch a stage, and
    they sum to the response the engine recorded within 0.01 ms."""
    srv, m = _served(name)
    parts = srv.backend.hp_response_parts(slowest=2)
    resp = m.response_ms[api.HP]
    assert m.completed[api.HP] > 0 and parts["jobs"] == len(resp)
    assert parts["sum_err_ms"] <= 0.01
    assert sorted(r[0] for r in parts["by_job"]) == sorted(resp)
    for row in parts["by_job"]:
        assert abs(sum(row[1:]) - row[0]) <= 0.01
        assert all(np.isfinite(v) and v >= -1e-9 for v in row)
    worst = parts["slowest"][0]
    assert worst["response_ms"] == max(resp)
    assert [s["stage"] for s in worst["stages"]] == list(range(N_STAGES))
    total = sum(parts["total_ms"].values())
    assert abs(total - sum(resp)) <= 0.01 * len(resp)


def test_a_lanes_programs_of_one_signature_share_static_inputs():
    """Static inputs are the lane's, a signature: two programs that take
    the same shapes on one lane copy into the same buffers (as HP and LP
    stages of one model, or equal stages, on a stream); another signature
    or another lane has its own. A lane goes with its programs."""
    import gc
    progs = [OneLaneProgram(lambda x, k=k: x * k) for k in (2.0, 3.0, 5.0)]
    for p in progs[:2]:
        assert torch.equal(p(torch.ones(4)), torch.ones(4) * p.fn(1.0))
    assert torch.equal(progs[2](torch.ones(2, 2)), torch.full((2, 2), 5.0))
    (a,), (b,), (c,) = (list(p._lanes.values()) for p in progs)
    assert a.inputs is b.inputs and a.inputs is not c.inputs
    assert a.lane is b.lane is c.lane is stage_graph.lane("one lane")
    # the shared buffer holds the last call's input, and each program
    # still returns its own result for its own input
    assert torch.equal(progs[0](torch.full((4,), 7.0)),
                       torch.full((4,), 14.0))
    assert torch.equal(a.inputs[0], torch.full((4,), 7.0))
    other = threading.Thread(target=stage_graph.StageProgram.__call__,
                             args=(progs[0], torch.ones(4)))
    other.start()
    other.join(timeout=60)
    assert len(progs[0]._lanes) == 1         # every thread on one lane
    del p, progs, a, b, c
    gc.collect()
    assert "one lane" not in stage_graph._lanes
    fresh = stage_graph.lane("one lane")
    assert fresh.pool is None and not len(fresh.inputs)


def test_a_repeated_call_builds_no_signature_string(monkeypatch):
    """A call keys its lane's static inputs by the arguments' structure,
    shapes, dtypes and devices without string work: once a signature has
    its static inputs, a call of it renders no tree spec; another
    structure or shape is another signature, with its own inputs, and
    each returns its own input's result."""
    from torch.utils import _pytree
    prog = OneLaneProgram(lambda h, s: (h + 1.0, {k: v * 2.0
                                                  for k, v in s.items()}))
    h, s = torch.ones(2), {"k": torch.ones(3), "v": torch.zeros(3)}
    prog(h, s)

    def refused(self):
        raise AssertionError("a repeated call rendered its tree spec")
    monkeypatch.setattr(_pytree.TreeSpec, "__str__", refused)
    monkeypatch.setattr(_pytree.TreeSpec, "__repr__", refused)
    out_h, out_s = prog(h + 1.0, {"k": torch.full((3,), 3.0), "v": s["v"]})
    assert torch.equal(out_h, torch.full((2,), 3.0))
    assert torch.equal(out_s["k"], torch.full((3,), 6.0))
    monkeypatch.undo()
    prog(h, {"v": s["v"], "k": s["k"]})            # keys in another order
    prog(torch.ones(4), s)                          # another shape
    assert len(prog._lanes) == 3
    assert len({id(st.inputs) for st in prog._lanes.values()}) == 3


# ------------------------------------------ the card's burst, on the CPU
class _Handle:
    """An event as the burst hands it to its launch: its handle."""

    def __init__(self):
        self.cuda_event = id(self)


class ByteGraph(stage_graph._Graph):
    """The card's burst on the CPU: the call goes through ``_Burst`` as on
    the card (its static ends, the call's output block and its views, the
    nodes' values it keeps), and ``launch`` stands in for the C launch:
    the node updates it would make (those whose value moved, recorded in
    ``updates``), then byte copies in (``ctypes.memmove``, bytes and not
    elements, as a copy node copies), the stage function on the static
    inputs with its results written into the static outputs (uncounted,
    as a replay), and byte copies out."""

    def _capture(self, fn, args):
        warm = tree_flatten(fn(*args))[0]
        with _lib.recording() as self.log:
            leaves, spec = tree_flatten(fn(*args))
        self.static_out = [o if stage_graph._dense(o) else o.contiguous()
                           for o in leaves]
        self.fn, self.args, self.updates = fn, args, []
        ends = ([torch.empty_like(t) for t in self.inputs],
                [torch.empty_like(t) for t in warm])
        n = 2 + sum(1 for t in (*self.inputs, *self.static_out) if t.nbytes)
        self.burst = stage_graph._Burst(
            self.launch, None, list(range(n)), [_Handle(), _Handle()],
            self.inputs, self.static_out, spec, ends)
        return tree_unflatten(self.static_out, spec)

    def launch(self, stream, graph_exec, nodes, n_in, n_out, start, end,
               src_in, dst_in, src_out, out_base, out_off, nbytes, last,
               stamps):
        values = ([start, end] + [src_in[i] for i in range(n_in)]
                  + [out_base + out_off[i] for i in range(n_out)])
        moved = [i for i, v in enumerate(values) if last[i] != v]
        for i in moved:
            last[i] = values[i]
        self.updates.append(moved)
        for i in range(n_in):
            ctypes.memmove(dst_in[i], src_in[i], nbytes[i])
        with _lib.recording():
            new = tree_flatten(self.fn(*self.args))[0]
        for s, t in zip(self.static_out, new):
            s.copy_(t)
        for i in range(n_out):
            ctypes.memmove(out_base + out_off[i], src_out[i],
                           nbytes[n_in + i])
        stamps[0] = stamps[1] = time.perf_counter()
        return 0


class ByteProgram(stage_graph.StageProgram):
    """A program on the emulated burst, a lane a thread keyed as a card
    lane is (device, stream)."""

    def _runner(self, device):
        return ByteGraph

    def _lane_of(self, device):
        return (0, threading.get_ident())


def _byte_lm_payloads():
    """The reduced staged LM's payloads (``LmStage``) with their programs
    on the emulated burst."""
    out = []
    for st in _lm_spec().stages:
        kw = st.payload.keywords
        prog = ByteProgram(kw["program"].fn,
                           functional=kw["program"].functional)
        out.append(LmStage(lm_stage, **{**kw, "program": prog}))
    return out


def test_a_repeated_lm_call_takes_its_plan_and_equals_the_functional_stages(
        monkeypatch):
    """Three jobs through the reduced staged LM on the emulated burst:
    each job's state (hidden and every cache slice) is bit-identical to
    the functional stages'; each stage captured once. After a stage's
    first call, a call walks no tree (no ``tree_flatten``, ``_expand`` or
    static inputs looked up), makes one allocation (its output block), and
    sets no event node and none of the donor slice's copy nodes: only the
    hidden state's and the outputs' move."""
    payloads = _byte_lm_payloads()
    vocab = _lm_model().cfg.vocab_size
    rng = np.random.default_rng(11)
    firsts = [{"hidden": torch.from_numpy(rng.integers(
        0, vocab, (BATCH, 1))).to(torch.int32), "slices": {}}
        for _ in range(3)]
    reset_counts()
    allocs = []

    def run(x, counted):
        for p in payloads:
            if counted:
                made = []
                with monkeypatch.context() as mp:
                    for name in ("empty", "empty_like", "zeros"):
                        real = getattr(torch, name)
                        mp.setattr(torch, name, lambda *a, _r=real, **k: (
                            made.append(1), _r(*a, **k))[1])
                    call = p.prepare(x)
                allocs.append(len(made))
            else:
                call = p.prepare(x)
            call.issue()
            x = call.result()
        return x

    states = [run(firsts[0], False)]

    def refused(*a, **k):
        raise AssertionError("a repeated call walked a tree")
    with monkeypatch.context() as mp:
        for name in ("tree_flatten", "tree_unflatten", "_expand"):
            mp.setattr(stage_graph, name, refused)
        mp.setattr(stage_graph.Lane, "static_inputs", refused)
        states += [run(x, True) for x in firsts[1:]]
    assert allocs == [1] * (2 * N_STAGES)
    for x, got in zip(firsts, states):
        want = x
        for p in payloads:
            want = _eager(p)(want)
        a, b = _leaves(got), _leaves(want)
        assert len(a) == len(b) == 1 + 4 * N_STAGES
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(states[0]["hidden"], states[1]["hidden"])
    assert _lib.stage_graphs.captures == N_STAGES
    assert _lib.stage_graphs.replays == 3 * N_STAGES
    for p in payloads:
        (st,) = p.keywords["program"]._lanes.values()
        burst, updates = st.runner.burst, st.runner.updates
        donor = list(range(3, 2 + burst.n_in))      # after events, hidden
        assert set(updates[0]) >= set(donor)        # the capture's ends
        for moved in updates[1:]:
            assert not {0, 1} & set(moved) and not set(donor) & set(moved)


def test_an_argument_of_another_layout_takes_its_own_entry():
    """On the emulated burst, whose copies move bytes: an argument whose
    shape, dtype or strides differ from every entry's takes an entry of
    its own (a permuted dense one among them, whose bytes a contiguous
    entry would read in the wrong order) and its own result; a non-dense
    one is copied into its dense static input's layout first; a repeat
    takes its entry again."""
    prog = ByteProgram(lambda x: x * 2.0 + 1.0, name="affine")

    def layouts(x):
        return [x, x.t().contiguous().t(), x.double(), x.reshape(4, 3),
                x[:, ::2]]
    x = torch.arange(12.0).reshape(3, 4)
    for i, y in enumerate(layouts(x)):
        out = prog(y)
        assert torch.equal(out, y * 2.0 + 1.0), i
        assert len(prog._lanes) == i + 1
    assert [st.relayout for st in prog._lanes.values()] == [[]] * 4 + [[0]]
    for y in layouts(x + 1.0):
        assert torch.equal(prog(y), y * 2.0 + 1.0)
    assert len(prog._lanes) == 5


def test_a_constant_is_taken_by_identity_and_copied_in_anew():
    """A ``Constant`` argument: its calls share one entry and never walk
    it; new values written into its tensors reach the next call; another
    ``Constant`` of the same structure takes an entry of its own that
    shares the lane's static inputs."""
    prog = ByteProgram(lambda h, c: (h + c["a"], {"b": c["b"] * h.sum()}))
    tree = {"a": torch.ones(3), "b": torch.arange(4.0)}
    const = stage_graph.Constant(tree)
    h = torch.full((3,), 2.0)
    out = prog(h, const)
    assert torch.equal(out[0], h + 1.0)
    tree["a"].fill_(5.0)
    out = prog(h, const)
    assert torch.equal(out[0], h + 5.0)
    assert torch.equal(out[1]["b"], torch.arange(4.0) * 6.0)
    assert len(prog._lanes) == 1
    prog(h, stage_graph.Constant({"a": torch.zeros(3),
                                  "b": torch.zeros(4)}))
    a, b = prog._lanes.values()
    assert len(prog._lanes) == 2 and a.inputs is b.inputs


# ------------------------------------ a call made ready, then on its lane
def _byte_cnn_payloads():
    """The small ResNet18's stage programs on the emulated burst."""
    return [ByteProgram(st.payload.fn, name=st.name)
            for st in _cnn_spec("resnet18").stages]


@pytest.mark.parametrize("name", ["resnet18", "smollm-135m"])
def test_ready_and_its_lane_step_equal_prepare(name):
    """Two jobs through a small CNN chain and a reduced staged LM chain on
    the emulated burst, each stage's call made ready on the previous
    stage's output (``ready``) and then taken on its lane (``call``): the
    same static entry, the same flattened arguments and a block of the
    same layout as ``prepare`` on the same input, and the same output bit
    for bit, which is the functional stages' (the CNN within 2e-4 of the
    scale); the output a ready call gives before its launch is the tree
    its result returns; a call made ready before any lane has an entry of
    its signature holds no block and knows no output ahead, and its lane's
    step makes the block."""
    if name == "smollm-135m":
        payloads = _byte_lm_payloads()
        firsts = _job_inputs(name, _lm_model().cfg.vocab_size)
    else:
        payloads = _byte_cnn_payloads()
        firsts = _job_inputs(name)
    for job, x in enumerate(firsts):
        want = x
        for p in payloads:
            prog = _program(p)
            r = p.ready(x)
            assert (r.block is None) == (job == 0)
            ahead = r.output()              # before the call is launched
            assert (ahead is None) == (job == 0)
            call = r.call()
            again = p.prepare(x)
            assert call.static is again.static
            assert len(call.flat) == len(again.flat)
            assert all(a is b for a, b in zip(call.flat, again.flat))
            layout = call.static.runner.burst.layout
            assert prog._layouts[r.sig] is layout
            assert job == 0 or (r.layout is layout
                                and call.block is r.block)
            for a, b in ((call.block, again.block),):
                assert (a.shape, a.dtype, a.stride()) == (
                    b.shape, b.dtype, b.stride())
                assert a.data_ptr() != b.data_ptr()
            call.issue()
            again.issue()
            got, ref = call.result(), again.result()
            assert ahead is None or got is ahead
            assert all(torch.equal(u, v)
                       for u, v in zip(_leaves(got), _leaves(ref)))
            x, want = got, _eager(p)(want)
        a, b = _leaves(x), _leaves(want)
        assert len(a) == len(b)
        for u, v in zip(a, b):
            if name == "smollm-135m":
                assert torch.equal(u, v)
            else:
                scale = max(1.0, float(v.abs().max()))
                assert float((u - v).abs().max()) <= CNN_TOL * scale


@pytest.mark.parametrize("name", ["resnet18", "smollm-135m"])
def test_a_chain_made_before_its_stages_run_equals_the_prepared_chain(
        name):
    """On the emulated burst, a job's calls made ready as one chain before
    any of its stages runs, each on the output the one before will give
    (``ReadyCall.output``: views of its block), then launched in turn:
    each stage's result is the very tree the next call was made on, and
    the job's final state equals the prepared chain's bit for bit."""
    payloads = (_byte_lm_payloads() if name == "smollm-135m"
                else _byte_cnn_payloads())
    firsts = (_job_inputs(name, _lm_model().cfg.vocab_size)
              if name == "smollm-135m" else _job_inputs(name))
    want = firsts[0]
    for p in payloads:                  # each lane's entry, and the reference
        call = p.prepare(want)
        call.issue()
        want = call.result()
    x, chain = firsts[1], []
    for p in payloads:
        chain.append(p.ready(x))
        x = chain[-1].output()
        assert x is not None
    ref = firsts[1]
    for p in payloads:
        call = p.prepare(ref)
        call.issue()
        ref = call.result()
    for r, nxt in zip(chain, chain[1:] + [None]):
        call = r.call()
        call.issue()
        got = call.result()
        assert got is r.output()
        if nxt is not None:
            assert nxt.args[0] is got or nxt.args[0] is got["hidden"]
    a, b = _leaves(got), _leaves(ref)
    assert len(a) == len(b) > 0
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_a_ready_block_made_on_one_lane_launches_on_another():
    """A call made ready on one lane (a worker thread, as on the card the
    stream of the stage before it) and taken on another: the other
    lane's entry of the signature shares the first's layout, takes the
    ready block as its output and gives the stage's result; a ready call
    whose layout is not its entry's takes a block of the entry's own."""
    import copy
    prog = ByteProgram(lambda x: (x * 2.0, x.sum(0)), name="two")
    lane_a = concurrent.futures.ThreadPoolExecutor(1)
    lane_b = concurrent.futures.ThreadPoolExecutor(1)

    def take(r):
        call = r.call()
        call.issue()
        return call, call.result()
    try:
        x = torch.arange(6.0).reshape(2, 3)
        for lane in (lane_a, lane_b):
            lane.submit(prog, x).result(timeout=60)
        a, b = prog._lanes.values()
        assert a.runner.burst.layout is b.runner.burst.layout
        for k in range(3):
            y = x + k
            r = lane_a.submit(prog.ready, y).result(timeout=60)
            call, (twice, total) = lane_b.submit(take, r).result(timeout=60)
            assert call.static is b and call.block is r.block
            assert torch.equal(twice, y * 2.0)
            assert torch.equal(total, y.sum(0))
        r = prog.ready(x)
        r.layout = copy.copy(r.layout)
        call, (twice, _) = lane_b.submit(take, r).result(timeout=60)
        assert call.block is not r.block and torch.equal(twice, x * 2.0)
    finally:
        lane_a.shutdown()
        lane_b.shutdown()


def test_a_stage_that_takes_its_ready_call_launches_before_any_stream_use():
    """The realtime backend on the stand-in seam with its stage programs
    on the emulated burst (the card's path but for the C launch), whose
    outputs are known before they run: a HP job's calls are made ready as
    one chain before its first stage (each on the output the one before
    will give), so its stages launch their graphs with no lane stream
    made current (the launch names its stream) and nothing made ready
    between them; each stage's output is the tree the next call was made
    on; the job done, the next job's chain is made, with no lane stream
    either. A stage that resolves at its boundary (another input
    factory) makes the stream current first. Each stage gives its input
    plus one."""
    from tests.test_torch_inline_dispatch import (WallEvent, WallSeam,
                                                  _ready_backend, _stage)
    from repro_torch.core.task import Job
    log, events = [], {}

    class LoggingSeam(WallSeam):
        """Its events have handles, which the emulated launch records."""

        def use(self, stream):
            log.append("use")
            return super().use(stream)

        def event(self):
            ev = WallEvent(self)
            ev.cuda_event = id(ev)
            events[ev.cuda_event] = ev
            return ev

    class LoggedGraph(ByteGraph):
        def launch(self, stream, graph_exec, nodes, n_in, n_out, start,
                   end, *rest):
            log.append("launch")
            for ev in (start, end):     # the burst's own at a bare call
                if ev in events:
                    events[ev].record()
            return super().launch(stream, graph_exec, nodes, n_in, n_out,
                                  start, end, *rest)

    class LoggedProgram(ByteProgram):
        def _runner(self, device):
            return LoggedGraph

    be, task, instance = _ready_backend(LoggingSeam(),
                                        program=LoggedProgram)
    try:
        job = Job(task, 0.0)
        chain = be._ready0[task.index]
        assert [r.stage for r in chain] == [0, 1]
        assert chain[1].src is chain[0].call.output()
        for stage in (0, 1):
            log.clear()
            steps = _stage(be, (stage, 0), instance(job, stage))
            assert "lookup" in steps and log == ["launch"]
            x = be._job_state[job.job_id]
            assert x is chain[stage].call.output()
            assert torch.equal(x, torch.full((1, 2, 2, 3), stage + 1.0))
        assert task.index not in be._ready0
        be.on_job_done(job)
        assert [r.stage for r in be._ready0[task.index]] == [0, 1]
        assert log == ["launch"]
        be.input_factory = lambda j: torch.full((1, 2, 2, 3), 5.0)
        log.clear()
        steps = _stage(be, (0, 0), instance(Job(task, 0.0), 0))
        assert "resolve" in steps and log[:2] == ["use", "launch"]
        assert be.ready_summary()["discarded"]["factory"]["s0"] == 1
    finally:
        be.stop()
    assert be.worker_exceptions == 0


@pytest.mark.parametrize("reason", ["killed", "ctx_failed"])
def test_a_broken_chain_is_discarded_whole_and_its_stages_resolve(reason):
    """A three-stage HP job on the emulated burst, its chain made ready
    before its first stage: a watchdog's kill of its first stage, or the
    failure of the context it runs on, discards the rest of the chain
    (two calls, counted under the reason); the relaunched stage and the
    job's later stages resolve at their boundary (no call is made ready
    between a job's stages); every stage gives its input plus one."""
    from tests.test_torch_inline_dispatch import (WallSeam, _drain,
                                                  _ready_backend, _stage)
    from repro_torch.core.task import Job

    class HandledSeam(WallSeam):
        def event(self):
            ev = super().event()
            ev.cuda_event = id(ev)
            ev.record()
            return ev

    be, task, instance = _ready_backend(HandledSeam(), n_stages=3,
                                        program=ByteProgram)
    try:
        job = Job(task, 0.0)
        inst = instance(job, 0)
        be.launch((1, 0), inst)
        assert [r.stage for r in be._ready[job.job_id][1]] == [1, 2]
        if reason == "killed":
            be.kill_lane((1, 0), inst)           # a watchdog's ghost
        else:
            be.cancel_ctx(1)                     # its context failed
        assert job.job_id not in be._ready
        _drain(be, be.now_ms() + 2000.0)
        for stage in (0, 1, 2):
            steps = _stage(be, (0, 0), instance(job, stage))
            assert "resolve" in steps and "lookup" not in steps
            assert job.job_id not in be._ready
        x = be._job_state[job.job_id]
        assert torch.equal(x, torch.full((1, 2, 2, 3), 3.0))
    finally:
        be.stop()
    ready = be.ready_summary()
    assert ready["discarded"][reason] == {"s0": 0, "later": 2}
    assert not any(sum(by.values()) for r, by in ready["discarded"].items()
                   if r != reason)
    for w in ("s0", "later"):
        assert ready["made"][w] == (ready["used"][w] + ready["left"][w]
                                    + sum(by[w] for by in
                                          ready["discarded"].values()))
    assert be.worker_exceptions == 0

"""The realtime backend's inline path on the CPU: on the card every stage
is enqueued on the engine thread under its lane's stream and harvested by
polling its end event (a chaos stall delays its enqueue, a synthetic
stage ends at the poll after its ``t_alone``), and the lanes are warmed
there; the worker pool (the host path) is the CPU's.

The card's streams and events come from one seam (``CudaSeam``). Here a
stand-in takes its place: a "stream" is the wall-clock instant its queued
work ends, a payload adds its stage's ``t_alone`` to the current stream,
and an event recorded on a stream completes when the stream's work
before it has. The engine thread, the poll, the harvest and every stamp
are the production code's. The default input is made once at the start,
a leading size at a time, and shared by every job; a caller's factory is
called for each.
"""
import contextlib
import threading
import time

import pytest

torch = pytest.importorskip("torch")

import repro_torch.api as api  # noqa: E402
from repro_torch.core.task import Job, StageInstance  # noqa: E402
from repro_torch.runtime.backend import RESPONSE_PARTS  # noqa: E402
from tests.test_torch_serving import fixed_time  # noqa: E402

PARTS_TOL_MS = 0.01       # an HP job's parts against its response


class WallStream:
    """A lane's stream: ``free_at`` is the perf_counter second its queued
    work ends."""

    def __init__(self):
        self.free_at = 0.0

    def synchronize(self):
        wait = self.free_at - time.perf_counter()
        if wait > 0:
            time.sleep(wait)


class WallEvent:
    def __init__(self, seam):
        self.seam, self.t = seam, None

    def record(self, stream=None):
        stream = stream or self.seam.current
        now = time.perf_counter()
        self.t = max(now, stream.free_at) if stream is not None else now

    def query(self):
        return time.perf_counter() >= self.t

    def synchronize(self):
        wait = self.t - time.perf_counter()
        if wait > 0:
            time.sleep(wait)

    def elapsed_time(self, other):
        return (other.t - self.t) * 1000.0


class WallSeam:
    """Stand-in for ``CudaSeam``: streams, the stream context, events
    (which a host-path worker also waits for) on the host's clock, and
    lane keys."""

    def __init__(self):
        self.current = None

    def stream(self):
        return WallStream()

    @contextlib.contextmanager
    def use(self, stream):
        prev, self.current = self.current, stream
        try:
            yield
        finally:
            self.current = prev

    def event(self):
        return WallEvent(self)

    def lane_key(self, stream):
        """No stage-program lane: on the CPU a program's lane is the
        calling thread."""
        return None

    def work(self, ms: float):
        """A payload's device time: ``ms`` more of the current stream."""
        s = self.current
        s.free_at = max(time.perf_counter(), s.free_at) + ms / 1000.0


def with_payloads(cfg, seam):
    """Every stage of ``cfg``'s tasks gets a payload that keeps its lane
    busy for its ``t_alone`` and hands its input on."""
    for spec in cfg._specs:
        for st in spec.stages:
            def payload(x, ms=st.t_alone_ms):
                seam.work(ms)
                return x
            st.payload = payload
    return cfg


def slowed(cfg, k: float = 2.0):
    """``cfg`` with every period, stage time and the horizon ``k`` times
    longer: the fixed-time scenario keeps 10 ms between events, and a
    loaded CPU has been seen to keep the polling engine thread off it for
    8 ms."""
    for spec in cfg._specs:
        spec.period_ms *= k
        for st in spec.stages:
            st.t_alone_ms *= k
    cfg._horizon_ms *= k
    return cfg


def on_stand_in(srv, seam):
    """The server's backend on the stand-in seam, with every submission
    to the pool and every inline enqueue recorded as (path, instance)."""
    be = srv.backend
    be._seam = seam
    paths = []
    submit, enqueue = be._pool.submit, be._enqueue

    def counted_submit(fn, lane, inst):
        if inst is not None:
            paths.append(("pool", inst))
        return submit(fn, lane, inst)

    def counted_enqueue(rec, stream):
        paths.append(("inline", rec.inst))
        return enqueue(rec, stream)
    be._pool.submit, be._enqueue = counted_submit, counted_enqueue
    return paths


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_inline_path_makes_the_simulators_decisions():
    """The fixed-time scenario (at twice its times) with a payload on
    every stage: every stage inline, none to the pool, decisions identical
    to the simulator's, and each HP job's parts sum to its response."""
    sim = slowed(fixed_time(api)).build()
    m_sim = sim.run()
    seam = WallSeam()
    real = with_payloads(slowed(fixed_time(api, realtime=True)),
                         seam).build()
    paths = on_stand_in(real, seam)
    m_real = real.run()
    assert real.decisions == sim.decisions and len(sim.decisions) > 20
    assert m_real.completed == m_sim.completed
    assert m_real.rejected == m_sim.rejected
    be = real.backend
    assert paths and {p for p, _ in paths} == {"inline"}
    assert be.worker_exceptions == 0 and not be._pool._threads
    assert be.stage_runs == len(paths) and be.pool_stage_runs == 0
    assert be.warm_s > 0 and len(be._streams) == 2
    parts = be.hp_response_parts()
    assert parts["jobs"] == len(m_real.response_ms[api.HP]) > 0
    assert parts["sum_err_ms"] <= PARTS_TOL_MS
    # the engine's own delay to the stage's start, and the poll that saw
    # the stage's end, which lies within the notice
    for job in parts["slowest"]:
        for st in job["stages"]:
            assert st["hand_off"] >= 0.0
            assert 0.0 <= st["sync_wake"] <= st["notice"] + 1e-9


def test_stalls_and_synthetic_stages_stay_on_the_engine_thread():
    """With a chaos stall on half the launches and a task whose stage has
    no payload: nothing goes to the pool; a stage begins at its launch, or
    once its stall has passed; every payload stage begun is enqueued
    inline, and a synthetic stage ends no sooner than its ``t_alone``
    after it began."""
    seam = WallSeam()
    specs = [api.TaskSpec(name=n, period_ms=40.0, priority=p, stages=[
        api.StageProfile(f"{n}/s{j}", t, n_sat=1.0, mem_frac=0.0,
                         overhead_ms=0.0) for j, t in enumerate(ts)])
        for n, p, ts in (("hp", api.HP, [3.0, 2.0]),
                         ("lp", api.LP, [4.0, 3.0]))]
    synthetic = api.TaskSpec(name="synthetic", period_ms=60.0,
                             priority=api.LP, stages=[api.StageProfile(
                                 "synthetic/s0", 2.0, n_sat=1.0,
                                 mem_frac=0.0, overhead_ms=0.0)])
    cfg = (api.ServerConfig.realtime(device="cpu").tasks(specs)
           .contexts(2).streams(2).oversubscribe(2.0)
           .device(api.DeviceModel(n_units=4.0)).horizon_ms(400.0)
           .phase_offsets(False).seed(0)
           .chaos(api.ChaosPlan(seed=3, stall_rate=0.5, stall_ms=2.0)))
    with_payloads(cfg, seam)
    cfg.task(synthetic)
    srv = cfg.build()
    paths = on_stand_in(srv, seam)
    be = srv.backend
    draws, stalled, begun, ended = [], {}, [], []
    draw, launch = srv.core._chaos.draw_launch, be.launch
    begin, synthetic_done = be._begin, be._synthetic_done

    def launched(lane, inst):
        launch(lane, inst)
        stalled[id(inst)] = draws[-1]

    def recorded():
        cfail, stall = draw()
        draws.append(stall)
        return cfail, stall

    def begun_(rec):
        begun.append((rec.inst, (time.perf_counter() - rec.t0) * 1000.0))
        return begin(rec)

    def ended_(rec):
        synthetic_done(rec)
        ended.append(rec.stamps["dev_end"] - rec.stamps["dev_start"])
    srv.core._chaos.draw_launch = recorded
    be.launch, be._begin, be._synthetic_done = launched, begun_, ended_
    m = srv.run()
    assert sum(m.completed.values()) > 0
    assert {p for p, _ in paths} == {"inline"} and not be._pool._threads
    assert be.pool_stage_runs == 0 and be.worker_exceptions == 0
    assert len(begun) <= len(stalled)
    for inst, late in begun:
        assert (late >= 2.0) == (stalled[id(inst)] > 0)
    assert {stalled[id(inst)] > 0 for inst, _ in begun} == {True, False}
    assert [i for p, i in paths] == [
        i for i, _ in begun if i.profile.payload is not None]
    assert ended and min(ended) >= 2.0
    assert be.stage_time_summary()["synthetic/s0"]["n"] == len(ended)
    assert be.hp_response_parts()["sum_err_ms"] <= PARTS_TOL_MS


def _warm_server(seam, fail_first=False):
    """A server on the stand-in (2 contexts x 2 streams) whose tasks "a"
    (two stages) and "b" have payloads that record (thread, stream, stage)
    and a task with a synthetic stage; ``fail_first``: "a"'s first stage
    raises at its first call. Returns the server and the record."""
    calls = []

    def profile(name, ms):
        return api.StageProfile(name, ms, n_sat=1.0, mem_frac=0.0)
    specs = [api.TaskSpec(name=n, period_ms=100.0, priority=p,
                          stages=[profile(f"{n}/s{j}", 1.0)
                                  for j in range(k)])
             for n, p, k in (("a", api.HP, 2), ("b", api.LP, 1))]
    for spec in specs:
        for st in spec.stages:
            def payload(x, name=st.name):
                calls.append((threading.get_ident(), id(seam.current),
                              name))
                if fail_first and len(calls) == 1:
                    raise RuntimeError("warm-up failure")
                return x
            st.payload = payload
    specs.append(api.TaskSpec(name="synthetic", period_ms=100.0,
                              priority=api.LP,
                              stages=[profile("synthetic/s0", 1.0)]))
    srv = (api.ServerConfig.realtime(device="cpu").tasks(specs)
           .contexts(2).streams(2).oversubscribe(2.0)
           .device(api.DeviceModel(n_units=4.0)).build())
    srv.backend._seam = seam
    srv.backend.bind(srv.core)
    return srv, calls


def _chains(be, lanes):
    """The warm-up's calls: each payload task's chain on each lane's
    stream, on this thread."""
    return _stream_chains([be._streams[ln] for ln in lanes])


def _stream_chains(streams):
    """Each payload task's chain on each of ``streams``, on this thread."""
    me = threading.get_ident()
    return [(me, id(s), name) for s in streams
            for name in ("a/s0", "a/s1", "b/s0")]


def test_warm_lanes_runs_every_task_twice_a_lane_on_the_engine_thread():
    """The backend's start on the card: the engine thread runs each
    payload task's chain on every lane's stream, once to capture and once
    more after every lane's captures; a task with a synthetic stage is not
    run, and no worker is started."""
    seam = WallSeam()
    srv, calls = _warm_server(seam)
    be = srv.backend
    be.start()
    be.stop()
    lanes = be._live_lanes()
    assert len(lanes) == 4 and len(be._streams) == 4
    assert calls == _chains(be, lanes) * 2
    assert be.warm_s > 0 and not be._pool._threads
    assert be.worker_exceptions == 0


def test_warm_lanes_survives_a_raising_payload(capsys):
    """A warm-up payload that raises (on the card: out of memory, a bad
    model) counts as one payload exception and loses that lane's chain;
    the warm-up goes on to every other lane's, and serving goes on."""
    seam = WallSeam()
    srv, calls = _warm_server(seam, fail_first=True)
    be = srv.backend
    be.start()
    be.stop()
    want = _chains(be, be._live_lanes()) * 2
    assert calls == want[:1] + want[3:]
    assert be.worker_exceptions == 1
    assert "warm-up failure" in repr(be.last_worker_exception)
    assert "stage warm-up on lane" in capsys.readouterr().err


def test_reconfigure_warms_the_new_lanes_before_their_first_launch():
    """A reconfigure that adds lanes (4 -> 6): the new lanes take the
    retired lanes' 4 streams, and the engine thread makes and warms only
    the 2 streams beyond those (their chains, then once more on every
    stream of the run) and counts the warm-up; every live lane holds a
    stream of its own; one that adds no lane warms nothing."""
    seam = WallSeam()
    srv, calls = _warm_server(seam)
    be = srv.backend
    be.start()
    try:
        old = list(be._slots)
        calls.clear()
        srv.core.sched.reconfigure(be.now_ms(), n_contexts=3)
        be.on_reconfigure()
        live = be._live_lanes()
        made = be._slots[len(old):]
        assert len(live) == 6 and len(old) == 4 and len(made) == 2
        assert calls == _stream_chains(made) + _stream_chains(be._slots)
        held = [be._streams[ln] for ln in live]
        assert len({id(s) for s in held}) == 6
        assert {id(s) for s in held} == {id(s) for s in be._slots}
        assert be.rewarm["count"] == 1 and be.rewarm["s"] > 0.0
        calls.clear()
        be.on_reconfigure()
        assert calls == [] and be.rewarm["count"] == 1
        assert not be._pool._threads
    finally:
        be.stop()


def _bare_backend(seam, work):
    """A started backend on the stand-in (2 contexts x 1 stream), bound
    to its server's core, with one HP task whose payload keeps its lane
    busy ``work[0]`` ms and returns a count of its calls."""
    calls = []
    spec = api.TaskSpec(name="t", period_ms=100.0, priority=api.HP,
                        stages=[api.StageProfile("t/s0", 1.0, n_sat=1.0,
                                                 mem_frac=0.0)])
    srv = (api.ServerConfig.realtime(device="cpu").tasks([spec])
           .contexts(2).streams(1).oversubscribe(1.0)
           .device(api.DeviceModel(n_units=4.0)).build())
    be = srv.backend
    be._seam = seam

    def payload(x):
        seam.work(work[0])
        calls.append(len(calls))
        return torch.tensor(float(len(calls)))
    spec.stages[0].payload = payload
    be.bind(srv.core)
    be.start()
    calls.clear()                     # the warm-up's
    task = srv.scheduler.tasks[0]

    def instance():
        return StageInstance(Job(task, 0.0), enqueue_ms=0.0,
                             virtual_deadline_ms=100.0)
    return be, instance


def _drain(be, cap_ms: float):
    out = []
    while be.has_inflight() and be.now_ms() < cap_ms:
        out += be.advance(cap_ms)
    return out


def test_ghosts_are_dropped_while_the_flight_drains():
    """A watchdog kill_lane's ghost and a cancelled context's stage are
    polled to their end and dropped; only the relaunched stage commits,
    with its own output."""
    seam, work = WallSeam(), [30.0]
    be, instance = _bare_backend(seam, work)
    try:
        a, c = instance(), instance()
        be.launch((0, 0), a)                 # call 1: becomes a ghost
        be.kill_lane((0, 0), a)
        work[0] = 5.0
        be.launch((0, 0), a)                 # call 2, behind call 1
        work[0] = 10.0
        be.launch((1, 0), c)                 # call 3, on a failed context
        be.cancel_ctx(1)
        assert be.has_inflight() and len(be._flight) == 3
        done = _drain(be, be.now_ms() + 2000.0)
        assert [(d.lane, d.inst) for d in done] == [((0, 0), a)]
        assert not be.has_inflight()
        assert float(be._job_state[a.job.job_id]) == 2.0
        assert c.job.job_id not in be._job_state
        assert be.stage_time_summary()["t/s0"]["n"] == 1
        assert 30.0 <= done[0].et_ms < 1000.0      # behind the ghost
    finally:
        be.stop()


@pytest.mark.parametrize("works", [(20.0, 5.0), (5.0, 20.0)],
                         ids=["first_ends_last", "first_ends_first"])
def test_simultaneous_completions_commit_in_launch_order(works):
    """Two stages done by the time of the poll: committed one a call, the
    first launched first, whichever ended first."""
    seam, work = WallSeam(), [0.0]
    be, instance = _bare_backend(seam, work)
    try:
        x, y = instance(), instance()
        work[0] = works[0]
        be.launch((0, 0), x)
        work[0] = works[1]
        be.launch((1, 0), y)
        time.sleep((max(works) + 10.0) / 1000.0)
        first = be.advance(be.now_ms() + 1000.0)
        second = be.advance(be.now_ms() + 1000.0)
        assert [c.inst for c in first + second] == [x, y]
        assert not be.has_inflight()
        assert be.pool_stage_runs == 0 and be.stage_runs == 2
    finally:
        be.stop()


# ------------------------------------------- one burst a stage, its stalls
class CountingSeam(WallSeam):
    """The stand-in seam, counting the events it makes; with ``slow_ms``,
    each event's record sleeps that long first (a stall inside the start
    and end events' steps)."""

    def __init__(self):
        super().__init__()
        self.events, self.slow_ms = 0, 0.0

    def event(self):
        self.events += 1
        seam = self

        class Event(WallEvent):
            def record(self, stream=None):
                if seam.slow_ms:
                    time.sleep(seam.slow_ms / 1000.0)
                super().record(stream)
        return Event(self)


def with_programs(cfg, seam):
    """Every stage of ``cfg``'s tasks gets a stage program (the CPU's
    eager run) that keeps its lane busy for its ``t_alone`` and hands on a
    new tensor: the payloads the backend resolves before the start event
    (``prepare``) and issues between the events."""
    from repro_torch.serving.stage_graph import StageProgram
    for spec in cfg._specs:
        for st in spec.stages:
            def fn(x, ms=st.t_alone_ms):
                seam.work(ms)
                return x + 1.0
            st.payload = StageProgram(fn, name=st.name)
    return cfg


PROGRAM_STEPS = ("input", "resolve", "start", "copy_in", "replay",
                 "copy_out", "end")
CALLABLE_STEPS = ("input", "start", "payload", "end")


@pytest.mark.parametrize("kind", ["program", "callable"])
def test_steps_sum_to_the_enqueue_and_the_parts_with_prep_to_the_response(
        kind):
    """The fixed-time scenario (at twice its times) on the stand-in seam,
    its payloads stage programs or plain callables: the decisions equal
    the simulator's; every card stage's steps are the path's, in order,
    and sum to its enqueue; a program's start event is recorded after its
    resolve (``prep``); each HP job's parts, ``prep`` among them, sum to
    its response."""
    sim = slowed(fixed_time(api)).build()
    sim.run()
    seam = WallSeam()
    cfg = slowed(fixed_time(api, realtime=True))
    (with_programs if kind == "program" else with_payloads)(cfg, seam)
    real = cfg.build()
    on_stand_in(real, seam)
    real.run()
    assert real.decisions == sim.decisions and len(sim.decisions) > 20
    be = real.backend
    want = PROGRAM_STEPS if kind == "program" else CALLABLE_STEPS
    rows = list(be._enqueues)
    assert len(rows) == be.stage_runs > 0
    for _, _, ms, steps, _ in rows:
        assert tuple(steps) == want
        assert abs(sum(steps.values()) - ms) <= 1e-6
    parts = be.hp_response_parts(slowest=len(real.core.metrics.response_ms[
        api.HP]))
    assert parts["jobs"] > 0 and parts["sum_err_ms"] <= PARTS_TOL_MS
    assert parts["parts"] == list(RESPONSE_PARTS) and "prep" in parts["parts"]
    for job in parts["slowest"]:
        for st in job["stages"]:
            assert abs(sum(st["steps"].values()) - st["enqueue"]) <= 1e-6
            assert st["prep"] >= 0.0
            # the start event is recorded as the "start" step begins
            assert abs(st["prep"] - sum(st["steps"][k] for k in
                                        want[:want.index("start")])) <= 1e-6
    summary = be.enqueue_summary()
    assert summary["n"] == len(rows) and set(summary["steps"]) == set(want)
    # the engine thread's whole cost a stage: the enqueue and the result
    assert abs(summary["engine_ms"]["sum"]
               - sum(r[2] + r[4] for r in rows)) <= 1e-6


@pytest.mark.parametrize("launches", [1, 24])
def test_no_event_is_made_after_the_warm_up(launches):
    """Each lane stream's start and end events come from its ring, made
    with the stream before the clock starts, as are the anchors' events:
    however many stages run (ghosts among them), the seam makes no event
    after ``start``, and every stage's device interval is read."""
    seam, work = CountingSeam(), [1.0]
    be, instance = _bare_backend(seam, work)
    made = seam.events
    assert made > 0 and be.graph_summary()["events_in_run"] == 0
    try:
        for i in range(launches):
            inst = instance()
            be.launch((i % 2, 0), inst)
            if i % 5 == 4:                  # a watchdog's ghost beside it
                be.kill_lane((i % 2, 0), inst)
                be.launch((i % 2, 0), inst)
            _drain(be, be.now_ms() + 2000.0)
        assert not be.has_inflight()
        assert be.stage_time_summary()["t/s0"]["n"] == launches
    finally:
        be.stop()
    assert seam.events == made
    assert be.graph_summary()["events_in_run"] == 0


def _program_backend(seam, work, factory_ms):
    """``_bare_backend`` with a stage program as the payload and an input
    factory that sleeps ``factory_ms[0]`` ms before it makes the input."""
    from repro_torch.serving.stage_graph import StageProgram
    be, instance = _bare_backend(seam, work)

    def fn(x):
        seam.work(work[0])
        if work[1]:
            time.sleep(work[1] / 1000.0)
        return x + 1.0
    be.core.sched.tasks[0].spec.stages[0].payload = StageProgram(fn, "t/s0")
    make = be.input_factory

    def factory(job):
        if factory_ms[0]:
            time.sleep(factory_ms[0] / 1000.0)
        return make(job)
    be.input_factory = factory
    return be, instance


@pytest.mark.parametrize("where", ["input", "start", "replay"])
def test_a_stall_inside_a_step_is_named(where):
    """A stand-in that sleeps 3 ms inside one step of a stage's enqueue
    (the input's factory, the start event's record, the program's run):
    ``engine_stalls`` has it under that step's name, its wall ms at least
    the sleep, and of the thread's CPU ms in the window that holds it at
    most half the stall's (the thread was off the CPU for the sleep); the
    same stages without the sleep show none in that step."""
    seam, work, factory_ms = CountingSeam(), [1.0, 0.0], [0.0]
    be, instance = _program_backend(seam, work, factory_ms)
    try:
        be.launch((0, 0), instance())
        _drain(be, be.now_ms() + 2000.0)
        assert [s for s in be.engine_stalls() if s["step"] == where] == []
        if where == "input":
            factory_ms[0] = 3.0
        elif where == "start":
            seam.slow_ms = 3.0
        else:
            work[1] = 3.0
        be.launch((1, 0), instance())
        _drain(be, be.now_ms() + 2000.0)
    finally:
        be.stop()
    named = [s for s in be.engine_stalls() if s["step"] == where]
    assert len(named) == 1
    row = named[0]
    assert row["wall_ms"] >= 3.0 and row["cpu_window_ms"] >= row["wall_ms"]
    before = row["cpu_window_ms"] - row["wall_ms"]    # the window's lead
    assert row["cpu_ms"] <= before + 0.5 * row["wall_ms"]
    steps = list(be._enqueues)[-1][3]
    assert steps[where] >= 3.0


# ------------------------------------------ the default input, made once
def _recording_factory(factory, made):
    def record(job):
        x = factory(job)
        made.append((job.job_id, job.n_inputs, x))
        return x
    return record


def test_the_default_input_is_made_before_the_clock_once():
    """The fixed-time scenario (at twice its times) with stage programs on
    the stand-in seam and the default input: one block of zeros is made
    at the start, before the warm-up, and nothing after; every job's
    first stage (and each warm-up chain) takes that same tensor, which
    is all zeros after the run; the decisions are the simulator's."""
    sim = slowed(fixed_time(api)).build()
    sim.run()
    seam = WallSeam()
    real = with_programs(slowed(fixed_time(api, realtime=True)),
                         seam).build()
    on_stand_in(real, seam)
    be = real.backend
    zeros, taken = be._zeros, []
    assert zeros is not None and not zeros.made and zeros.blocks == 0
    be.input_factory = _recording_factory(zeros, taken)
    start = be.start
    at_start = {}

    def started():
        start()
        at_start.update(blocks=zeros.blocks, taken=len(taken))
    be.start = started
    real.run()
    assert real.decisions == sim.decisions
    assert at_start["blocks"] == zeros.blocks == 1
    assert sorted(zeros.made) == [1]
    x = zeros.made[1]
    assert x.shape == (1, 64, 64, 3) and not x.any()
    first = [r for r in be._enqueues if r[0] == 0]
    assert at_start["taken"] > 0
    assert len(taken) == at_start["taken"] + len(first) > at_start["taken"]
    assert all(t is x for _, _, t in taken)


def test_each_leading_size_is_made_once_and_another_raises():
    """With batching up to 3 inputs a job, the start makes one zero input
    a leading size (views of one block, its batch of 2 images an input);
    a second start makes nothing; a job of 4 inputs, which the run cannot
    form, raises at its input."""
    spec = api.TaskSpec(name="t", period_ms=100.0, priority=api.HP,
                        stages=[api.StageProfile("t/s0", 1.0, n_sat=1.0,
                                                 mem_frac=0.0)])
    spec.stages[0].payload = lambda x: x
    srv = (api.ServerConfig.realtime(device="cpu").tasks([spec])
           .contexts(1).streams(1).oversubscribe(1.0).batching(max_batch=3)
           .device(api.DeviceModel(n_units=4.0))
           .realtime_io(input_hw=5, batch=2).build())
    be = srv.backend
    be.bind(srv.core)
    be.start()
    be.stop()
    zeros = be._zeros
    assert sorted(zeros.made) == [1, 2, 3] and zeros.blocks == 1
    for n, x in zeros.made.items():
        assert x.shape == (2 * n, 5, 5, 3) and not x.any()
        assert x.data_ptr() == zeros.made[3].data_ptr()
    be.start()
    be.stop()
    assert zeros.blocks == 1
    task = srv.scheduler.tasks[0]
    wide = StageInstance(Job(task, 0.0, extra_release_ms=[1.0, 2.0, 3.0]),
                         enqueue_ms=0.0, virtual_deadline_ms=100.0)
    assert wide.job.n_inputs == 4
    with pytest.raises(RuntimeError, match="no zero input of 4 inputs"):
        be._stage_input(wide, (0, 0))
    ok = StageInstance(Job(task, 0.0, extra_release_ms=[1.0]),
                       enqueue_ms=0.0, virtual_deadline_ms=100.0)
    assert be._stage_input(ok, (0, 0)) is zeros.made[2]


def test_a_callers_input_factory_is_called_once_a_job():
    """A factory the caller gives (``realtime_io(input_factory=...)``)
    makes no default input and is called, as before, once for each warm-up
    chain and once for each job's first stage, each time anew."""
    seam, made = WallSeam(), []

    def factory(job):
        x = torch.zeros((1, 4))
        made.append((job.job_id, x))
        return x
    cfg = with_programs(slowed(fixed_time(api, realtime=True)), seam)
    real = cfg.realtime_io(input_factory=factory).build()
    on_stand_in(real, seam)
    be = real.backend
    assert be._zeros is None
    real.run()
    first = [r for r in be._enqueues if r[0] == 0]
    warm = [m for m in made if m[0] == -1]
    assert warm and len(made) == len(warm) + len(first)
    assert len({id(x) for _, x in made}) == len(made)

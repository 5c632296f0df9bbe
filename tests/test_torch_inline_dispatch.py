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
called for each. A HP job's calls are made ready ahead of its stages, as
one chain made as the job before it is done (each call on the output the
one before will give, as stage programs on the emulated burst of
``tests/test_torch_stage_graph.py`` know it, as the card's do): a served
CNN and LM chain take them with outputs bit-identical to the boundary's
path, LP stages never do, and each way a ready call stops matching its
stage discards the rest of the chain under its reason, after which the
job's stages resolve at their boundary.
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
# a HP stage that took the call made ready for it: only the lane's step
READY_STEPS = ("input", "lookup", "start", "copy_in", "replay", "copy_out",
               "end")
CALLABLE_STEPS = ("input", "start", "payload", "end")


@pytest.mark.parametrize("kind", ["program", "callable"])
def test_steps_sum_to_the_enqueue_and_the_parts_with_prep_to_the_response(
        kind):
    """The fixed-time scenario (at twice its times) on the stand-in seam,
    its payloads stage programs or plain callables: the decisions equal
    the simulator's; every card stage's steps are the path's, in order
    (a HP program stage's ``lookup`` where it took its ready call, an LP
    one's always ``resolve``), and sum to its enqueue; a program's start
    event is recorded after its resolve (``prep``); each HP job's parts,
    ``prep`` among them, sum to its response."""
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
    for _, prio, ms, steps, _ in rows:
        assert tuple(steps) == want or (
            kind == "program" and prio == api.HP
            and tuple(steps) == READY_STEPS)
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
            names = list(st["steps"])
            assert abs(st["prep"] - sum(st["steps"][k] for k in
                                        names[:names.index("start")])) <= 1e-6
    summary = be.enqueue_summary()
    assert summary["n"] == len(rows)
    assert set(summary["steps"]) == set(want) | (
        {"lookup"} if kind == "program" else set())
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


# --------------------------------- a HP stage's call made ready ahead of it
def _small_specs(name):
    """HP and LP tasks of ``name`` at a small size on the CPU, 1.0 ms a
    stage: ResNet18 at width 8 on 2 x 33 x 33 inputs, or smollm-135m cut
    to 4 layers in 4 stages (batch 2, prompt 8); and the server's
    ``realtime_io``."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import BUILDERS, build_model
    from repro_torch.serving.engine import (staged_cnn_taskspec,
                                            staged_lm_taskspec)
    tasks = ((api.HP, "-hp", 20.0), (api.LP, "-lp", 5.0))
    if name == "resnet18":
        model = BUILDERS[name](width=8, device="cpu")
        return [staged_cnn_taskspec(model, priority=p, jps=jps,
                                    input_hw=33, batch=2, calibrate=False,
                                    device="cpu", tag=t)
                for p, t, jps in tasks], dict(input_hw=33, batch=2)
    model = build_model(get_reduced(name).replace(n_layers=4), device="cpu")
    params = model.init_params(0)
    specs = [staged_lm_taskspec(model, priority=p, jps=jps, n_stages=4,
                                prompt_len=8, batch=2, device="cpu", tag=t,
                                params=params) for p, t, jps in tasks]
    # 1.0 ms a stage, as the CNN's uncalibrated stages: the calibration's
    # times on a loaded host can make admission reject every LP job
    for spec in specs:
        for st in spec.stages:
            st.t_alone_ms = 1.0
    return specs, {}


class HandleSeam(WallSeam):
    """The stand-in seam whose events carry handles, as the card's do,
    which the emulated burst's launch hands back (``byte_program``)."""

    def __init__(self):
        super().__init__()
        self.events = {}

    def event(self):
        ev = super().event()
        ev.cuda_event = id(ev)
        self.events[ev.cuda_event] = ev
        return ev


def byte_program(seam):
    """A stage program class on the emulated burst (``ByteProgram``)
    whose launch records ``seam``'s start event before the stage's run
    and its end event after it, on the host's clock (the launch names no
    stand-in stream)."""
    from tests.test_torch_stage_graph import ByteGraph, ByteProgram

    class Graph(ByteGraph):
        def launch(self, stream, graph_exec, nodes, n_in, n_out, start,
                   end, *rest):
            if start in seam.events:
                seam.events[start].record()
            err = super().launch(stream, graph_exec, nodes, n_in, n_out,
                                 start, end, *rest)
            if end in seam.events:
                seam.events[end].record()
            return err

    class Program(ByteProgram):
        def _runner(self, device):
            return Graph
    return Program


def on_byte_programs(specs, seam):
    """Every stage program of ``specs`` (a CNN's ``StageProgram``, an LM's
    ``LmStage``) made again on the emulated burst of ``seam``."""
    from repro_torch.serving.engine import LmStage
    program = byte_program(seam)
    for spec in specs:
        for st in spec.stages:
            p = st.payload
            if isinstance(p, LmStage):
                kw = p.keywords
                prog = program(kw["program"].fn,
                               functional=kw["program"].functional)
                st.payload = LmStage(p.func, **{**kw, "program": prog})
            else:
                st.payload = program(p.fn, name=p.name,
                                     functional=p.functional)
    return specs


def _leaves_of(tree):
    from torch.utils._pytree import tree_flatten
    return tree_flatten(tree)[0]


@pytest.mark.parametrize("name", ["resnet18", "smollm-135m"])
def test_hp_stages_take_ready_calls_bit_identical_to_the_boundary_path(
        name):
    """A small CNN chain and a reduced staged LM chain served on the
    stand-in seam (2 x 2 lanes), their programs on the emulated burst: HP
    stages take the calls made ready for them ahead (each job's chain,
    made as the job before it is done, from its first stage on the
    default input), and every harvested stage's output equals its payload
    called on the same input at the boundary bit for bit; LP stages are
    never made ready (they resolve at the boundary);
    every ready call made is used, discarded or left at the stop, none
    discarded here; the parts still sum to each response."""
    seam = HandleSeam()
    specs, io = _small_specs(name)
    on_byte_programs(specs, seam)
    cfg = (api.ServerConfig.realtime(device="cpu").tasks(specs)
           .contexts(2).streams(2).oversubscribe(2.0)
           .device(api.DeviceModel(n_units=4.0)).horizon_ms(400.0))
    if io:
        cfg = cfg.realtime_io(**io)
    srv = cfg.build()
    on_stand_in(srv, seam)
    be = srv.backend
    taken, pairs = {}, []
    stage_input, harvest = be._stage_input, be._harvest

    def take(inst, lane):
        x = stage_input(inst, lane)
        taken[(inst.job.job_id, inst.job.stage_idx)] = (
            inst.profile.payload, x, inst.task.priority)
        return x

    def harvested(rec):
        c = harvest(rec)
        job = rec.inst.job
        got = taken.pop((job.job_id, job.stage_idx), None)
        if c is not None and not rec.failed:
            pairs.append((*got, be._job_state[job.job_id]))
        return c
    be._stage_input, be._harvest = take, harvested
    m = srv.run()
    assert m.completed[api.HP] > 0 and be.worker_exceptions == 0
    ready = be.ready_summary()
    assert ready["used"]["s0"] > 0 and ready["used"]["later"] > 0
    assert not any(n for by in ready["discarded"].values()
                   for n in by.values())
    for where in ("s0", "later"):
        assert ready["made"][where] == (ready["used"][where]
                                        + ready["left"][where])
    rows = list(be._enqueues)
    hp_rows = [r for r in rows if r[1] == api.HP]
    assert sum(ready["stages"].values()) == len(hp_rows)
    assert sum(ready["used"].values()) == sum(
        1 for r in hp_rows if "lookup" in r[3])
    assert all("resolve" in r[3] and "lookup" not in r[3]
               for r in rows if r[1] == api.LP)
    assert {p for *_, p, _ in pairs} == {api.HP, api.LP}
    for payload, x, _, out in pairs:
        a, b = _leaves_of(out), _leaves_of(payload(x))
        assert len(a) == len(b) > 0
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    parts = be.hp_response_parts(slowest=len(m.response_ms[api.HP]))
    assert parts["jobs"] == len(m.response_ms[api.HP])
    assert parts["sum_err_ms"] <= PARTS_TOL_MS
    used = [st for job in parts["slowest"] for st in job["stages"]
            if st["ready"] is not None]
    assert used and all("lookup" in st["steps"] for st in used)


def _ready_backend(seam, n_stages=2, max_batch=1, ctx_devices=None,
                   program=None):
    """A started backend on the stand-in (2 contexts x 1 stream) with one
    HP task of ``n_stages`` stage programs (``program``, by default on
    the emulated burst of ``seam``, a ``HandleSeam``) ``x + 1`` on the
    default zero input (1 x 2 x 2 x 3 an input), bound to its server's
    core. Returns the backend, the task and a function of (job, stage)
    that makes the instance."""
    program = program or byte_program(seam)
    spec = api.TaskSpec(name="t", period_ms=100.0, priority=api.HP, stages=[
        api.StageProfile(f"t/s{j}", 1.0, n_sat=1.0, mem_frac=0.0)
        for j in range(n_stages)])
    for st in spec.stages:
        def fn(x):
            if seam.current is not None:    # an emulated launch has none
                seam.work(1.0)
            return x + 1.0
        st.payload = program(fn, st.name)
    cfg = (api.ServerConfig.realtime(device="cpu").tasks([spec])
           .contexts(2).streams(1).oversubscribe(1.0)
           .device(api.DeviceModel(n_units=4.0))
           .realtime_io(input_hw=2, batch=1))
    if max_batch > 1:
        cfg = cfg.batching(max_batch=max_batch)
    srv = cfg.build()
    be = srv.backend
    be._seam = seam
    if ctx_devices is not None:
        be.ctx_devices = ctx_devices
    be.bind(srv.core)
    be.start()
    task = srv.scheduler.tasks[0]

    def instance(job, stage):
        job.stage_idx = stage
        return StageInstance(job, enqueue_ms=0.0, virtual_deadline_ms=100.0)
    return be, task, instance


def _stage(be, lane, inst):
    """Launch ``inst`` on ``lane`` and drain the flight; its steps."""
    be.launch(lane, inst)
    _drain(be, be.now_ms() + 2000.0)
    return list(be._enqueues)[-1][3]


class _Fail:
    """A chaos plan's draw that fails every launch, without a stall."""

    @staticmethod
    def draw_launch():
        return True, 0.0


@pytest.mark.parametrize("reason", ["migrated", "cancelled", "killed",
                                    "ctx_failed", "chaos", "batch",
                                    "factory"])
def test_each_discarded_ready_call_is_counted_by_its_reason(reason,
                                                            monkeypatch):
    """Each way a call made ready ahead stops being the one its stage
    would make: the rest of its job's chain is discarded, each call
    counted under the reason and no other (a first stage's reason: the
    whole two-stage chain), and the job's remaining stages resolve at
    their boundary as before (``resolve``, not ``lookup``) with the right
    output; a ready call that matches is taken (``lookup``); a stage
    relaunched after its ghost took its ready call finds none and
    resolves."""
    seam = HandleSeam()
    kw = {"max_batch": 2} if reason == "batch" else {}
    if reason == "migrated":
        kw["ctx_devices"] = {0: "cpu", 1: "cpu"}
        from repro_torch.serving import staging
        # a move to another device: new storage, the same values
        monkeypatch.setattr(staging, "migrate",
                            lambda x, dev: x.clone())
    be, task, instance = _ready_backend(seam, **kw)
    # the first job's chain, made at the start
    assert [r.stage for r in be._ready0[task.index]] == [0, 1]
    try:
        job = Job(task, 0.0, extra_release_ms=[1.0] if reason == "batch"
                  else [])
        if reason == "factory":
            be.input_factory = lambda j: torch.full((1, 2, 2, 3), 5.0)
        if reason == "chaos":
            be.core._chaos = _Fail
        if reason in ("killed", "ctx_failed"):
            lane = (0, 0) if reason == "killed" else (1, 0)
            inst = instance(job, 0)
            be.launch(lane, inst)
            assert job.job_id in be._ready
            if reason == "killed":
                be.kill_lane(lane, inst)         # a watchdog's ghost
            else:
                be.cancel_ctx(1)                 # its context failed
            assert job.job_id not in be._ready
            _drain(be, be.now_ms() + 2000.0)
        steps = _stage(be, (0, 0), instance(job, 0))
        base = 5.0 if reason == "factory" else 0.0
        if reason in ("batch", "factory", "chaos", "killed", "ctx_failed"):
            # a ghost took the first stage's ready call: none is left
            assert "resolve" in steps and "lookup" not in steps
            assert be.ready_summary()["none"]["s0"] == (
                reason in ("killed", "ctx_failed"))
        else:
            assert "lookup" in steps
        if reason == "chaos":
            # a failed stage's output is not committed, and no call is
            # made ready on it
            assert job.job_id not in be._job_state
            assert job.job_id not in be._ready
        else:
            x = be._job_state[job.job_id]
            assert x.shape[0] == job.n_inputs
            assert torch.equal(x, torch.full_like(x, base + 1.0))
            # the chain's rest, where the first stage took its call
            assert (job.job_id in be._ready) == (
                reason in ("migrated", "cancelled"))
        if reason == "cancelled":
            be.on_job_done(job)                  # retired at the boundary
        elif reason != "chaos":
            lane = (1, 0) if reason == "migrated" else (0, 0)
            steps = _stage(be, lane, instance(job, 1))
            assert "resolve" in steps and "lookup" not in steps
            x = be._job_state[job.job_id]
            assert torch.equal(x, torch.full_like(x, base + 2.0))
    finally:
        be.stop()
    ready = be.ready_summary()
    discarded = {r: sum(by.values())
                 for r, by in ready["discarded"].items() if any(by.values())}
    first = reason in ("chaos", "batch", "factory")
    assert discarded == {reason: 2 if first else 1}
    assert ready["discarded"][reason] == {"s0": int(first), "later": 1}
    for w in ("s0", "later"):
        assert ready["made"][w] == (ready["used"][w] + ready["left"][w]
                                    + sum(by[w] for by in
                                          ready["discarded"].values()))
    assert be.worker_exceptions == 0


def test_a_stall_inside_a_ready_step_is_named_ready():
    """A payload whose ready step sleeps 3 ms (a first stage's call made
    ready for the next job as a job is done): the engine thread's stall
    is named ``ready``, and the ready call's ms holds the sleep; no
    enqueue step holds it."""
    seam = HandleSeam()
    be, task, instance = _ready_backend(seam, n_stages=1)
    prog = task.spec.stages[0].payload
    ready = prog.ready

    def slow(*args, **kw):
        time.sleep(3.0 / 1000.0)
        return ready(*args, **kw)
    try:
        job = Job(task, 0.0)
        _stage(be, (0, 0), instance(job, 0))
        be.on_job_done(job)
        assert [s for s in be.engine_stalls() if s["step"] == "ready"] == []
        prog.ready = slow
        job = Job(task, 0.0)
        steps = _stage(be, (0, 0), instance(job, 0))
        be.on_job_done(job)
    finally:
        be.stop()
    named = [s for s in be.engine_stalls() if s["step"] == "ready"]
    assert len(named) == 1 and named[0]["wall_ms"] >= 3.0
    assert be.ready_summary()["ms"]["s0"]["max"] >= 3.0
    assert max(steps.values()) < 3.0


# ------------------------------- what the engine thread's host readings say
class QuerySeam(WallSeam):
    """The stand-in seam counting its events' queries."""

    def __init__(self):
        super().__init__()
        self.queries = 0

    def event(self):
        seam = self

        class Event(WallEvent):
            def query(self):
                seam.queries += 1
                return super().query()
        return Event(self)


def test_a_stream_whose_handle_a_slot_holds_is_refused():
    """A seam that hands the same stream handle back (PyTorch's pool of 32
    a priority, wrapped): the backend refuses the stream, naming the
    count, at its start."""
    class WrapSeam(WallSeam):
        def __init__(self, handles):
            super().__init__()
            self.handles = iter(handles)

        def stream(self):
            s = super().stream()
            s.cuda_stream = next(self.handles)
            return s

        def lane_key(self, stream):
            return 0, stream.cuda_stream

    with pytest.raises(RuntimeError, match="wrapped at 1 streams"):
        _bare_backend(WrapSeam([7, 7]), [1.0])
    be, _ = _bare_backend(WrapSeam([7, 8]), [1.0])
    be.stop()
    assert [be._lane_keys[id(s)] for s in be._slots] == [(0, 7), (0, 8)]


def test_a_served_runs_host_readings_name_the_engine_thread_and_cgroup(
        monkeypatch):
    """``chip_smoke.py``'s host readings over stages on the stand-in:
    the engine thread's CPU seconds and switches read on the thread that
    started the backend, the cgroup's limit and throttling deltas or
    None with a reason (a host whose ``/proc/self/cgroup`` cannot be
    read gives the reason), and the backend's polls and end-event
    queries, each query the seam saw counted once; the clock's
    throttling read (None where the cgroup is unreadable)."""
    import threading

    import chip_smoke
    from repro_torch.runtime.backend import _Throttled, cgroup_cpu_dir
    seam, work = QuerySeam(), [5.0]
    be, instance = _bare_backend(seam, work)
    counted = chip_smoke.switches_counted()
    before = {"usage": chip_smoke.thread_usage(counted),
              "cgroup": chip_smoke.cgroup_cpu()[0]}
    queries = seam.queries
    try:
        for _ in range(3):
            for lane in ((0, 0), (1, 0)):
                be.launch(lane, instance())
            _drain(be, be.now_ms() + 2000.0)
        time.sleep(0.002)            # one switch the thread surely makes
        host = chip_smoke.run_host(before, threading.get_ident(), be)
        queries = seam.queries - queries
    finally:
        be.stop()
    eng = host["engine_thread"]
    assert eng["on_engine_thread"] and eng["cpu_s"] > 0.0
    assert eng["switches_counted"] == counted
    if counted:
        assert eng["voluntary_switches"] >= 1
    else:
        assert eng["voluntary_switches"] is eng["involuntary_switches"] is None
    assert host["poll_counts"]["queries"] == queries > 6
    assert host["poll_counts"]["polls"] >= queries // 2
    cg, reason = host["cgroup"], host["cgroup_reason"]
    assert cg is not None or reason
    throttled = _Throttled()()
    assert (throttled is None) == (cgroup_cpu_dir() is None)
    if cg is not None and reason is None:
        assert all(cg[k] >= 0 for k in chip_smoke.CGROUP_COUNTS)
        assert throttled is not None and throttled >= 0
    real_open = open

    def no_cgroup(path, *a, **k):
        if str(path) == "/proc/self/cgroup":
            raise PermissionError(path)
        return real_open(path, *a, **k)
    monkeypatch.setattr("builtins.open", no_cgroup)
    cg, reason = chip_smoke.cgroup_cpu()
    assert cg is None and "/proc/self/cgroup" in reason
    assert cgroup_cpu_dir() is None

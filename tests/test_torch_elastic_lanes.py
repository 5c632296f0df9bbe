"""The elastic drills on the realtime backend's inline path, on the CPU:
lane streams are slots the run reuses, so a reshape, a context failure and
a scale-out take the retired lanes' streams (and on the card the CUDA
graphs those hold) before any new stream is made, and a plan the run
knows at its start is warmed before the clock starts.

The card's streams and events are test_torch_inline_dispatch.py's
stand-in seam (a "stream" is the wall-clock instant its queued work
ends). The drills are ``chip_smoke.py``'s, on 2 contexts x 2 streams at
oversubscription 2.0: ``reshape`` (4 contexts x 1 stream at 4.0, then 3 x
2 at 3.0, then 2 x 2 at 2.0, at a quarter, half and three quarters of the
horizon: 4 -> 4 -> 6 -> 4 lanes), ``fault`` (context 0 fails at a
third, one context is added at two thirds: 4 -> 2 -> 4 lanes; no task is
placed on the added context) and ``scale_out`` (a context added at a
third, context 1 fails at two thirds: 4 -> 6 -> 4 lanes, its LP task
re-placed onto the added context). The port's simulator runs the drills
bit for bit as ``repro``'s does.
"""
import time

import pytest

torch = pytest.importorskip("torch")

import repro.api as ref_api  # noqa: E402
import repro_torch.api as api  # noqa: E402
from tests.test_torch_inline_dispatch import (WallSeam,  # noqa: E402
                                              _bare_backend, _drain,
                                              _stream_chains, _warm_server,
                                              on_stand_in, slowed,
                                              with_payloads)
from tests.test_torch_serving import fixed_time, make_spec  # noqa: E402


def reshape(cfg, horizon_ms: float):
    return (cfg.reconfigure_at(horizon_ms / 4, n_contexts=4, n_streams=1,
                               oversubscription=4.0)
            .reconfigure_at(horizon_ms / 2, n_contexts=3, n_streams=2,
                            oversubscription=3.0)
            .reconfigure_at(3 * horizon_ms / 4, n_contexts=2, n_streams=2,
                            oversubscription=2.0))


def fault(cfg, horizon_ms: float):
    return (cfg.fail_context_at(0, horizon_ms / 3)
            .scale_out_at(2 * horizon_ms / 3))


def scale_out(cfg, horizon_ms: float):
    return (cfg.scale_out_at(horizon_ms / 3)
            .fail_context_at(1, 2 * horizon_ms / 3))


# each drill and the most lanes live at once in it
DRILLS = {"reshape": (reshape, 6), "fault": (fault, 4),
          "scale_out": (scale_out, 6)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _drill_run(kind: str) -> dict:
    """The fixed-time scenario's tasks on 2 contexts x 2 streams at 2.0,
    with ``kind``'s plan over its horizon, served on the stand-in seam.
    Records the live lanes after each scheduler event, the lanes the
    backend planned for at its start, every warm-up after the clock
    started, the lanes launched, and at each launch how many live lanes
    share a stream with another."""
    seam = WallSeam()
    cfg = fixed_time(api, realtime=True).contexts(2).streams(2) \
        .oversubscribe(2.0)
    cfg = with_payloads(DRILLS[kind][0](cfg, cfg._horizon_ms), seam)
    srv = cfg.build()
    paths = on_stand_in(srv, seam)
    be, sched = srv.backend, srv.core.sched
    rec = {"live": [sum(c.n_streams for c in sched.live_contexts())],
           "warm_after_start": [],
           "shared": [], "lanes": set(), "paths": paths, "srv": srv}
    for name in ("reconfigure", "add_context", "fail_context"):
        def event(*a, fn=getattr(sched, name), **k):
            out = fn(*a, **k)
            rec["live"].append(len(be._live_lanes()))
            return out
        setattr(sched, name, event)
    warm, launch, plan = be._warm_streams, be.launch, be._planned_lanes

    def planned():
        rec["planned"] = plan()
        return rec["planned"]

    def warmed(new):
        if be._t0:                       # set as the clock starts
            rec["warm_after_start"].append(len(new))
        return warm(new)

    def launched(lane, inst):
        launch(lane, inst)
        rec["lanes"].add(lane)
        held = [id(s) for ln, s in be._streams.items()
                if sched.contexts[ln[0]].alive]
        rec["shared"].append(len(held) - len(set(held)))
    be._warm_streams, be.launch, be._planned_lanes = warmed, launched, planned
    rec["m"] = srv.run()
    return rec


@pytest.fixture(scope="module")
def drill_runs():
    return {kind: _drill_run(kind) for kind in DRILLS}


@pytest.mark.parametrize("kind", list(DRILLS))
def test_streams_made_equal_the_most_lanes_live_at_once(drill_runs, kind):
    """The run makes one stream for each lane of its busiest moment (6 for
    ``reshape``, where the parent made 4 + 4 + 6 + 4; 4 for ``fault``; 6
    for ``scale_out``),
    which the backend reads from the plan before the clock starts; every
    stage runs inline and the drill's events all happened. The added
    context (2) launches in ``scale_out`` only: in ``fault`` no task is
    placed on it."""
    rec = drill_runs[kind]
    be, m = rec["srv"].backend, rec["m"]
    assert max(rec["live"]) == DRILLS[kind][1]
    assert len(rec["live"]) == (4 if kind == "reshape" else 3)
    assert len(be._slots) == max(rec["live"]) == rec["planned"]
    assert be.graph_summary()["streams"] == len(be._slots)
    assert {p for p, _ in rec["paths"]} == {"inline"}
    assert be.worker_exceptions == 0 and be.pool_stage_runs == 0
    assert sum(m.completed.values()) > 0
    assert (m.reconfigures, m.faults) == ((3, 0) if kind == "reshape"
                                          else (0, 1))
    if kind != "reshape":
        assert any(ln[0] == 2 for ln in rec["lanes"]) == (kind == "scale_out")


@pytest.mark.parametrize("kind", list(DRILLS))
def test_a_planned_drill_warms_nothing_after_the_clock_starts(drill_runs,
                                                              kind):
    """Every stream was made and warmed before the clock started: no
    warm-up after it, and ``rewarm`` counts none."""
    rec = drill_runs[kind]
    be = rec["srv"].backend
    assert rec["warm_after_start"] == []
    assert be.rewarm == {"count": 0, "s": 0.0, "captures": 0, "replays": 0}
    assert be.warm_s > 0.0


@pytest.mark.parametrize("kind", list(DRILLS))
def test_live_lanes_never_share_a_stream(drill_runs, kind):
    """At every launch of the drill, each live lane that holds a stream
    holds one no other live lane holds."""
    rec = drill_runs[kind]
    assert rec["shared"] and set(rec["shared"]) == {0}


def test_a_same_size_reshape_makes_no_stream_and_warms_nothing():
    """4 lanes -> 4 new lanes: each takes a retired lane's stream, in the
    order they were made; nothing is made or warmed."""
    seam = WallSeam()
    srv, calls = _warm_server(seam)
    be = srv.backend
    be.start()
    try:
        old = list(be._slots)
        calls.clear()
        srv.core.sched.reconfigure(be.now_ms(), n_contexts=2)
        be.on_reconfigure()
        live = be._live_lanes()
        assert live[0][0] == 2 and len(live) == 4
        assert [be._streams[ln] for ln in live] == old == be._slots
        assert calls == [] and be.rewarm["count"] == 0
    finally:
        be.stop()


def test_a_growing_reshape_makes_only_the_lanes_beyond_the_streams_in_hand():
    """A run of reshapes from 4 lanes: 6 makes 2 streams, 4 makes none, 8
    makes 2 more; each warm-up runs the chains on the streams it made,
    then on every stream of the run."""
    seam = WallSeam()
    srv, calls = _warm_server(seam)
    be, sched = srv.backend, srv.core.sched
    be.start()
    try:
        for shape, made in (((3, 2), 2), ((4, 1), 0), ((2, 4), 2)):
            n_before = len(be._slots)
            calls.clear()
            sched.reconfigure(be.now_ms(), n_contexts=shape[0],
                              n_streams=shape[1])
            be.on_reconfigure()
            assert len(be._slots) == n_before + made
            want = (_stream_chains(be._slots[n_before:])
                    + _stream_chains(be._slots)) if made else []
            assert calls == want
            live = be._live_lanes()
            assert len({id(be._streams[ln]) for ln in live}) == len(live)
        assert be.rewarm["count"] == 2 and len(be._slots) == 8
    finally:
        be.stop()


def test_a_scale_out_takes_the_failed_contexts_streams():
    """Context 0 fails (its 2 lanes' stages dropped at harvest); the
    context a scale-out adds takes context 0's 2 streams at its lanes'
    first launches, with no warm-up; a second scale-out, with no stream
    free, makes and warms one stream a lane before that lane's first
    launch (``rewarm``)."""
    seam = WallSeam()
    srv, calls = _warm_server(seam)
    be, sched = srv.backend, srv.core.sched
    be.start()
    try:
        failed = [be._streams[(0, s)] for s in range(2)]
        calls.clear()
        be.cancel_ctx(0)
        sched.fail_context(0, be.now_ms())
        ctx = sched.add_context(be.now_ms())
        lanes = [(ctx.index, s) for s in range(ctx.n_streams)]
        assert [be._lane_stream(ln) for ln in lanes] == failed
        assert calls == [] and be.rewarm["count"] == 0
        assert len(be._slots) == 4
        more = sched.add_context(be.now_ms())
        for s in range(more.n_streams):
            stream = be._lane_stream((more.index, s))
            assert stream is be._slots[-1]
            assert calls[:3] == _stream_chains([stream])
            calls.clear()
        assert be.rewarm["count"] == 2 and len(be._slots) == 6
        live = be._live_lanes()
        assert len({id(be._streams[ln]) for ln in live}) == len(live) == 6
    finally:
        be.stop()


def test_a_scale_out_past_the_plan_warms_its_stream_before_its_launch():
    """A lane no hook announced (a scale-out the run's plan did not name)
    launches: its new stream is warmed first, then its stage is enqueued
    on that stream."""
    seam, work = WallSeam(), [1.0]
    be, instance = _bare_backend(seam, work)
    order = []
    warm, enqueue = be._warm_streams, be._enqueue

    def warmed(new):
        order.append(("warm", [id(s) for s in new]))
        return warm(new)

    def enqueued(rec, stream):
        order.append(("enqueue", id(stream)))
        return enqueue(rec, stream)
    be._warm_streams, be._enqueue = warmed, enqueued
    try:
        ctx = be.core.sched.add_context(be.now_ms())
        inst = instance()
        be.launch((ctx.index, 0), inst)
        new = be._slots[-1]
        assert order == [("warm", [id(new)]), ("enqueue", id(new))]
        assert be.rewarm["count"] == 1 and be.rewarm["s"] > 0.0
        done = _drain(be, be.now_ms() + 2000.0)
        assert [(c.lane, c.inst) for c in done] == [((ctx.index, 0), inst)]
    finally:
        be.stop()


def test_a_stage_on_a_reused_stream_starts_after_the_ghost_before_it():
    """Context 1's stage (30 ms) becomes a ghost when the context fails;
    the scale-out's lane takes its stream while it is in flight (no other
    is free), so its stage (5 ms) runs after the ghost in stream order and
    is the only one committed."""
    seam, work = WallSeam(), [30.0]
    be, instance = _bare_backend(seam, work)
    sched = be.core.sched
    try:
        ghost, c = instance(), instance()
        be.launch((1, 0), ghost)
        be.cancel_ctx(1)
        sched.fail_context(1, be.now_ms())
        ctx = sched.add_context(be.now_ms())
        lane = (ctx.index, 0)
        work[0] = 5.0
        t0 = time.perf_counter()
        be.launch(lane, c)
        assert be._streams[lane] is be._streams[(1, 0)]
        assert len(be._slots) == 2 and be.rewarm["count"] == 0
        done = _drain(be, be.now_ms() + 2000.0)
        assert [(d.lane, d.inst) for d in done] == [(lane, c)]
        assert (time.perf_counter() - t0) * 1000.0 >= 30.0
        assert done[0].et_ms >= 30.0              # behind the ghost
        assert ghost.job.job_id not in be._job_state
        assert float(be._job_state[c.job.job_id]) == 2.0
        assert not be.has_inflight()
    finally:
        be.stop()


def test_a_new_lane_prefers_a_free_stream_with_no_stage_in_flight():
    """A same-size reshape while the first-made stream still runs a stage
    of its retired lane: the first new lane takes the idle stream, the
    second the busy one; the retired lane's stage still commits (a
    reshape retires, it does not cancel)."""
    seam, work = WallSeam(), [40.0]
    be, instance = _bare_backend(seam, work)
    sched = be.core.sched
    try:
        first, idle = be._streams[(0, 0)], be._streams[(1, 0)]
        busy = instance()
        be.launch((0, 0), busy)
        sched.reconfigure(be.now_ms(), n_contexts=2)
        be.on_reconfigure()
        lanes = be._live_lanes()
        assert [be._streams[ln] for ln in lanes] == [idle, first]
        done = _drain(be, be.now_ms() + 2000.0)
        assert [(d.lane, d.inst) for d in done] == [((0, 0), busy)]
        be._free_streams()                 # lets go of the retired lanes
        assert set(be._streams) == set(lanes)
    finally:
        be.stop()


def test_inline_path_with_a_reshape_makes_the_simulators_decisions():
    """The slowed fixed-time scenario with a reshape to 3 contexts at 340
    ms, while every lane is idle (between the LP job's end at 180 ms and
    the next HP release at 500): decisions identical to the simulator's,
    every stage inline, the third lane's stream made and warmed before
    the clock started, the others the retired lanes'."""
    def reshaped(cfg):
        return cfg.reconfigure_at(340.0, n_contexts=3)
    sim = reshaped(slowed(fixed_time(api))).build()
    m_sim = sim.run()
    seam = WallSeam()
    real = with_payloads(reshaped(slowed(fixed_time(api, realtime=True))),
                         seam).build()
    paths = on_stand_in(real, seam)
    m_real = real.run()
    assert real.decisions == sim.decisions and len(sim.decisions) > 20
    assert any(d.startswith("reconfigure") for d in sim.decisions)
    assert m_real.completed == m_sim.completed
    assert m_real.rejected == m_sim.rejected
    be = real.backend
    assert paths and {p for p, _ in paths} == {"inline"}
    assert be.worker_exceptions == 0 and be.pool_stage_runs == 0
    assert len(be._slots) == 3 and be.rewarm["count"] == 0
    assert len({id(be._streams[ln]) for ln in be._live_lanes()}) == 3


def drill(mod, kind: str):
    """``chip_smoke.py``'s drill on the simulator: an HP and an LP task
    of four short stages at 30 jobs/s (about ResNet18's), 2 contexts x 2
    streams at 2.0 on 132 units (an H100's SMs), 3 s, seed 0, with the
    simulator's stage noise."""
    specs = [make_spec(mod, name, prio, [0.6, 0.5, 0.5, 0.4], 1000.0 / 30,
                       n_sat=8.0)
             for name, prio in (("hp", mod.HP), ("lp", mod.LP))]
    cfg = (mod.ServerConfig.sim().tasks(specs).contexts(2).streams(2)
           .oversubscribe(2.0).device(mod.DeviceModel(n_units=132.0))
           .horizon_ms(3000.0).seed(0).record_decisions())
    return DRILLS[kind][0](cfg, 3000.0)


@pytest.mark.parametrize("kind", list(DRILLS))
def test_port_sim_matches_reference_sim_on_the_drills(kind):
    """The drill on the port's simulator and on ``repro``'s: decision logs,
    completions, rejections, responses and summaries identical bit for
    bit, with the drill's events in the log."""
    ref = drill(ref_api, kind).build()
    ours = drill(api, kind).build()
    m_ref, m_ours = ref.run(), ours.run()
    assert ours.decisions == ref.decisions
    assert len(ref.decisions) > 200
    word = "reconfigure" if kind == "reshape" else "scale-out"
    assert sum(d.startswith(word) for d in ref.decisions) == \
        (3 if kind == "reshape" else 1)
    if kind == "scale_out":               # the added context gets work
        assert any("lane(2," in d for d in ref.decisions)
    assert m_ours.completed == m_ref.completed
    assert m_ours.rejected == m_ref.rejected
    assert m_ours.response_ms == m_ref.response_ms
    assert m_ours.summary() == m_ref.summary()

"""The port's serving front-end (``repro_torch.serve``) and SchedCheck CLI
against the JAX package's.

``serve/{journal,client,config,daemon}.py`` are copies whose relative
imports resolve to the port's facade; ``serve/__main__.py`` and
``analysis/schedcheck/__main__.py`` are written by the port. Held here:

- twins of every test of tests/test_serve.py on the port: the handle
  lifecycle, journal semantics, daemon socket round trips, SIGTERM restart
  with zero acknowledged-but-lost jobs, and the journal -> TraceArrival
  bit-identical replay; where a run is deterministic, its numbers are the
  reference's;
- a journal recorded by either package's live daemon replays through
  either package's ``to_trace_arrivals`` and ``build_server`` with the
  live run's digest (``_digest`` of tests/test_serve.py);
- every CLI verb of ``python -m repro_torch.serve``, and the fsck and
  daemon-refusal tests of tests/test_chaos.py;
- twins of tests/test_schedcheck.py's daemon-config and CLI tests, with
  the report JSON identical to ``repro``'s, and the CLI's ``--figure``,
  ``--all-figures``, ``--list`` and ``--oracle`` over
  ``benchmarks/figure_specs_torch.py``.

Every daemon runs on a thread that each test joins under a timeout.
"""
import importlib
import json
import math
import threading
import types

import pytest

torch = pytest.importorskip("torch")

from tests.test_serve import _digest, daemon_cfg  # noqa: E402


def _package(name):
    ns = types.SimpleNamespace(name=name)
    for attr, mod in (("api", "api"), ("serve", "serve"),
                      ("journal", "serve.journal"),
                      ("client", "serve.client"),
                      ("config", "serve.config"),
                      ("cli", "serve.__main__"),
                      ("sc", "analysis.schedcheck"),
                      ("sc_cli", "analysis.schedcheck.__main__")):
        setattr(ns, attr, importlib.import_module(f"{name}.{mod}"))
    return ns


REF, PORT = _package("repro"), _package("repro_torch")
api = PORT.api
HP, LP = api.HP, api.LP
JOIN_S = 10.0


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


def serving_server(m, specs, *, contexts=1):
    cfg = m.api.ServerConfig.sim()
    for s in specs:
        cfg.task(s, arrival=m.api.ManualArrival())
    srv = (cfg.contexts(contexts).streams(1)
           .oversubscribe(float(contexts))
           .device(m.api.DeviceModel(n_units=4.0, bubble=0.0,
                                     l2_pressure=0.0))
           .horizon_ms(1e6).phase_offsets(False).noise(0.0).seed(0)
           .build())
    srv.begin_serving()
    return srv


def both(fn):
    """``fn(m)`` for the reference and the port; the port's result must
    be the reference's."""
    ref, port = fn(REF), fn(PORT)
    assert port == ref
    return port


# --------------------------------------------------- SubmitHandle surface
def test_handle_lifecycle_queued_running_completed():
    def run(m):
        H = m.api.SubmitHandle
        srv = serving_server(m, [make_spec(m, "hog", HP, [30.0], 1000.0),
                                 make_spec(m, "lp", LP, [10.0], 1000.0)])
        srv.request("hog", at_ms=0.0)
        h = srv.request("lp", at_ms=5.0)
        seen = [h.status == H.PENDING, h.done]
        srv.pump(5.0)
        seen += [h.status == H.QUEUED, h.status == H.ADMITTED]
        srv.pump(30.0)
        seen.append(h.status == H.RUNNING)
        srv.pump(45.0)
        seen += [h.status == H.COMPLETED, h.done, srv.serving_idle()]
        r = h.result()
        srv.end_serving()
        return seen, h.response_ms.hex(), r
    seen, resp, r = both(run)
    assert seen == [True, False, True, True, True, True, True, True]
    assert float.fromhex(resp) == pytest.approx(35.0)
    assert r["status"] == "completed"
    assert r["task"] == "lp" and r["release_ms"] == 5.0


def test_handle_rejected_on_admission_failure():
    def run(m):
        srv = serving_server(m, [make_spec(m, "lp", LP, [900.0], 1000.0)])
        h1 = srv.request("lp", at_ms=0.0)
        h2 = srv.request("lp", at_ms=1.0)
        srv.pump(1.0)
        out = (h1.status, h2.status, h2.done)
        return out, srv.end_serving().rejected[LP]
    (s1, s2, done), rejected = both(run)
    assert s1 in ("queued", "running")
    assert s2 == "rejected" and done and rejected == 1


def test_handle_missed_when_deadline_blown():
    def run(m):
        srv = serving_server(m, [make_spec(m, "hp", HP, [30.0], 20.0)])
        h = srv.request("hp", at_ms=0.0)
        srv.pump(0.0)
        met = srv.end_serving()
        return h.status, h.done, h.response_ms, met.missed[HP], \
            met.completed[HP]
    status, done, resp, missed, completed = both(run)
    assert status == "missed" and done
    assert resp == pytest.approx(30.0)
    assert missed == 1 and completed == 1


def test_per_tenant_accounting():
    def run(m):
        srv = serving_server(m, [make_spec(m, "lp", LP, [10.0], 1000.0)])
        srv.request("lp", at_ms=0.0, tenant="teamA")
        srv.request("lp", at_ms=40.0, tenant="teamA")
        srv.request("lp", at_ms=80.0, tenant="teamB")
        met = srv.end_serving()
        return met.per_tenant, "per_tenant" in met.summary()
    per, in_summary = both(run)
    assert set(per) == {"teamA", "teamB"} and in_summary
    assert per["teamA"]["submitted"] == 2
    assert per["teamA"]["completed"] == 2
    assert per["teamB"]["submitted"] == 1
    assert per["teamB"]["resp"]["mean"] == pytest.approx(10.0)


def test_serving_metrics_horizon_is_elapsed_time():
    def run(m):
        srv = serving_server(m, [make_spec(m, "lp", LP, [10.0], 1000.0)])
        srv.request("lp", at_ms=5.0)
        return srv.end_serving().horizon_ms
    assert both(run) == pytest.approx(15.0)      # not the 1e6 guard


# -------------------------------------------------------- journal basics
def test_journal_append_and_read(tmp_path):
    J = PORT.journal
    p = tmp_path / "j.jsonl"
    j = J.Journal(p)
    j.append({"rec": "submit", "seq": 0, "task": "t", "at_ms": 1.0})
    j.append({"rec": "done", "seq": 0, "status": "completed",
              "response_ms": 9.5})
    j.close()
    recs = J.read_journal(p)
    assert recs[0]["rec"] == "meta" and recs[0]["version"] == 1
    assert [r["rec"] for r in recs[1:]] == ["submit", "done"]
    # reopening an existing journal must NOT write a second meta record
    J.Journal(p).close()
    assert [r["rec"] for r in J.read_journal(p)].count("meta") == 1
    # the reference reads the port's journal as the port does
    assert REF.journal.read_journal(p) == J.read_journal(p)


def test_journal_drops_torn_tail(tmp_path):
    J = PORT.journal
    p = tmp_path / "j.jsonl"
    j = J.Journal(p)
    j.append({"rec": "submit", "seq": 0, "task": "t", "at_ms": 1.0})
    j.close()
    with open(p, "a", encoding="utf-8") as f:
        f.write('{"rec": "submit", "seq": 1, "ta')    # crash mid-write
    recs = J.read_journal(p)
    assert [r.get("seq") for r in J.submit_records(recs)] == [0]


def test_unfinished_and_audit():
    J = PORT.journal
    recs = [
        {"rec": "meta", "version": 1},
        {"rec": "submit", "seq": 0, "task": "a", "at_ms": 1.0},
        {"rec": "submit", "seq": 1, "task": "a", "at_ms": 2.0},
        {"rec": "submit", "seq": 2, "task": "b", "at_ms": 3.0},
        {"rec": "done", "seq": 1, "status": "completed",
         "response_ms": 5.0},
        {"rec": "resubmitted", "seq": 0, "at_ms": 9.0},
    ]
    # resubmitted does not finish a seq; 0 and 2 are still owed
    assert [r["seq"] for r in J.unfinished_submits(recs)] == [0, 2]
    assert J.audit_zero_lost(recs) == [0, 2]
    recs.append({"rec": "done", "seq": 0, "status": "cancelled",
                 "response_ms": None})
    recs.append({"rec": "done", "seq": 2, "status": "missed",
                 "response_ms": 30.0})
    assert J.audit_zero_lost(recs) == []


def test_to_trace_arrivals_and_replay_plan():
    J = PORT.journal
    recs = [
        {"rec": "submit", "seq": 0, "task": "a", "at_ms": 1.0},
        {"rec": "submit", "seq": 1, "task": "b", "at_ms": 2.0},
        {"rec": "submit", "seq": 2, "task": "a", "at_ms": 7.0},
        {"rec": "cancel", "seq": 1, "at_ms": 3.0},
    ]
    arr = J.to_trace_arrivals(recs)
    assert set(arr) == {"a", "b"}
    assert type(arr["a"]) is api.TraceArrival      # the port's class
    assert list(arr["a"].times) == [1.0, 7.0]
    arr2 = J.to_trace_arrivals(recs, until_ms=2.0)
    assert list(arr2["a"].times) == [1.0]
    subs, cancels = J.replay_plan(recs)
    assert len(subs) == 3 and cancels == [(1, 3.0)]


# ------------------------------------------------------- daemon fixtures
def start_daemon(tmp_path, name="d", cfg=None, m=PORT, **kw):
    d = m.serve.ServeDaemon(cfg or daemon_cfg(),
                            socket_path=str(tmp_path / f"{name}.sock"),
                            journal_path=str(tmp_path / "journal.jsonl"),
                            checkpoint_path=str(tmp_path / "ckpt.msgpack"),
                            **kw)
    th = threading.Thread(target=d.run, daemon=True)
    th.start()
    c = m.serve.DarisClient(d.socket_path)
    c.wait_up()
    return d, th, c


def join(th):
    th.join(timeout=JOIN_S)
    assert not th.is_alive()


def test_daemon_round_trip(tmp_path):
    d, th, c = start_daemon(tmp_path, time_scale=200.0, tick_ms=1.0)
    assert type(d.server) is api.DarisServer      # the port's engine
    assert c.ping()["ok"]
    s0 = c.submit("resnet18", tenant="teamA")
    assert s0["status"] in ("queued", "running", "completed")
    s1 = c.submit("unet", tenant="teamB")
    r0 = c.result(s0["seq"], timeout_s=30.0)
    assert r0["status"] in ("completed", "missed")
    assert r0["tenant"] == "teamA" and r0["response_ms"] is not None
    st = c.status(s1["seq"])
    assert st["ok"] and st["task"] == "unet"
    stats = c.stats()
    assert stats["submitted"] == 2
    assert "completed" in stats["snapshot"]
    assert "cancelled" in stats["snapshot"]
    # unknown task / unknown seq are clean errors, not daemon deaths
    with pytest.raises(PORT.client.DaemonError, match="KeyError"):
        c.submit("nonexistent-model")
    with pytest.raises(PORT.client.DaemonError, match="unknown seq"):
        c.cancel(999)
    out = c.drain()
    join(th)
    assert out["lost"] == []
    assert out["summary"]["jps_hp"] > 0.0       # the HP job completed
    assert PORT.journal.audit_zero_lost(
        PORT.journal.read_journal(tmp_path / "journal.jsonl")) == []


def test_daemon_cancel_round_trip(tmp_path):
    # virtual time frozen at ticks: submissions stay queued long enough
    # to be cancelled deterministically
    d, th, c = start_daemon(tmp_path, time_scale=0.0, tick_ms=1.0)
    s = c.submit("unet", tenant="teamA")
    assert s["status"] == "running"      # empty engine: dispatches at once
    out = c.cancel(s["seq"])
    assert out["status"] == "cancelled"
    r = c.result(s["seq"], timeout_s=5.0)
    assert r["status"] == "cancelled"
    fin = c.drain()
    join(th)
    assert fin["summary"]["cancelled_lp"] == 1
    assert fin["lost"] == []
    recs = PORT.journal.read_journal(tmp_path / "journal.jsonl")
    assert [r["rec"] for r in recs if r.get("seq") == s["seq"]] \
        == ["submit", "cancel", "done"]


def test_daemon_sigterm_restart_zero_lost(tmp_path):
    """Acknowledge work, die by SIGTERM with it unfinished, restart on the
    same journal+checkpoint (the checkpoint the port's codec wrote, which
    the reference reads too), finish every acknowledged seq under its
    original identity."""
    J = PORT.journal
    d1, th1, c1 = start_daemon(tmp_path, name="d1", time_scale=1e-7)
    seqs = [c1.submit("resnet18", tenant="teamA")["seq"] for _ in range(3)]
    seqs.append(c1.submit("unet", tenant="teamB")["seq"])
    d1._on_signal(None, None)            # what SIGTERM delivers
    join(th1)

    recs = J.read_journal(tmp_path / "journal.jsonl")
    assert J.audit_zero_lost(recs) == seqs                # owed, not lost
    assert any(r["rec"] == "checkpoint" for r in recs)
    ref_srv = REF.config.build_server(daemon_cfg())
    ref_srv.load_state(str(tmp_path / "ckpt.msgpack"))
    assert [t.ctx for t in ref_srv.scheduler.tasks] == \
        [t.ctx for t in d1.server.scheduler.tasks]

    d2, th2, c2 = start_daemon(tmp_path, name="d2", time_scale=500.0)
    for seq in seqs:
        r = c2.result(seq, timeout_s=30.0)
        assert r["status"] in ("completed", "missed")
    fin = c2.drain()
    join(th2)
    assert fin["lost"] == []
    recs = J.read_journal(tmp_path / "journal.jsonl")
    assert J.audit_zero_lost(recs) == []
    assert sum(r["rec"] == "resubmitted" for r in recs) == len(seqs)


# ---------------------------------------------- bit-identical replay
def _record(m, tmp_path):
    """tests/test_serve.py's replay traffic through package ``m``'s live
    daemon (batching off, time_scale 0: stamps from the tick alone);
    returns the live metrics, the journal and the config."""
    cfg = daemon_cfg()
    del cfg["batching"]
    d, th, c = start_daemon(tmp_path, cfg=cfg, m=m, time_scale=0.0,
                            tick_ms=5.0)
    for i in range(12):
        c.submit("resnet18" if i % 3 else "unet",
                 tenant="teamA" if i % 2 else "teamB")
    c.drain()
    join(th)
    live = d.final_metrics
    assert sum(live.completed.values()) > 0
    return live, m.journal.read_journal(tmp_path / "journal.jsonl"), cfg


@pytest.mark.parametrize("recorder, replayer", [
    (PORT, PORT), (REF, PORT), (PORT, REF)],
    ids=["port-port", "ref-port", "port-ref"])
def test_journal_replay_is_bit_identical(tmp_path, recorder, replayer):
    """Traffic recorded by a live daemon, replayed from the journal as
    TraceArrival into a freshly built engine, reproduces the run
    bit-exactly (``_digest``: counts and SHA-256 over the IEEE-754
    response times) — across the two packages too."""
    live, recs, cfg = _record(recorder, tmp_path)
    arrivals = replayer.journal.to_trace_arrivals(recs)
    m = replayer.config.build_server(cfg, arrivals=arrivals).drain()
    assert _digest(m) == _digest(live)


def test_replay_cli_and_audit_cli(tmp_path, capsys):
    main = PORT.cli.main
    cfg_path = tmp_path / "serve.json"
    cfg_path.write_text(json.dumps(daemon_cfg()))
    d, th, c = start_daemon(tmp_path, time_scale=0.0, tick_ms=5.0)
    c.submit("unet")
    c.drain()
    join(th)
    jrn = str(tmp_path / "journal.jsonl")
    capsys.readouterr()
    assert main(["audit", "--journal", jrn]) == 0
    assert main(["replay", "--config", str(cfg_path),
                 "--journal", jrn]) == 0
    port_out = capsys.readouterr().out
    assert REF.cli.main(["audit", "--journal", jrn]) == 0
    assert REF.cli.main(["replay", "--config", str(cfg_path),
                         "--journal", jrn]) == 0
    assert port_out == capsys.readouterr().out    # same words, same JSON
    # an owed seq flips the audit to failing
    PORT.journal.Journal(jrn).append({"rec": "submit", "seq": 99,
                                      "task": "unet", "at_ms": 1e6})
    assert main(["audit", "--journal", jrn]) == 1


def test_build_server_requires_tasks():
    with pytest.raises(ValueError, match="at least one task"):
        PORT.serve.build_server({"tasks": []})


# -------------------------------------------------- CLI: the client verbs
def test_cli_client_verbs_against_a_live_daemon(tmp_path, capsys):
    """submit, status, result, cancel, stats and drain through ``python -m
    repro_torch.serve``'s ``main``; then shutdown, which checkpoints."""
    main = PORT.cli.main
    d, th, c = start_daemon(tmp_path, time_scale=200.0, tick_ms=1.0)
    sock = ["--socket", d.socket_path]

    def verb(*argv):
        capsys.readouterr()
        assert main([*argv, *sock]) == 0
        return json.loads(capsys.readouterr().out)

    seq = verb("submit", "--task", "resnet18", "--tenant", "teamA")["seq"]
    assert verb("status", "--seq", str(seq))["task"] == "resnet18"
    assert verb("result", "--seq", str(seq), "--timeout-s", "30")[
        "status"] in ("completed", "missed")
    lp = verb("submit", "--task", "unet")["seq"]
    assert verb("cancel", "--seq", str(lp))["seq"] == lp
    assert verb("stats")["submitted"] == 2
    assert verb("drain")["lost"] == []
    join(th)

    d, th, c = start_daemon(tmp_path, name="d2", time_scale=1e-7)
    sock = ["--socket", d.socket_path]
    c.submit("resnet18")
    assert verb("shutdown")["open"] == [2]
    join(th)
    recs = PORT.journal.read_journal(tmp_path / "journal.jsonl")
    assert recs[-1]["rec"] == "checkpoint"


# ------------------------------------------- fsck (twins of test_chaos.py)
def _write_journal(path, lines):
    path.write_text("\n".join(lines) + "\n")


def test_fsck_cli_verb(tmp_path, capsys):
    """Twin of test_chaos.py's test: refuse without --yes, repair with
    it; the port's words are the reference's."""
    good = [json.dumps({"rec": "submit", "seq": i}) for i in range(3)]
    outs = []
    for m in (REF, PORT):
        p = tmp_path / f"{m.name}.jsonl"
        _write_journal(p, good[:2] + ["@@rot@@"] + good[2:])
        capsys.readouterr()
        assert m.cli.main(["fsck", "--journal", str(p)]) == 1
        out = capsys.readouterr().out
        assert "CORRUPT" in out
        assert m.cli.main(["fsck", "--journal", str(p), "--yes"]) == 0
        assert m.cli.main(["fsck", "--journal", str(p)]) == 0  # clean now
        outs.append(out + capsys.readouterr().out)
    assert outs[1] == outs[0]


def test_daemon_refuses_midfile_corrupt_journal(tmp_path):
    """Twin of test_chaos.py's test (the message names the reference's
    CLI: the daemon module is a copy)."""
    p = tmp_path / "journal.jsonl"
    rec = {"rec": "submit", "seq": 0, "task": "resnet18", "tenant": None,
           "prio": 0, "at_ms": 1.0}
    _write_journal(p, [json.dumps({"rec": "meta", "version": 1}),
                       "@@rot@@", json.dumps(rec)])
    with pytest.raises(RuntimeError, match="serve fsck"):
        PORT.serve.ServeDaemon(daemon_cfg(),
                               socket_path=str(tmp_path / "d.sock"),
                               journal_path=str(p))


# ------------------------------- SchedCheck's daemon-config side and CLI
def test_check_schedulability_modes():
    sc = PORT.sc
    check = PORT.config.check_schedulability
    cfg = {"tasks": [{"dnn": "resnet18", "priority": "HP", "jps": 30.0}],
           "contexts": 2, "streams": 1, "oversubscribe": 2.0, "seed": 0}
    assert check(cfg) is None                           # default: off
    rep = check({**cfg, "schedcheck": "warn"})
    assert rep is not None and rep.hp_verdict in (sc.GUARANTEED,
                                                  sc.CONDITIONAL)
    assert rep.to_json() == REF.config.check_schedulability(
        {**cfg, "schedcheck": "warn"}).to_json()
    rep = check({**cfg, "schedcheck": "enforce"})
    assert rep.hp_verdict != sc.UNSCHEDULABLE
    with pytest.raises(ValueError, match="schedcheck mode"):
        check({**cfg, "schedcheck": "always"})


def test_enforce_mode_blocks_unschedulable_daemon_config(tmp_path):
    sc = PORT.sc
    cfg = {"tasks": [{"dnn": "unet", "priority": "HP", "jps": 2000.0}],
           "contexts": 1, "streams": 1, "oversubscribe": 1.0, "seed": 0,
           "schedcheck": "enforce"}
    with pytest.raises(sc.UnschedulableError):
        PORT.config.check_schedulability(cfg)
    # the daemon refuses to start on it, before any engine exists
    with pytest.raises(sc.UnschedulableError):
        PORT.serve.ServeDaemon(cfg, socket_path=str(tmp_path / "d.sock"),
                               journal_path=str(tmp_path / "j.jsonl"))
    # the same config in warn mode reports instead of raising
    rep = PORT.config.check_schedulability({**cfg, "schedcheck": "warn"})
    assert rep.hp_verdict == sc.UNSCHEDULABLE


def _cli_json(m, argv, path, capsys):
    capsys.readouterr()
    rc = m.sc_cli.main([*argv, "--json", str(path)])
    return rc, path.read_text(), capsys.readouterr().out


def test_cli_on_config_files(tmp_path, capsys):
    cfg = {"tasks": [{"dnn": "resnet18", "priority": "HP", "jps": 30.0},
                     {"dnn": "unet", "priority": "LP", "jps": 10.0}],
           "contexts": 2, "streams": 1, "oversubscribe": 2.0, "seed": 0}
    path = tmp_path / "serve.json"
    path.write_text(json.dumps(cfg))
    argv = [str(path), "--require-hp-guaranteed"]
    rc, doc, out = _cli_json(PORT, argv, tmp_path / "port.json", capsys)
    assert rc == 0
    payload = json.loads(doc)   # single config -> bare report
    assert payload["hp_verdict"] == PORT.sc.GUARANTEED
    assert math.isfinite(payload["hp_bound_ms"])
    assert "GUARANTEED" in out
    assert (rc, doc, out) == _cli_json(REF, argv, tmp_path / "ref.json",
                                       capsys)


def test_cli_fails_unschedulable_config(tmp_path, capsys):
    cfg = {"tasks": [{"dnn": "unet", "priority": "HP", "jps": 2000.0}],
           "contexts": 1, "streams": 1, "oversubscribe": 1.0, "seed": 0}
    path = tmp_path / "hot.json"
    path.write_text(json.dumps(cfg))
    assert PORT.sc_cli.main([str(path)]) == 1
    capsys.readouterr()


def test_cli_usage_error_is_2(capsys):
    assert PORT.sc_cli.main([]) == 2
    capsys.readouterr()


def test_shipped_example_configs_are_guaranteed(tmp_path, capsys):
    argv = ["examples/configs/serve_basic.json",
            "examples/configs/serve_tiered.json", "--require-hp-guaranteed"]
    port = _cli_json(PORT, argv, tmp_path / "port.json", capsys)
    assert port[0] == 0
    assert port == _cli_json(REF, argv, tmp_path / "ref.json", capsys)


def test_cli_lists_and_analyzes_every_figure(tmp_path, capsys):
    """``--list`` and ``--all-figures`` over the port's figure registry
    (benchmarks/figure_specs_torch.py) print and write what the
    reference's CLI does over benchmarks/figure_specs.py."""
    for m in (REF, PORT):
        capsys.readouterr()
        assert m.sc_cli.main(["--list"]) == 0
        listed = capsys.readouterr().out
        if m is REF:
            want = listed
    assert listed == want and "fig13_light" in listed.split()
    port = _cli_json(PORT, ["--all-figures"], tmp_path / "p.json", capsys)
    assert port == _cli_json(REF, ["--all-figures"], tmp_path / "r.json",
                             capsys)
    assert len(json.loads(port[1])) == len(listed.split())


@pytest.mark.parametrize("name", ["fig4_6_light", "fig13_light"])
def test_cli_oracle_on_a_figure(tmp_path, capsys, name):
    """``--figure NAME --oracle``: the simulated differential check runs
    on the port and its report, JSON and exit code are the reference's."""
    argv = ["--figure", name, "--oracle", "--require-hp-guaranteed"]
    port = _cli_json(PORT, argv, tmp_path / "p.json", capsys)
    assert port[0] == 0 and json.loads(port[1])["oracle"]["ok"]
    assert port == _cli_json(REF, argv, tmp_path / "r.json", capsys)


def test_figure_registry_twin_is_the_reference_s():
    """benchmarks/figure_specs_torch.py: the same names, smoke oracle set
    and scenarios (analyzed alike) as benchmarks/figure_specs.py."""
    import benchmarks.figure_specs as ref_specs
    import benchmarks.figure_specs_torch as port_specs
    assert port_specs.names() == ref_specs.names()
    assert port_specs.ORACLE_SMOKE == ref_specs.ORACLE_SMOKE
    assert type(port_specs.scenario("fig13_light")) is api.ServerConfig
    assert [n for n, _ in port_specs.oracle_suite()] == \
        [n for n, _ in ref_specs.oracle_suite()]

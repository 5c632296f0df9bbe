"""``chip_smoke.py``'s run plans and its kernel rows' timing, on the CPU.

A ``torch.profiler`` session makes every later CUDA-graph launch of the
process dearer, so each plan serves everything before it profiles
anything, and the runner fails a phase that serves or opens a session
where its plan says it does not. The kernel phase times a row's plain
version at fewer repetitions than the kernel and the library call (a
yardstick, checked by one call), and gives each row its seconds.
"""
import inspect
import types

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402

# the default run's phases before the LM profiles moved (``phase_seconds``
# of the tree before), and the phase that now takes them
PHASES_BEFORE = {
    "kernels", "dryrun_wait", "contention", "resnet18_path", "unet_path",
    "inceptionv3_path", "drills", "resume_path", "profiles", "dense_path",
    "epoch_path", "ssm_path", "moe_path", "hybrid_path", "int8_path",
    "mla_path", "gemma2_path", "vlm_path", "encdec_path", "dh160_check",
    "train_path", "train_cut", "dist_path", "roofline_path", "cluster_path"}


@pytest.mark.parametrize("kind", ["default", "lm_paths", "families"])
def test_every_served_phase_comes_before_every_profiling_phase(kind):
    """Each plan (no arguments, ``--lm-paths``, ``--families``) serves in
    some phases and profiles in others, every serving phase before every
    profiling one; each phase once."""
    phases = chip_smoke.plan(kind)
    names = [ph.name for ph in phases]
    assert len(set(names)) == len(names)
    served = [i for i, ph in enumerate(phases) if ph.serves]
    profiling = [i for i, ph in enumerate(phases) if ph.sessions]
    assert served and profiling
    assert max(served) < min(profiling)
    assert not any(ph.serves and ph.sessions for ph in phases)
    assert {"profiles", "lm_profiles"} <= set(names)


def test_the_default_plan_keeps_every_phase_and_serves_the_five_lms():
    """The default plan runs every phase the script ran before, plus the
    LM profiles' own; the five served LM paths, the CNNs, the drills and
    resume serve, and the decode-step profiles of the unserved models
    (hybrid, int8, vlm, encdec) and the training step come after."""
    phases = {ph.name: ph for ph in chip_smoke.plan()}
    assert set(phases) == PHASES_BEFORE | {"lm_profiles"}
    serving = {n for n, ph in phases.items() if ph.serves}
    assert serving == {"resnet18_path", "unet_path", "inceptionv3_path",
                       "drills", "resume_path", "dense_path", "ssm_path",
                       "moe_path", "mla_path", "gemma2_path"}
    assert {"hybrid_path", "int8_path", "vlm_path", "encdec_path",
            "train_path"} <= {n for n, ph in phases.items() if ph.sessions}
    assert chip_smoke.plan("lm_paths")[1].name == "moe_path"
    assert [ph.name for ph in chip_smoke.plan("families")[1:3]] == [
        "mla_path", "gemma2_path"]
    with pytest.raises(ValueError, match="no plan named"):
        chip_smoke.plan("no such run")


@pytest.mark.parametrize("kind,names", [
    ("train", ["kernels", "profiles", "train_path", "train_cut"]),
    ("dist", ["kernels", "profiles", "dryrun_wait", "dist_path",
              "roofline_path"])])
def test_the_train_and_dist_plans_serve_nothing(kind, names):
    """``--train`` and ``--dist`` run their phases through plans too: no
    phase of theirs serves, and the kernel rows' profiles come right
    after the rows."""
    phases = chip_smoke.plan(kind)
    assert [ph.name for ph in phases] == names
    assert not any(ph.serves for ph in phases)


def test_the_script_defines_each_top_level_name_once():
    """No function, class or constant of ``chip_smoke.py`` is defined
    twice at its top level: a later definition would replace the earlier
    one for every caller (a phase helper named as the dist phase's
    ``lm_run`` once broke that phase on the card)."""
    import ast
    import collections
    tree = ast.parse(open(chip_smoke.__file__).read())
    names = collections.Counter()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names[node.name] += 1
        elif isinstance(node, ast.Assign):
            names.update(t.id for tg in node.targets for t in ast.walk(tg)
                         if isinstance(t, ast.Name))
    assert [n for n, k in names.items() if k > 1] == []


def _stand_in_torch():
    """What ``run_plan`` asks of ``torch``: the card's memory calls."""
    cuda = types.SimpleNamespace(reset_peak_memory_stats=lambda: None,
                                 max_memory_allocated=lambda: 0,
                                 empty_cache=lambda: None)
    return types.SimpleNamespace(cuda=cuda)


@pytest.mark.parametrize("flags", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_a_phase_that_profiles_or_serves_against_its_plan_fails(
        monkeypatch, flags):
    """A phase that opens a profiler session (through ``profiler``) or
    starts a served run (as ``guard_session_free`` marks it) fails the
    run where its plan does not say so, and passes where it does; each
    phase's seconds are kept."""
    for name in ("PROFILER_SESSIONS", "PHASES_RUN", "SERVED_STARTS"):
        monkeypatch.setattr(chip_smoke, name, [])
    serves, sessions = flags

    def profiles(c):
        chip_smoke.PROFILER_SESSIONS.append(chip_smoke.CURRENT_PHASE[0])

    def serving(c):
        chip_smoke.SERVED_STARTS.append({"kind": "lm", "model": "m"})
    c = chip_smoke.Run(_stand_in_torch(), None, [])
    chip_smoke.run_plan(c, [
        chip_smoke.Phase("a", serving, serves=serves),
        chip_smoke.Phase("b", profiles, sessions=sessions, free=True)])
    want = ([] if serves else ["phase a served, which its plan does not "
                                   "say"]) + \
        ([] if sessions else ["phase b opened a profiler session, which "
                              "its plan does not say"])
    assert c.failures == want
    assert set(c.seconds) == {"a", "b"}
    assert chip_smoke.PROFILER_SESSIONS == ["b"]


def _cases(fns):
    """``kernel_cases`` with two rows on the CPU: RMSNorm through its
    wrapper (its plain version here) at the default repetitions, timed in
    a graph, with the library call; and a heavy row's options (timed
    eagerly, 5 x 2). Each dtype's calls go into ``fns`` by role."""
    def cases(torch_, F, dtype):
        from repro_torch.kernels import rmsnorm as rms
        g = torch.Generator().manual_seed(0)
        x = torch.randn((4, 1, 64), generator=g).to(dtype)
        w = torch.randn((64,), generator=g).to(dtype)

        def kern():
            return rms.rmsnorm(x, w)

        def plain():
            return rms.rmsnorm_plain(x, w)

        def lib():
            return F.rms_norm(x, (64,), w, 1e-6)
        fns.update(kern=kern, plain=plain, lib=lib)
        return [("norm", kern, plain, lib, 1e3, 1e3, 1e12, {}),
                ("heavy", kern, plain, None, 1e3, 1e3, 1e12,
                 {"reps": 5, "inner": 2, "graph": False})]
    return cases


def test_the_plain_version_is_timed_at_its_own_repetitions(monkeypatch):
    """``kernel_phase`` with a stand-in timer: each row times its kernel
    and its library call at the row's repetitions (graph and eager), its
    plain version at ``PLAIN_REPS`` x ``PLAIN_INNER`` (or fewer), still
    holds one plain call against the kernel, and carries ``row_s``."""
    import torch.nn.functional as F
    timed, fns = [], {}

    def stand_in(kind, real):
        sig = inspect.signature(real)

        def timer(*args, **kw):
            b = sig.bind(*args, **kw)
            b.apply_defaults()
            who = next(k for k, f in fns.items() if f is b.arguments["fn"])
            timed.append((kind, who, b.arguments["reps"],
                          b.arguments["inner"]))
            return 1.0
        return timer
    monkeypatch.setattr(chip_smoke, "graph_ms",
                        stand_in("graph", chip_smoke.graph_ms))
    monkeypatch.setattr(chip_smoke, "cuda_ms",
                        stand_in("eager", chip_smoke.cuda_ms))
    monkeypatch.setattr(chip_smoke, "kernel_cases", _cases(fns))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: types.SimpleNamespace(
                            multi_processor_count=132))
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    failures = []
    rows = chip_smoke.kernel_phase(torch, F, failures)
    assert failures == [] and set(rows) == {"norm", "heavy"}
    checks = [ln["kernel_check"] for ln in lines]
    assert [(r["name"], r["dtype"]) for r in checks] == [
        ("norm", "bfloat16"), ("heavy", "bfloat16"),
        ("norm", "float32"), ("heavy", "float32")]
    pr, pi = chip_smoke.PLAIN_REPS, chip_smoke.PLAIN_INNER
    assert (pr, pi) == (3, 2)
    norm = [("graph", "kern", 30, 20), ("graph", "plain", pr, 2 * pi),
            ("eager", "kern", 30, 10), ("eager", "plain", pr, pi),
            ("graph", "lib", 30, 20), ("eager", "lib", 30, 10)]
    heavy = [("eager", "kern", 5, 2), ("eager", "plain", 3, 2),
             ("eager", "kern", 5, 2), ("eager", "plain", 3, 2)]
    assert timed == (norm + heavy) * 2
    for r in checks:
        assert r["within_tol"] and r["max_err"] == 0.0
        assert r["row_s"] > 0.0
        assert r["plain_reps"] == [pr, pi]
        assert r["plain_ms"] == r["kernel_ms"] == 1.0
    assert [r["reps"] for r in checks] == [[30, 10], [5, 2]] * 2


def test_the_dry_runs_start_at_once_and_are_killed_at_exit(monkeypatch,
                                                          tmp_path):
    """``start_dryruns``: every dry-run cell starts at once, the longest
    (the tiny train cell) first, each under ``nice -n 19`` and with its
    own log; at the script's exit those still running are killed and
    waited for, those that ended are left alone."""
    import sys
    started, at_exit = [], []

    class StandIn:
        def __init__(self, cmd, stdout=None, **kw):
            self.cmd, self.log, self.killed = cmd, stdout.name, False
            self.code = None if len(started) % 2 else 0
            started.append(self)

        def poll(self):
            return self.code

        def kill(self):
            self.killed = True

        def wait(self, timeout=None):
            self.code = -9
            return self.code
    monkeypatch.setattr(chip_smoke.subprocess, "Popen", StandIn)
    monkeypatch.setattr(chip_smoke.atexit, "register",
                        lambda fn, *a: at_exit.append((fn, a)))
    procs = chip_smoke.start_dryruns(tmp_path)
    n = (len(chip_smoke.DRYRUN_CELLS) + len(chip_smoke.DRYRUN_SINGLE)
         + len(chip_smoke.ROOF_CELLS) + len(chip_smoke.LAYOUTS))
    assert len(procs) == len(started) == n == 17
    assert [p for _, p, _ in procs] == started
    assert procs[0][0] == (*chip_smoke.DRYRUN_CELLS[0], "")
    for cell, proc, log in procs:
        assert proc.cmd[:4] == ["nice", "-n", "19", sys.executable]
        assert proc.cmd[4:7] == ["-m", "repro_torch.launch.dryrun",
                                 "--arch"]
        assert proc.log == str(log) and log.parent == tmp_path
    assert len(at_exit) == 1
    fn, args = at_exit[0]
    fn(*args)
    assert [p.killed for p in started] == [i % 2 == 1 for i in range(n)]
    assert all(p.poll() is not None for p in started)


def test_each_lm_profile_rebuilds_its_model_from_its_seed(monkeypatch):
    """``lm_profiles``: every served LM's decode-step profile is taken on
    an HP task rebuilt from its config at seed 0 and its served rate (no
    LP task), one step run before the profile; each line names the
    model, carries the profile's keys, the served phase's peak GB and
    the rebuild's seconds, and the card is freed after each."""
    import repro_torch.models as models
    calls = []

    class Model:
        def __init__(self, cfg):
            self.cfg = cfg
            calls.append(("build", cfg.name))

        def init_params(self, seed):
            calls.append(("params", self.cfg.name, seed))
            return {"seed": seed}

    def lm_specs(model, params, jps, lp=True):
        calls.append(("specs", model.cfg.name, params["seed"], jps, lp))
        return [f"{model.cfg.name}-hp"]

    def staged_step(spec):
        return lambda: calls.append(("step", spec))

    def profile_step(torch_, step):
        step()
        calls.append("profiled")
        return {"steps": 3, "wall_ms_per_step": 1.0}
    lines = []
    monkeypatch.setattr(models, "build_model", Model)
    monkeypatch.setattr(chip_smoke, "lm_specs", lm_specs)
    monkeypatch.setattr(chip_smoke, "staged_step", staged_step)
    monkeypatch.setattr(chip_smoke, "profile_step", profile_step)
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    monkeypatch.setattr(chip_smoke, "free_card",
                        lambda t: calls.append("freed"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    entries = [{"cfg": types.SimpleNamespace(name=n), "jps": j,
                "peak_memory_gb": g}
               for n, j, g in (("a", 2.0, 4.0), ("b", 1.0, 45.0))]
    chip_smoke.lm_profiles(torch, entries)
    assert entries == []
    for n, j in (("a", 2.0), ("b", 1.0)):
        i = calls.index(("build", n))
        assert calls[i:i + 7] == [
            ("build", n), ("params", n, 0), ("specs", n, 0, j, False),
            ("step", f"{n}-hp"), ("step", f"{n}-hp"), "profiled", "freed"]
    got = [ln["decode_step_profile"] for ln in lines]
    assert [p["model"] for p in got] == ["a", "b"]
    assert [p["peak_memory_gb"] for p in got] == [4.0, 45.0]
    for p in got:
        assert set(p) == {"model", "steps", "wall_ms_per_step",
                          "peak_memory_gb", "rebuild_s"}
        assert p["rebuild_s"] >= 0.0


def test_the_dist_rank_set_seconds_by_part():
    """``rank_part_seconds``: each part is its longest rank's, the start
    runs to the last rank's entry, and the rest makes up the set's wall."""
    ranks = [{"entered": 103.0, "setup_s": 20.0, "serve_s": 1.5,
              "layouts_s": 40.0},
             {"entered": 105.0, "setup_s": 18.0, "serve_s": 1.75,
              "layouts_s": 41.0}]
    got = chip_smoke.rank_part_seconds(ranks, 100.0, 80.0)
    assert got == {"start_s": 5.0, "setup_s": 20.0, "serve_s": 1.75,
                   "layouts_s": 41.0, "rest_s": 12.25}
    assert ranks[0]["entered"] == 103.0           # the records untouched


def test_the_cluster_phase_gives_its_seconds_by_part(monkeypatch):
    """``cluster_phase`` with stand-in engine runs and oracle: ``parts``
    sums each engine's run seconds over the three scenarios, the f64
    contention launches' seconds (the kernel runs' ``rates_for``) and the
    two oracle runs' seconds; the ``cluster`` lines are unchanged."""
    import repro_torch.analysis.schedcheck as schedcheck
    walls = iter([1.0, 2.0, 3.0, 10.0, 20.0, 30.0, 100.0, 200.0, 300.0])

    def run_engines(make_cfg, name, failures, rate_groups=False):
        runs = {label: {"wall_s": next(walls)} for label in
                ("heap", "epoch", "epoch_kernel_min_1")}
        runs["epoch_kernel_min_1"]["rates_for"] = {
            "calls": 5, "s": runs["epoch_kernel_min_1"]["wall_s"] / 2}
        return runs, True, "sha", {"contention_eta_f64": 5}

    class Cfg:
        def engine(self, name):
            return name
    res = types.SimpleNamespace(ok=True, verdict="ok", hp_verdict="ok",
                                bound_ms=1.0, observed_max_ms=0.5,
                                dmr_hp=0.0, vacuous=False, violations=[])
    lines = []
    monkeypatch.setattr(chip_smoke, "run_engines", run_engines)
    monkeypatch.setattr(chip_smoke, "fig13_light", Cfg)
    monkeypatch.setattr(chip_smoke, "fig13_fail_1of4", Cfg)
    monkeypatch.setattr(chip_smoke, "path_counts", lambda *a: {"k": 1})
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    monkeypatch.setattr(chip_smoke, "gpu_line", lambda: "card")
    monkeypatch.setattr(schedcheck, "differential_check",
                        lambda engine, label: res)
    parts, failures = {}, []
    launches = chip_smoke.cluster_phase(torch, failures, parts=parts)
    assert failures == []
    assert set(launches) == {"fleet_64dev_diurnal", "cluster_rn18_4gpu",
                             "fig13_fail_1of4", "fig13_light_oracle",
                             "fig13_fail_1of4_oracle"}
    oracle = parts.pop("oracle")
    assert parts == {"heap": 111.0, "epoch": 222.0,
                     "epoch_kernel_min_1": 333.0,
                     "contention_launch_s": 166.5}
    assert 0.0 <= oracle < 5.0
    assert [ln["cluster"]["scenario"] for ln in lines if "cluster" in ln] \
        == ["fleet_64dev_diurnal", "cluster_rn18_4gpu", "fig13_fail_1of4"]
    assert all("cluster_parts" not in ln for ln in lines)

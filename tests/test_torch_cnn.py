"""The port's staged CNNs (``repro_torch.models.cnn``) against the JAX
package's, stage by stage on the CPU, and served in real time through the
port's backend.

Both packages get the same parameters (drawn by numpy from a seed in the
reference's layouts, carried across by ``cnn_params_from_jax``) and the
same numpy input made from a seed. Every
stage's output is compared whole (UNet's ``(x, skips)`` too) after a layout
permute, in f32: the largest absolute difference must stay within 2e-4 of
the reference output's scale (``max(1, max |ref|)``). The sizes show the
traps of the reference's XLA semantics: 65 gives odd maps, asymmetric SAME
padding and UNet's odd resize targets; ResNet18 at 32 and batch 1 reaches a
1x1 map in stage 3, where ``bn_apply`` normalises one value a channel.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.cnn as ref_cnn  # noqa: E402
import repro.serving.requests as ref_requests  # noqa: E402
import repro_torch.models.cnn as cnn  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.analysis.sanitizer import Sanitizer  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import BUILDERS, cnn_params_from_jax  # noqa: E402
from repro_torch.serving import requests  # noqa: E402
from repro_torch.serving.engine import staged_cnn_taskspec  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-4          # of the reference output's scale, f32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps these tests from taking
    every core from wall-clock tests in other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_REFERENCE = {}


def reference(name):
    """The JAX package's model at width 8 with parameters drawn by numpy
    from a seed, in the reference's layouts: BN scales and biases are random
    too, so that a misplaced one shows. (The reference's own initialisers
    compile a program per parameter shape, several seconds a model; the
    stages are what is compared.) Built once per model."""
    if name not in _REFERENCE:
        rng = np.random.default_rng(0)

        def conv_init(ctx, kh, kw, cin, cout):
            w = rng.standard_normal((kh, kw, cin, cout)) / np.sqrt(kh * kw
                                                                   * cin)
            return w.astype(np.float32)

        def bn_init(ctx, c):
            return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                    "bias": (0.1 * rng.standard_normal(c)).astype(np.float32)}

        def dense_init(ctx, shape):
            w = rng.standard_normal(shape) / np.sqrt(shape[0])
            return w.astype(np.float32)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ref_cnn, "conv_init", conv_init)
            mp.setattr(ref_cnn, "bn_init", bn_init)
            mp.setattr(ref_cnn, "dense_init", dense_init)
            _REFERENCE[name] = ref_cnn.BUILDERS[name](width=8)
    return _REFERENCE[name]


def _flat(state):
    return [state[0], *state[1]] if isinstance(state, tuple) else [state]


def _as_nhwc(t: torch.Tensor) -> np.ndarray:
    a = t.detach().numpy()
    return a.transpose(0, 2, 3, 1) if a.ndim == 4 else a


def _max_rel_err(ref_state, port_state, last: bool):
    refs = [np.asarray(r) for r in _flat(ref_state)]
    # the port's last stage returns the reference's layout already
    ports = [(t.detach().numpy() if last else _as_nhwc(t))
             for t in _flat(port_state)]
    assert [r.shape for r in refs] == [p.shape for p in ports]
    return max(float(np.abs(r - p).max()) / max(1.0, float(np.abs(r).max()))
               for r, p in zip(refs, ports))


CASES = [("resnet18", 64, 2), ("resnet18", 65, 1), ("resnet18", 32, 1),
         ("resnet50", 64, 1), ("resnet50", 65, 2),
         ("unet", 64, 1), ("unet", 65, 2),
         ("inceptionv3", 64, 2), ("inceptionv3", 65, 1)]


@pytest.mark.parametrize("name,hw,batch", CASES,
                         ids=[f"{n}-{hw}-b{b}" for n, hw, b in CASES])
def test_every_stage_matches_the_reference(name, hw, batch):
    ref = reference(name)
    port = BUILDERS[name](width=8, device="cpu")
    params = cnn_params_from_jax(jax.device_get(ref.params), device="cpu")
    x = np.random.default_rng(hw + batch).standard_normal(
        (batch, hw, hw, 3)).astype(np.float32)
    rs, ps = jnp.asarray(x), torch.from_numpy(x)
    errs = []
    for i, (rst, pst) in enumerate(zip(ref.stages, port.stages)):
        rs = jax.jit(rst)(ref.params, rs)
        ps = pst(params, ps)
        errs.append(_max_rel_err(rs, ps, last=i == len(port.stages) - 1))
    assert max(errs) <= TOL, errs


def test_final_outputs_have_the_reference_shapes():
    x = torch.zeros((2, 33, 33, 3))
    for name in BUILDERS:
        m = BUILDERS[name](width=4, device="cpu")
        out = m.forward(m.params, x)
        want = (2, 33, 33, 2) if name == "unet" else (2, m.n_classes)
        assert tuple(out.shape) == want, name


@pytest.mark.parametrize("name", ["resnet18", "unet"])
def test_stage_errors_compares_every_output_of_every_stage(name):
    """``stage_errors`` (the card-against-CPU check of the card tests and
    chip_smoke.py), here the CPU against itself: zero at every stage, UNet's
    skips included; a stage that differs between the two chains shows as
    the difference over ``max(1, max |reference|)``."""
    m = BUILDERS[name](width=4, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 33, 33, 3)).astype(np.float32))
    assert cnn.stage_errors(m, x) == [0.0] * 4
    # the reference chain gets a copy of the parameter tree
    skew = dataclasses.replace(m, stages=[
        lambda p, s: s * (3.0 if p is m.params else 1.0),
        lambda p, s: s[:, :1] if p is m.params else s])
    x = torch.full((1, 2, 2, 3), 2.0)
    assert cnn.stage_errors(skew, x) == [2.0, float("inf")]


@pytest.mark.parametrize("size", range(1, 12))
@pytest.mark.parametrize("k,stride", [(1, 1), (3, 1), (5, 1), (7, 2),
                                      (3, 2), (2, 2), (1, 2)])
def test_same_pads_are_xla_s(size, k, stride):
    (want,) = jax.lax.padtype_to_pads((size,), (k,), (stride,), "SAME")
    assert cnn._same_pads(size, k, stride) == tuple(want)


@pytest.mark.parametrize("hw", [16, 17])
def test_strided_conv_and_max_pool_pad_as_xla(hw):
    """The stem's 7x7 stride-2 conv and its 3x3 stride-2 max pool: more
    padding at the end than at the start (zeros, ``-inf``)."""
    rng = np.random.default_rng(hw)
    x = rng.standard_normal((2, hw, hw, 3)).astype(np.float32)
    w = rng.standard_normal((7, 7, 3, 5)).astype(np.float32)
    want = np.asarray(ref_cnn.conv(jnp.asarray(x), jnp.asarray(w), 2))
    got = cnn.conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                   cnn_params_from_jax(w, device="cpu"), 2)
    np.testing.assert_allclose(_as_nhwc(got), want, rtol=1e-5, atol=1e-5)
    want = np.asarray(jax.lax.reduce_window(
        jnp.asarray(x), -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
        "SAME"))
    got = cnn.max_pool(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2)
    np.testing.assert_array_equal(_as_nhwc(got), want)


@pytest.mark.parametrize("shape", [(1, 1, 1, 6), (2, 1, 1, 6), (1, 3, 2, 6),
                                   (3, 5, 4, 6)])
def test_bn_apply_is_the_reference_s(shape):
    """Batch statistics over (N, H, W), biased variance; with one value a
    channel (which ``F.batch_norm`` refuses) the result is ``bias``."""
    rng = np.random.default_rng(len(shape) + shape[0])
    x = rng.standard_normal(shape).astype(np.float32)
    p = {"scale": rng.standard_normal(6).astype(np.float32),
         "bias": rng.standard_normal(6).astype(np.float32)}
    want = np.asarray(ref_cnn.bn_apply(jax.tree.map(jnp.asarray, p),
                                       jnp.asarray(x)))
    got = cnn.bn_apply(cnn_params_from_jax(p, device="cpu"),
                       torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(_as_nhwc(got), want, rtol=1e-5, atol=1e-5)
    if shape[0] * shape[1] * shape[2] == 1:
        np.testing.assert_array_equal(_as_nhwc(got)[0, 0, 0], p["bias"])


def test_params_from_jax_keeps_the_reference_tree():
    ref = reference("unet")
    tree = jax.device_get(ref.params)
    port = cnn_params_from_jax(tree, device="cpu")
    ref_leaves = jax.tree_util.tree_leaves_with_path(tree)
    for path, leaf in ref_leaves:
        t = port
        for key in path:
            t = t[getattr(key, "key", getattr(key, "idx", None))]
        want = (leaf.shape if leaf.ndim != 4
                else (leaf.shape[3], leaf.shape[2], *leaf.shape[:2]))
        assert tuple(t.shape) == want
    w = port["down0"]["c1"]["w"]
    assert w.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(
        w.permute(2, 3, 1, 0).numpy(), tree["down0"]["c1"]["w"])


@pytest.mark.parametrize("dnn", sorted(requests.TABLE2))
def test_table2_tasksets_are_the_reference_s(dnn):
    mine = requests.table2_taskset(dnn)
    theirs = ref_requests.table2_taskset(dnn)
    assert [(t.name, t.period_ms, t.priority,
             [(s.name, s.t_alone_ms, s.n_sat) for s in t.stages])
            for t in mine] == [
        (t.name, t.period_ms, t.priority,
         [(s.name, s.t_alone_ms, s.n_sat) for s in t.stages])
        for t in theirs]


# ---------------------------------------------------------------- serving
def _resnet18_specs(model, **kw):
    return [staged_cnn_taskspec(model, priority=api.HP, jps=20.0,
                                input_hw=32, tag="-hp", device="cpu", **kw),
            staged_cnn_taskspec(model, priority=api.LP, jps=20.0,
                                input_hw=32, tag="-lp0", device="cpu", **kw)]


def test_taskspec_calibrates_each_stage_and_runs_its_chain():
    model = BUILDERS["resnet18"](width=8, device="cpu")
    spec = _resnet18_specs(model)[0]
    assert [s.name for s in spec.stages] == [f"resnet18/s{j}"
                                             for j in range(4)]
    assert all(s.t_alone_ms > 0 for s in spec.stages)
    flat = staged_cnn_taskspec(model, priority=api.LP, jps=5.0,
                               calibrate=False, device="cpu")
    assert [s.t_alone_ms for s in flat.stages] == [1.0] * 4
    state = torch.randn(1, 32, 32, 3)
    want = model.forward(model.params, state)
    for st in spec.stages:
        state = st.payload(state)
    torch.testing.assert_close(state, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="lives on"):
        staged_cnn_taskspec(model, priority=api.HP, jps=5.0,
                            device="meta")


def test_realtime_backend_serves_staged_cnns():
    """Twin of tests/test_system.py's realtime CNN test on the port."""
    model = BUILDERS["resnet18"](width=8, device="cpu")
    srv = (api.ServerConfig.realtime(device="cpu")
           .tasks(_resnet18_specs(model))
           .contexts(2).oversubscribe(2.0)
           .device(api.DeviceModel(n_units=2.0))
           .horizon_ms(1500.0)
           .realtime_io(input_hw=32)
           .build())
    m = srv.run()
    assert srv.backend.worker_exceptions == 0
    assert m.completed[api.HP] > 0
    assert m.resp_stats(api.HP)["mean"] > 0


def test_realtime_backend_chaos_faults_and_retry():
    """Twin of tests/test_chaos.py's realtime chaos test: faults drawn on
    the engine thread at launch, failed completions never commit worker
    output, retries recover. Wall clock: it asserts no timings."""
    model = BUILDERS["resnet18"](width=8, device="cpu")
    srv = (api.ServerConfig.realtime(device="cpu")
           .tasks(_resnet18_specs(model)).contexts(2).oversubscribe(2.0)
           .device(api.DeviceModel(n_units=2.0)).horizon_ms(1500.0)
           .realtime_io(input_hw=32)
           .sanitize(level=1)
           .chaos(api.ChaosPlan(seed=0, stage_fault_rate=0.3,
                                retry=api.RetryPolicy(max_attempts=4,
                                                      backoff_ms=1.0)))
           .build())
    m = srv.run()
    s = srv.core._sanitizer
    assert isinstance(s, Sanitizer) and s.violations == 0 and s.audits > 0
    assert m.chaos_faults > 0 and m.retries > 0
    assert sum(m.completed.values()) > 0


# ------------------------------------------------------------ entry points
def test_launcher_serves_on_the_cpu(capsys):
    launch_serve.main(["--device", "cpu", "--seconds", "0.5",
                       "--dnns", "resnet18"])
    assert capsys.readouterr().out.startswith("JPS ")


def test_launcher_ckpt_fails_naming_q5(tmp_path, capsys):
    """``--ckpt`` (ROADMAP Q5, ported): the first run saves the
    scheduler's state, the second resumes from it and saves again."""
    ckpt = str(tmp_path / "sched.msgpack")
    argv = ["--device", "cpu", "--seconds", "0.5", "--dnns", "resnet18",
            "--ckpt", ckpt]
    launch_serve.main(argv)
    out = capsys.readouterr().out
    assert "resumed scheduler state" not in out
    assert f"scheduler state saved -> {ckpt}" in out
    launch_serve.main(argv)
    out = capsys.readouterr().out
    assert out.startswith(f"resumed scheduler state from {ckpt} "
                          f"(AFET cold-start skipped)")
    assert f"scheduler state saved -> {ckpt}" in out


def test_example_serves_the_four_tasks_on_the_cpu(capsys):
    path = ROOT / "examples" / "serve_realtime_torch.py"
    spec = importlib.util.spec_from_file_location("serve_realtime_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu", "--seconds", "0.5"])
    out = capsys.readouterr().out
    for task in ("resnet18-hp0", "resnet18-lp0", "unet-lp0",
                 "inceptionv3-hp0"):
        assert task in out
    assert "completed: HP" in out and "deadline miss rate" in out

"""The port's training substrate against the JAX package, on the CPU: the
optimizer, the train step, the data pipeline, the launcher and the
example (``repro_torch.training``, ``data/pipeline.py``,
``launch/train.py``, examples/train_smollm_torch.py).

Tolerances (f32 unless said):
* ``lr_at``, and ``adamw_update`` given the same gradients: 1e-6
  relative, of each leaf's largest element for the trees (the same f32
  operations; ``pow``, ``cos`` and ``sqrt`` may round one ulp apart, and
  a bf16 moment rounds what differs by an ulp); bf16 parameters within
  one bf16 step (2^-8) of their largest element, their f32 ``master``
  copies 1e-6.
* One train step from the same parameters and batch: loss, grad_norm and
  lr within 1e-5 relative. Adam's first update is about ``lr * sign(g)``,
  so an element whose gradient is rounding noise may move either way: the
  new parameters are held within 1e-6 where |g| exceeds 1e-3 of its
  leaf's largest (the two frameworks' gradients agree within about 1e-5
  of that largest, so such an element's sign is the same in both) and
  within ``2 lr`` + 1e-6 elsewhere.
"""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data.pipeline import TokenPipeline as JaxPipeline  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training.train_step import \
    make_train_step as jax_make_train_step  # noqa: E402

from repro_torch.checkpoint import load_pytree  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.models import build_model, params_from_jax  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training.train_step import (make_loss_fn,  # noqa: E402
                                             make_train_step,
                                             value_and_grad)
from test_torch_train_families import (batch_arrays, leaf_paths,  # noqa: E402
                                       reference_pair)

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-6
STEP_RTOL = 1e-5
G_FLOOR = 1e-3          # of a leaf's largest |g|: a sign both agree on
P_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_lr_at_matches_over_warmup_cosine_and_floor():
    cfg = dict(lr=3e-3, warmup_steps=10, total_steps=50, min_lr_frac=0.1)
    steps = np.arange(0, 60, dtype=np.int32)        # past the end: floor
    ours = [float(topt.lr_at(topt.AdamWConfig(**cfg), torch.tensor(s)))
            for s in steps]
    ref = [float(jopt.lr_at(jopt.AdamWConfig(**cfg), jnp.asarray(s)))
           for s in steps]
    np.testing.assert_allclose(ours, ref, rtol=RTOL)
    assert ours[-1] == pytest.approx(3e-4, rel=1e-6)


def test_config_fields_and_defaults_are_the_reference_s():
    import dataclasses
    assert ([(f.name, f.default) for f in dataclasses.fields(
        topt.AdamWConfig)] == [(f.name, f.default) for f in
                               dataclasses.fields(jopt.AdamWConfig)])


def _tree(rng, dtype):
    """A small parameter tree with a nested dict and a list, as numpy."""
    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    tree = {"w": a(6, 5), "layers": {"ln": a(3, 5), "mlp": a(3, 5, 4)},
            "dense": [a(4), a(2, 3)]}
    return jax.tree.map(lambda x: x.astype(dtype), tree)


@pytest.mark.parametrize("kw,dtype", [
    ({}, "float32"),
    ({"grad_clip": 0.0}, "float32"),
    ({"master": True}, "bfloat16"),
    ({"master": True, "m_dtype": "bfloat16"}, "bfloat16"),
    ({"m_dtype": "bfloat16", "weight_decay": 0.0}, "float32"),
], ids=["f32", "no-clip", "bf16-master", "bf16-master-bf16-m", "bf16-m"])
def test_adamw_update_matches_the_reference(kw, dtype):
    """Three updates from the same parameters with the same gradients
    (large enough that the clip bites where it is on)."""
    rng = np.random.default_rng(0)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    params = _tree(rng, np.float32)
    jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    jp = jax.tree.map(lambda x: jnp.asarray(x, jdt), params)
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    js, ts = jopt.adamw_init(jp, jcfg), topt.adamw_init(tp, tcfg)
    for i in range(3):
        grads = jax.tree.map(lambda x: 3.0 * x, _tree(rng, np.float32))
        jg = jax.tree.map(lambda x: jnp.asarray(x, jdt), grads)
        tg = params_from_jax(jax.device_get(jg), device="cpu")
        jp, js, jm = jopt.adamw_update(jp, jg, js, jcfg)
        tp, ts, tm = topt.adamw_update(tp, tg, ts, tcfg)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=RTOL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=RTOL)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        ptol = 2.0 ** -8 if dtype == "bfloat16" else RTOL
        for ours, ref, tol in ((tp, jp, ptol), (ts["m"], js["m"], RTOL),
                               (ts["v"], js["v"], RTOL)):
            _assert_leaves_close(ours, ref, tol)
        if kw.get("master"):
            _assert_leaves_close(ts["master"], js["master"], RTOL)
    assert ts["m"]["w"].dtype == {"float32": torch.float32,
                                  "bfloat16": torch.bfloat16}[tcfg.m_dtype]
    assert ts["v"]["w"].dtype == torch.float32


def _assert_leaves_close(ours, ref, tol):
    """Each leaf within ``tol`` of its largest element."""
    a, b = leaf_paths(ours), leaf_paths(jax.device_get(ref))
    for path, want in b.items():
        err = float(np.abs(a[path] - want).max())
        assert err <= tol * float(np.abs(want).max()), (path, err)


def test_update_leaves_its_arguments_alone():
    tree = {"a": torch.ones(3), "b": [torch.full((2,), 2.0)]}
    grads = {"a": torch.ones(3), "b": [torch.ones(2)]}
    cfg = topt.AdamWConfig(lr=0.1, warmup_steps=0)
    state = topt.adamw_init(tree, cfg)
    new, st, _ = topt.adamw_update(tree, grads, state, cfg)
    assert float(tree["a"][0]) == 1.0 and int(state["step"]) == 0
    assert float(new["a"][0]) < 1.0 and int(st["step"]) == 1


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2-moe-a2.7b"])
def test_one_train_step_matches_the_reference(arch):
    jmodel, jparams, tmodel, tparams = reference_pair(arch)
    arrays = batch_arrays(jmodel.cfg, b=4, s=16)
    jbatch = {k: jnp.asarray(v) for k, v in arrays.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in arrays.items()}
    cfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jcfg, tcfg = jopt.AdamWConfig(**cfg), topt.AdamWConfig(**cfg)
    jnew, _, jm = jax.jit(jax_make_train_step(jmodel, jcfg))(
        jparams, jopt.adamw_init(jparams, jcfg), jbatch)
    tnew, tstate, tm = make_train_step(tmodel, tcfg)(
        tparams, topt.adamw_init(tparams, tcfg), tbatch)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=STEP_RTOL, err_msg=k)
    assert int(tstate["step"]) == 1
    # the reference's gradients pick the elements whose sign is certain
    _, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(jparams, jbatch)
    grads = leaf_paths(jax.device_get(jgrads))
    a, b = leaf_paths(tnew), leaf_paths(jax.device_get(jnew))
    for path, g in grads.items():
        sure = np.abs(g) > G_FLOOR * np.abs(g).max()
        d = np.abs(a[path] - b[path])
        assert sure.any() and float(d[sure].max()) <= P_TOL, path
        assert float(d.max()) <= 2 * cfg["lr"] + P_TOL, path


def _train_batch(cfg, b, s):
    return {k: torch.from_numpy(v)
            for k, v in batch_arrays(cfg, b=b, s=s).items()}


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-2.7b"])
def test_train_step_decreases_loss(arch):
    """Twin of tests/test_arch_smoke.py's: 8 steps memorize a fixed batch."""
    model = build_model(get_reduced(arch), device="cpu")
    params = model.init_params(0)
    cfg = topt.AdamWConfig(lr=5e-3, warmup_steps=1, total_steps=50)
    opt = topt.adamw_init(params, cfg)
    step = make_train_step(model, cfg)
    batch = _train_batch(model.cfg, 4, 32)
    losses = []
    for _ in range(8):
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_train_step_grad_accum_matches():
    """Twin of tests/test_arch_smoke.py's: the same data in 2 microbatches
    gives the same mean gradient and the same update (tolerances as
    there)."""
    model = build_model(get_reduced("smollm-135m"), device="cpu")
    params = model.init_params(0)
    cfg = topt.AdamWConfig(lr=1e-3, grad_clip=0.0, weight_decay=0.0)
    batch = _train_batch(model.cfg, 4, 16)
    p1, _, m1 = make_train_step(model, cfg, accum=1)(
        params, topt.adamw_init(params, cfg), batch)
    p2, _, m2 = make_train_step(model, cfg, accum=2)(
        params, topt.adamw_init(params, cfg), batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    d = [float((a - b).abs().max()) for a, b in zip(
        topt.tree_leaves(p1), topt.tree_leaves(p2))]
    assert max(d) < 5e-3


def test_gradients_leave_the_caller_s_tensors_alone():
    model = build_model(get_reduced("smollm-135m"), device="cpu")
    params = model.init_params(0)
    loss, grads = value_and_grad(make_loss_fn(model), params,
                                 _train_batch(model.cfg, 2, 8))
    assert loss.grad_fn is None and np.isfinite(float(loss))
    for p, g in zip(topt.tree_leaves(params), topt.tree_leaves(grads)):
        assert not p.requires_grad and p.grad is None
        assert g.shape == p.shape and g.dtype == p.dtype


def test_pipeline_is_the_reference_s_and_resumes():
    """Twin of tests/test_system.py's deterministic resume, plus the same
    tokens as the reference's pipeline for the same seed."""
    ours, ref = TokenPipeline(1000, 4, 32, seed=3), JaxPipeline(1000, 4, 32,
                                                                seed=3)
    for _ in range(3):
        np.testing.assert_array_equal(ours.next_batch()["tokens"],
                                      ref.next_batch()["tokens"])
    p1 = TokenPipeline(1000, 4, 32, seed=3)
    b0 = p1.next_batch()
    b1 = p1.next_batch()
    state = p1.state_dict()
    b2 = p1.next_batch()
    p2 = TokenPipeline(1000, 4, 32, seed=3)
    p2.load_state_dict(state)
    np.testing.assert_array_equal(b2["tokens"], p2.next_batch()["tokens"])
    assert b0["tokens"].max() < 1000
    assert not np.array_equal(b0["tokens"], b1["tokens"])


def _skeleton(text: str) -> list:
    """The printout's lines with every number and path blanked."""
    lines = [ln for ln in text.splitlines() if ln.strip()]
    return [re.sub(r"\d+(\.\d+)?", "#", re.sub(r"saved: .*", "saved: P", ln))
            for ln in lines]


def test_launcher_prints_the_reference_s_lines_and_saves_loadable_params(
        tmp_path, monkeypatch, capsys):
    from repro.launch import train as jax_train
    from repro_torch import checkpoint
    from repro_torch.launch import train

    saved = []
    real = checkpoint.save_pytree

    def keep(tree, path, step=None):
        saved.append(tree)
        return real(tree, path, step=step)

    monkeypatch.setattr(checkpoint, "save_pytree", keep)
    ck = tmp_path / "ck"
    train.main(["--device", "cpu", "--steps", "3", "--batch", "2", "--seq",
                "16", "--ckpt", str(ck)])
    ours = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["train", "--steps", "3", "--batch",
                                      "2", "--seq", "16", "--ckpt",
                                      str(tmp_path / "jax")])
    jax_train.main()
    ref = capsys.readouterr().out
    assert _skeleton(ours) == _skeleton(ref)
    assert len(saved) == 1
    model = build_model(get_reduced("smollm-135m"), device="cpu")
    back = load_pytree(model.init_params(1), str(ck))
    a, b = topt.tree_leaves(back), topt.tree_leaves(saved[0])
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_example_trains_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "examples/train_smollm_torch.py", "--device", "cpu",
         "--steps", "2", "--batch", "2", "--seq", "16", "--ckpt",
         str(tmp_path / "ex")], capture_output=True, text=True,
        cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("model: smollm-135m-reduced")
    assert re.match(r"step +0 loss \d+\.\d{4} gnorm \d+\.\d{3} lr ", lines[1])
    assert lines[-1].startswith("saved checkpoint -> ")

"""The port's SPMD forward on gloo CPU ranks against the same model run
whole, for every family (reduced configs, f32).

Each case runs subprocess ranks on a ("data", "model") mesh of (2, 2),
(1, 4) or (1, 2): every rank draws the model's parameters from seed 0 at their
global shapes (``build_model(..., pad_for_tp=tp)``), keeps its shards
under ``ShardingRules`` and runs the loss, a prefill and two decode steps
on its rows of the batch; rank 0 gathers the logits (vocabulary over the
model axis, rows over the data axis). The parent runs the same padded
model unsharded on the CPU. Tolerance 1e-4 of the logits' scale (f32: the
sharded run sums partial products over the ranks, as
``tests/test_torch_moe.py``'s MODEL_TOL allows for a different order).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models.api import build_model, loss_from_logits  # noqa: E402,E501

ROOT = Path(__file__).resolve().parents[1]
SPMD_TOL = 1e-4
B, S, STEPS = 2, 8, 2

RANK = textwrap.dedent("""
    import json, sys, numpy as np, torch, torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_reduced
    from repro_torch.models.api import build_model
    from repro_torch.parallel.sharding import ShardingRules, shard_local
    rank, world, init, arch, shape, dst, layout = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
        json.loads(sys.argv[5]), sys.argv[6], json.loads(sys.argv[7]))
    dist.init_process_group("gloo", init_method=init,
                            rank=rank, world_size=world)
    mesh = init_device_mesh("cpu", tuple(shape),
                            mesh_dim_names=("data", "model"))
    cfg = get_reduced(arch)
    tp = shape[1]
    whole = build_model(cfg, pad_for_tp=tp, device="cpu")
    params = whole.init_params(0)
    rules = ShardingRules(whole.cfg, mesh).for_batch(%(B)d)
    dist_ctx = rules.dist_ctx()
    dist_ctx["seq_shard"] = bool(layout.get("seq_shard"))
    specs = rules.param_specs(params)
    dist_ctx["param_specs"] = specs
    model = build_model(cfg, pad_for_tp=tp, dist=dist_ctx, device="cpu")
    spmd = dist_ctx["spmd"]

    def shard(tree, sp):
        if isinstance(tree, dict):
            return {k: shard(v, sp[k]) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shard(v, s) for v, s in zip(tree, sp)]
        return shard_local(tree, sp, mesh)
    local = shard(params, specs)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (%(B)d, %(S)d + %(STEPS)d)))
    dp = rules.dp
    nd, rd = (spmd.size(dp), spmd.rank(dp)) if dp else (1, 0)
    rows = slice(rd * %(B)d // nd, (rd + 1) * %(B)d // nd)
    extra = {}
    if cfg.family == "encdec":
        frames = torch.from_numpy(rng.standard_normal(
            (%(B)d, cfg.encoder_frames, cfg.d_model)).astype(np.float32))
        extra = {"frames": frames[rows]}
    cache = whole.init_cache(%(B)d, %(S)d + %(STEPS)d)
    cache = shard(cache, rules.cache_specs(cache))   # rows over the data axes

    def gather(lg):
        if dist_ctx.get("vocab_tp") and lg.shape[-1] != whole.cfg.vocab_size:
            lg = spmd._all_gather(lg, lg.dim() - 1, "model")
        if dp:
            lg = spmd._all_gather(lg, 0, dp)
        return lg

    with torch.no_grad():
        loss = model.loss(local, {"tokens": tokens[rows, :%(S)d], **extra})
        loss = spmd._all_reduce(loss, dp) / nd if dp else loss
        batch = {"tokens": tokens[rows, :%(S)d], "cache": cache, **extra}
        logits, cache = model.prefill(local, batch)
        outs = [gather(logits)]
        enc = (model.encode(local, extra["frames"])
               if cfg.family == "encdec" else None)
        for i in range(%(STEPS)d):
            batch = {"tokens": tokens[rows, %(S)d + i:%(S)d + i + 1],
                     "cache": cache}
            if enc is not None:
                batch["enc_out"] = enc
            logits, cache = model.decode_step(local, batch)
            outs.append(gather(logits))
    if rank == 0:
        np.savez(dst, loss=loss.numpy(),
                 **{f"l{i}": o.numpy() for i, o in enumerate(outs)},
                 counts=np.array(json.dumps(spmd.counts.as_dict())))
    dist.barrier()          # no rank tears gloo down under another's read
    dist.destroy_process_group()
""") % {"B": B, "S": S, "STEPS": STEPS}


def rendezvous(dst) -> str:
    """The ranks' rendezvous: a file beside ``dst``, which no other test's
    ranks can take (a TCP port found free and released was, under a full
    run's parallel gloo tests, free for any process to bind before rank
    0's store did)."""
    path = Path(f"{dst}.rendezvous")
    path.unlink(missing_ok=True)
    return f"file://{path}"


def run_sharded(arch, shape, dst, timeout=300, layout=None):
    """The RANK script: loss, prefill and decode on the ranks, under
    ``layout`` (``{"seq_shard": True}``: sequence parallelism in the loss
    and the prefill; decode's one token takes none)."""
    # one thread a rank: the ranks share the host with the other tests
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    init = rendezvous(dst)
    world = shape[0] * shape[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(world), init, arch,
         str(list(shape)), str(dst), json.dumps(layout or {})], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    errs = []
    for p in procs:
        _, err = p.communicate(timeout=timeout)
        if p.returncode:
            errs.append(err[-3000:])
    assert not errs, errs[0]
    return np.load(dst)


def run_whole(arch, tp):
    """The padded model unsharded; the MoE layers through the capacity
    path, as ``moe_ep`` computes them (the default below 17 experts is the
    dense oracle, which drops no pair)."""
    cfg = get_reduced(arch)
    model = build_model(cfg, pad_for_tp=tp, device="cpu")
    params = model.init_params(0)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (B, S + STEPS)))
    extra = {}
    if cfg.family == "encdec":
        extra = {"frames": torch.from_numpy(rng.standard_normal(
            (B, cfg.encoder_frames, cfg.d_model)).astype(np.float32))}

    def step(batch, cache):
        if cfg.family == "encdec":
            return (model.prefill(params, {**batch, "cache": cache})
                    if "frames" in batch else
                    model.decode_step(params, {**batch, "cache": cache}))
        return model._lm_forward(params, batch, cache=cache,
                                 moe_oracle=False)
    with torch.no_grad():
        if cfg.family == "encdec":
            loss = float(model.loss(params, {"tokens": tokens[:, :S],
                                             **extra}))
        else:
            logits, _, aux = model._lm_forward(
                params, {"tokens": tokens[:, :S]}, moe_oracle=False,
                with_aux=True)
            loss = float(loss_from_logits(logits[:, :-1], tokens[:, 1:S]))
            if cfg.n_experts:
                loss += float(model.AUX_WEIGHT * aux / cfg.n_layers)
        logits, cache = step({"tokens": tokens[:, :S], **extra},
                             model.init_cache(B, S + STEPS))
        outs = [logits]
        enc = (model.encode(params, extra["frames"])
               if cfg.family == "encdec" else None)
        for i in range(STEPS):
            batch = {"tokens": tokens[:, S + i:S + i + 1]}
            if enc is not None:
                batch["enc_out"] = enc
            logits, cache = step(batch, cache)
            outs.append(logits)
    return loss, [o.numpy() for o in outs]


# the MoE cases keep one data rank: a rank's expert capacity counts its
# own tokens, so rows split over the data axis drop other pairs than the
# whole batch does (the reference's moe_ep_shardmap does the same)
CASES = [("smollm-135m", (2, 2)), ("qwen2-moe-a2.7b", (1, 4)),
         ("mamba2-2.7b", (2, 2)),
         ("zamba2-7b", (2, 2)), ("deepseek-v2-236b", (1, 2)),
         ("gemma2-27b", (2, 2)), ("whisper-tiny", (2, 2)),
         ("pixtral-12b", (2, 2)), ("qwen1.5-32b", (1, 4))]


@pytest.mark.parametrize("arch,shape", CASES,
                         ids=[f"{a}-{s[0]}x{s[1]}" for a, s in CASES])
def test_sharded_forward_matches_whole(arch, shape, tmp_path):
    got = run_sharded(arch, shape, tmp_path / "out.npz")
    loss, outs = run_whole(arch, shape[1])
    assert float(got["loss"]) == pytest.approx(loss, rel=SPMD_TOL)
    for i, want in enumerate(outs):
        have = got[f"l{i}"]
        assert have.shape == want.shape, i
        scale = float(np.abs(want).max())
        assert float(np.abs(have - want).max()) <= SPMD_TOL * scale, i


GRAD = textwrap.dedent("""
    import json, sys, numpy as np, torch, torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_reduced
    from repro_torch.models.api import build_model
    from repro_torch.parallel.sharding import ShardingRules, shard_local
    from repro_torch.training.train_step import (_sync, make_loss_fn,
                                                 value_and_grad)
    rank, world, init, shape, dst, layouts = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
        json.loads(sys.argv[4]), sys.argv[5], json.loads(sys.argv[6]))
    dist.init_process_group("gloo", init_method=init,
                            rank=rank, world_size=world)
    mesh = init_device_mesh("cpu", tuple(shape),
                            mesh_dim_names=("data", "model"))
    for li, layout in enumerate(layouts):
        cfg = get_reduced(layout["arch"]).replace(**layout.get("cfg", {}))
        flags = {k: bool(layout.get(k))
                 for k in ("no_fsdp", "dp_only", "mlp_fsdp")}
        pad = 1 if flags["dp_only"] else shape[1]
        whole = build_model(cfg, pad_for_tp=pad, device="cpu")
        params = whole.init_params(0)
        rules = ShardingRules(whole.cfg, mesh, **flags).for_batch(%(GB)d)
        ctx = rules.dist_ctx()
        ctx["seq_shard"] = bool(layout.get("seq_shard"))
        specs = rules.param_specs(params)
        ctx["param_specs"] = specs
        model = build_model(cfg, pad_for_tp=pad, dist=ctx, device="cpu")
        spmd = ctx["spmd"]

        def tree(fn, t, sp):
            if isinstance(t, dict):
                return {k: tree(fn, v, sp[k]) for k, v in t.items()}
            if isinstance(t, list):
                return [tree(fn, v, s) for v, s in zip(t, sp)]
            return fn(t, sp)

        def whole_leaf(t, sp):
            for i, e in enumerate(sp):
                if e is not None:
                    t = spmd._all_gather(t, i, e)
            return t
        local = tree(lambda t, sp: shard_local(t, sp, mesh), params, specs)
        rng = np.random.default_rng(1)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                               (%(GB)d, %(S)d)))
        dp = rules.dp
        nd, rd = (spmd.size(dp), spmd.rank(dp)) if dp else (1, 0)
        rows = slice(rd * %(GB)d // nd, (rd + 1) * %(GB)d // nd)
        batch = {"tokens": tokens[rows]}
        if cfg.family == "encdec":
            batch["frames"] = torch.from_numpy(rng.standard_normal(
                (%(GB)d, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
                )[rows]
        loss, grads = value_and_grad(make_loss_fn(model, remat="none"), local,
                                     batch)
        loss, grads, norm = _sync(ctx, loss, grads)
        counts = spmd.counts.as_dict()
        grads = tree(whole_leaf, grads, specs)
        if rank == 0:
            flat = {}

            def walk(t, p):
                if isinstance(t, dict):
                    for k, v in t.items():
                        walk(v, p + "/" + k)
                elif isinstance(t, list):
                    for i, v in enumerate(t):
                        walk(v, p + f"/{i}")
                else:
                    flat[p] = t.float().numpy()
            walk(grads, "")
            np.savez(f"{dst}{li}.npz", loss=loss.numpy(), norm=norm.numpy(),
                     counts=np.array(json.dumps(counts)),
                     seq_rows=np.array(sorted(spmd.seq_rows)), **flat)
    dist.barrier()          # no rank tears gloo down under another's read
    dist.destroy_process_group()
""") % {"GB": 4, "S": 16}


def run_grads(shape, layouts, dst, timeout=300):
    """The GRAD ranks on a mesh of ``shape``, one training step's loss and
    gradients under each layout of ``layouts`` (dicts: the ``arch``,
    ``ShardingRules``' ``no_fsdp``/``dp_only``/``mlp_fsdp``, the dry-run's
    ``seq_shard``, ``cfg`` overrides of the reduced config), in one set of
    processes; rank 0's results, one npz a layout."""
    # one thread a rank: the ranks share the host with the other tests
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    init, world = rendezvous(dst), shape[0] * shape[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", GRAD, str(r), str(world), init,
         str(list(shape)), str(dst), json.dumps(layouts)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    for p in procs:
        _, err = p.communicate(timeout=timeout)
        assert p.returncode == 0, err[-3000:]
    return [np.load(f"{dst}{i}.npz") for i in range(len(layouts))]


def whole_grads(arch, pad, cfg_over=None):
    """The unsharded step's loss, global gradient norm and gradients (by
    path) of the reduced ``arch`` padded for ``pad`` ranks, on GRAD's
    batch."""
    from repro_torch.training.optimizer import global_norm
    from repro_torch.training.train_step import value_and_grad
    cfg = get_reduced(arch).replace(**(cfg_over or {}))
    model = build_model(cfg, pad_for_tp=pad, device="cpu")
    params = model.init_params(0)
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (4, 16)))}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (4, cfg.encoder_frames, cfg.d_model)).astype(np.float32))

    def loss_fn(p, batch):
        if cfg.family == "encdec":
            return model.loss(p, batch)
        logits, _, aux = model._lm_forward(p, batch, moe_oracle=False,
                                           with_aux=True)
        loss = loss_from_logits(logits[:, :-1], batch["tokens"][:, 1:])
        if cfg.n_experts:
            loss = loss + model.AUX_WEIGHT * aux / max(cfg.n_layers, 1)
        return loss
    loss, grads = value_and_grad(loss_fn, params, batch)
    flat = {}

    def walk(t, p):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, p + "/" + k)
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, p + f"/{i}")
        else:
            flat[p] = t.float().numpy()
    walk(grads, "")
    return float(loss), float(global_norm(grads)), flat


def assert_grads_match(got, want):
    """Loss and norm within SPMD_TOL relative, every gradient within
    SPMD_TOL of the largest."""
    loss, norm, flat = want
    assert float(got["loss"]) == pytest.approx(loss, rel=SPMD_TOL)
    assert float(got["norm"]) == pytest.approx(norm, rel=SPMD_TOL)
    top = max(float(np.abs(v).max()) for v in flat.values())
    for k, v in flat.items():
        assert float(np.abs(got[k] - v).max()) <= SPMD_TOL * top, k


GRAD_CASES = [("smollm-135m", (2, 2)), ("qwen1.5-32b", (1, 4)),
              ("gemma2-27b", (2, 2)), ("mamba2-2.7b", (2, 2)),
              ("zamba2-7b", (2, 2)), ("qwen2-moe-a2.7b", (1, 4)),
              ("deepseek-v2-236b", (1, 2)), ("pixtral-12b", (2, 2)),
              ("whisper-tiny", (2, 2))]


@pytest.mark.parametrize("arch,shape", GRAD_CASES,
                         ids=[f"{a}-{s[0]}x{s[1]}" for a, s in GRAD_CASES])
def test_sharded_gradients_match_whole(arch, shape, tmp_path):
    """One training step's loss, gradients (gathered whole) and global
    gradient norm on the ranks against unsharded autograd of the same
    padded model (MoE layers on the capacity path, as ``moe_ep``), 1e-4
    of the largest gradient: the f/g pairs, the FSDP gathers'
    reduce-scatters, the sums of gradients of tensors every rank holds
    whole, and the data-parallel sync."""
    got, = run_grads(shape, [{"arch": arch}], tmp_path / "grads")
    assert_grads_match(got, whole_grads(arch, shape[1]))

"""The reference's remaining layouts on the port: sequence parallelism
(``seq_shard``), ``no_fsdp``, ``dp_only`` and ``mlp_fsdp``.

* ``ShardingRules(no_fsdp=, dp_only=, mlp_fsdp=)`` gives the reference's
  parameter and cache specs and ``dist_ctx`` for all ten archs on the
  tiny, tiny-multi and production meshes.
* One training step on gloo CPU ranks under each layout, held to the
  unsharded step (``tests/test_torch_spmd.py``'s GRAD ranks with a layout
  argument): loss and global gradient norm within ``SPMD_TOL`` relative,
  every gradient within ``SPMD_TOL`` of the largest. Sequence parallelism
  for every family of its ``GRAD_CASES``; ``no_fsdp``, ``dp_only`` and
  ``mlp_fsdp`` on smollm-135m and gemma2-27b; one case whose heads every
  ``model`` rank computes whole (the slice in the backward of the
  sequence's gather).
* The loss, a prefill and decode steps under ``serve_seq_shard`` (the
  RANK script with a layout) against the whole model.
* The dry-run at reduced size on the tiny mesh under each flag.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS  # noqa: E402
from test_torch_spmd import (SPMD_TOL, assert_grads_match,  # noqa: E402
                             run_grads, run_sharded, run_whole, whole_grads)

SEQ = {"seq_shard": True}
# the train cells' layouts: sequence parallelism unless --no_seq_shard
LAYOUTS = {"seq_shard": SEQ,
           "no_fsdp": dict(SEQ, no_fsdp=True),
           "dp_only": dict(SEQ, dp_only=True),
           "mlp_fsdp": dict(SEQ, mlp_fsdp=True)}
# heads 6 and kv 2 at tp 4: unpadded (8 is past 25%) and split neither
REPLICATED = {"n_heads": 6, "n_kv_heads": 2, "head_dim": 16}

# (arch, mesh, layout names, cfg overrides)
GRAD_ROWS = [
    ("smollm-135m", (2, 2), ("seq_shard", "no_fsdp", "dp_only", "mlp_fsdp"),
     None),
    ("gemma2-27b", (2, 2), ("seq_shard", "no_fsdp", "dp_only", "mlp_fsdp"),
     None),
    ("qwen1.5-32b", (1, 4), ("seq_shard",), None),
    ("mamba2-2.7b", (2, 2), ("seq_shard",), None),
    ("zamba2-7b", (2, 2), ("seq_shard",), None),
    ("qwen2-moe-a2.7b", (1, 4), ("seq_shard",), None),
    ("deepseek-v2-236b", (1, 2), ("seq_shard",), None),
    ("pixtral-12b", (2, 2), ("seq_shard",), None),
    ("whisper-tiny", (2, 2), ("seq_shard",), None),
    # query heads split, kv heads whole on every rank
    ("smollm-135m", (1, 4), ("seq_shard",), None),
    ("smollm-135m", (1, 4), ("seq_shard",), REPLICATED),
]
GRAD_CASES = [(a, shape, name, over) for a, shape, names, over in GRAD_ROWS
              for name in names]
_RUNS = {}


def _mesh_results(shape, tmp_dir):
    """Every case on a mesh of ``shape``, run once in one set of rank
    processes: {(arch, layout, overrides): rank 0's results}."""
    if shape not in _RUNS:
        cases = [c for c in GRAD_CASES if c[1] == shape]
        layouts = [dict(LAYOUTS[n], arch=a, cfg=o or {})
                   for a, _, n, o in cases]
        res = run_grads(shape, layouts,
                        tmp_dir / f"grads-{shape[0]}x{shape[1]}-")
        _RUNS[shape] = {(a, n, json.dumps(o)): r
                        for (a, _, n, o), r in zip(cases, res)}
    return _RUNS[shape]


@pytest.mark.parametrize(
    "arch,shape,layout,over", GRAD_CASES,
    ids=[f"{a}-{s[0]}x{s[1]}-{n}" + ("-replicated_heads" if o else "")
         for a, s, n, o in GRAD_CASES])
def test_layout_gradients_match_whole(arch, shape, layout, over,
                                      tmp_path_factory):
    got = _mesh_results(shape, tmp_path_factory.getbasetemp())[
        (arch, layout, json.dumps(over))]
    pad = 1 if layout == "dp_only" else shape[1]
    assert_grads_match(got, whole_grads(arch, pad, over))
    counts = json.loads(str(got["counts"]))["counts"]
    rows = set(got["seq_rows"].tolist())
    if layout == "dp_only":
        assert not rows                      # no model axis to split over
    elif arch == "whisper-tiny":
        # 16 frames split over 2; the decoder's 15 teacher-forced rows do
        # not
        assert rows == {"enc_layers", "enc_norm"}
    else:
        assert "layers" in rows and "final_norm" in rows
        assert counts.get("reduce-scatter", 0) > 0


@pytest.mark.parametrize("arch,shape", [("qwen2-moe-a2.7b", (1, 4)),
                                        ("whisper-tiny", (2, 2))])
def test_serve_seq_shard_forward_matches_whole(arch, shape, tmp_path):
    """The RANK script's loss, prefill and decode steps under sequence
    parallelism (``--serve_seq_shard``'s prefill) against the whole
    model, as ``test_torch_spmd.py`` holds them without it."""
    got = run_sharded(arch, shape, tmp_path / "out.npz",
                      layout={"seq_shard": True})
    loss, outs = run_whole(arch, shape[1])
    assert float(got["loss"]) == pytest.approx(loss, rel=SPMD_TOL)
    for i, want in enumerate(outs):
        have = got[f"l{i}"]
        assert have.shape == want.shape, i
        scale = float(np.abs(want).max())
        assert float(np.abs(have - want).max()) <= SPMD_TOL * scale, i
    assert json.loads(str(got["counts"]))["counts"]["reduce-scatter"] > 0


# ---------------------------------------------------------------------------
# Specs against the reference
# ---------------------------------------------------------------------------
SPEC_MESHES = {"tiny": ((2, 4), ("data", "model")),
               "tiny-multi": ((2, 2, 2), ("pod", "data", "model")),
               "single": ((16, 16), ("data", "model"))}
FLAGS = ("no_fsdp", "dp_only", "mlp_fsdp")


@pytest.mark.parametrize("flag", FLAGS)
@pytest.mark.parametrize("kind", sorted(SPEC_MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_layout_specs_match_reference(arch, kind, flag):
    """Parameter and cache specs, activation specs and ``dist_ctx`` under
    one option, the model padded as the reference's dry-run pads it."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config
    from repro.parallel import sharding as jax_sharding
    from repro_torch.launch import dryrun
    from repro_torch.models import api as torch_api
    from repro_torch.parallel import sharding as tsh
    from test_torch_sharding import CACHE_BATCH, CACHE_LEN, _leaves, \
        _reference_trees
    shape, names = SPEC_MESHES[kind]
    pad = 1 if flag == "dp_only" else shape[-1]
    jcfg, jparams, jcache = _reference_trees(arch, pad)
    jr = jax_sharding.ShardingRules(
        jcfg, jax.sharding.AbstractMesh(shape, names), **{flag: True})
    model = torch_api.build_model(get_config(arch), pad_for_tp=pad,
                                  device="meta")
    tr = tsh.ShardingRules(model.cfg, dryrun.fake_mesh(kind), **{flag: True})
    for ours, ref in ((tr.params_tree(model.init_params(0)),
                       jr.params_tree(jparams)),
                      (tr.cache_tree(model.init_cache(CACHE_BATCH,
                                                      CACHE_LEN)),
                       jr.cache_tree(jcache))):
        ours, ref = dict(_leaves(ours)), dict(_leaves(ref))
        assert ours.keys() == ref.keys()
        for path, sh in ref.items():
            assert tuple(ours[path].spec) == tuple(sh.spec), path
    for name in ("tokens_spec", "embeds_spec", "logits_spec"):
        assert tuple(getattr(tr, name)()) == tuple(getattr(jr, name)())
    for b in (1, 128):
        assert tr.for_batch(b).dp == jr.for_batch(b).dp
    jd, td = jr.dist_ctx(), tr.dist_ctx()
    assert jd["mlp_fsdp"] is (flag == "mlp_fsdp")
    for k, v in jd.items():
        if k != "mesh":
            assert td[k] == v, k
    assert td["seq_shard"] is False        # until a dry-run sets it


# ---------------------------------------------------------------------------
# The dry-run under each flag
# ---------------------------------------------------------------------------
# smollm-135m's train_4k cut to 64 tokens and a global batch of 8, reduced
# config, on the tiny (2, 4) mesh: the parent tree's dry-run (no sequence
# parallelism) gave these FLOPs and collectives
PARENT_NO_SEQ = {
    "flops": 70778880.0,
    "counts": {"all-reduce": 83, "all-gather": 112, "reduce-scatter": 56},
    "bytes_by_op": {"all-reduce": 1876408.0, "all-gather": 884736.0,
                    "reduce-scatter": 442368.0}}
_CELLS = {}


def _cut_cell(monkeypatch, **flags):
    """The cut cell's artifact under ``flags``, once a flag set."""
    import dataclasses
    from repro_torch.configs import shape_by_name
    from repro_torch.launch import dryrun
    cell = dataclasses.replace(shape_by_name("train_4k"), seq_len=64,
                               global_batch=8)
    monkeypatch.setattr(dryrun, "shape_by_name", lambda name: cell)
    key = tuple(sorted(flags))
    if key not in _CELLS:
        _CELLS[key] = dryrun.run_cell("smollm-135m", "train_4k", "tiny",
                                      extra={"reduced": True, **flags})
    art = _CELLS[key]
    assert art["status"] == "ok" and art["extra"] == {"reduced": True,
                                                      **flags}
    return art


def _coll(art):
    return art["collectives_per_device"]


def test_dryrun_no_seq_shard_gives_the_parents_counts(monkeypatch):
    art = _cut_cell(monkeypatch, no_seq_shard=True)
    assert art["flops_per_device"] == PARENT_NO_SEQ["flops"]
    assert _coll(art)["counts"] == PARENT_NO_SEQ["counts"]
    assert _coll(art)["bytes_by_op"] == PARENT_NO_SEQ["bytes_by_op"]


def test_dryrun_train_cells_take_seq_shard(monkeypatch):
    """By default the hidden states leave each block by a reduce-scatter
    and enter the next by an all-gather in place of the all-reduces; the
    same FLOPs, a lower peak."""
    seq, noseq = _cut_cell(monkeypatch), _cut_cell(monkeypatch,
                                                   no_seq_shard=True)
    assert seq["flops_per_device"] == noseq["flops_per_device"]
    a, b = _coll(seq)["counts"], _coll(noseq)["counts"]
    assert a["reduce-scatter"] > b["reduce-scatter"]
    assert a["all-gather"] > b["all-gather"]
    assert a["all-reduce"] < b["all-reduce"]
    assert seq["peak_bytes_per_device"] < noseq["peak_bytes_per_device"]


def test_dryrun_no_fsdp_has_no_fsdp_gather(monkeypatch):
    """Without FSDP the only all-gathers are the sequence's: the default's
    less the parent layout's (which are all FSDP's), and none at all
    without sequence parallelism."""
    nf = _cut_cell(monkeypatch, no_fsdp=True)
    nf_noseq = _cut_cell(monkeypatch, no_fsdp=True, no_seq_shard=True)
    seq, noseq = _cut_cell(monkeypatch), _cut_cell(monkeypatch,
                                                   no_seq_shard=True)
    assert "all-gather" not in _coll(nf_noseq)["counts"]
    assert "reduce-scatter" not in _coll(nf_noseq)["counts"]
    ag = lambda art: _coll(art)["counts"]["all-gather"]   # noqa: E731
    assert ag(nf) == ag(seq) - ag(noseq) > 0
    assert nf["resident_bytes_per_device"] > seq["resident_bytes_per_device"]


def test_dryrun_dp_only_forward_has_no_model_axis_collective(monkeypatch):
    """Under ``dp_only`` the forward's only collectives are the FSDP
    gathers over every axis; the default's forward also sums over the
    model axis (reduce-scatters of the blocks' outputs, the vocabulary's
    all-reduces)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import dryrun
    art = _cut_cell(monkeypatch, dp_only=True)
    assert art["accum"] == 1 and art["mesh_shape"] == {"data": 2,
                                                       "model": 4}

    def forward_counts(**flags):
        mesh = dryrun.fake_mesh("tiny")
        with FakeTensorMode(), torch.no_grad():
            built = dryrun.build_cell("smollm-135m", "train_4k", mesh,
                                      extra={"reduced": True, **flags})
            spmd = built["dist"]["spmd"]
            spmd.counts.reset()
            built["model"].loss(built["params"], built["batch"])
            return dict(spmd.counts.counts)
    dp = forward_counts(dp_only=True)
    assert set(dp) == {"all-gather"}
    assert {"reduce-scatter", "all-reduce"} <= set(forward_counts())


def test_dryrun_mlp_fsdp_runs_the_mlp_whole(monkeypatch):
    """``mlp_fsdp``: the MLP weights gathered over both axes, the MLP
    computed whole on every model rank (more FLOPs a device)."""
    mf, seq = _cut_cell(monkeypatch, mlp_fsdp=True), _cut_cell(monkeypatch)
    assert mf["flops_per_device"] > seq["flops_per_device"]
    assert (_coll(mf)["bytes_by_op"]["all-gather"]
            > _coll(seq)["bytes_by_op"]["all-gather"])


def test_dryrun_cli_records_the_flags(tmp_path):
    """The flags reach the artifact's ``extra``; ``--skip-existing`` keeps
    an ``ok`` artifact."""
    from test_torch_dryrun import run_cli
    args = ["--arch", "smollm-135m", "--shape", "decode_32k", "--mesh",
            "tiny", "--no_fsdp", "--mlp_fsdp", "--serve_seq_shard", "--tag",
            "flags"]
    run_cli(args, tmp_path)
    path = tmp_path / "smollm-135m__decode_32k__tiny__flags.json"
    art = json.loads(path.read_text())
    assert art["status"] == "ok"
    assert art["extra"] == {"tag": "flags", "no_fsdp": True,
                            "mlp_fsdp": True, "serve_seq_shard": True}
    assert "CACHED smollm-135m decode_32k tiny" in run_cli(
        args + ["--skip-existing"], tmp_path)

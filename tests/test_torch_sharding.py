"""The port's sharding rules, meshes and published accounting against the
JAX package's.

* Every parameter and cache path's spec from the port's ``ShardingRules``
  equals the reference's, for all ten archs built with ``pad_for_tp`` 16
  and 4, on the (16, 16), (2, 16, 16) and (2, 4) meshes: the reference
  gets a ``jax.sharding.AbstractMesh`` (no devices), the port a
  ``DeviceMesh`` over the ``"fake"`` process group of the mesh's size.
* ``pad_heads_for_tp`` and ``make_partition_meshes`` give the reference's
  rows; ``placements`` maps specs to DTensor placements.
* ``param_counts``, ``model_flops``, ``param_bytes``, ``kv_cache_bytes``
  and ``analytic_hbm_bytes`` equal the reference's exactly (the same
  arithmetic on the same config), for every arch x ``SHAPES`` cell, and
  ``input_specs`` gives the reference's shapes and dtypes.
* ``ActConstraint(None)`` is the identity.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.parallel import sharding as jax_sharding  # noqa: E402
from repro_torch.launch import dryrun, mesh as tmesh  # noqa: E402
from repro_torch.models import api as torch_api  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "tiny": ((2, 4), ("data", "model"))}
CACHE_BATCH, CACHE_LEN = 32, 512


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield "/".join(path), tree


_REF = {}


def _reference_trees(arch, pad):
    """The reference's parameter and cache shapes (``jax.eval_shape``: no
    compile, no devices), once per (arch, pad)."""
    key = (arch, pad)
    if key not in _REF:
        m = jax_api.build_model(get_config(arch), pad_for_tp=pad)
        params = jax.eval_shape(lambda: m.init_params(0))
        cache = (jax.eval_shape(lambda: m.init_cache(CACHE_BATCH, CACHE_LEN))
                 if m.cfg.family != "encdec" else
                 jax.eval_shape(lambda: m.init_cache(CACHE_BATCH, CACHE_LEN)))
        _REF[key] = (m.cfg, params, cache)
    return _REF[key]


@pytest.fixture(scope="module")
def fake_meshes():
    out = {}
    for kind in MESHES:
        out[kind] = dryrun.fake_mesh(kind)
    return out


@pytest.mark.parametrize("pad", [16, 4])
@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_cache_specs_match_reference(arch, kind, pad):
    shape, names = MESHES[kind]
    tm = dryrun.fake_mesh(kind)
    jcfg, jparams, jcache = _reference_trees(arch, pad)
    jm = jax.sharding.AbstractMesh(shape, names)
    jr = jax_sharding.ShardingRules(jcfg, jm)
    model = torch_api.build_model(get_config(arch), pad_for_tp=pad,
                                  device="meta")
    tr = tsh.ShardingRules(model.cfg, tm)
    # the same paths, shapes and specs
    ours = dict(_leaves(tr.params_tree(model.init_params(0))))
    ref = dict(_leaves(jr.params_tree(jparams)))
    assert ours.keys() == ref.keys()
    for path, sh in ref.items():
        assert tuple(ours[path].spec) == tuple(sh.spec), path
    ours = dict(_leaves(tr.cache_tree(model.init_cache(CACHE_BATCH,
                                                       CACHE_LEN))))
    ref = dict(_leaves(jr.cache_tree(jcache)))
    assert ours.keys() == ref.keys()
    for path, sh in ref.items():
        assert tuple(ours[path].spec) == tuple(sh.spec), path
    # and the activation specs and the dist context's reference keys
    for name in ("tokens_spec", "embeds_spec", "logits_spec"):
        assert tuple(getattr(tr, name)()) == tuple(getattr(jr, name)())
    for b in (1, 128):
        assert tr.for_batch(b).dp == jr.for_batch(b).dp
    jd, td = jr.dist_ctx(), tr.dist_ctx()
    for k, v in jd.items():
        if k != "mesh":
            assert td[k] == v, k


@pytest.mark.parametrize("tp", [1, 4, 16])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_pad_heads_for_tp_matches_reference(arch, tp):
    cfg = get_config(arch)
    assert torch_api.pad_heads_for_tp(cfg, tp) == jax_api.pad_heads_for_tp(
        cfg, tp)
    ours = torch_api.build_model(cfg, pad_for_tp=tp, device="meta")
    ref = jax_api.build_model(cfg, pad_for_tp=tp)
    assert ours.cfg == ref.cfg and ours.orig == ref.orig


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("pad", [None, 16])
def test_accounting_matches_reference(arch, pad):
    cfg = get_config(arch)
    ours = torch_api.build_model(cfg, pad_for_tp=pad, device="meta")
    ref = jax_api.build_model(cfg, pad_for_tp=pad)
    assert ours.param_counts() == ref.param_counts()
    assert ours.param_bytes() == ref.param_bytes()
    for cell in SHAPES:
        assert ours.model_flops(cell) == ref.model_flops(cell), cell.name
        assert (ours.kv_cache_bytes(cell.global_batch, cell.seq_len)
                == ref.kv_cache_bytes(cell.global_batch, cell.seq_len))
        for accum in (1, 16):
            assert (ours.analytic_hbm_bytes(cell, accum=accum)
                    == ref.analytic_hbm_bytes(cell, accum=accum))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch):
    cfg = get_config(arch)
    ours = torch_api.build_model(cfg, device="meta")
    ref = jax_api.build_model(cfg)
    for cell in SHAPES[:3]:
        a = dict(_leaves(ours.input_specs(cell)))
        b = dict(_leaves(ref.input_specs(cell)))
        assert a.keys() == b.keys()
        for k, v in b.items():
            assert tuple(a[k].shape) == tuple(v.shape), (cell.name, k)
            assert str(a[k].dtype).replace("torch.", "") == str(v.dtype)
            assert a[k].device.type == "meta"


def test_partition_meshes_match_reference():
    """Eq. 9's rows over the production meshes: the reference's device ids
    (512 forced host devices, in a subprocess) against the port's ranks."""
    code = (
        "import json\n"
        "from repro.launch.mesh import make_partition_meshes\n"
        "out = {}\n"
        "for multi in (False, True):\n"
        "    for n, os_ in ((2, 1.0), (3, 1.5), (4, 2.0), (5, 1.0)):\n"
        "        ms = make_partition_meshes(n, os_, multi_pod=multi)\n"
        "        out[f'{multi} {n} {os_}'] = [[[d.id for d in row]\n"
        "            for row in m.reshape(m.shape[0], -1)] for m in ms]\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    ref = json.loads(res.stdout.strip().splitlines()[-1])
    for key, rows in ref.items():
        multi, n, os_ = key.split()
        ours = tmesh.make_partition_meshes(int(n), float(os_),
                                           multi_pod=multi == "True")
        got = [[list(map(int, r)) for r in m.reshape(m.shape[0], -1)]
               for m in ours]
        assert got == rows, key


def test_meshes_have_the_reference_shapes(fake_meshes):
    for kind, (shape, names) in MESHES.items():
        m = fake_meshes[kind]
        assert tuple(m.mesh_dim_names) == names
        assert tuple(m.shape) == shape
    assert tmesh.production_shape(False) == MESHES["single"]
    assert tmesh.tiny_shape(False) == MESHES["tiny"]
    assert tmesh.tiny_shape(True) == ((2, 2, 2), ("pod", "data", "model"))


def test_placements_map_specs_to_dtensor_placements():
    from torch.distributed.tensor import Replicate, Shard
    m = dryrun.fake_mesh("multi")
    P = tsh.P
    assert tsh.placements(P(None, "model"), m) == [Replicate(), Replicate(),
                                                   Shard(1)]
    assert tsh.placements(P(("pod", "data"), "model"), m) == [
        Shard(0), Shard(0), Shard(1)]
    assert tsh.placements(P(), m) == [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        tsh.placements(P(("data", "pod")), m)
    # a rank's shard of a global tensor: mixed-radix over (pod, data)
    t = torch.arange(2 * 16 * 32 * 4).reshape(2 * 16 * 32, 4)
    coord = {"pod": 1, "data": 3, "model": 0}
    got = tsh.shard_local(t, P(("pod", "data"), None), m, coord)
    assert got.shape == (32, 4)
    assert torch.equal(got, t[(16 + 3) * 32:(16 + 4) * 32])


def test_act_constraint_noop_without_mesh():
    c = tsh.ActConstraint(None)
    x = torch.ones((2, 4, 8))
    for fn in (c.hidden, c.heads, c.kv_heads, c.ffn, c.logits, c.ssm_heads,
               c.ssm_inner):
        assert fn(x) is x


def test_act_constraint_passes_local_shards():
    """Under a mesh's dist context every boundary passes this rank's local
    shard unchanged: the forward holds its layout by construction, and no
    boundary splits the sequence."""
    m = dryrun.fake_mesh("tiny")
    cfg = get_config("qwen2-moe-a2.7b")
    c = tsh.ActConstraint(tsh.ShardingRules(cfg, m).dist_ctx())
    x = torch.randn(2, 4, 8)
    for fn in (c.hidden, c.heads, c.kv_heads, c.ffn, c.logits, c.ssm_heads,
               c.ssm_inner):
        assert fn(x) is x

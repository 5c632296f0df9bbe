"""Expert parallelism: the port's ``moe_ep`` against the reference's
``moe_ep_shardmap``, and the expert-slice arguments of ``dispatch_indices``
and ``moe_capacity``.

``moe_ep`` runs on 4 gloo CPU ranks (subprocesses, a (1, 4) ("data",
"model") mesh), the reference in a subprocess with 4 forced host devices
on ``jax.make_mesh((1, 4), ("data", "model"))``, on the same reduced
qwen2-moe layer (8 experts, top-2, f32) from numpy. Tolerances: the port's
``moe_ep`` against its own ``moe_capacity`` 1e-6 of the output's scale (the
same products; only the order in which a token's k pairs are summed
differs: on one rank, or one a rank and then across ranks); against the
reference 1e-5, the cross-framework f32 tolerance of
``tests/test_torch_moe.py``.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as jax_moe  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from test_torch_spmd import RANK_END, run_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
SAME_TOL = 1e-6          # moe_ep against moe_capacity, of the output's scale
E, K, D, F, B, S = 8, 2, 64, 32, 2, 12


def _np(t):
    return t.detach().cpu().numpy()


def _layer(seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {
        "router": (rng.standard_normal((D, E)) / 8).astype(f32),
        "experts": {
            "w_gate": (rng.standard_normal((E, D, F)) / 8).astype(f32),
            "w_up": (rng.standard_normal((E, D, F)) / 8).astype(f32),
            "w_down": (rng.standard_normal((E, F, D)) / 6).astype(f32)},
    }, rng.standard_normal((B, S, D)).astype(f32)


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


@pytest.mark.parametrize("offset,n_local,capacity", [
    (0, 8, 3), (2, 2, 3), (6, 2, 1), (4, 4, 5), (3, 1, 2)])
def test_dispatch_indices_with_offsets_match_reference(offset, n_local,
                                                       capacity):
    rng = np.random.default_rng(offset * 10 + n_local)
    ids = np.stack([rng.choice(E, K, replace=False) for _ in range(16)]
                   ).astype(np.int32)
    w = rng.uniform(0.1, 1.0, (16, K)).astype(np.float32)
    ours = moe.dispatch_indices(torch.from_numpy(ids), torch.from_numpy(w),
                                capacity, offset, n_local)
    ref = jax_moe.dispatch_indices(jnp.asarray(ids), jnp.asarray(w),
                                   capacity, offset, n_local)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    # an offset given as a 0-d tensor (a rank's) is the same
    again = moe.dispatch_indices(torch.from_numpy(ids), torch.from_numpy(w),
                                 capacity, torch.tensor(offset), n_local)
    for a, b in zip(ours, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("offset,n_local", [(0, 8), (0, 2), (4, 4), (6, 2)])
def test_capacity_slices_match_reference(offset, n_local):
    """``moe_capacity`` over an expert slice, routed inside or handed a
    ``precomputed_route``, against the reference's."""
    layer, x = _layer()
    sl = _tree(layer["experts"], lambda a: a[offset:offset + n_local])
    tp = {"router": torch.from_numpy(layer["router"]),
          "experts": _tree(sl, torch.from_numpy)}
    jp = {"router": jnp.asarray(layer["router"]),
          "experts": _tree(sl, jnp.asarray)}
    kw = dict(capacity_factor=1.0, norm_topk=True, n_valid=E,
              expert_offset=offset, n_local=n_local)
    out, aux = moe.moe_capacity(tp, torch.from_numpy(x), K, **kw)
    jout, jaux = jax_moe.moe_capacity(jp, jnp.asarray(x), K, **kw)
    np.testing.assert_allclose(_np(out), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    route = moe.route(tp["router"], torch.from_numpy(x).reshape(-1, D), K,
                      True, E)
    again, _ = moe.moe_capacity(tp, torch.from_numpy(x), K,
                                precomputed_route=route, **kw)
    assert torch.equal(again, out)


REF_EP = textwrap.dedent("""
    import sys, numpy as np, jax, jax.numpy as jnp
    from repro.models.moe import moe_ep_shardmap
    d = np.load(sys.argv[1])
    params = {"router": jnp.asarray(d["router"]),
              "experts": {k: jnp.asarray(d[k])
                          for k in ("w_gate", "w_up", "w_down")}}
    mesh = jax.make_mesh((1, 4), ("data", "model"))
    with mesh:
        out, aux = moe_ep_shardmap(params, jnp.asarray(d["x"]), topk=2,
                                   mesh=mesh, dp_axes="data",
                                   norm_topk=True, n_valid=8)
    np.savez(sys.argv[2], out=np.asarray(out), aux=np.asarray(aux))
""")

PORT_EP = textwrap.dedent("""
    import os, sys, numpy as np, torch, torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.models.moe import moe_ep
    from repro_torch.parallel.sharding import Spmd
    rank, world, init, src, dst = (int(sys.argv[1]), int(sys.argv[2]),
                                   sys.argv[3], sys.argv[4], sys.argv[5])
    dist.init_process_group("gloo", init_method=init,
                            rank=rank, world_size=world)
    mesh = init_device_mesh("cpu", (1, world),
                            mesh_dim_names=("data", "model"))
    d = np.load(src)
    e_loc = d["w_gate"].shape[0] // world
    r = mesh.get_local_rank("model")
    params = {"router": torch.from_numpy(d["router"]),
              "experts": {k: torch.from_numpy(d[k][r * e_loc:(r + 1) * e_loc])
                          for k in ("w_gate", "w_up", "w_down")}}
    spmd = Spmd(mesh)
    out, aux = moe_ep(params, torch.from_numpy(d["x"]), topk=2,
                      dist={"spmd": spmd, "tp": "model", "dp": "data"},
                      norm_topk=True, n_valid=8)
    if rank == 0:
        np.savez(dst, out=out.numpy(), aux=aux.numpy(),
                 counts=np.array(spmd.counts.counts.get("all-reduce", 0)))
""") + RANK_END


def test_moe_ep_on_four_gloo_ranks_matches_reference_shardmap(tmp_path):
    layer, x = _layer(1)
    src = tmp_path / "layer.npz"
    np.savez(src, router=layer["router"], x=x, **layer["experts"])
    ref_out = tmp_path / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, "-c", REF_EP, str(src),
                          str(ref_out)], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    port_out = tmp_path / "port.npz"
    run_ranks(PORT_EP, 4, port_out, [str(src), str(port_out)], timeout=240)
    ref, got = np.load(ref_out), np.load(port_out)
    np.testing.assert_allclose(got["out"], ref["out"], **TOL)
    np.testing.assert_allclose(got["aux"], ref["aux"], **TOL)
    # one all-reduce over the model axis (the data axis has one rank)
    assert int(got["counts"]) == 1
    # and against the port's own moe_capacity over all the experts
    tp = {"router": torch.from_numpy(layer["router"]),
          "experts": _tree(layer["experts"], torch.from_numpy)}
    cap, aux = moe.moe_capacity(tp, torch.from_numpy(x), K, norm_topk=True,
                                n_valid=E)
    scale = float(np.abs(_np(cap)).max())
    assert float(np.abs(got["out"] - _np(cap)).max()) <= SAME_TOL * scale
    assert float(got["aux"]) == pytest.approx(float(aux), rel=1e-6)

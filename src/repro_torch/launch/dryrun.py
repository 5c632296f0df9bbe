"""Dry-run of every (arch x shape x mesh) cell on fake tensors.

Counterpart of src/repro/launch/dryrun.py. The reference lowers and
compiles each cell for a mesh of forced host devices and reads XLA's
analyses; the port runs each cell's step as rank 0 of the mesh, on fake
tensors (``FakeTensorMode``) over the ``"fake"`` process group of the
mesh's size, so that nothing is allocated and no collective moves data:

  * the model is built with ``pad_for_tp`` = the mesh's ``model`` width
    (1 under ``--dp_only``), its parameters, optimizer state, inputs and
    cache made as this rank's shards under ``ShardingRules`` (fake
    tensors of the local shapes), with the reference's layout flags:
    ``--dp_only``, ``--no_fsdp`` and ``--mlp_fsdp`` pass to the rules;
    train cells take sequence parallelism (``seq_shard``: the hidden
    states split over ``model`` between blocks) unless ``--no_seq_shard``,
    serving cells only with ``--serve_seq_shard``;
  * the step is the reference's: ``make_train_step`` with its ``accum``,
    ``remat`` and ``q_chunk`` choices, ``prefill`` or ``decode_step``,
    running the port's SPMD forward (``models/transformer.py``);
  * ``FlopCounterMode`` counts the FLOPs of the products this rank runs
    (its local ops: per device, not the global count a DTensor op would
    give); the kernels count through their operators' FLOP formulas;
  * the collectives' bytes per kind come from the rank's ``Spmd``
    (``parallel/sharding.py``; the reference parses them from the HLO);
  * ``peak_bytes_per_device`` is the local shards of parameters,
    optimizer state, inputs and cache plus the high-water mark of the
    storages the step makes while they are alive (``PeakBytes``);
  * a train cell of more than 4 microbatches runs at 3 and at 4 of them
    and its FLOPs and collectives are extrapolated exactly to its own
    ``accum`` (``measure_cell``; ``--whole`` runs every microbatch); the
    artifact's ``accum_run`` names the accumulations run.

``launch/hlo_cost.py`` has no counterpart: the FLOP counter replaces its
walk of the HLO, and the reference's ``--save-hlo`` has none either (no
HLO is made). Each cell writes a JSON artifact with the reference's
keys (``cost_per_device.flops`` and ``collectives_per_device`` where
``roofline.py`` reads them) and ``fits_80gb`` (one H100's 80 GB) in place
of ``fits_16gb``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-32b --shape decode_32k --mesh tiny
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k --mesh single --no_seq_shard --tag noseq
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time
import traceback
import weakref

import torch
import torch.distributed as tdist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..configs import ARCH_IDS, cells, get_config, get_reduced, shape_by_name
from ..models.api import build_model
from ..parallel.sharding import ShardingRules, local_shape, mesh_axes
from ..training.optimizer import AdamWConfig, adamw_init
from ..training.train_step import make_train_step
from . import mesh as meshes
from .mesh import production_shape, tiny_shape

HBM_BYTES = 80 * 10 ** 9          # one H100 80GB HBM3


# ---------------------------------------------------------------------------
# Fake process group and mesh
# ---------------------------------------------------------------------------
MESH_KINDS = ("single", "multi", "tiny", "tiny-multi", "unit", "2x2")


def mesh_for(kind: str):
    """(shape, axis names) of a mesh kind: the reference's single, multi,
    tiny and tiny-multi, ``unit``, one rank (1 x 1: a cell run whole on
    one card, for comparison with a measured run), and ``2x2`` (four ranks
    of one card, ``chip_smoke.py --dist``'s layouts)."""
    if kind == "unit":
        return (1, 1), ("data", "model")
    if kind == "2x2":
        return (2, 2), ("data", "model")
    multi = kind in ("multi", "tiny-multi")
    return tiny_shape(multi) if kind.startswith("tiny") else \
        production_shape(multi)


def fake_mesh(kind: str):
    """A DeviceMesh of ``kind`` over a ``"fake"`` process group of its size
    (re-initialised when a group of another size is up); this process is
    rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape, axes = mesh_for(kind)
    n = math.prod(shape)
    if tdist.is_initialized() and (tdist.get_backend() != "fake"
                                   or tdist.get_world_size() != n):
        tdist.destroy_process_group()
    if not tdist.is_initialized():
        tdist.init_process_group("fake", store=FakeStore(), rank=0,
                                 world_size=n)
    multi = kind in ("multi", "tiny-multi")
    if kind in ("unit", "2x2"):
        return meshes._mesh(shape, axes)
    return (meshes.make_tiny_mesh(multi_pod=multi) if kind.startswith("tiny")
            else meshes.make_production_mesh(multi_pod=multi))


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------
class PeakBytes(TorchDispatchMode):
    """The high-water mark of the bytes held by storages that ops make
    while this mode is on, each counted once (views share it) until the
    last tensor made on it dies. Storages that exist before (``base``)
    are not counted again."""

    def __init__(self, base=()):
        super().__init__()
        self.known = {t.untyped_storage()._cdata for t in base
                      if isinstance(t, torch.Tensor)}
        self.refs = {}
        self.live = 0
        self.peak = 0

    def _drop(self, key, nbytes):
        self.refs[key] -= 1
        if not self.refs[key]:
            del self.refs[key]
            self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self.known:
                continue
            if key not in self.refs:
                self.refs[key] = 0
                self.live += st.nbytes()
                self.peak = max(self.peak, self.live)
            self.refs[key] += 1
            weakref.finalize(t, self._drop, key, st.nbytes())
        return out


def tree_bytes(*trees) -> int:
    """Bytes of the distinct storages under ``trees``."""
    seen = {}
    for t in tree_flatten(trees)[0]:
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _local_tree(tree, specs, mesh):
    """Fake tensors of this rank's shard shapes (made under the caller's
    FakeTensorMode) for a tree of meta tensors and its specs."""
    if isinstance(tree, dict):
        return {k: _local_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_local_tree(v, s, mesh)
                          for v, s in zip(tree, specs))
    return torch.empty(local_shape(tree.shape, specs, mesh),
                       dtype=tree.dtype)


def default_q_chunk(cell) -> int:
    """The reference's ``q_chunk`` rule."""
    if cell.seq_len >= 32768:
        return 512
    return 1024 if cell.kind == "train" and cell.seq_len >= 4096 else 0


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------
def build_cell(arch_id: str, shape_name: str, mesh, *,
               extra: dict | None = None) -> dict:
    """The cell's model, rules, step and local inputs, as fake tensors
    under the caller's FakeTensorMode (the reference's ``build_cell``
    choices). ``extra`` may set ``global_batch`` and ``n_layers`` (a cut
    cell), ``accum``,
    ``remat``, ``q_chunk``, ``tag`` (the artifact's suffix), ``reduced``
    (the arch's reduced config), ``kv_dtype`` (the KV cache's), the
    layout flags ``dp_only``, ``no_fsdp``, ``mlp_fsdp``, ``no_seq_shard``
    and ``serve_seq_shard``, and ``pad_for_tp`` (the head padding's width
    in place of the model axis's)."""
    extra = extra or {}
    cell = shape_by_name(shape_name)
    if extra.get("global_batch"):          # a cut cell
        cell = dataclasses.replace(cell, global_batch=extra["global_batch"])
    cfg = (get_reduced if extra.get("reduced") else get_config)(arch_id)
    if extra.get("n_layers"):              # a cut cell
        cfg = cfg.replace(n_layers=extra["n_layers"])
    if extra.get("kv_dtype"):
        cfg = cfg.replace(kv_cache_dtype=extra["kv_dtype"])
    _, sizes = mesh_axes(mesh)
    dp_only = bool(extra.get("dp_only"))
    pad = extra.get("pad_for_tp", 1 if dp_only else sizes["model"])
    model0 = build_model(cfg, pad_for_tp=pad, device="meta")
    rules = ShardingRules(model0.cfg, mesh, no_fsdp=bool(extra.get("no_fsdp")),
                          dp_only=dp_only,
                          mlp_fsdp=bool(extra.get("mlp_fsdp"))
                          ).for_batch(cell.global_batch)
    dist = rules.dist_ctx()
    if ((cell.kind == "train" or extra.get("serve_seq_shard"))
            and not extra.get("no_seq_shard")):
        dist["seq_shard"] = True      # Megatron-style sequence parallelism
    model = build_model(cfg, pad_for_tp=pad, dist=dist, device="meta")
    params_meta = model.init_params(0)
    pspecs = rules.param_specs(params_meta)
    dist["param_specs"] = pspecs
    q_chunk = extra.get("q_chunk", default_q_chunk(cell))
    dp_size = rules._dp_size if rules.dp else 1
    params = _local_tree(params_meta, pspecs, mesh)

    def local_batch(specs: dict) -> dict:
        out = {}
        for k, v in specs.items():
            if k == "cache":
                out[k] = _local_tree(v, rules.cache_specs(v), mesh)
                continue
            shape = list(v.shape)
            shape[0] //= dp_size
            out[k] = torch.empty(shape, dtype=v.dtype)
        return out

    batch = local_batch(model.input_specs(cell))
    built = {"cell": cell, "model": model, "rules": rules, "dist": dist,
             "params": params, "batch": batch}
    if cell.kind == "train":
        # bf16 first moment and gradient accumulation for the largest MoE
        low_mem = model.param_counts()["total"] > 1e11
        opt_cfg = (AdamWConfig(m_dtype="bfloat16") if low_mem
                   else AdamWConfig())
        accum = extra.get("accum", max(1, min(16, cell.global_batch
                                              // rules._dp_size)))
        opt = adamw_init(params, opt_cfg)

        def run_with(n: int):
            """The step over ``n`` of the cell's microbatches: the first
            ``n`` microbatches' rows of the local batch (views of it), in
            microbatches of the cell's own size."""
            step = make_train_step(model, opt_cfg, q_chunk=q_chunk,
                                   remat=extra.get("remat", "full"),
                                   accum=n, accum_dtype="bfloat16"
                                   if low_mem else "float32")
            part = batch if n == accum else {
                k: v[:v.shape[0] // accum * n] for k, v in batch.items()}
            return lambda: step(params, opt, part)
        built.update(opt=opt, accum=accum, run=run_with(accum),
                     run_with=run_with)
    elif cell.kind == "prefill":
        built.update(accum=1, opt=None,
                     run=lambda: model.prefill(params, batch,
                                               q_chunk=q_chunk))
    else:
        built.update(accum=1, opt=None,
                     run=lambda: model.decode_step(params, batch))
    return built


def measure(built: dict, n: int | None = None) -> dict:
    """Run the built step once (or, given ``n``, the step over ``n`` of
    its microbatches: ``run_with``): FLOPs of this rank, collectives by kind, peak bytes
    (resident shards plus the step's high-water mark)."""
    from torch.utils.flop_counter import FlopCounterMode
    spmd = built["dist"]["spmd"]
    resident = [built["params"], built["batch"], built["opt"]]
    base = tree_bytes(*resident)
    spmd.counts.reset()
    grad = torch.enable_grad() if built["cell"].kind == "train" \
        else torch.no_grad()
    run = built["run"] if n is None else built["run_with"](n)
    with grad, FlopCounterMode(display=False) as fc, \
            PeakBytes(tree_flatten(resident)[0]) as pk:
        t0 = time.time()
        run()
        run_s = time.time() - t0
    return {"flops": fc.get_total_flops(),
            "collectives": spmd.counts.as_dict(),
            "resident_bytes": base, "transient_peak_bytes": pk.peak,
            "peak_bytes": base + pk.peak, "run_s": run_s,
            "accum_run": [built["accum"] if n is None else n]}


# a train cell of more microbatches is measured at these two: its FLOPs and
# collectives are ``fixed + accum x per microbatch`` (the step's loop runs
# the same microbatch ``accum`` times), so two runs give both terms
# exactly; its transient peak is the same from the third microbatch on (at
# two, the running loss has one scalar fewer alive: 4 bytes less)
ACCUM_RUNS = (3, 4)


def _at(x, y, n: int):
    """The value at ``n`` microbatches of a count that is ``x`` at
    ``ACCUM_RUNS[0]`` and ``y`` at ``ACCUM_RUNS[1]``: whole numbers, exact
    in ints and in floats below 2**53; None where either is not one."""
    if not all(float(v).is_integer() and abs(v) < 2 ** 53 for v in (x, y)):
        return None
    a = ACCUM_RUNS[0]
    per = y - x
    return type(x)((x - a * per) + n * per)


def measure_cell(built: dict, whole: bool = False) -> dict:
    """``measure`` of the cell's step. A train cell of more than
    ``ACCUM_RUNS[1]`` microbatches (unless ``whole``) is run at the two
    accumulations of ``ACCUM_RUNS``, each microbatch the cell's own, and
    its FLOPs and collectives (bytes and calls by kind) are extrapolated to
    its own ``accum``; its resident and peak bytes are the runs' where they
    agree (one microbatch's activations are alive at a time). Where they or
    the collectives' kinds differ, or a count is not a whole number, the
    cell is measured whole. ``accum_run``: the accumulations run."""
    n = built["accum"]
    if whole or "run_with" not in built or n <= max(ACCUM_RUNS):
        return measure(built)
    x, y = (measure(built, a) for a in ACCUM_RUNS)
    cx, cy = x["collectives"], y["collectives"]
    out = dict(x, run_s=x["run_s"] + y["run_s"], accum_run=list(ACCUM_RUNS))
    flops = _at(x["flops"], y["flops"], n)
    coll = {part: {k: _at(cx[part][k], cy[part].get(k, -1), n)
                   for k in cx[part]}
            for part in ("bytes_by_op", "counts")}
    same = all(x[k] == y[k] for k in ("resident_bytes",
                                      "transient_peak_bytes"))
    kinds = all(set(cx[p]) == set(cy[p]) for p in coll)
    if not (same and kinds and flops is not None and None not in [
            v for part in coll.values() for v in part.values()]):
        return measure(built)
    coll["total_bytes"] = float(sum(coll["bytes_by_op"].values()))
    out.update(flops=flops, collectives=coll)
    return out


def run_cell(arch_id: str, shape_name: str, mesh_kind: str,
             out_dir: pathlib.Path | None = None, *,
             extra: dict | None = None, whole: bool = False) -> dict:
    """One cell's artifact (written to ``out_dir`` where given); a long
    train cell is measured from two short accumulations unless ``whole``
    (``measure_cell``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mesh = fake_mesh(mesh_kind)
    names, sizes = mesh_axes(mesh)
    n_chips = math.prod(sizes.values())
    t0 = time.time()
    with FakeTensorMode():
        built = build_cell(arch_id, shape_name, mesh, extra=extra)
        build_s = time.time() - t0
        m = measure_cell(built, whole)
    model, cell = built["model"], built["cell"]
    peak = m["peak_bytes"]
    art = {
        "arch": arch_id, "shape": shape_name, "mesh": mesh_kind,
        "mesh_shape": dict(sizes), "n_chips": n_chips,
        "extra": extra or {},
        "status": "ok",
        "peak_bytes_per_device": int(peak),
        "resident_bytes_per_device": int(m["resident_bytes"]),
        "transient_peak_bytes_per_device": int(m["transient_peak_bytes"]),
        "fits_80gb": bool(peak <= HBM_BYTES),
        "flops_per_device": float(m["flops"]),
        "cost_per_device": {"flops": float(m["flops"])},
        "collectives_per_device": m["collectives"],
        "analytic_hbm_bytes_global": model.analytic_hbm_bytes(
            cell, accum=built["accum"]),
        "model_flops": model.model_flops(cell),
        "param_counts": model.param_counts(),
        "accum": built["accum"],
        "build_s": build_s, "run_s": m["run_s"],
        "accum_run": m["accum_run"],
    }
    if out_dir is not None:
        out_dir = pathlib.Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        tag = (extra or {}).get("tag", "")
        suffix = f"__{tag}" if tag else ""
        (out_dir / f"{arch_id}__{shape_name}__{mesh_kind}{suffix}.json"
         ).write_text(json.dumps(art, indent=1))
    return art


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        epilog="The reference's --save-hlo has no counterpart: no HLO is "
               "made (launch/hlo_cost.py has none either; the FLOP counter "
               "replaces it).")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=list(MESH_KINDS) + ["both"])
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true",
                    help="keep a cell whose artifact says ok")
    ap.add_argument("--q-chunk", type=int, default=-1)
    ap.add_argument("--remat", default="")
    ap.add_argument("--accum", type=int, default=0)
    ap.add_argument("--global-batch", type=int, default=0,
                    help="cut the cell's global batch (a cut cell)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model's depth (a cut cell)")
    ap.add_argument("--pad-for-tp", type=int, default=0,
                    help="pad heads and vocabulary for this width, not the "
                         "model axis's (1: no padding)")
    ap.add_argument("--dp_only", action="store_true",
                    help="the model axis joins data parallelism")
    ap.add_argument("--no_fsdp", action="store_true",
                    help="parameters replicated over the data axes")
    ap.add_argument("--serve_seq_shard", action="store_true",
                    help="sequence parallelism in serving cells too")
    ap.add_argument("--no_seq_shard", action="store_true",
                    help="no sequence parallelism in train cells")
    ap.add_argument("--mlp_fsdp", action="store_true",
                    help="MLP weights over data and model, MLPs whole")
    ap.add_argument("--whole", action="store_true",
                    help="run a long train cell's every microbatch, not "
                         "two short accumulations (measure_cell)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in a process of its own")
    args = ap.parse_args(argv)

    out_dir = pathlib.Path(args.out)
    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    kinds = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.jobs > 1:
        return _fan_out(args, argv, archs, kinds)
    n_ok = n_skip = n_fail = 0
    for arch in archs:
        for cell, runnable, reason in cells(arch):
            if args.shape != "all" and cell.name not in args.shape.split(","):
                continue
            for mk in kinds:
                tagsuf = f"__{args.tag}" if args.tag else ""
                fname = out_dir / f"{arch}__{cell.name}__{mk}{tagsuf}.json"
                if not runnable:
                    out_dir.mkdir(parents=True, exist_ok=True)
                    fname.write_text(json.dumps({
                        "arch": arch, "shape": cell.name, "mesh": mk,
                        "status": "skipped", "reason": reason}, indent=1))
                    print(f"SKIP {arch} {cell.name} {mk}: {reason}")
                    n_skip += 1
                    continue
                if args.skip_existing and fname.exists():
                    try:
                        if json.loads(fname.read_text()).get(
                                "status") == "ok":
                            print(f"CACHED {arch} {cell.name} {mk}")
                            n_ok += 1
                            continue
                    except ValueError:
                        pass
                extra = {"tag": args.tag} if args.tag else {}
                if args.q_chunk >= 0:
                    extra["q_chunk"] = args.q_chunk
                if args.remat:
                    extra["remat"] = args.remat
                if args.accum:
                    extra["accum"] = args.accum
                if args.global_batch:
                    extra["global_batch"] = args.global_batch
                if args.layers:
                    extra["n_layers"] = args.layers
                if args.pad_for_tp:
                    extra["pad_for_tp"] = args.pad_for_tp
                for flag in ("dp_only", "no_fsdp", "serve_seq_shard",
                             "no_seq_shard", "mlp_fsdp"):
                    if getattr(args, flag):
                        extra[flag] = True
                try:
                    art = run_cell(arch, cell.name, mk, out_dir,
                                   extra=extra or None, whole=args.whole)
                    gb = art["peak_bytes_per_device"] / 2 ** 30
                    print(f"OK {arch} {cell.name} {mk}: peak {gb:.2f} GiB/dev"
                          f" fits={art['fits_80gb']}"
                          f" flops/dev={art['flops_per_device']:.3e}"
                          f" coll={art['collectives_per_device']['total_bytes']:.3e}B"
                          f" run={art['run_s']:.1f}s", flush=True)
                    n_ok += 1
                except Exception as e:  # record failures as artifacts too
                    out_dir.mkdir(parents=True, exist_ok=True)
                    fname.write_text(json.dumps({
                        "arch": arch, "shape": cell.name, "mesh": mk,
                        "status": "error", "error": repr(e),
                        "traceback": traceback.format_exc()[-4000:]},
                        indent=1))
                    print(f"FAIL {arch} {cell.name} {mk}: {e!r}", flush=True)
                    n_fail += 1
    print(f"dry-run done: ok={n_ok} skipped={n_skip} failed={n_fail}")
    return 1 if n_fail else 0


def _fan_out(args, argv, archs, kinds) -> int:
    """``--jobs N``: every (arch x shape x mesh) cell as its own process of
    this module, N at a time; their lines as they end, then the count."""
    import subprocess
    import sys
    argv = list(sys.argv[1:] if argv is None else argv)
    rest, skip = [], False
    for i, a in enumerate(argv):      # the caller's options but the cell's
        if skip:
            skip = False
            continue
        if a in ("--arch", "--shape", "--mesh", "--jobs"):
            skip = True
            continue
        if a.split("=")[0] in ("--arch", "--shape", "--mesh", "--jobs"):
            continue
        rest.append(a)
    todo = [(a, c.name, m) for a in archs for c, _, _ in cells(a)
            if args.shape == "all" or c.name in args.shape.split(",")
            for m in kinds]
    todo.sort(key=lambda t: t[1] != "train_4k")   # the long cells first
    running, lines = [], []
    while todo or running:
        while todo and len(running) < args.jobs:
            a, sh, m = todo.pop(0)
            running.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 a, "--shape", sh, "--mesh", m, *rest],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                text=True))
        done = [p for p in running if p.poll() is not None]
        for p in done:
            running.remove(p)
            for ln in p.stdout.read().splitlines():
                if ln.startswith(("OK ", "FAIL ", "SKIP ", "CACHED ")):
                    print(ln, flush=True)
                    lines.append(ln)
        if not done:
            time.sleep(0.5)
    n = {k: sum(ln.startswith(k) for ln in lines)
         for k in ("OK ", "CACHED ", "SKIP ", "FAIL ")}
    print(f"dry-run done: ok={n['OK '] + n['CACHED ']} "
          f"skipped={n['SKIP ']} "
          f"failed={n['FAIL ']}")
    return 1 if n["FAIL "] else 0


if __name__ == "__main__":
    raise SystemExit(main())

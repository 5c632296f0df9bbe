"""The port stands alone: it imports ``torch`` and nothing of ``jax`` or of
the JAX package ``repro``; and the modules it copies from ``repro`` stay
copies (only their first line, which names the original, differs)."""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "serve_realtime_torch.py",
    ROOT / "examples" / "serve_daemon_torch.py",
    ROOT / "examples" / "train_smollm_torch.py",
    ROOT / "examples" / "quickstart_torch.py",
    ROOT / "examples" / "migrate_zero_delay_torch.py",
    ROOT / "benchmarks" / "figure_specs_torch.py"]
COPIED = sorted(p for p in PORT.rglob("*.py")
                if p.read_text().startswith("# Copy of src/repro/"))


def _forbidden_imports(path: Path):
    """Absolute imports of jax, repro or msgpack, and relative imports
    that climb out of the port's package."""
    tree = ast.parse(path.read_text(), str(path))
    # package depth (chip_smoke.py, the examples and the figure registry
    # are top-level scripts or modules: no relative imports)
    depth = (len(path.relative_to(PORT.parent).parts) - 1
             if path.is_relative_to(PORT) else 0)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                if node.level > depth:
                    bad.append(f"line {node.lineno}: relative import above "
                               f"the package")
                continue
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            if top in ("jax", "jaxlib", "repro", "msgpack"):
                bad.append(f"line {node.lineno}: import {n}")
    return bad


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_imports_neither_jax_nor_repro(path):
    assert _forbidden_imports(path) == []


def test_import_everything_and_simulate_without_jax_or_repro():
    """In a fresh interpreter where ``jax`` and ``msgpack`` cannot be
    imported and an import hook refuses ``repro`` (but not
    ``repro_torch``), every module of the port imports, a short simulation
    runs, and its scheduler state round-trips through ``save_state``."""
    code = textwrap.dedent("""
        import importlib, os, pkgutil, sys, tempfile
        sys.modules["jax"] = None
        sys.modules["msgpack"] = None

        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name == "repro" or name.startswith("repro."):
                    raise ImportError(f"refused: {name}")
                return None
        sys.meta_path.insert(0, Refuse())

        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for n in names:
            importlib.import_module(n)
        from repro_torch.api import (HP, LP, DeviceModel, ServerConfig,
                                     StageProfile, TaskSpec)
        specs = [TaskSpec(name=n, period_ms=50.0, priority=p,
                          stages=[StageProfile(f"{n}/s0", 5.0, n_sat=1.0,
                                               mem_frac=0.0)])
                 for n, p in (("a", HP), ("b", LP))]
        def build():
            return (ServerConfig.sim().tasks(specs).contexts(2)
                    .device(DeviceModel(n_units=4.0)).horizon_ms(500.0)
                    .build())
        srv = build()
        m = srv.run()
        assert m.completed[HP] > 0, m.completed
        import repro_torch.checkpoint, repro_torch.serve
        path = os.path.join(tempfile.mkdtemp(), "sched.msgpack")
        srv.save_state(path)
        again = build()
        again.load_state(path)
        assert ([t.mret.task_mret() for t in again.scheduler.tasks]
                == [t.mret.task_mret() for t in srv.scheduler.tasks])
        assert not any(k == "repro" or k.startswith("repro.")
                       for k in sys.modules)
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


@pytest.mark.parametrize("path", COPIED,
                         ids=[str(p.relative_to(PORT)) for p in COPIED])
def test_copied_module_is_the_original_but_for_its_first_line(path):
    rel = path.relative_to(PORT)
    original = ROOT / "src" / "repro" / rel
    lines = path.read_text().splitlines(keepends=True)
    assert lines[0].startswith(f"# Copy of src/repro/{rel.as_posix()};")
    assert "".join(lines[1:]) == original.read_text()


def test_the_scheduler_stack_is_copied():
    copied = {p.relative_to(PORT).as_posix() for p in COPIED}
    for rel in ("core/task.py", "core/mret.py", "core/partition.py",
                "core/stage_queue.py", "core/batching.py", "core/metrics.py",
                "core/scheduler.py", "runtime/contention.py",
                "runtime/arrivals.py", "runtime/engine_core.py",
                "runtime/epoch.py", "configs/mamba2_27b.py",
                "chaos/plan.py", "analysis/sanitizer.py", "configs/base.py",
                "configs/smollm_135m.py", "configs/zamba2_7b.py",
                "configs/qwen2_moe_a27b.py", "configs/qwen15_32b.py",
                "configs/deepseek_v2_236b.py", "configs/gemma2_27b.py",
                "configs/pixtral_12b.py", "configs/stablelm_12b.py",
                "configs/whisper_tiny.py",
                "serving/profiles.py",
                "serving/requests.py", "cluster/__init__.py",
                "cluster/devices.py", "cluster/scheduler.py",
                "analysis/schedcheck/__init__.py",
                "analysis/schedcheck/model.py",
                "analysis/schedcheck/analyzer.py",
                "analysis/schedcheck/oracle.py", "analysis/races.py",
                "serve/__init__.py", "serve/journal.py", "serve/client.py",
                "serve/config.py", "serve/daemon.py", "data/pipeline.py"):
        assert rel in copied


def test_mesh_and_launch_tooling_are_covered():
    """The mesh, sharding, dry-run and roofline modules are scanned above
    (and imported in the fresh interpreter, with every module of the
    port); ``analysis/lint.py`` is a byte copy of the reference's, first
    line aside -- its path rule still names ``repro/chaos/``, as the
    reference's does."""
    scanned = {p.relative_to(PORT).as_posix() for p in SOURCES
               if p.is_relative_to(PORT)}
    for rel in ("parallel/sharding.py", "launch/mesh.py",
                "launch/dryrun.py", "launch/roofline.py",
                "analysis/lint.py"):
        assert rel in scanned
    assert PORT / "analysis" / "lint.py" in COPIED
    assert "repro/chaos/" in (PORT / "analysis" / "lint.py").read_text()

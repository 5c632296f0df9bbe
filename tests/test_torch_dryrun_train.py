"""The reference's tiny-mesh train cell (``DRYRUN_CELLS``' smollm-135m
train_4k on the (2, 4) mesh) through the port's dry-run: status ``ok`` and
FLOPs > 0, its 16 microbatches measured at 3 and at 4 of them and
extrapolated (``dryrun.ACCUM_RUNS``). A file of its own: the two short
accumulations on fake tensors take a minute or two of host CPU."""
import json

import pytest

pytest.importorskip("torch")

from test_torch_dryrun import run_cli  # noqa: E402


def test_dryrun_tiny_mesh_train_cell(tmp_path):
    run_cli(["--arch", "smollm-135m", "--shape", "train_4k", "--mesh",
             "tiny"], tmp_path)
    art = json.loads((tmp_path / "smollm-135m__train_4k__tiny.json")
                     .read_text())
    assert art["status"] == "ok" and art["flops_per_device"] > 0
    assert art["accum"] == 16 and art["fits_80gb"]
    assert art["accum_run"] == [3, 4]
    coll = art["collectives_per_device"]["bytes_by_op"]
    # FSDP gathers and their reduce-scatters, TP and data-parallel sums
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= set(coll)

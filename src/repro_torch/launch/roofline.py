"""Roofline analysis from the port's dry-run artifacts, for one NVIDIA H100.

Counterpart of src/repro/launch/roofline.py, with the H100 SXM's published
peaks in place of the reference's TPU v5e ones. Per (arch x shape x mesh):

    compute term    = FLOPs a device / 989 TFLOP/s   (bf16 dense)
    memory term     = HBM bytes a device / 3.35 TB/s (HBM3)
    collective term = collective bytes a device / 450 GB/s

The dry-run (``launch/dryrun.py``) counts a device's own FLOPs and
collective bytes (its local ops, post-sharding), so the per-device terms
divide by the peaks directly; global FLOPs multiply back by the device
count. The memory term reads the reference's analytic HBM traffic
(``Model.analytic_hbm_bytes``) over the devices.

The collective term divides by 450 GB/s, one direction of NVLink 4:
NVIDIA publishes 900 GB/s a GPU as the sum of both directions over its 18
links (25 GB/s a link and direction). A device's collective bytes
(``Spmd``'s accounting: an all-reduce twice its operand, an all-gather its
result, a reduce-scatter its operand) are what it sends, or what it
receives, in a ring, so one direction's rate bounds them; the reference
divides by one ICI link's rate for the same reason.

MODEL_FLOPS = 6·N_active·D (train) or 2·N_active·D (inference), from the
*published* config (``Model.model_flops``): the ratio of the counted to the
model FLOPs exposes remat recompute, capacity slack and padding.
"""
from __future__ import annotations

import argparse
import json
import pathlib
from typing import Dict, List

PEAK_FLOPS = 989e12        # bf16 dense / GPU (H100 SXM)
HBM_BW = 3.35e12           # bytes/s / GPU (HBM3)
LINK_BW = 450e9            # bytes/s / GPU, one direction of NVLink 4


def load_artifacts(art_dir: str) -> List[dict]:
    out = []
    for p in sorted(pathlib.Path(art_dir).glob("*.json")):
        try:
            out.append(json.loads(p.read_text()))
        except (OSError, ValueError):
            pass
    return out


def roofline_row(art: dict) -> Dict:
    chips = art["n_chips"]
    cost = art.get("cost_per_device", {})
    hc = art.get("hlo_cost_per_device", {})
    # the reference's artifacts carry its HLO walk; the port's dry-run
    # counts FLOPs on fake tensors into cost_per_device
    flops_dev = hc.get("flops") or cost.get("flops", 0.0)
    bytes_dev = (art.get("analytic_hbm_bytes_global", 0.0) / chips
                 or cost.get("bytes accessed", 0.0))
    coll_dev = (hc.get("coll_total_bytes")
                or art.get("collectives_per_device", {}).get("total_bytes",
                                                             0.0))
    t_compute = flops_dev / PEAK_FLOPS
    t_memory = bytes_dev / HBM_BW
    t_coll = coll_dev / LINK_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    model_flops = art.get("model_flops", 0.0)
    hlo_flops_global = flops_dev * chips
    bound = max(t_compute, t_memory, t_coll)
    # fraction of roofline: useful work per chip-second at the binding rate
    roofline_frac = ((model_flops / chips / PEAK_FLOPS) / bound
                     if bound > 0 else 0.0)
    return {
        "arch": art["arch"], "shape": art["shape"], "mesh": art["mesh"],
        "chips": chips,
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops": model_flops,
        "hlo_flops_global": hlo_flops_global,
        "useful_ratio": (model_flops / hlo_flops_global
                         if hlo_flops_global else 0.0),
        "roofline_fraction": roofline_frac,
        "peak_gib": art.get("peak_bytes_per_device", 0) / 2 ** 30,
        "fits": art.get("fits_80gb", art.get("fits_16gb")),
    }


def build_table(art_dir: str = "artifacts/dryrun_torch",
                mesh: str = "single",
                include_tagged: bool = False) -> List[Dict]:
    rows = []
    for art in load_artifacts(art_dir):
        if art.get("status") != "ok" or art.get("mesh") != mesh:
            continue
        if not include_tagged and art.get("extra", {}).get("tag"):
            continue
        rows.append(roofline_row(art))
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    return rows


def fmt_table(rows: List[Dict]) -> str:
    hdr = (f"{'arch':18s} {'shape':12s} {'Tcomp(s)':>10s} {'Tmem(s)':>10s} "
           f"{'Tcoll(s)':>10s} {'dom':>5s} {'useful':>7s} {'roofl%':>7s} "
           f"{'GiB/dev':>8s} fits")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r['arch']:18s} {r['shape']:12s} {r['t_compute_s']:10.3e} "
            f"{r['t_memory_s']:10.3e} {r['t_collective_s']:10.3e} "
            f"{r['dominant'][:4]:>5s} {r['useful_ratio']:7.2f} "
            f"{100*r['roofline_fraction']:6.1f}% {r['peak_gib']:8.2f} "
            f"{'Y' if r['fits'] else 'N'}")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--art", default="artifacts/dryrun_torch")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--json-out", default="artifacts/roofline_torch.json")
    args = ap.parse_args(argv)
    rows = build_table(args.art, args.mesh)
    print(fmt_table(rows))
    pathlib.Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(args.json_out).write_text(json.dumps(rows, indent=1))
    print(f"\n{len(rows)} cells -> {args.json_out}")


if __name__ == "__main__":
    main()

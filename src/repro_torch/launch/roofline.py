"""Roofline analysis over the dry run's cell JSONs, port of
``repro/launch/roofline.py``: ``python -m repro_torch.launch.roofline
[--dir DIR] [--mesh 32x8|2x32x8|all] [--json-out F]``.

Three terms per (arch x shape x mesh) cell, all in seconds a step:

  compute    = FLOPs per device / PEAK_FLOPS
  memory     = HBM bytes per device / HBM_BW
  collective = sum over mesh dims of that dim's wire bytes per device
               over its link's rate

FLOPs and wire bytes are one device's, counted by ``launch/opcount.py``
while the dry run traced the step (exact trip counts: eager runs every
loop iteration).  HBM bytes are the reference's analytic traffic model
below.  MODEL_FLOPS = 6·N·D (active N for MoE) is reported against the
counted FLOPs to expose recomputation and redundancy.

Hardware model: one NVIDIA H100 SXM5 (80 GB HBM3) a device, from NVIDIA's
datasheet peaks, at the card's 700 W limit.  An H100 has two fabrics
where the reference's v5e has one ICI, so the collective term prices
each mesh dim at its own link: ``model`` runs inside a node's NVLink
domain, ``data`` and ``pod`` cross nodes over InfiniBand.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

PEAK_FLOPS = 989e12     # H100 SXM5: dense bf16 tensor-core FLOP/s, datasheet peak
HBM_BW = 3.35e12        # H100 SXM5: HBM3 bytes/s, datasheet peak
NVLINK_BW = 450e9       # H100 SXM5: NVLink 4, bytes/s one direction, datasheet peak
IB_BW = 50e9            # one NDR 400 Gb/s InfiniBand port a GPU (DGX H100), datasheet peak
LINK_BW = {"model": NVLINK_BW, "data": IB_BW, "pod": IB_BW}
# H100 SXM5 80GB HBM3: torch.cuda.get_device_properties(0).total_memory
DEVICE_MEMORY = 85_017_493_504
FIT_SHARE = 14 / 16     # static bytes below this share of a card fit (the reference's 14 of 16)


def analytic_hbm_bytes(info: dict) -> float:
    """Per-device HBM traffic per step (streaming model).

    train:   3x param stream (fwd read, bwd read, update write) + opt state
             read+write + activation boundary traffic.
    decode:  params once + full cache read + cache write (1 token).
    prefill: params once + activation stream.
    """
    static = info.get("static_bytes_per_dev", 0)
    shape = info["shape"]
    if shape.startswith("train") or shape.startswith("vol"):
        return 5.0 * static  # 3x params + ~2x opt state, activations folded in
    return 1.2 * static  # params + cache streamed ~once


def model_flops(info: dict) -> float:
    """6·N·D with active-N for MoE; decode D = new tokens only."""
    n = info["n_params"] * info.get("active_fraction", 1.0)
    d = info["ntokens"]
    mult = 6.0 if (info["shape"].startswith("train") or info["shape"].startswith("vol")) else 2.0
    return mult * n * d


def collective_seconds(walked: dict) -> float:
    """Each mesh dim's wire bytes over its link (a group spanning several
    dims, or one not named, at the slowest link)."""
    return sum(b / LINK_BW.get(dim, IB_BW)
               for dim, b in walked.get("wire_bytes_by_mesh_dim", {}).items())


def load_cells(out_dir: str, tag: str = "") -> list[dict]:
    cells = []
    for path in sorted(glob.glob(os.path.join(out_dir, f"*{tag}.json"))):
        stem = os.path.basename(path)[: -len(".json")]
        if not tag and not (stem.endswith("_single") or stem.endswith("_multi")):
            continue  # tagged perf-experiment file; not part of the baseline table
        with open(path) as f:
            info = json.load(f)
        info["_file"] = os.path.basename(path)
        cells.append(info)
    return cells


def analyse(info: dict) -> dict | None:
    if "skipped" in info or "error" in info:
        return None
    dev = info["devices"]
    walked = info.get("walked", {})
    # the counter ran on one rank's shards: its numbers are per device
    flops_dev = walked.get("flops", float("nan"))
    hbm = analytic_hbm_bytes(info)
    t_comp = flops_dev / PEAK_FLOPS
    t_mem = hbm / HBM_BW
    t_coll = collective_seconds(walked)
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    dom = max(terms, key=lambda k: terms[k] if terms[k] == terms[k] else -1)
    mf = model_flops(info)  # global 6ND
    useful = (mf / dev) / flops_dev if flops_dev else float("nan")
    bound = max(terms.values())
    frac = (mf / dev / PEAK_FLOPS) / bound if bound > 0 else float("nan")
    static = info.get("static_bytes_per_dev", 0)
    return {
        "arch": info["arch"], "shape": info["shape"], "mesh": info["mesh"],
        "t_compute_s": t_comp, "t_memory_s": t_mem, "t_collective_s": t_coll,
        "dominant": dom,
        "model_flops": mf, "walked_flops": walked.get("flops"),
        "useful_fraction": useful,
        "roofline_fraction": frac,  # useful work / dominant-term time
        "static_GB": static / 1e9,
        "fits_80GB": static < FIT_SHARE * DEVICE_MEMORY,
        "trace_s": info.get("trace_s"),
        "settings": info.get("settings", {}),
    }


def markdown_table(rows: list[dict]) -> str:
    hdr = ("| arch | shape | mesh | compute s | memory s | collective s | dominant "
           "| 6ND/counted | roofline-frac | static GB | fits | trace s |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|---|\n")
    out = [hdr]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['t_compute_s']:.3e} "
            f"| {r['t_memory_s']:.3e} | {r['t_collective_s']:.3e} | **{r['dominant']}** "
            f"| {r['useful_fraction']:.2f} | {r['roofline_fraction']:.2f} "
            f"| {r['static_GB']:.2f} | {'Y' if r['fits_80GB'] else 'N'} "
            f"| {r['trace_s']:.1f} |\n"
        )
    return "".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.roofline")
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--tag", default="")
    ap.add_argument("--mesh", default="32x8", help="32x8 | 2x32x8 | all")
    ap.add_argument("--json-out", default="")
    args = ap.parse_args(argv)
    rows = []
    skips = []
    for info in load_cells(args.dir, args.tag):
        if "skipped" in info:
            skips.append((info["arch"], info["shape"], info["mesh"], info["skipped"]))
            continue
        if "error" in info:
            skips.append((info["arch"], info["shape"], info.get("mesh", "?"),
                          "ERROR " + info["error"]))
            continue
        r = analyse(info)
        if r and (args.mesh == "all" or r["mesh"] == args.mesh):
            rows.append(r)
    rows.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    print(markdown_table(rows))
    if skips:
        print("\nSkipped/failed cells:")
        for s in sorted(set(skips)):
            print(f"- {s[0]} / {s[1]} / {s[2]}: {s[3]}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()

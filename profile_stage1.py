"""Where the time of the Hopper stage-1 kernel goes, on one NVIDIA GPU.

    python3 profile_stage1.py

Builds nakama_tpu_torch/csrc/stage1_wgmma.cu three times: as shipped;
with STAGE1_EXP=1, which leaves out the epilogue (the products alone);
and with STAGE1_EXP=2, which leaves out the products (the epilogue on
zero counts, with the same loads and barriers). Times each at the first
north-star interval's shape (131,072 rows x 114,688 columns), without and
with embeddings, in turns (kernel, products, epilogue, epilogue,
products, kernel), with CUDA events, while nvidia-smi samples the SM clock
and the board power. Prints the card's name and power limit, then one
JSON line per shape. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import torch

import chip_smoke as cs

BUILDS = {"kernel": (), "products_only": ("STAGE1_EXP=1",),
          "epilogue_only": ("STAGE1_EXP=2",)}


def sampled(fn, reps: int) -> dict:
    """`cs.cuda_time_ms(fn, reps)` with nvidia-smi sampling every 50 ms."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, text=True,
    )
    try:
        ms = cs.cuda_time_ms(fn, reps)
    finally:
        smi.terminate()
        out = smi.communicate()[0]
    samples = []
    for line in out.splitlines():
        try:
            clock, power = (float(x) for x in line.split(","))
        except ValueError:
            continue
        samples.append((clock, power))
    return {
        "ms": ms,
        "sm_clock_mhz_median": statistics.median(c for c, _ in samples) if samples else None,
        "power_w_max": max(p for _, p in samples) if samples else None,
        "samples": len(samples),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_stage1: no CUDA device", file=sys.stderr)
        return 1
    from nakama_tpu_torch import kernels
    from nakama_tpu_torch.matchmaker import device2 as td2

    info = cs.phase_device()
    k = kernels.STAGE1_WGMMA
    libs = {name: kernels.load_library(k, d) for name, d in BUILDS.items()}
    dev = torch.device("cuda:0")
    pool, lo, inv = cs.bench_pool(131_072, 24, 16, 16, 16, 7, dev)
    active = torch.arange(cs.N_TICKETS, dtype=torch.int32, device=dev)
    rows, n_cols = 131_072, 114_688
    m = td2.winners_per_block(cs.K, n_cols // cs.BN)
    for emb in (False, True):
        args = cs.stage1_case(pool, (lo, inv), n_cols, rows, active, False, emb)
        kw = dict(f_tot=41.0, m=m, bn=cs.BN, emb_scale=256.0, **args)
        runs = {name: [] for name in BUILDS}
        order = list(BUILDS) + list(reversed(BUILDS))
        for name in order:
            k.lib = libs[name]
            runs[name].append(sampled(lambda: kernels.stage1_wgmma(**kw), 20))
        k.lib = libs["kernel"]
        ms = {name: statistics.median(r["ms"] for r in rs) for name, rs in runs.items()}
        cs.emit({
            "phase": "profile_stage1", "rows": rows, "cols": n_cols, "m": m,
            "with_embedding": emb, "median_ms": ms,
            "products_plus_epilogue_ms": ms["products_only"] + ms["epilogue_only"],
            "runs": runs,
        })
        del args, kw
        torch.cuda.empty_cache()
    print(info["nvidia_smi"])
    return 0


if __name__ == "__main__":
    sys.exit(main())

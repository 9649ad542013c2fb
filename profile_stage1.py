"""Where the time of a Hopper stage-1 kernel goes, on one NVIDIA GPU.

    python3 profile_stage1.py [stage1_wgmma | stage1_select | plans]

stage1_wgmma (the default): builds nakama_tpu_torch/csrc/stage1_wgmma.cu
three times: as shipped; with STAGE1_EXP=1, which leaves out the epilogue
(the products alone); and with STAGE1_EXP=2, which leaves out the
products (the epilogue on zero counts, with the same loads and barriers).
Times each at the first north-star interval's shape (131,072 rows x
114,688 columns), without and with embeddings.

stage1_select: builds nakama_tpu_torch/csrc/stage1_select.cu as shipped,
with STAGE1_EXP=1 (the products alone) and with STAGE1_EXP=3 (the queues
filled, never merged: the kept lists stay empty). Times each at 32,768 x
32,768 north-star tickets at k = 256 (m = 16, the wide_k256 phase's
shape), at k = 1024 (m = 64), and with 48 numeric and 32 string fields
at k = 64 (D = 1032, m = 4: the wide_fields phase's shape).

Every build is timed in turns (kernel, products, other, other, products,
kernel), with CUDA events, while nvidia-smi samples the SM clock and the
board power.

plans: stage1_select under every shared-memory plan that fits
(kernels.select_plans: consumer warpgroups, ring stages, queue words, row
operand resident or streamed), each held word for word against the plan
kernels.select_plan picks, at
32,768 x 32,768 north-star tickets: D = 1032 at m = 4 without flags and
under rev (the wide_fields phase's shape), D = 520 at m = 16 (wide_k256's)
and at m = 64, rev at D = 1544, m = 4. CUDA-event medians, the picked
plan timed first and last.

Prints the card's name and power limit, then one JSON line per shape.
Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import torch

import chip_smoke as cs

# The builds of each kernel, and its shapes: (rows = columns of the pool,
# active rows, columns, k, embeddings, numeric and string fields).
PROFILES = {
    "stage1_wgmma": (
        {"kernel": (), "products_only": ("STAGE1_EXP=1",),
         "epilogue_only": ("STAGE1_EXP=2",)},
        [(131_072, cs.N_TICKETS, 114_688, cs.K, False, 24, 16),
         (131_072, cs.N_TICKETS, 114_688, cs.K, True, 24, 16)],
    ),
    "stage1_select": (
        {"kernel": (), "products_only": ("STAGE1_EXP=1",),
         "no_merges": ("STAGE1_EXP=3",)},
        [(32_768, 32_768, 32_768, 256, False, 24, 16),
         (32_768, 32_768, 32_768, 1024, False, 24, 16),
         (32_768, 32_768, 32_768, cs.K, False, 48, 32)],
    ),
}


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


# plans: (fn, fs, k, rev) at 32,768 x 32,768.
PLAN_SHAPES = [(48, 32, cs.K, False), (48, 32, cs.K, True), (24, 16, 256, False),
               (24, 16, 1024, False), (64, 64, cs.K, True)]


def time_plans(dev) -> None:
    """stage1_select under every fitting plan at PLAN_SHAPES."""
    import dataclasses

    from nakama_tpu_torch import kernels
    from nakama_tpu_torch.matchmaker import device2 as td2

    n = 32_768
    for fn, fs, cands, rev in PLAN_SHAPES:
        pool, lo, inv = cs.bench_pool(n, fn, fs, 16, 16, 7, dev)
        active = torch.arange(n, dtype=torch.int32, device=dev)
        m = td2.winners_per_block(cands, n // cs.BN)
        args = cs.stage1_case(pool, (lo, inv), n, n, active, rev, False, fn, fs)
        d = args["uq"].shape[1]
        kw = dict(f_tot=float(fn + fs + 1), m=m, bn=cs.BN, emb_scale=256.0, **args)
        picked = kernels.select_plan(m, d, 0, rev)
        want = kernels.stage1_select(**kw)
        results = [{"plan": dataclasses.asdict(picked), "picked": True,
                    "ms": cs.cuda_time_ms(lambda: kernels.stage1_select(**kw), 10)}]
        for plan in kernels.select_plans(m, d, 0, rev):
            got = kernels.stage1_select(plan=plan, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"plan {plan} disagrees with {picked}")
            del got
            results.append({
                "plan": dataclasses.asdict(plan), "picked": plan == picked,
                "ms": cs.cuda_time_ms(lambda p=plan: kernels.stage1_select(plan=p, **kw), 10),
            })
        results.append({"plan": dataclasses.asdict(picked), "picked": True,
                        "ms": cs.cuda_time_ms(lambda: kernels.stage1_select(**kw), 10)})
        best = min(results, key=lambda r: r["ms"])
        cs.emit({
            "phase": "profile_plans", "rows": n, "cols": n, "m": m, "d": d, "rev": rev,
            "picked": dataclasses.asdict(picked),
            "picked_ms": [results[0]["ms"], results[-1]["ms"]], "best": best,
            "plans": results[1:-1],
        })
        del pool, args, kw, want
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_stage1: no CUDA device", file=sys.stderr)
        return 1
    from nakama_tpu_torch import kernels
    from nakama_tpu_torch.matchmaker import device2 as td2

    name = sys.argv[1] if len(sys.argv) > 1 else "stage1_wgmma"
    if name == "plans":
        info = cs.phase_device()
        time_plans(torch.device("cuda:0"))
        print(info["nvidia_smi"])
        return 0
    builds, shapes = PROFILES[name]
    info = cs.phase_device()
    k = next(kernel for kernel in kernels.KERNELS if kernel.name == name)
    launch = getattr(kernels, name)
    libs = {build: kernels.load_library(k, d) for build, d in builds.items()}
    dev = torch.device("cuda:0")
    for n, n_active, n_cols, cands, emb, fn, fs in shapes:
        pool, lo, inv = cs.bench_pool(n, fn, fs, 16, 16, 7, dev)
        active = torch.arange(n_active, dtype=torch.int32, device=dev)
        m = td2.winners_per_block(cands, n_cols // cs.BN)
        args = cs.stage1_case(pool, (lo, inv), n_cols, n, active, False, emb, fn, fs)
        kw = dict(f_tot=float(fn + fs + 1), m=m, bn=cs.BN, emb_scale=256.0, **args)
        runs = {build: [] for build in builds}
        for build in list(builds) + list(reversed(builds)):
            k.lib = libs[build]
            runs[build].append(sampled(lambda: launch(**kw), 20))
        k.lib = libs["kernel"]
        ms = {build: statistics.median(r["ms"] for r in rs) for build, rs in runs.items()}
        cs.emit({
            "phase": "profile_stage1", "kernel": name, "rows": n, "cols": n_cols,
            "k": cands, "m": m, "d": args["uq"].shape[1], "with_embedding": emb,
            "median_ms": ms, "runs": runs,
        })
        del pool, args, kw
        torch.cuda.empty_cache()
    print(info["nvidia_smi"])
    return 0


if __name__ == "__main__":
    sys.exit(main())

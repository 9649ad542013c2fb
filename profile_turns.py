"""The port's redesigned hand kernels beside other commits', on one
NVIDIA GPU, in turns.

    python3 profile_turns.py OTHER [OTHER ...]

Each OTHER is an unpacked tree of another commit (say `git archive` of
the parent into a directory that .gitignore lists). Runs the trees'
kernels in turns, the OTHERs and then this tree and back (A, this, this,
A for one OTHER; A, B, this, this, B, A for two), each turn a fresh
process that imports `nakama_tpu_torch` from its tree and builds its
kernels there, and times in each: `stage1_wgmma` at the first
north-star interval's shape (131,072 rows x 114,688 columns, D = 520,
m = 2) without and with embeddings, at `wide`'s (32,768 x 32,768,
k = 128: m = 8), and at the north-star shape with 32-wide embeddings
(E = 32) and with 32 numeric and 32 string fields (D = 776)
(CUDA-event medians of the call, `chip_smoke.cuda_time_ms`); `lex_ranks` over one board at the
leaderboard phase's size (16,777,216 slots, 10,000,000 live keys, sorted
on the card) at 1,024 queries and at one (device time with L2 evicted
and warm, `chip_smoke.device_time_ms`); and one dependent load's latency
(`chip_smoke.load_latency`, the same probe in every turn). Every result
is held against the plain version. Prints the card's name and power
limit, then one JSON line of the turns and each tree's medians. Needs a CUDA
device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs

SLOTS = 16_777_216
LIVE = 10_000_000
ROWS, COLS = 131_072, 114_688


def board(dev):
    """A desc board's sorted key rows (-score, -subscore, seq), PAD_KEY
    past the live ones, as the rank engine keeps them."""
    from nakama_tpu_torch.leaderboard import cuda as b8

    g = torch.Generator(device=dev).manual_seed(3)
    keys = torch.full((SLOTS, 3), int(b8.PAD_KEY), dtype=torch.int32, device=dev)
    keys[:LIVE, 0] = -torch.randint(0, 4 * LIVE, (LIVE,), generator=g, device=dev,
                                    dtype=torch.int32)
    keys[:LIVE, 1] = -torch.randint(0, 1000, (LIVE,), generator=g, device=dev,
                                    dtype=torch.int32)
    keys[:LIVE, 2] = torch.arange(1, LIVE + 1, dtype=torch.int32, device=dev)
    return b8.sort_boards(keys[None])[0][0].contiguous()


# stage1_wgmma's shapes: (pool's fn, fs and embedding width), rows,
# columns, k, embeddings scored.
STAGE1_CASES = {
    "without": ((24, 16, 16), ROWS, COLS, cs.K, False),
    "with_embedding": ((24, 16, 16), ROWS, COLS, cs.K, True),
    "wide_m8": ((24, 16, 16), 32_768, 32_768, 128, False),
    "e32": ((24, 16, 32), ROWS, COLS, cs.K, True),
    "d776": ((32, 32, 16), ROWS, COLS, cs.K, False),
}


def stage1_turn(dev) -> dict:
    from nakama_tpu_torch import kernels
    from nakama_tpu_torch.matchmaker import device2 as td2

    out = {}
    pools: dict = {}
    for name, ((fn, fs, e), rows, cols, k, emb) in STAGE1_CASES.items():
        if (fn, fs, e) not in pools:
            pools.clear()
            torch.cuda.empty_cache()
            pools[(fn, fs, e)] = cs.bench_pool(ROWS, fn, fs, 16, e, 7, dev)
        pool, lo, inv = pools[(fn, fs, e)]
        active = torch.arange(min(cs.N_TICKETS, rows), dtype=torch.int32, device=dev)
        m = td2.winners_per_block(k, cols // cs.BN)
        args = cs.stage1_case(pool, (lo, inv), cols, rows, active, False, emb, fn, fs)
        kw = dict(f_tot=float(fn + fs + 1), m=m, bn=cs.BN, emb_scale=256.0, **args)
        want = td2.stage1_plain(fn=fn, fs=fs, m=m, bn=cs.BN, emb_scale=256.0, **args)
        check = cs.compare_winners(kernels.stage1_wgmma(**kw), want, emb, "stage1_wgmma")
        del want
        out[name] = {
            "m": m, "ms": cs.cuda_time_ms(lambda: kernels.stage1_wgmma(**kw), 20),
            **check}
        del args, kw
        torch.cuda.empty_cache()
    return out


def lex_turn(dev) -> dict:
    from nakama_tpu_torch.leaderboard import cuda as b8

    sorted_keys = board(dev)
    rng = np.random.default_rng(5)
    rows = torch.from_numpy(rng.integers(0, LIVE, 1024)).to(dev)
    iters = b8.n_search_iters(SLOTS)
    out = {}
    for name, q in (("q1024", sorted_keys[rows].contiguous()),
                    ("q1", sorted_keys[rows[:1]].contiguous())):
        got = b8.lex_ranks(sorted_keys, q, iters)
        want = b8.lex_ranks_plain(sorted_keys, q, iters)
        out[name] = {
            "cold_ms": cs.device_time_ms(
                lambda q=q: b8.lex_ranks(sorted_keys, q, iters), 30, True),
            "warm_ms": cs.device_time_ms(
                lambda q=q: b8.lex_ranks(sorted_keys, q, iters), 20, False),
            "max_abs_err": int((got.long() - want.long()).abs().max()),
        }
    return out


def child(tree: str) -> None:
    """One turn: this process's `nakama_tpu_torch` is `tree`'s."""
    sys.path.insert(0, os.path.abspath(tree))
    import nakama_tpu_torch

    if not nakama_tpu_torch.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {nakama_tpu_torch.__file__}, not {tree}'s")
    dev = cs.DEVICE
    res = {"stage1_wgmma": stage1_turn(dev), "lex_ranks": lex_turn(dev),
           "load_latency": cs.load_latency(SLOTS)}
    print(json.dumps(res))


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_turns: no CUDA device", file=sys.stderr)
        return 1
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(sys.argv[2])
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    trees = {path: os.path.abspath(path) for path in sys.argv[1:]}
    trees["this"] = here
    smi = cs.phase_device()["nvidia_smi"]
    runs: dict = {name: [] for name in trees}
    for name in list(trees) + list(reversed(trees)):
        done = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", trees[name]],
            capture_output=True, text=True, cwd=here)
        if done.returncode != 0:
            print(done.stdout, done.stderr, file=sys.stderr)
            return 1
        runs[name].append(json.loads(done.stdout.strip().splitlines()[-1]))

    def med(name, *path):
        vals = []
        for r in runs[name]:
            for key in path:
                r = r[key]
            vals.append(r)
        return statistics.median(vals)

    medians = {name: {
        **{f"stage1_wgmma_{case}_ms": med(name, "stage1_wgmma", case, "ms")
           for case in STAGE1_CASES},
        "lex_q1024_cold_ms": med(name, "lex_ranks", "q1024", "cold_ms"),
        "lex_q1_cold_ms": med(name, "lex_ranks", "q1", "cold_ms"),
        "load_latency_ms": med(name, "load_latency", "ms"),
    } for name in runs}
    print(smi)
    print(json.dumps({"trees": trees, "medians": medians, "runs": runs}))
    errors = [t["max_abs_err"] for rs in runs.values() for r in rs
              for t in r["lex_ranks"].values()]
    return 1 if any(errors) else 0


if __name__ == "__main__":
    sys.exit(main())

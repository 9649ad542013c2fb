"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written kernel and native library from the sources
in this checkout, holds the kernel against its plain PyTorch version on
the card, runs the port's device self-check, then drives the matchmaker's
main path through its public entry point (`LocalMatchmaker` with the
default `backend="cuda"`) at the default widths: 100,000 1v1 tickets
(the device-pairing path) and 100,000 embedding-scored 5v5 tickets (the
native-assembler path). Every phase prints one JSON line; any failure
raises and the script exits non-zero without a result line. The last line
is the device summary.

Needs a CUDA device (exits non-zero without one) and imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

N_TICKETS = 100_000
BN = 1024
K = 64
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_time_ms(fn, reps: int) -> float:
    """Median device time of `fn` over `reps` runs (after one warm-up),
    timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ----------------------------------------------------------------- phases


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    cap = torch.cuda.get_device_capability(0)
    info = {
        "phase": "device",
        "name": torch.cuda.get_device_name(0),
        "nvidia_smi": smi,
        "capability": list(cap),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
    }
    emit(info)
    if cap != (9, 0):
        raise RuntimeError(f"needs a Hopper card (sm_90), got {cap}")
    return info


def phase_build() -> None:
    from nakama_tpu_torch import kernels, native

    errors: list[BaseException] = []
    seconds: dict[str, float] = {}

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
        except BaseException as e:  # re-raised below, on the main thread
            errors.append(e)
        seconds[name] = round(time.perf_counter() - t0, 3)

    jobs = [
        threading.Thread(target=run, args=(k.name, lambda k=k: kernels.build(k)))
        for k in kernels.KERNELS
    ]
    jobs.append(threading.Thread(target=run, args=("native", native.build)))
    for j in jobs:
        j.start()
    for j in jobs:
        j.join()
    if errors:
        raise errors[0]
    ptxas = {
        k.name: [
            line.split("info    :")[-1].strip()
            for line in k.build_log.splitlines()
            if "registers" in line or "spill" in line
        ]
        for k in kernels.KERNELS
    }
    emit({"phase": "build", "seconds": seconds, "ptxas": ptxas})


def bench_pool(n: int, fn: int, fs: int, s: int, d: int, seed: int, dev):
    """Pool columns of `n` north-star tickets (1v1, one of 8 mode terms,
    rank window +-100 over ranks 0..999), laid out as the compiler lays
    them out, plus unit skill embeddings; and the bucket grid the backend
    would derive from them."""
    from nakama_tpu_torch.matchmaker.compile import (
        FULL_HI, FULL_LO, MISSING, hash_str,
    )
    from nakama_tpu_torch.matchmaker.device import (
        FLAG_HAS_MUST, FLAG_VALID, pool_schema,
    )

    rng = np.random.default_rng(seed)
    p = pool_schema(n, fn, fs, s, d)
    mode = rng.integers(0, 8, n)
    rank = rng.integers(0, 1000, n).astype(np.float32)
    mode_hash = np.asarray([hash_str(f"m{m}") for m in range(8)], np.int32)
    p["num"][:] = MISSING
    p["num"][:, 0] = 2  # builtin min_count
    p["num"][:, 1] = 2  # builtin max_count
    p["num"][:, 2] = np.float32(1.7e9)  # builtin created_at
    p["num"][:, 3] = rank  # properties.rank
    p["str"][:, 1] = rng.integers(1, 2**31 - 1, n)  # builtin ticket id hash
    p["str"][:, 2] = mode_hash[mode]  # properties.mode
    p["n_lo"][:] = FULL_LO
    p["n_hi"][:] = FULL_HI
    p["n_lo"][:, 3] = np.maximum(0, rank - 100)
    p["n_hi"][:, 3] = rank + 100
    p["s_req"][:, 2] = mode_hash[mode]
    p["min_count"][:] = 2
    p["max_count"][:] = 2
    p["created"][:] = np.arange(n)
    p["flags"][:] = FLAG_VALID | FLAG_HAS_MUST
    emb = rng.standard_normal((n, d)).astype(np.float32)
    p["emb"][:] = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    grid_lo = np.zeros(fn, np.float32)
    grid_inv = np.ones(fn, np.float32)
    for col in range(4):
        lo, hi = float(p["num"][:, col].min()), float(p["num"][:, col].max())
        grid_lo[col] = lo
        grid_inv[col] = 1.0 / max(hi - lo, 1e-30)
    pool = {k: torch.from_numpy(v).to(dev) for k, v in p.items()}
    return pool, torch.from_numpy(grid_lo).to(dev), torch.from_numpy(grid_inv).to(dev)


def stage1_case(pool, grid, n_cols, rows, active, rev, emb):
    """The stage-1 operands of one dispatch, through the port's encoders."""
    from nakama_tpu_torch.matchmaker import device2 as td2

    pool_n = {k: v[:n_cols] for k, v in pool.items()}
    act = torch.full((rows,), -1, dtype=torch.int32, device=active.device)
    act[: len(active)] = active
    rowq = {k: pool_n[k][act.clamp(min=0).long()] for k in td2.ROWQ_KEYS}
    return td2.stage1_inputs(
        pool_n, rowq, act, *grid, fn=24, fs=16, rev=rev, with_embedding=emb
    )


def compare_winners(got: torch.Tensor, want: torch.Tensor, emb: bool) -> dict:
    """Identical words without embeddings; with them the same empty lanes
    and priorities within 1 (the bump's truncation boundary)."""
    from nakama_tpu_torch.matchmaker.device2 import COL_BITS, PACKED_NONE

    got, want = got.cpu().numpy(), want.cpu().numpy()
    differ = int((got != want).sum())
    empty_same = bool(((got == PACKED_NONE) == (want == PACKED_NONE)).all())
    live = got != PACKED_NONE
    dprio = int(
        np.abs((got[live] >> COL_BITS) - (want[live] >> COL_BITS)).max(initial=0)
    )
    ok = differ == 0 if not emb else (empty_same and dprio <= 1)
    if not ok:
        raise AssertionError(
            f"stage1 kernel disagrees with its plain version: {differ} words"
            f" differ, max priority difference {dprio}, empty lanes same:"
            f" {empty_same}"
        )
    return {
        "differing_words": differ,
        "max_prio_diff": dprio,
        "live_words": int(live.sum()),
    }


def stage1_bound_ms(args: dict, out_words: int) -> tuple[float, str]:
    """Least time for the stage-1 function on this card: the larger of
    its operations at the bf16 tensor-core peak and its bytes (each input
    read once, the output written once) at the memory peak."""
    a, d = args["uq"].shape
    n = args["vv"].shape[0]
    flops = 2.0 * a * n * d
    nbytes = out_words * 4
    for t in args.values():
        nbytes += t.numel() * t.element_size()
    if "uv" in args:
        flops += 2.0 * a * n * d
    if "ue" in args:
        flops += 2.0 * a * n * args["ue"].shape[1]
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_kernels(dev) -> dict:
    from nakama_tpu_torch.matchmaker import device2 as td2

    pool, grid_lo, grid_inv = bench_pool(131_072, 24, 16, 16, 16, 7, dev)
    grid = (grid_lo, grid_inv)
    max_err = 0
    # The three winners-per-block regimes at k = 64, bn = 1024: m = 2 at
    # the north-star extent (112 blocks), m = 1 at 128 blocks, m = 2k on a
    # one-block pool; a few thousand rows, all columns, every flag pair.
    for n_cols in (114_688, 131_072, 1024):
        m = td2.winners_per_block(K, n_cols // BN)
        active = torch.arange(min(4000, n_cols), dtype=torch.int32, device=dev)
        for rev in (False, True):
            for emb in (False, True):
                args = stage1_case(pool, grid, n_cols, 4096, active, rev, emb)
                kw = dict(fn=24, fs=16, m=m, bn=BN, emb_scale=256.0, **args)
                got = td2.stage1(**kw)
                want = td2.stage1_plain(**kw)
                res = compare_winners(got, want, emb)
                max_err = max(max_err, res["max_prio_diff"])
                emit({
                    "phase": "kernels", "kernel": "stage1", "rows": 4096,
                    "cols": n_cols, "m": m, "rev": rev, "with_embedding": emb,
                    **res,
                })
                del args, kw, got, want

    # The main path's own shape: the first north-star interval dispatches
    # 100,000 actives padded to 131,072 rows against 114,688 columns.
    rows, n_cols = 131_072, 114_688
    m = td2.winners_per_block(K, n_cols // BN)
    active = torch.arange(N_TICKETS, dtype=torch.int32, device=dev)
    args = stage1_case(pool, grid, n_cols, rows, active, False, False)
    kw = dict(fn=24, fs=16, m=m, bn=BN, emb_scale=256.0, **args)
    got = td2.stage1(**kw)
    res = compare_winners(got, td2.stage1_plain(**kw), False)
    kernel_ms = cuda_time_ms(lambda: td2.stage1(**kw), 5)
    plain_ms = cuda_time_ms(lambda: td2.stage1_plain(**kw), 2)
    bound_ms, bound_by = stage1_bound_ms(args, got.numel())
    del got
    uq, vv = args["uq"], args["vv"]
    library_ms = cuda_time_ms(lambda: torch.matmul(uq, vv.T), 3)
    timing = {
        "rows": rows, "cols": n_cols, "m": m, "kernel_ms": kernel_ms,
        "plain_ms": plain_ms, "library_ms": library_ms,
        "library_call": "torch.matmul(uq, vv.T) in bf16 (the product alone)",
        "bound_ms": bound_ms, "bound_by": bound_by, **res,
    }
    emit({"phase": "kernels", "kernel": "stage1", "timing": timing})
    del args, kw, uq, vv
    torch.cuda.empty_cache()
    phase_layers(pool, grid, rows, n_cols, active, kernel_ms)
    del pool
    torch.cuda.empty_cache()
    return {"max_abs_err": max_err, **timing}


def phase_layers(pool, grid, rows, n_cols, active, stage1_ms) -> None:
    """Device-timeline time of each layer of the two-stage dispatch at the
    first north-star interval's shape (CUDA events around each call, so a
    layer whose many small launches leave the card idle is charged its
    launch gaps too): the encoders, stage 1, stage 2 (pairs order), the
    pairing handshake."""
    from nakama_tpu_torch.matchmaker import device2 as td2

    pool_n = {k: v[:n_cols] for k, v in pool.items()}
    act = torch.full((rows,), -1, dtype=torch.int32, device=active.device)
    act[: len(active)] = active
    rowq = {k: pool_n[k][act.clamp(min=0).long()] for k in td2.ROWQ_KEYS}
    m = td2.winners_per_block(K, n_cols // BN)

    def encode():
        return td2.stage1_inputs(
            pool_n, rowq, act, *grid, fn=24, fs=16, rev=False,
            with_embedding=False,
        )

    args = encode()
    winners = td2.stage1(fn=24, fs=16, m=m, bn=BN, emb_scale=256.0, **args)

    def stage2():
        return td2._stage2(
            pool_n, rowq, act, winners, k=K, rev=False, with_should=False,
            with_embedding=False, order_exact=False,
        )

    cand = stage2()
    layers = {
        "encoders_ms": cuda_time_ms(encode, 3),
        "stage1_ms": stage1_ms,
        "stage2_ms": cuda_time_ms(stage2, 3),
        "pair_partners_ms": cuda_time_ms(
            lambda: td2.pair_partners(cand, act, cap=131_072), 3
        ),
    }
    emit({"phase": "layers", "rows": rows, "cols": n_cols, **layers})


def phase_selfcheck() -> None:
    from nakama_tpu_torch.matchmaker.selfcheck import run_chip_selfcheck

    t0 = time.perf_counter()
    lines: list[str] = []
    results = run_chip_selfcheck(log=lines.append, device="cuda:0")
    emit({
        "phase": "selfcheck", "results": results, "log": lines,
        "seconds": round(time.perf_counter() - t0, 3),
    })


class StrictLogger:
    """Logger for the smoke run: an error logged anywhere in the
    matchmaker fails the run instead of degrading an interval quietly."""

    def with_fields(self, **_):
        return self

    def debug(self, msg, **kv):
        pass

    info = warn = warning = debug

    def error(self, msg, **kv):
        raise RuntimeError(f"matchmaker logged an error: {msg} {kv}")


def north_star_ticket(rng) -> tuple[str, dict, dict]:
    """The JAX package's north-star ticket (bench.py `build_ticket`):
    1v1, one of 8 mode terms, rank window +-100."""
    mode = int(rng.integers(0, 8))
    rank = int(rng.integers(0, 1000))
    query = (
        f"+properties.mode:m{mode} "
        f"+properties.rank:>={max(0, rank - 100)} "
        f"+properties.rank:<={rank + 100}"
    )
    return query, {"mode": f"m{mode}"}, {"rank": float(rank)}


def assembler_ticket(rng) -> tuple[str, dict, dict, np.ndarray]:
    """The JAX package's embedding config (bench.py `ticket_cfg3`): a
    16-dim unit skill embedding, wildcard query, 5v5 (min = max = 10)."""
    emb = rng.standard_normal(16).astype(np.float32)
    emb /= max(1e-6, float((emb**2).sum()) ** 0.5)
    return "*", {}, {}, emb


def refill(mm, rng, target: int, counter: list, kind: str) -> float:
    from nakama_tpu_torch.matchmaker import MatchmakerPresence

    t0 = time.perf_counter()
    while len(mm) < target:
        i = counter[0]
        counter[0] += 1
        p = MatchmakerPresence(user_id=f"u{i}", session_id=f"s{i}")
        if kind == "1v1":
            q, strs, nums = north_star_ticket(rng)
            mm.add([p], p.session_id, "", q, 2, 2, 1, strs, nums)
        else:
            q, strs, nums, emb = assembler_ticket(rng)
            mm.add([p], p.session_id, "", q, 10, 10, 1, strs, nums,
                   embedding=emb)
    return time.perf_counter() - t0


def validate(batch, size: int) -> int:
    """Every formed match: the expected size, distinct sessions, and each
    member's query accepts every other member (re-evaluated with the
    port's query evaluator). Returns the matched entries."""
    from nakama_tpu_torch.matchmaker.query import matches

    entries = 0
    for i in range(len(batch)):
        tickets = batch.tickets(i)
        sessions = [s for t in tickets for s in t.session_ids]
        if len(sessions) != size or len(set(sessions)) != size:
            raise AssertionError(f"bad match shape: {sessions}")
        for a in tickets:
            for b in tickets:
                if a is not b and not matches(a.parsed_query, b.document()):
                    raise AssertionError(
                        f"invalid match: {a.query!r} rejects {b.ticket}"
                    )
        entries += len(sessions)
    return entries


def ms_stats(samples: list[float]) -> dict:
    """Median and nearest-rank p99 (the maximum below 100 samples)."""
    ranked = sorted(samples)
    return {
        "n": len(samples),
        "median_ms": statistics.median(samples),
        "p99_ms": ranked[max(0, -(-99 * len(ranked) // 100) - 1)],
        "samples_ms": samples,
    }


def run_intervals(mm, rng, kind, size, n_sync, n_pipe):
    """Refill to N_TICKETS before every interval (the gap's work), then
    one timed process(). Returns per-interval records."""
    from nakama_tpu_torch import kernels

    counter = [0]
    records = []
    batches = []
    for step in range(n_sync + n_pipe):
        pipelined = step >= n_sync
        mm.config.interval_pipelining = pipelined
        mm.store.drain()  # idle-gap teardown of matched tickets
        fill_s = refill(mm, rng, N_TICKETS, counter, kind)
        if pipelined:
            mm.backend.wait_idle(120)  # the gap lets the last cohort finish
        # The interval's first step, timed on its own: the staged tail of
        # the refill goes to the device (process() then flushes nothing).
        t0 = time.perf_counter()
        mm.backend.pool.flush()
        torch.cuda.synchronize()
        flush_ms = (time.perf_counter() - t0) * 1e3
        before = kernels.STAGE1.launches
        t0 = time.perf_counter()
        batch = mm.process()
        if not pipelined:
            # A synchronous interval ends with its device work done; a
            # pipelined one returns with its cohort still in flight, and
            # the time its caller waits is the interval's latency.
            torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        batches.append(batch)
        records.append({
            "interval": step, "pipelined": pipelined, "process_ms": dt,
            "flush_ms": flush_ms,
            "matched_entries": batch.entry_count, "refill_s": fill_s,
            "stage1_launches": kernels.STAGE1.launches - before,
            "pool": len(mm),
        })
    mm.backend.wait_idle(120)
    tail = mm.collect_pipelined()
    if tail is not None:
        batches.append(tail)
    valid = sum(validate(b, size) for b in batches)
    return records, batches, valid


def phase_north_star(stage1_ms: float) -> int:
    from nakama_tpu_torch import kernels
    from nakama_tpu_torch.config import MatchmakerConfig
    from nakama_tpu_torch.matchmaker import LocalMatchmaker

    cfg = MatchmakerConfig(interval_pipelining=False)  # default widths
    mm = LocalMatchmaker(StrictLogger(), cfg)
    if mm.backend.device != torch.device("cuda:0"):
        raise AssertionError(f"backend on {mm.backend.device}")
    rng = np.random.default_rng(2024)
    for k in kernels.KERNELS:
        k.launches = 0
    records, batches, valid = run_intervals(mm, rng, "1v1", 2, 3, 3)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    mm.stop()
    first = records[0]["matched_entries"]
    if launches["stage1"] <= 0:
        raise AssertionError("the main path never launched the stage-1 kernel")
    if first < 0.8 * N_TICKETS:
        raise AssertionError(f"first interval matched {first} < 80% of pool")
    sync = [r["process_ms"] for r in records if not r["pipelined"]]
    pipe = [r["process_ms"] for r in records if r["pipelined"]]
    emit({
        "phase": "north_star", "tickets": N_TICKETS, "intervals": records,
        "sync_interval": ms_stats(sync), "pipelined_interval": ms_stats(pipe),
        "first_interval_matched_share": first / N_TICKETS,
        "matched_entries_validated": valid,
        "stage1_share_of_sync_interval": stage1_ms / statistics.median(sync),
        "launches": launches,
    })
    return launches["stage1"]


def phase_assembler() -> None:
    from nakama_tpu_torch import kernels
    from nakama_tpu_torch.config import MatchmakerConfig
    from nakama_tpu_torch.matchmaker import LocalMatchmaker

    cfg = MatchmakerConfig(interval_pipelining=False)
    mm = LocalMatchmaker(StrictLogger(), cfg)
    rng = np.random.default_rng(99)
    for k in kernels.KERNELS:
        k.launches = 0
    records, batches, valid = run_intervals(mm, rng, "5v5", 10, 2, 0)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    uses_assembler = not mm.backend._use_pairs()
    mm.stop()
    if launches["stage1"] <= 0 or not uses_assembler:
        raise AssertionError("assembler path did not run through stage 1")
    if records[0]["matched_entries"] <= 0:
        raise AssertionError("assembler path formed no matches")
    emit({
        "phase": "assembler", "tickets": N_TICKETS, "intervals": records,
        "interval": ms_stats([r["process_ms"] for r in records]),
        "matched_entries_validated": valid, "launches": launches,
    })


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from nakama_tpu_torch import kernels

    t_start = time.perf_counter()
    info = phase_device()
    phase_build()
    dev = torch.device("cuda:0")
    timing = phase_kernels(dev)
    phase_selfcheck()
    launches = phase_north_star(timing["kernel_ms"])
    phase_assembler()
    emit({"phase": "done", "seconds": round(time.perf_counter() - t_start, 1)})
    emit({"kernels": [{
        "name": kernels.STAGE1.name,
        "route": "cuda",
        "source": "nakama_tpu_torch/csrc/" + kernels.STAGE1.source,
        "replaces": kernels.STAGE1.replaces,
        "launches": launches,
        "max_abs_err": timing["max_abs_err"],
        "ms": timing["kernel_ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }]})
    print(info["nvidia_smi"])
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())

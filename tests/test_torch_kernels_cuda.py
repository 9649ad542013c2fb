"""The stage-1 CUDA kernels of the PyTorch/CUDA port (stage1.cu,
stage1_wgmma.cu, stage1_select.cu) against their plain version, on the
card; the leaderboard device programs (B8,
`leaderboard/cuda.py`) on cuda:0 against the same programs on the CPU,
and the `DeviceRankEngine` on the card against the host oracle.

This file imports no JAX, so it runs on a machine with a CUDA device and
PyTorch alone: `python -m pytest tests/test_torch_kernels_cuda.py`. On a
host without CUDA its card test skips. The numpy input generator here is
shared with `test_torch_stage1.py`, which holds the plain version against
the JAX package's Pallas kernel.
"""

import time

import numpy as np
import pytest
import torch

from nakama_tpu_torch.matchmaker import device2 as td2

COL_BITS = 18


def stage1_inputs(seed, n, with_emb, rev, rows=64, fn=8, fs=8, e=16, tight=0.5):
    """0/1 operands shaped like the encoders' output (one-hot values per
    field plane, interval masks per query plane, each bound of a mask
    pulled in by one value with probability `tight`) so a good share of
    pairs is eligible; jitter hashes and `e`-wide embeddings from the
    same seed. Wide layouts (64 and more fields) need a lower `tight`
    for pairs to pass every field."""
    rng = np.random.default_rng(seed)
    planes = [16] * fn + [8] * fs + [8]
    d = sum(planes)

    def values(count):
        v = np.zeros((count, d), np.float32)
        off = 0
        for w in planes:
            v[np.arange(count), off + rng.integers(0, w, count)] = 1
            off += w
        return v

    def queries(count):
        u = np.zeros((count, d), np.float32)
        off = 0
        idx = np.arange(max(planes))
        for w in planes:
            lo = (rng.random(count) < tight)[:, None].astype(np.int64)
            hi = w - 1 - (rng.random(count) < tight)[:, None]
            u[:, off : off + w] = (idx[:w] >= lo) & (idx[:w] <= hi)
            off += w
        return u

    inp = {
        "uq": queries(rows),
        "vv": values(n),
        "col_mix": rng.integers(-(2**31), 2**31, n).astype(np.int32),
        "col_gidx": np.arange(n, dtype=np.int32),
        "row_mix": rng.integers(-(2**31), 2**31, rows).astype(np.int32),
        # Rows are pool slots too, so self-exclusion bites.
        "row_slot": rng.permutation(n)[:rows].astype(np.int32),
    }
    inp["uq"][rows - 4 :] = 0  # padding rows
    if with_emb:
        inp["ue"] = (rng.standard_normal((rows, e)) * 0.5).astype(np.float32)
        inp["ve"] = (rng.standard_normal((n, e)) * 0.5).astype(np.float32)
    if rev:
        inp["uv"] = inp["vv"][inp["row_slot"]]
        inp["vq"] = queries(n)
    return inp


def torch_args(inp, device="cpu"):
    out = {}
    for key, v in inp.items():
        t = torch.from_numpy(v)
        out[key] = (t.to(torch.bfloat16) if v.dtype == np.float32 else t).to(device)
    return out


def assert_winners_match(got, want, with_emb):
    """Identical words without embeddings; with embeddings the same empty
    lanes and priorities within 1. Returns the number of differing words."""
    if not with_emb:
        np.testing.assert_array_equal(got, want)
        return 0
    none = np.int32(td2.PACKED_NONE)
    np.testing.assert_array_equal(got == none, want == none)
    live = got != none
    dprio = np.abs((got[live] >> COL_BITS) - (want[live] >> COL_BITS))
    assert dprio.max(initial=0) <= 1, dprio.max()
    return int((got != want).sum())


def _hold_on_card(launch, cases, fn=24, fs=16, k=64, e=16, tight=0.5, m=None):
    """Each (n_blocks, bn, rows) case, every flag pair, through `launch`
    against the plain version on the card, at m = `m` or k's winners per
    block (`m` may name one per flag pair: a dict by (with_emb, rev)).
    Returns the cases run."""
    runs = 0
    for n_blocks, bn, rows in cases:
        for with_emb in (False, True):
            for rev in (False, True):
                if m is None:
                    m_case = td2.winners_per_block(k, n_blocks)
                else:
                    m_case = m[with_emb, rev] if isinstance(m, dict) else m
                inp = stage1_inputs(
                    n_blocks + 2 * with_emb + rev, n_blocks * bn, with_emb,
                    rev, rows=rows, fn=fn, fs=fs, e=e, tight=tight,
                )
                args = torch_args(inp, "cuda")
                want = td2.stage1_plain(
                    fn=fn, fs=fs, m=m_case, bn=bn, emb_scale=256.0, **args
                )
                got = launch(
                    f_tot=float(fn + fs + 1), m=m_case, bn=bn, emb_scale=256.0,
                    **args
                )
                torch.cuda.synchronize()
                assert_winners_match(
                    got.cpu().numpy(), want.cpu().numpy(), with_emb
                )
                runs += 1
    return runs


@pytest.mark.cuda
def test_stage1_kernel_matches_plain_on_card():
    """The first hand-written kernel (csrc/stage1.cu) against its plain
    version on the card, in the three winners-per-block regimes and all
    four flag combinations, at the kernel's 1024-column selection block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from nakama_tpu_torch import kernels

    before = kernels.STAGE1.launches
    runs = _hold_on_card(
        kernels.stage1, [(128, 1024, 256), (112, 1024, 256), (1, 1024, 256)]
    )
    assert kernels.STAGE1.launches == before + runs == before + 12


@pytest.mark.cuda
def test_stage1_wgmma_kernel_matches_plain_on_card():
    """The Hopper kernel (csrc/stage1_wgmma.cu) against the plain version
    on the card, through the routing of device2.stage1: m = 1 and 2 at
    bn = 1024, m = 4 and 3 at bn = 256 (32 and 43 blocks) on a row count
    that is not a multiple of its row tile; the wide route: m = 5 and 8
    at bn = 1024 (26 and 16 blocks), 32-wide embeddings, D = 776
    (fn = fs = 32: the half row tile) and D = 1008 with 64-wide
    embeddings at m = 8 (fn = 48, fs = 29); m = 512 (k = 256 on one
    block: no plan of the selection kernel fits) goes to the first
    kernel. Every flag pair; launch counts of each kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from nakama_tpu_torch import kernels

    def routed(f_tot, **kw):
        fn = 24
        return td2.stage1(fn=fn, fs=int(f_tot) - fn - 1, **kw)

    before = {k.name: k.launches for k in kernels.KERNELS}
    runs = _hold_on_card(
        routed, [(128, 1024, 256), (112, 1024, 256), (32, 256, 200), (43, 256, 200)]
    )
    runs += _hold_on_card(routed, [(26, 1024, 200), (16, 1024, 256)])
    runs += _hold_on_card(routed, [(112, 1024, 256)], e=32)
    runs += _hold_on_card(routed, [(16, 1024, 200)], fn=32, fs=32, tight=0.1)
    runs += _hold_on_card(
        routed, [(16, 1024, 200)], fn=48, fs=29, e=64, tight=0.05
    )
    runs_first = _hold_on_card(routed, [(1, 1024, 256)], k=256)
    after = {k.name: k.launches for k in kernels.KERNELS}
    assert after["stage1_wgmma"] - before["stage1_wgmma"] == runs == 36
    assert after["stage1"] - before["stage1"] == runs_first == 4


@pytest.mark.cuda
def test_stage1_select_kernel_matches_plain_on_card():
    """The selection kernel (csrc/stage1_select.cu) against the plain
    version on the card, through the routing of device2.stage1, word for
    word: m = 9, 11, 16, 32 and 64 at k = 64, at bn = 256 and 1024, on row
    counts that are not a multiple of either row tile; m = 16 at D = 776
    (fn = fs = 32), and m = 64 at D = 1008 with 64-wide embeddings (one
    64-row warpgroup; under rev the row operand streams). Every flag pair; no
    launch of another kernel. The wrapper raises where no plan fits and
    on CPU tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from nakama_tpu_torch import kernels

    def routed(f_tot, **kw):
        fn = 24
        return td2.stage1(fn=fn, fs=int(f_tot) - fn - 1, **kw)

    before = {k.name: k.launches for k in kernels.KERNELS}
    runs = _hold_on_card(routed, [
        (15, 1024, 200), (12, 256, 200), (8, 1024, 256), (8, 256, 200),
        (4, 256, 200), (4, 1024, 130), (2, 1024, 200), (2, 256, 70),
    ])
    runs += _hold_on_card(routed, [(8, 1024, 200)], fn=32, fs=32, tight=0.1)
    runs += _hold_on_card(
        routed, [(2, 1024, 200)], fn=48, fs=29, e=64, tight=0.05
    )
    after = {k.name: k.launches for k in kernels.KERNELS}
    assert after["stage1_select"] - before["stage1_select"] == runs == 40
    assert after["stage1"] == before["stage1"]
    assert after["stage1_wgmma"] == before["stage1_wgmma"]
    args = torch_args(stage1_inputs(1, 2 * 1024, False, False), "cuda")
    kw = dict(f_tot=41.0, bn=1024, emb_scale=256.0)
    with pytest.raises(ValueError, match="no shared-memory plan"):
        kernels.stage1_select(m=512, **kw, **args)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.stage1_select(
            m=16, **kw, **{k: v.cpu() for k, v in args.items()}
        )


def _largest_m(d, e):
    """The largest m that stage1_select has a plan for, by flag pair."""
    from nakama_tpu_torch import kernels

    return {
        (with_emb, rev): max(
            m for m in range(1, 1025)
            if kernels.select_plan(m, d, e if with_emb else 0, rev)
        )
        for with_emb in (False, True) for rev in (False, True)
    }


@pytest.mark.cuda
def test_stage1_select_takes_the_first_kernel_s_shapes_on_card():
    """The shapes the selection kernel took over from csrc/stage1.cu,
    through the routing of device2.stage1, word for word against the
    plain version, every flag pair, on row counts that are not a multiple
    of either row tile, at bn = 256 and 1024: D = 1032, 1544 and 2056
    (rev streams the row operand past 1280); 80- and 128-wide embeddings
    (5 and 8 k16 steps) at m = 16 and 32; m = 65, 128 and the largest m with a plan at
    D = 520 (streamed). Launch counts of each kernel; the wrapper raises
    where no plan fits (m = 512, E = 144); the C side counts the plan's
    bytes as `kernels.select_layout_bytes` does, launches the plan at the
    edge of the fit and refuses one stage more (ERR_SHAPE)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from nakama_tpu_torch import kernels

    def routed_at(fn):
        def routed(f_tot, **kw):
            return td2.stage1(fn=fn, fs=int(f_tot) - fn - 1, **kw)
        return routed

    before = {k.name: k.launches for k in kernels.KERNELS}
    runs = 0
    streamed = 0
    for fn, fs in ((48, 32), (64, 64), (112, 32)):
        d = td2.encoding_dims(fn, fs)
        streamed += kernels.select_plan(4, d, 16, True).streamed
        runs += _hold_on_card(
            routed_at(fn), [(32, 1024, 200), (8, 256, 130)], fn=fn, fs=fs,
            tight=0.05,
        )
    assert streamed == 2  # rev at D = 1544 and 2056
    routed = routed_at(24)
    for e in (80, 128):  # m = 16 and 32: past stage1_wgmma without them too
        runs += _hold_on_card(routed, [(8, 1024, 200), (4, 256, 70)], e=e)
    fit = _largest_m(520, 16)
    assert all(kernels.select_plan(m, 520, 16 * w, r).streamed
               for (w, r), m in fit.items())
    for m in (65, 128, fit):
        runs += _hold_on_card(
            routed, [(1, 1024, 200), (4, 256, 130)], m=m, tight=0.1
        )
    after = {k.name: k.launches for k in kernels.KERNELS}
    assert after["stage1_select"] - before["stage1_select"] == runs == 64
    assert after["stage1"] == before["stage1"]
    assert after["stage1_wgmma"] == before["stage1_wgmma"]

    args = torch_args(stage1_inputs(1, 1024, True, False, e=16), "cuda")
    kw = dict(f_tot=41.0, bn=1024, emb_scale=256.0)
    with pytest.raises(ValueError, match="no shared-memory plan"):
        kernels.stage1_select(m=512, **kw, **args)
    wide = dict(args, ue=torch.zeros((64, 144), dtype=torch.bfloat16, device="cuda"),
                ve=torch.zeros((1024, 144), dtype=torch.bfloat16, device="cuda"))
    with pytest.raises(ValueError, match="no shared-memory plan"):
        kernels.stage1_select(m=4, **kw, **wide)
    for rev in (False, True):
        for emb in (False, True):
            for kch, ek, m in ((5, 1, 16), (9, 8, 4), (13, 5, 65), (17, 0, 209)):
                for ncw in (1,) if rev else (1, 2):
                    for stream in (False, True):
                        for st, qcap in ((2, 8), (5, 16), (8, 32)):
                            layout = (rev, emb, ncw, stream, kch, ek if emb else 0,
                                      st, m, qcap)
                            assert kernels.compiled_select_layout_bytes(
                                *layout) == kernels.select_layout_bytes(*layout)
    # At the edge of the fit (no flags, D = 520: the largest m), the plan
    # launches; a plan one ring stage deeper does not fit, and the C side
    # refuses it before any work.
    m = fit[False, False]
    plan = kernels.select_plan(m, 520, 0, False)
    assert plan.smem <= 232_448
    deeper = kernels.SelectPlan(plan.ncw, plan.stages + 1, plan.qcap,
                                plan.streamed, 0)
    assert kernels.select_layout_bytes(
        False, False, plan.ncw, plan.streamed, 5, 0, plan.stages + 1, m,
        plan.qcap) > 232_448
    args = torch_args(
        stage1_inputs(2, 1024, False, False, fn=24, fs=16, tight=0.1), "cuda"
    )
    got = kernels.stage1_select(m=m, plan=plan, **kw, **args)
    want = td2.stage1_plain(fn=24, fs=16, m=m, bn=1024, emb_scale=256.0, **args)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    n = kernels.STAGE1_SELECT.launches
    with pytest.raises(RuntimeError, match="error 100002"):
        kernels.stage1_select(m=m, plan=deeper, **kw, **args)
    assert kernels.STAGE1_SELECT.launches == n


@pytest.mark.cuda
def test_device_clock_reads_completed_events_without_a_synchronise(monkeypatch):
    """A device call on the card is timed by a pair of CUDA events; the
    telemetry plane folds its device time in only once the events have
    completed and never synchronises to get there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from nakama_tpu_torch.devobs import DEVOBS

    DEVOBS.reset()
    dev = torch.device("cuda:0")
    a = torch.randn(4096, 4096, device=dev)
    torch.cuda.synchronize()

    def no_sync(*args, **kw):
        raise AssertionError("the telemetry plane synchronised the device")

    with DEVOBS.device_call("matchmaker.score", device=dev):
        for _ in range(20):
            a = a @ a.T / 4096.0
    event = DEVOBS.timeline[-1]
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "synchronize", no_sync)
        m.setattr(torch.cuda.Event, "synchronize", no_sync)
        DEVOBS.resolve()  # the products are most likely still running
    pending = DEVOBS.stats()["pending_device_events"]
    assert (pending == 1) == (event[3] is None)
    a.sum().item()  # the test itself waits for the card
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "synchronize", no_sync)
        DEVOBS.interval_tick()
    assert DEVOBS.stats()["pending_device_events"] == 0
    assert event[3] is not None and event[3] > 0.0
    stats = {k["kernel"]: k for k in DEVOBS.kernel_stats()}["matchmaker.score"]
    assert stats["device_calls"] == 1
    DEVOBS.reset()


@pytest.mark.cuda
def test_pool_flush_does_not_wait_behind_queued_device_work(monkeypatch):
    """PoolBuffer.flush stages from pinned memory: issued while the card
    is still busy (a ~200 ms spin standing in for an in-flight cohort),
    three chunk flushes return long before the spin ends, without a
    synchronise, and the pool holds every row once the card catches up."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from nakama_tpu_torch.matchmaker.device import PoolBuffer, pool_schema

    dev = torch.device("cuda:0")
    chunk, n = 256, 768
    pool = PoolBuffer(n, 8, 8, 8, flush_chunk=chunk, device=dev)
    rows = pool_schema(n, 8, 8, 8)
    rng = np.random.default_rng(3)
    for v in rows.values():
        v[:] = rng.integers(1, 100, v.shape).astype(v.dtype)
    pool.add(0, {k: v[0] for k, v in rows.items()})
    pool.flush()  # warm the pinned-memory cache
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    cycles = int(200.0 * 10_000_000 / start.elapsed_time(end))

    def no_sync(*args, **kw):
        raise AssertionError("the flush waited for the card")

    host_ms = []
    for _ in range(2):  # the first pass also fills the pinned-memory cache
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        with monkeypatch.context() as m:
            m.setattr(torch.cuda, "synchronize", no_sync)
            m.setattr(torch.cuda.Event, "synchronize", no_sync)
            for slot in range(n):  # eager flushes at 256 and 512
                pool.add(slot, {k: v[slot] for k, v in rows.items()})
            pool.flush()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    assert host_ms[-1] < 100.0, host_ms
    for k, v in rows.items():
        np.testing.assert_array_equal(pool.tensors[k].cpu().numpy(), v, err_msg=k)


@pytest.mark.cuda
def test_server_on_the_card_launches_stage1_wgmma(tmp_path):
    """`NakamaServer` with its default backend (`CudaBackend` on cuda:0)
    over a pool above `big_pool_threshold`: two socket clients' tickets
    and 4,096 more in the pool; one interval goes through the Hopper
    stage-1 kernel (never the first one) and both clients are matched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import asyncio
    import base64
    import json

    from nakama_tpu_torch import kernels
    from nakama_tpu_torch.api import wsproto
    from nakama_tpu_torch.config import parse_args
    from nakama_tpu_torch.logger import test_logger
    from nakama_tpu_torch.matchmaker import MatchmakerPresence
    from nakama_tpu_torch.server import NakamaServer

    cfg = parse_args([
        "--socket.port", "0", "--data_dir", str(tmp_path),
        "--matchmaker.interval_sec", "100",
        "--matchmaker.interval_pipelining", "false",
        "--matchmaker.pool_capacity", "8192",
        "--matchmaker.candidates_per_ticket", "8",
        "--matchmaker.big_pool_threshold", "4096",
    ])
    basic = {"Authorization": "Basic " + base64.b64encode(b"defaultkey:").decode()}

    async def run():
        server = NakamaServer(cfg, test_logger())
        assert server.matchmaker.backend.device == torch.device("cuda:0")
        await server.start()
        try:
            sockets = []
            for i in range(2):
                r = await wsproto.request(
                    "127.0.0.1", server.port, "POST",
                    "/v2/account/authenticate/device", headers=basic,
                    body={"account": {"id": f"device-card-{i}"}},
                )
                ws = await wsproto.connect(
                    "127.0.0.1", server.port, f"/ws?token={r.json()['token']}"
                )
                await ws.send(json.dumps({"matchmaker_add": {
                    "min_count": 2, "max_count": 2,
                    "query": "+properties.mode:card",
                    "string_properties": {"mode": "card"}}}))
                while "matchmaker_ticket" not in json.loads(
                    await asyncio.wait_for(ws.recv(), 30)
                ):
                    pass
                sockets.append(ws)
            # Fillers carry no "mode", so the clients' stage-1 rows see
            # only each other as eligible.
            for i in range(4096):
                p = MatchmakerPresence(user_id=f"u{i}", session_id=f"s{i}")
                server.matchmaker.add(
                    [p], p.session_id, "", f"+properties.team:t{i % 64}",
                    2, 2, 1, {"team": f"t{i % 64}"}, {},
                )
            before = (kernels.STAGE1_WGMMA.launches, kernels.STAGE1.launches)
            server.matchmaker.process()
            torch.cuda.synchronize()
            after = (kernels.STAGE1_WGMMA.launches, kernels.STAGE1.launches)
            matched = []
            for ws in sockets:
                while True:
                    env = json.loads(await asyncio.wait_for(ws.recv(), 30))
                    if "matchmaker_matched" in env:
                        matched.append(env["matchmaker_matched"])
                        break
            return before, after, matched
        finally:
            await server.stop()

    before, after, matched = asyncio.run(run())
    assert after[0] > before[0]
    assert after[1] == before[1]
    assert len(matched) == 2
    assert matched[0]["token"] == matched[1]["token"]


def _b8_keys(rng, b, c):
    """[B, C, 3] int32 board keys: a live share with ties on (k0, k1),
    unique seqs, PAD_KEY rows, shuffled over the slots."""
    from nakama_tpu_torch.leaderboard import cuda as b8

    keys = np.full((b, c, 3), b8.PAD_KEY, dtype=np.int32)
    for i in range(b):
        live = int(rng.integers(c // 2, c + 1))
        keys[i, :live, 0] = rng.integers(-50, 50, size=live)
        keys[i, :live, 1] = rng.integers(0, 4, size=live)
        keys[i, :live, 2] = rng.permutation(live) + 1
        keys[i] = keys[i, rng.permutation(c)]
    return keys


@pytest.mark.cuda
@pytest.mark.parametrize("b,c", [(1, 8), (3, 8), (1, 1000), (3, 1000),
                                 (1, 4096), (3, 4096), (1, 1_000_000)])
def test_b8_programs_on_card_match_the_cpu(b, c):
    """Each leaderboard program on cuda:0 gives exactly its CPU result:
    the segmented sort (keys and permutation), the inverse permutation,
    batched lower-bound ranks (present keys, absent keys, PAD_KEY: the
    hand kernel csrc/lex_ranks.cu, also held against its plain version
    on the card), windows and the dirty-row scatter."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from nakama_tpu_torch import kernels
    from nakama_tpu_torch.leaderboard import cuda as b8

    dev = torch.device("cuda:0")
    rng = np.random.default_rng(c + b)
    keys = _b8_keys(rng, b, c)
    before = dict(b8.LAUNCHES), kernels.LEX_RANKS.launches
    sk_c, perm_c = b8.sort_boards(torch.from_numpy(keys))
    sk_g, perm_g = b8.sort_boards(torch.from_numpy(keys).to(dev))
    assert torch.equal(perm_g.cpu(), perm_c) and torch.equal(sk_g.cpu(), sk_c)
    assert torch.equal(b8.rank_of_slots(perm_g).cpu(), b8.rank_of_slots(perm_c))
    iters = b8.n_search_iters(c)
    for i in range(b):
        q = np.concatenate([
            keys[i, rng.integers(0, c, size=1024)],
            np.stack([rng.integers(-60, 60, 64), rng.integers(0, 5, 64),
                      rng.integers(0, c + 2, 64)], axis=1),
            np.full((2, 3), b8.PAD_KEY),
        ]).astype(np.int32)
        got = b8.lex_ranks(sk_g[i], torch.from_numpy(q).to(dev), iters)
        assert torch.equal(got.cpu(), b8.lex_ranks(sk_c[i], torch.from_numpy(q), iters))
        plain = b8.lex_ranks_plain(sk_g[i], torch.from_numpy(q).to(dev), iters)
        assert torch.equal(got, plain)
        for start, limit in ((0, min(c, 100)), (c // 2, 1), (c - 1, 1)):
            assert torch.equal(b8.window_slots(perm_g[i], start, limit).cpu(),
                               b8.window_slots(perm_c[i], start, limit))
    u = max(1, c // 8)
    idx = torch.from_numpy(rng.choice(c, size=u, replace=False))
    rows = torch.from_numpy(_b8_keys(rng, 1, u)[0])
    want = b8.scatter_keys(torch.from_numpy(keys[0].copy()), idx, rows)
    got = b8.scatter_keys(torch.from_numpy(keys[0]).to(dev), idx.to(dev), rows.to(dev))
    assert torch.equal(got.cpu(), want)
    assert kernels.LEX_RANKS.launches == before[1] + b
    assert b8.LAUNCHES["sort_boards"] == before[0]["sort_boards"] + 1


@pytest.mark.cuda
def test_rank_engine_on_the_card_matches_the_oracle():
    """`DeviceRankEngine` on cuda:0 (its default) over a 20,000-entry
    board: ranks, windows and a sweep equal the host oracle's, through
    a write/delete stream, with the breaker closed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from nakama_tpu_torch.config import LeaderboardConfig
    from nakama_tpu_torch.leaderboard import DeviceRankEngine, LeaderboardRankCache
    from nakama_tpu_torch.logger import test_logger

    rng = np.random.default_rng(2)
    oracle = LeaderboardRankCache()
    n = 20_000
    owners = [f"o{i}" for i in range(n)]
    oracle.restore_board("b", 0.0, 1, [
        (o, int(-s), 0, i + 1)
        for i, (o, s) in enumerate(zip(owners, rng.integers(0, 500, n)))])
    engine = DeviceRankEngine(
        LeaderboardConfig(device_flush_dirty_threshold=1), test_logger(),
        oracle=oracle)
    assert engine.device == torch.device("cuda:0")
    assert engine.adopt_board("b", 0.0, 1) and engine.flush_all()
    for _ in range(3):
        for j in rng.integers(0, n, 300):
            if rng.random() < 0.2:
                oracle.delete("b", 0.0, owners[j])
                engine.record_delete("b", 0.0, owners[j])
            else:
                oracle.insert("b", 0.0, 1, owners[j], int(rng.integers(0, 500)), 0)
                engine.record_upsert("b", 0.0, 1, owners[j])
        batch = [owners[j] for j in rng.integers(0, n, 1024)]
        assert engine.get_many("b", 0.0, batch) == oracle.get_many("b", 0.0, batch)
        assert engine.rank_window("b", 0.0, 100, 50) == oracle.rank_window(
            "b", 0.0, 100, 50)
    assert engine.sweep_many([("b", 0.0)])[("b", 0.0)] == oracle.standings("b", 0.0)
    # A request with 1 ms left still launches the kernel.
    from nakama_tpu_torch import kernels
    from nakama_tpu_torch.overload import Deadline, deadline_scope

    before = kernels.LEX_RANKS.launches
    with deadline_scope(Deadline(0.001)):
        assert engine.get_many("b", 0.0, batch) == oracle.get_many("b", 0.0, batch)
    assert kernels.LEX_RANKS.launches == before + 1 and engine.fallbacks == 0
    assert engine.breaker.state == "closed" and engine.breaker.failures == 0


@pytest.mark.cuda
def test_account_delete_keeps_the_card_s_ranks_the_oracle_s(tmp_path):
    """A server whose `DeviceRankEngine` holds a 5,000-record board on
    cuda:0: three players post records, one deletes its account. As in
    the JAX server, the delete removes the record in SQL and tells
    neither rank store: the listing no longer shows it, and every rank
    the card gives (owners, a window, a haystack) is the host oracle's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import asyncio
    import base64
    import sqlite3

    from nakama_tpu_torch.api import wsproto
    from nakama_tpu_torch.config import parse_args
    from nakama_tpu_torch.leaderboard import LeaderboardRankCache, Leaderboards
    from nakama_tpu_torch.logger import test_logger
    from nakama_tpu_torch.server import NakamaServer
    from nakama_tpu_torch.storage import Database

    path = str(tmp_path / "server.db")
    cfg = parse_args([
        "--socket.port", "0", "--data_dir", str(tmp_path),
        "--database.address", path, "--matchmaker.interval_sec", "100",
        "--leaderboard.device_min_board_size", "1000",
        "--leaderboard.device_flush_interval_sec", "0.05",
    ])
    basic = {"Authorization": "Basic " + base64.b64encode(b"defaultkey:").decode()}
    n = 5000
    rng = np.random.default_rng(4)

    async def seed():
        db = Database(path, read_pool_size=1)
        await db.connect()
        boards = Leaderboards(test_logger(), db, LeaderboardRankCache())
        await boards.load()
        await boards.create("card-board", sort_order="desc")
        await db.close()
        con = sqlite3.connect(path)
        con.executemany(
            "INSERT INTO leaderboard_record (leaderboard_id, owner_id, username,"
            " score, subscore, num_score, metadata, create_time, update_time,"
            " expiry_time, max_num_score) VALUES ('card-board', ?, ?, ?, 0, 1,"
            " '{}', ?, ?, 0, 0)",
            ((f"seed-{i:05d}", f"seed{i}", int(s), 1.0 + i, 1.0 + i)
             for i, s in enumerate(rng.integers(0, 300, n))))
        con.commit()
        con.close()

    async def call(server, method, url, token, body=None):
        r = await wsproto.request("127.0.0.1", server.port, method, url,
                                  headers={"Authorization": f"Bearer {token}"},
                                  body=body)
        assert r.status == 200, r.body
        return r.json()

    async def run():
        await seed()
        server = NakamaServer(cfg, test_logger())
        await server.start()
        try:
            engine, oracle = server.leaderboards.device, server.leaderboards.ranks
            assert engine.device == torch.device("cuda:0")
            players = []
            for i in range(3):
                r = await wsproto.request(
                    "127.0.0.1", server.port, "POST",
                    "/v2/account/authenticate/device", headers=basic,
                    body={"account": {"id": f"device-rank-{i}"}})
                token = r.json()["token"]
                await call(server, "POST", "/v2/leaderboard/card-board", token,
                           {"score": 150 + i})
                players.append(token)
            account = await call(server, "GET", "/v2/account", players[1])
            gone_id = account["user"]["id"]
            await call(server, "DELETE", "/v2/account", players[1])
            await asyncio.sleep(0.1)  # past the flush interval
            listing = await call(server, "GET",
                                 "/v2/leaderboard/card-board?limit=1000", players[0])
            hay = await call(server, "GET",
                             f"/v2/leaderboard/card-board/owner/{account['user']['id']}"
                             "?limit=5", players[0])
            owners = [r["owner_id"] for r in listing["records"]]
            assert gone_id not in owners
            key = ("card-board", 0.0)
            assert engine._boards.get(key) is not None  # adopted at start()
            assert [r["rank"] for r in hay["records"]] == [
                oracle.get(*key, r["owner_id"]) + 1 for r in hay["records"]]
            everyone = [f"seed-{i:05d}" for i in range(n)] + owners[:3]
            assert engine.get_many(*key, everyone) == oracle.get_many(*key, everyone)
            assert engine.rank_window(*key, 0, 200) == oracle.rank_window(*key, 0, 200)
            assert [r["rank"] for r in listing["records"]] == [
                oracle.get(*key, o) + 1 for o in owners]
            assert engine.fallbacks == 0 and engine.breaker.failures == 0
        finally:
            await server.stop()

    asyncio.run(run())


def _lex_board(rng, c, pad):
    """[C, 3] int32 keys in lexicographic order with ties in each column
    (and whole-key ties), `pad` PAD_KEY rows at the tail."""
    from nakama_tpu_torch.leaderboard import cuda as b8

    live = c - pad
    keys = np.stack([rng.integers(-20, 20, live), rng.integers(0, 3, live),
                     rng.integers(0, 4, live)], axis=1).astype(np.int32)
    keys = keys[np.lexsort((keys[:, 2], keys[:, 1], keys[:, 0]))]
    return np.concatenate([keys, np.full((pad, 3), b8.PAD_KEY, np.int32)])


@pytest.mark.cuda
@pytest.mark.parametrize("c", [0, 1, 31, 33, 2**20 + 7])
@pytest.mark.parametrize("n_q", [1, 1024])
@pytest.mark.parametrize("pad", [False, True])
def test_lex_ranks_kernel_is_exact_bisect_left_on_card(c, n_q, pad):
    """csrc/lex_ranks.cu (a warp a query, 33-ary search) against the plain
    version on the card and a numpy bisect_left, bit for bit: ties in
    every column, PAD_KEY tails, C not a multiple of the warp, C of 0
    and 1, one query and 1,024, queries present, absent, below every
    key and above every live key (PAD_KEY itself on padded boards)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from nakama_tpu_torch import kernels
    from nakama_tpu_torch.leaderboard import cuda as b8

    dev = torch.device("cuda:0")
    rng = np.random.default_rng(c + n_q + pad)
    n_pad = c // 4 if pad else 0
    keys = _lex_board(rng, c, n_pad)
    extremes = np.array([[-(2**31), -(2**31), -(2**31)], [-21, 0, 0],
                         [20, 0, 0], [19, 2, 4],
                         [b8.PAD_KEY] * 3, [b8.PAD_KEY, b8.PAD_KEY, 0]], np.int32)
    if n_q == 1:
        q = extremes[[2]]  # above every live key
    else:
        half = (n_q - len(extremes)) // 2
        present = keys[rng.integers(0, c, half)] if c else extremes[[0] * half]
        rest = n_q - len(extremes) - half
        q = np.concatenate([extremes, present, np.stack(
            [rng.integers(-22, 22, rest), rng.integers(-1, 4, rest),
             rng.integers(-1, 5, rest)], axis=1).astype(np.int32)])
    want = np.searchsorted(
        keys.view([("k0", "<i4"), ("k1", "<i4"), ("k2", "<i4")]).ravel(),
        q.view([("k0", "<i4"), ("k1", "<i4"), ("k2", "<i4")]).ravel(),
        side="left",
    ) if c else np.zeros(len(q), np.int64)
    keys_d = torch.from_numpy(keys).to(dev)
    q_d = torch.from_numpy(np.ascontiguousarray(q)).to(dev)
    iters = b8.n_search_iters(c)
    before = kernels.LEX_RANKS.launches
    got = kernels.lex_ranks(keys_d, q_d, iters)
    torch.cuda.synchronize()
    assert kernels.LEX_RANKS.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    if c:
        assert torch.equal(got, b8.lex_ranks_plain(keys_d, q_d, iters))

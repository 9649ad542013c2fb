"""Stage-1 prefilter of the PyTorch/CUDA port held against the JAX package.

The same numpy-seeded inputs go through the JAX Pallas kernel (interpret
mode on the CPU, as the JAX package's own tests run it) and through the
port's plain version `stage1_plain` — the function the CUDA kernels
(`nakama_tpu_torch/csrc/stage1_wgmma.cu`, `csrc/stage1_select.cu`,
`csrc/stage1.cu`) are held against on the card. Without embeddings the packed winners must be
identical; with embeddings a word may differ only where the float
embedding bump rounds across an integer (priority within 1), since the
two frameworks sum the E-term dot product in different orders.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nakama_tpu.matchmaker import device2 as jd2
from nakama_tpu.matchmaker.compile import CLAMP, FULL_HI, FULL_LO, MISSING
from nakama_tpu_torch import kernels
from nakama_tpu_torch.config import MatchmakerConfig
from nakama_tpu_torch.logger import test_logger as quiet_logger
from nakama_tpu_torch.matchmaker import device2 as td2
from nakama_tpu_torch.matchmaker.cuda import CudaBackend

from test_torch_kernels_cuda import (
    assert_winners_match,
    stage1_inputs,
    torch_args,
)

FN = FS = 8
K = 8  # candidates per ticket: 2k = 16 winners across all blocks
BN = 64
A = 64


def jax_stage1(inp, m, with_emb, rev, fn=FN, fs=FS):
    bf = jnp.bfloat16
    n = inp["vv"].shape[0]
    a = inp["uq"].shape[0]

    def opt(key, count):
        if key in inp:
            return jnp.asarray(inp[key], bf)
        return jnp.zeros((count, 8), bf)

    out = jd2._stage1_call(
        jnp.asarray(inp["uq"], bf),
        jnp.asarray(inp["vv"], bf),
        jnp.asarray(inp["col_mix"])[None],
        jnp.asarray(inp["col_gidx"])[None],
        jnp.asarray(inp["row_mix"])[:, None],
        jnp.asarray(inp["row_slot"])[:, None],
        opt("ue", a), opt("ve", n), opt("uv", a), opt("vq", n),
        fn=fn, fs=fs, m=m, bm=a, bn=BN, with_embedding=with_emb, rev=rev,
        emb_scale=256.0, interpret=True,
    )
    return np.asarray(out)[:, : (n // BN) * m]


# m = ceil(2k / n_blocks): 1 at 16 blocks, 2 at 8 blocks, 2k at one block;
# the Hopper kernel's wide route: m = 5 (k = 10 at 4 blocks), m = 8 (k = 8
# at 2 blocks), 32-wide embeddings, D = 776 > 640 (fn = fs = 32); the
# selection kernel's route: m = 9 (k = 9 at 2 blocks), 16 (k = 32 at 4
# blocks), 32 (k = 32 at 2 blocks), 16 at D = 776, and the shapes it took
# over from the first kernel: D = 1032 (fn = 48, fs = 32), 80- and
# 128-wide embeddings, m = 128 (k = 64 on one block).
@pytest.mark.parametrize("n_blocks,m,k,e,fn,fs,tight", [
    pytest.param(16, 1, K, 16, FN, FS, 0.5, id="16-1"),
    pytest.param(8, 2, K, 16, FN, FS, 0.5, id="8-2"),
    pytest.param(1, 2 * K, K, 16, FN, FS, 0.5, id="1-16"),
    pytest.param(4, 5, 10, 16, FN, FS, 0.5, id="4-5-k10"),
    pytest.param(2, 8, K, 16, FN, FS, 0.5, id="2-8"),
    pytest.param(8, 2, K, 32, FN, FS, 0.5, id="8-2-e32"),
    pytest.param(2, 8, K, 16, 32, 32, 0.1, id="2-8-d776"),
    pytest.param(2, 9, 9, 16, FN, FS, 0.5, id="2-9-k9"),
    pytest.param(4, 16, 32, 16, FN, FS, 0.5, id="4-16-k32"),
    pytest.param(2, 32, 32, 16, FN, FS, 0.5, id="2-32-k32"),
    pytest.param(2, 16, 16, 16, 32, 32, 0.1, id="2-16-k16-d776"),
    pytest.param(2, 4, 4, 16, 48, 32, 0.05, id="2-4-k4-d1032"),
    pytest.param(4, 16, 32, 80, FN, FS, 0.5, id="4-16-k32-e80"),
    pytest.param(8, 2, K, 128, FN, FS, 0.5, id="8-2-e128"),
    pytest.param(1, 128, 64, 16, FN, FS, 0.1, id="1-128-k64"),
])
@pytest.mark.parametrize("with_emb", [False, True])
@pytest.mark.parametrize("rev", [False, True])
def test_stage1_plain_matches_pallas(n_blocks, m, k, e, fn, fs, tight, with_emb, rev):
    assert td2.winners_per_block(k, n_blocks) == m
    n = n_blocks * BN
    inp = stage1_inputs(
        n_blocks * 4 + with_emb * 2 + rev, n, with_emb, rev, fn=fn, fs=fs, e=e,
        tight=tight,
    )
    want = jax_stage1(inp, m, with_emb, rev, fn=fn, fs=fs)
    got = td2.stage1_plain(
        fn=fn, fs=fs, m=m, bn=BN, emb_scale=256.0, **torch_args(inp)
    ).numpy()
    assert got.shape == want.shape
    assert (got != jd2.PACKED_NONE).any()  # eligibility really occurred
    assert_winners_match(got, want, with_emb)


def test_stage1_wrapper_takes_plain_version_for_cpu_tensors():
    inp = stage1_inputs(3, 8 * BN, True, True)
    before = [k.launches for k in kernels.KERNELS]
    kw = dict(fn=FN, fs=FS, m=2, bn=BN, emb_scale=256.0, **torch_args(inp))
    got = td2.stage1(**kw)
    torch.testing.assert_close(got, td2.stage1_plain(**kw), rtol=0, atol=0)
    assert [k.launches for k in kernels.KERNELS] == before  # none launched
    for launch in (kernels.stage1, kernels.stage1_wgmma, kernels.stage1_select):
        with pytest.raises(ValueError):
            launch(
                **{k: v for k, v in kw.items() if k not in ("fn", "fs")},
                f_tot=float(FN + FS + 1),
            )


@pytest.mark.parametrize("d", [200, 520, 528])
def test_int8_operand_is_exact_zero_padded_and_aligned(d):
    rng = np.random.default_rng(d)
    x = torch.from_numpy((rng.random((37, d)) < 0.3).astype(np.float32))
    x = x.to(torch.bfloat16)
    width = -(-d // 16) * 16
    y = kernels.int8_operand(x, width)
    assert y.dtype == torch.int8 and tuple(y.shape) == (37, width)
    assert y.is_contiguous() and (width % 16, y.data_ptr() % 16) == (0, 0)
    np.testing.assert_array_equal(y[:, :d].numpy(), x.float().numpy())
    assert not y[:, d:].any()


@pytest.mark.parametrize("with_emb", [False, True])
@pytest.mark.parametrize("rev", [False, True])
def test_stage1_plain_on_int8_operands_gives_identical_words(with_emb, rev):
    """The operands exactly as the Hopper kernel receives them (int8,
    zero-padded to 16 columns; embeddings padded to 16) give the same
    words as the encoders' bf16 operands."""
    inp = stage1_inputs(11 + rev + 2 * with_emb, 4 * BN, with_emb, rev)
    args = torch_args(inp)
    kw = dict(fn=FN, fs=FS, m=3, bn=BN, emb_scale=256.0)
    want = td2.stage1_plain(**kw, **args)
    width = -(-args["uq"].shape[1] // 16) * 16
    prepared = dict(args)
    for key in ("uq", "vv", "uv", "vq"):
        if key in args:
            prepared[key] = kernels.int8_operand(args[key], width)
    if with_emb:
        for key in ("ue", "ve"):
            pad = torch.zeros((args[key].shape[0], 16), dtype=torch.bfloat16)
            pad[:, : args[key].shape[1]] = args[key]
            prepared[key] = pad
    got = td2.stage1_plain(**kw, **prepared)
    assert (want != td2.PACKED_NONE).any()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_stage1_routes_m_up_to_4_to_the_hopper_kernel(monkeypatch):
    """The rule by plans: m <= 8, D <= 1024 and E <= 64 → stage1_wgmma.cu;
    else wherever `kernels.select_plan` finds a layout → stage1_select.cu;
    else stage1.cu. And that device2.stage1 launches what it names for a
    tensor off the CPU (meta tensors: nothing runs)."""
    flags = [(e, rev) for e in (0, 16) for rev in (False, True)]
    for m in range(1, 9):
        for e, rev in flags + [(64, False), (64, True)]:
            for d in (200, 520, 1024):
                assert td2.stage1_route(m, d, e, rev) is kernels.STAGE1_WGMMA
    # wide_fields' shape (48 numeric, 32 string fields: D = 1032, k = 64 at
    # 32 blocks: m = 4) goes to the selection kernel, row operand resident,
    # under every flag pair.
    d1032 = td2.encoding_dims(48, 32)
    assert (d1032, td2.winners_per_block(64, 32)) == (1032, 4)
    for e, rev in flags:
        assert td2.stage1_route(4, d1032, e, rev) is kernels.STAGE1_SELECT
        assert not kernels.select_plan(4, d1032, e, rev).streamed
    assert kernels.select_plan(4, d1032, 0, False) == kernels.SelectPlan(
        ncw=2, stages=5, qcap=16, streamed=False, smem=228_960
    )
    # Rev at D = 1544 and 2056 streams the row operand; without rev it
    # stays resident (beside a ring of 3 stages) to D = 2944.
    for d in (1544, 2056):
        assert kernels.select_plan(4, d, 0, True).streamed
        assert not kernels.select_plan(4, d, 0, False).streamed
    assert not kernels.select_plan(4, 2944, 0, False).streamed
    assert kernels.select_plan(4, 2945, 0, False).streamed
    # E <= 128 for every D and m up to the planned fit; E = 144 and m = 512
    # (k = 256 on one block) have no plan and stay on stage1.cu.
    fit = {}
    for e in (0, 16, 64, 80, 128):
        for rev in (False, True):
            fit[e, rev] = max(
                m for m in range(1, 1025) if kernels.select_plan(m, 520, e, rev)
            )
            for d in (9, 520, 1032, 1544, 2056, 4104, 65_536):
                for m in (9, 16, 65, 128, fit[e, rev]):
                    want = (kernels.STAGE1_WGMMA if m <= 8 and d <= 1024
                            and e <= 64 else kernels.STAGE1_SELECT)
                    assert td2.stage1_route(m, d, e, rev) is want, (m, d, e, rev)
                # Past D = 256 the streamed layout is the smaller, so the
                # fit no longer depends on D; one chunk leaves room for more.
                beyond = td2.stage1_route(fit[e, rev] + 1, d, e, rev)
                assert beyond is (kernels.STAGE1 if d >= 520 else
                                  kernels.STAGE1_SELECT), (d, e, rev)
            assert td2.stage1_route(4, 520, e + 144, rev) is kernels.STAGE1
    assert fit[0, False] == 369 and fit[128, True] == 209
    assert min(fit.values()) > 128
    for e, rev in flags:
        assert td2.stage1_route(512, 520, e, rev) is kernels.STAGE1
        assert td2.stage1_route(td2.winners_per_block(256, 1), 520, e, rev) is (
            kernels.STAGE1
        )
    # Main path at the default widths: >= 32 selection blocks of 1024;
    # k = 128 there gives m = 8, still the wgmma kernel; k = 256 gives
    # m = 16 at 32 blocks and m = 9 at 63, the selection kernel.
    cfg = MatchmakerConfig()
    blocks = cfg.big_pool_threshold // 1024
    assert td2.winners_per_block(64, blocks) == 4
    assert td2.winners_per_block(128, blocks) == 8
    assert td2.winners_per_block(256, blocks) == 16
    assert td2.winners_per_block(256, 63) == 9
    for k, route in ((64, kernels.STAGE1_WGMMA), (128, kernels.STAGE1_WGMMA),
                     (256, kernels.STAGE1_SELECT)):
        assert td2.stage1_route(
            td2.winners_per_block(k, blocks), td2.encoding_dims(24, 16), 16
        ) is route
    # The self-check's two-stage pools (4 blocks of 256 at k = 64).
    assert td2.winners_per_block(64, 4) == 32
    assert td2.stage1_route(td2.winners_per_block(64, 4), 200) is (
        kernels.STAGE1_SELECT
    )

    called = []
    for name in ("stage1", "stage1_wgmma", "stage1_select"):
        monkeypatch.setattr(
            kernels, name, lambda *a, name=name, **k: called.append(name)
        )
    inp = torch_args(stage1_inputs(2, 4 * BN, False, False))
    meta = {k: torch.empty_like(v, device="meta") for k, v in inp.items()}
    for m in (2, 4, 5, 8, 9, 32, 64, 65, 369, 370):
        td2.stage1(fn=FN, fs=FS, m=m, bn=BN, emb_scale=256.0, **meta)
    assert called == (
        ["stage1_wgmma"] * 4 + ["stage1_select"] * 5 + ["stage1"]
    )
    inp = torch_args(stage1_inputs(3, 4 * BN, True, True, e=128))
    meta = {k: torch.empty_like(v, device="meta") for k, v in inp.items()}
    for m in (8, 209, 210):  # E = 128 under rev: the narrowest fit
        td2.stage1(fn=FN, fs=FS, m=m, bn=BN, emb_scale=256.0, **meta)
    assert called[-3:] == ["stage1_select", "stage1_select", "stage1"]
    inp = torch_args(stage1_inputs(3, 4 * BN, True, False, fn=48, fs=32, e=64))
    meta = {k: torch.empty_like(v, device="meta") for k, v in inp.items()}
    td2.stage1(fn=48, fs=32, m=4, bn=BN, emb_scale=256.0, **meta)
    assert called[-1] == "stage1_select"


def _sel_layout_total(rev, emb, ncw, stream, kch, ek, n_stages, m, qcap):
    """csrc/stage1_select.cu's `sel_layout(...).total`, line for line."""
    def round_up(x, to):
        return (x + to - 1) // to * to

    bm = ncw * 64
    a_chunk = bm * 128
    a_ops = 2 if rev else 1
    ue = 0 if stream else kch * a_chunk * a_ops
    stages = round_up(ue + (ek * bm * 16 * 2 if emb else 0), 1024)
    sa = 64 * 128 * a_ops
    ve = sa + (a_chunk * a_ops if stream else 0)
    stage_bytes = round_up(ve + (ek * 64 * 16 * 2 if emb else 0), 1024)
    queues = stages + n_stages * stage_bytes
    bars = round_up(queues + bm * ((2 * m + 4 * (qcap + 1)) | 1) * 4, 8)
    return bars + (2 * n_stages + 2) * 8 + 1024


def test_select_plan_bytes_follow_the_kernel_layout():
    """The plan's byte count equals stage1_select.cu's layout arithmetic
    on a grid of shapes and plans, and `select_plans` lists every plan
    that fits, and `select_plan` takes the first, in the search order (rings of 3+ stages before 2; resident before
    streamed; two consumer warpgroups, without rev and 3+ stages only,
    before one; longer queues, then more stages)."""
    smem = 232_448
    for rev in (False, True):
        for e in (0, 16, 64, 80, 128):
            ek = -(-e // 16)
            for d in (200, 520, 1032, 1544, 2056, 3080):
                kch = -(-d // 128)
                for m in (1, 4, 16, 64, 65, 128, 209, 257, 369):
                    for ncw in (1,) if rev else (1, 2):
                        for stream in (False, True):
                            for st, qcap in ((2, 8), (5, 16), (8, 32)):
                                want = _sel_layout_total(
                                    rev, e > 0, ncw, stream, kch, ek, st, m, qcap
                                )
                                assert kernels.select_layout_bytes(
                                    rev, e > 0, ncw, stream, kch, ek, st, m, qcap
                                ) == want
                    plan = kernels.select_plan(m, d, e, rev)
                    order = [
                        (stream, ncw, qcap, st)
                        for stages in (range(8, 2, -1), [2])
                        for stream in (False, True)
                        for ncw in ((1,) if rev or stages == [2] else (2, 1))
                        for qcap in (32, 16, 8)
                        for st in stages
                    ]
                    fits = [
                        o for o in order
                        if _sel_layout_total(rev, e > 0, o[1], o[0], kch, ek,
                                             o[3], m, o[2]) <= smem
                    ]
                    assert [
                        (p.streamed, p.ncw, p.qcap, p.stages)
                        for p in kernels.select_plans(m, d, e, rev)
                    ] == fits, (m, d, e, rev)
                    if not fits:
                        assert plan is None, (m, d, e, rev)
                        continue
                    stream, ncw, qcap, st = fits[0]
                    assert plan == kernels.SelectPlan(
                        ncw, st, qcap, stream,
                        _sel_layout_total(rev, e > 0, ncw, stream, kch, ek,
                                          st, m, qcap),
                    ), (m, d, e, rev)
    # Limits outside shared memory: E > 128, m < 1, and the bounds that
    # keep the C side's int arithmetic exact.
    assert kernels.select_plan(4, 520, 144, False) is None
    assert kernels.select_plan(0, 520, 0, False) is None
    assert kernels.select_plan(4, 4096 * 128 + 1, 0, False) is None
    assert kernels.select_plan(4, 4096 * 128, 0, False).streamed


def test_mix_matches_jax_int32_wraparound():
    x = np.array([0, 1, 7919, 2**31 - 1, -(2**31), -5, 123456789], np.int32)
    want = np.asarray(jd2._mix(jnp.asarray(x)))
    got = td2._mix(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def _edge_pool(rng, n, fn, fs):
    """Pool columns with the encoders' edge values: the full-range query
    bounds, the missing sentinel, the clamp, and empty forbidden ranges."""
    num = rng.uniform(-50, 150, (n, fn)).astype(np.float32)
    num[::5, 2] = MISSING
    num[1::7, 3] = CLAMP
    num[2::7, 4] = -CLAMP
    n_lo = np.full((n, fn), FULL_LO, np.float32)
    n_hi = np.full((n, fn), FULL_HI, np.float32)
    n_lo[:, 5] = rng.uniform(-60, 60, n)
    n_hi[:, 5] = n_lo[:, 5] + rng.uniform(0, 100, n)
    n_lo[::3, 6] = -CLAMP
    n_hi[::4, 6] = CLAMP
    n_flo = np.ones((n, fn), np.float32)
    n_fhi = np.full((n, fn), -1.0, np.float32)
    n_flo[::2, 7] = 10.0
    n_fhi[::2, 7] = 90.0
    s_req = np.where(rng.random((n, fs)) < 0.3, rng.integers(1, 99, (n, fs)), 0)
    return {
        "num": num,
        "str": rng.integers(0, 2**31 - 1, (n, fs)).astype(np.int32),
        "pool_id": rng.integers(0, 20, n).astype(np.int32),
        "flags": rng.choice([0, 1, 9], n).astype(np.int32),
        "n_lo": n_lo,
        "n_hi": n_hi,
        "n_flo": n_flo,
        "n_fhi": n_fhi,
        "s_req": s_req.astype(np.int32),
        "min_count": rng.integers(1, 4, n).astype(np.int32),
        "max_count": rng.integers(2, 8, n).astype(np.int32),
    }


@pytest.mark.parametrize("with_counts", [True, False])
def test_encoders_match_jax_at_edge_values(with_counts):
    rng = np.random.default_rng(5)
    n = 96
    pool = _edge_pool(rng, n, FN, FS)
    grid_lo = rng.uniform(-60, 0, FN).astype(np.float32)
    grid_inv = (1.0 / rng.uniform(1, 200, FN)).astype(np.float32)
    grid_inv[0] = np.float32(1e30)  # a degenerate (zero-width) field
    jp = {k: jnp.asarray(v) for k, v in pool.items()}
    tp = {k: torch.from_numpy(v) for k, v in pool.items()}
    jg = (jnp.asarray(grid_lo), jnp.asarray(grid_inv))
    tg = (torch.from_numpy(grid_lo), torch.from_numpy(grid_inv))

    np.testing.assert_array_equal(
        td2._bucket_of(tp["num"], *tg).numpy(),
        np.asarray(jd2._bucket_of(jp["num"], *jg)),
    )
    np.testing.assert_array_equal(
        td2._value_vectors(tp, n, FN, FS, *tg).float().numpy(),
        np.asarray(jd2._value_vectors(jp, n, FN, FS, *jg), np.float32),
    )
    np.testing.assert_array_equal(
        td2._query_vectors(tp, FN, FS, *tg, with_counts=with_counts)
        .float().numpy(),
        np.asarray(
            jd2._query_vectors(jp, FN, FS, *jg, with_counts=with_counts),
            np.float32,
        ),
    )


def test_cuda_backend_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = MatchmakerConfig(pool_capacity=256, numeric_fields=8, string_fields=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        CudaBackend(cfg, quiet_logger())
    assert CudaBackend(cfg, quiet_logger(), device="cpu").device.type == "cpu"

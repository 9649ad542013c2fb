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
# selection kernel's route (8 < m <= 64): m = 9 (k = 9 at 2 blocks), 16
# (k = 32 at 4 blocks), 32 (k = 32 at 2 blocks), and 16 at D = 776.
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
    """The rule (D <= 1024 and E <= 64: m <= 8 → stage1_wgmma.cu,
    8 < m <= 64 → stage1_select.cu; else stage1.cu), and that
    device2.stage1 launches what it names for a tensor off the CPU (meta
    tensors: nothing runs)."""
    limit = kernels.SELECT_MAX_M
    assert limit >= 64
    for m in range(1, 9):
        assert td2.stage1_route(m, 520, 16) is kernels.STAGE1_WGMMA
        assert td2.stage1_route(m, 520) is kernels.STAGE1_WGMMA
        assert td2.stage1_route(m, 1024, 64) is kernels.STAGE1_WGMMA
    for m in (9, 11, 16, 32, limit):
        assert td2.stage1_route(m, 520, 16) is kernels.STAGE1_SELECT
        assert td2.stage1_route(m, 520) is kernels.STAGE1_SELECT
        assert td2.stage1_route(m, 1024, 64) is kernels.STAGE1_SELECT
    for m in (limit + 1, 128):
        assert td2.stage1_route(m, 520, 16) is kernels.STAGE1
    assert td2.stage1_route(2, td2.encoding_dims(32, 32), 32) is (
        kernels.STAGE1_WGMMA
    )
    assert td2.stage1_route(8, td2.encoding_dims(48, 29), 64) is (
        kernels.STAGE1_WGMMA
    )
    assert td2.stage1_route(16, td2.encoding_dims(48, 29), 64) is (
        kernels.STAGE1_SELECT
    )
    for m in (2, 16):
        assert td2.stage1_route(m, 1025) is kernels.STAGE1
        assert td2.stage1_route(m, td2.encoding_dims(48, 32)) is kernels.STAGE1
        assert td2.stage1_route(m, 520, 80) is kernels.STAGE1
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
    for m in (2, 4, 5, 8, 9, 32, limit, limit + 1):
        td2.stage1(fn=FN, fs=FS, m=m, bn=BN, emb_scale=256.0, **meta)
    assert called == (
        ["stage1_wgmma"] * 4 + ["stage1_select"] * 3 + ["stage1"]
    )
    inp = torch_args(stage1_inputs(3, 4 * BN, True, False, e=64))
    meta = {k: torch.empty_like(v, device="meta") for k, v in inp.items()}
    td2.stage1(fn=FN, fs=FS, m=8, bn=BN, emb_scale=256.0, **meta)
    td2.stage1(fn=FN, fs=FS, m=16, bn=BN, emb_scale=256.0, **meta)
    assert called[-2:] == ["stage1_wgmma", "stage1_select"]


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

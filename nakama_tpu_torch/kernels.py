"""Hand-written CUDA kernels of the port: build, bind and launch.

Each kernel source in `csrc/` is compiled by `nvcc` for `sm_90a` into a
shared library with a plain C interface, on first use, into
`build/kernels/` at the repository root, and bound with ctypes (pointers
and the stream as `c_void_p`). The library name carries a hash of the
source, so an edited source builds anew and concurrent builds never
write the same file. Nothing is compiled or loaded at import: this module
imports on hosts without CUDA, where the callers take the plain PyTorch
versions for CPU tensors.

Every wrapper checks device, dtype, shape and contiguity, allocates its
outputs with `torch.empty`, launches on PyTorch's current stream, raises
if the launch reports an error, and adds one to its kernel's `launches`
count — there and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass

import torch

from .devobs import DEVOBS

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "build", "kernels",
)
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]


@dataclass
class Kernel:
    name: str
    source: str  # file under csrc/
    replaces: str  # the TPU kernel it ports, file:line
    launches: int = 0
    lib: ctypes.CDLL | None = None
    build_log: str = ""


# B1's first kernel (WMMA bf16): since the Hopper kernels took every
# shape with a plan, only the shapes without one (select_plan).
STAGE1 = Kernel(
    name="stage1",
    source="stage1.cu",
    replaces="nakama_tpu/matchmaker/device2.py:302",
)
# B1 at m <= 8, D <= 1024, E <= 64 (the main path): int8 wgmma from a TMA
# ring, a running top-8 in registers.
STAGE1_WGMMA = Kernel(
    name="stage1_wgmma",
    source="stage1_wgmma.cu",
    replaces="nakama_tpu/matchmaker/device2.py:302",
)
# B1's other shapes, wherever select_plan finds a shared-memory layout:
# the Hopper mainloop of stage1_wgmma.cu with a threshold-and-queue
# selection as its epilogue.
STAGE1_SELECT = Kernel(
    name="stage1_select",
    source="stage1_select.cu",
    replaces="nakama_tpu/matchmaker/device2.py:302",
)
# B8's batched rank search: a jax.jit program in the JAX package (not a
# Pallas kernel), given a hand kernel because its plain version is
# launch-bound (PERF.md).
LEX_RANKS = Kernel(
    name="lex_ranks",
    source="lex_ranks.cu",
    replaces="nakama_tpu/leaderboard/tpu.py:67",
)
KERNELS = [STAGE1, STAGE1_WGMMA, STAGE1_SELECT, LEX_RANKS]
# What stage1_wgmma.cu takes: winners per block (a running top-8),
# operand width (8 128-byte chunks; above 5 the row tile halves), and
# embedding width (4 bf16 k16 steps).
WGMMA_MAX_M = 8
WGMMA_MAX_D = 1024
WGMMA_MAX_E = 64
# What stage1_select.cu takes: embeddings of up to 8 bf16 k16 steps, and
# any m and D for which select_plan finds a layout.
SELECT_MAX_E = 128
_lock = threading.Lock()

# stage1_select.cu's shared-memory arithmetic (sel_layout, plan_fits).
_SMEM_MAX = 232_448  # dynamic shared memory a block may use
_KC = 128  # K chunk of the 0/1 operands, int8 columns
_EC = 16  # embedding chunk, bf16 columns
_TN = 64  # columns per product tile
_SELECT_MAX_STAGES = 8
# Bounds that keep the C side's layout arithmetic inside int.
_SELECT_M_MAX = 1024
_SELECT_KCH_MAX = 4096


@dataclass(frozen=True)
class SelectPlan:
    """How stage1_select.cu lays out one shape in shared memory."""

    ncw: int  # consumer warpgroups: 64 rows each
    stages: int  # ring stages
    qcap: int  # queue words a thread holds for a row
    streamed: bool  # the row operand comes through the ring, not resident
    smem: int  # bytes of dynamic shared memory


def _round_up(x: int, to: int) -> int:
    return -(-x // to) * to


def select_layout_bytes(
    rev: bool, emb: bool, ncw: int, streamed: bool, kch: int, ek: int,
    stages: int, m: int, qcap: int,
) -> int:
    """Shared memory of one stage1_select.cu layout, as its `sel_layout`
    counts it: the resident row operands (none when streamed) and
    embedding rows, the ring's stages (column chunks, the row chunks when
    streamed, the embedding chunks), each row's kept lists and queues, the
    mbarriers, and 1,024 bytes to align the base."""
    bm = 64 * ncw
    a_chunk = bm * _KC
    a_ops = 2 if rev else 1
    resident = 0 if streamed else kch * a_chunk * a_ops
    stages_at = _round_up(resident + (ek * bm * _EC * 2 if emb else 0), 1024)
    ve = _TN * _KC * a_ops + (a_chunk * a_ops if streamed else 0)
    stage_bytes = _round_up(ve + (ek * _TN * _EC * 2 if emb else 0), 1024)
    queues = stages_at + stages * stage_bytes
    row_words = (2 * m + 4 * (qcap + 1)) | 1
    bars = _round_up(queues + bm * row_words * 4, 8)
    return bars + (2 * stages + 2) * 8 + 1024


def select_plans(m: int, d: int, e: int, rev: bool):
    """Every layout of stage1_select.cu that fits m winners a block,
    operand width d, embedding width e (0 without) and rev, best first: a
    ring of at least 3 stages, with the row operand resident, then
    streamed; a 2-stage ring only after those (it left the consumers
    waiting: profile_stage1.py plans, PERF.md). Within each, two consumer
    warpgroups (without rev, 3+ stages) before one, the longest queues
    (32, 16, 8 words) before more stages."""
    if not (1 <= m <= _SELECT_M_MAX and 1 <= d <= _SELECT_KCH_MAX * _KC
            and 0 <= e <= SELECT_MAX_E):
        return
    kch, ek = -(-d // _KC), -(-e // _EC)
    for least, most in ((3, _SELECT_MAX_STAGES), (2, 2)):
        for streamed in (False, True):
            for ncw in (1,) if rev or least < 3 else (2, 1):
                for qcap in (32, 16, 8):
                    for stages in range(most, least - 1, -1):
                        smem = select_layout_bytes(
                            rev, e > 0, ncw, streamed, kch, ek, stages, m, qcap
                        )
                        if smem <= _SMEM_MAX:
                            yield SelectPlan(ncw, stages, qcap, streamed, smem)


@functools.lru_cache(maxsize=None)
def select_plan(m: int, d: int, e: int, rev: bool) -> SelectPlan | None:
    """The layout stage1_select.cu takes for this shape (the first of
    `select_plans`), or None where none fits."""
    return next(select_plans(m, d, e, rev), None)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def library_path(kernel: Kernel, defines: tuple[str, ...] = ()) -> str:
    """The library of `kernel`, named by a hash of its source, the shared
    headers of csrc/ and `defines`."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
    for name in [kernel.source, *headers]:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    h.update(repr(defines).encode())
    digest = h.hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{kernel.name}-{digest}.so")


def build(kernel: Kernel, defines: tuple[str, ...] = ()) -> str:
    """Compile `kernel` (with `-D` for each of `defines`, for measurement
    builds) unless this version of its source is built; returns the
    library path. `kernel.build_log` keeps ptxas's report (registers,
    shared memory, spills)."""
    path = library_path(kernel, defines)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [
        _nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v", *(f"-D{d}" for d in defines),
        "-o", tmp, os.path.join(_CSRC, kernel.source),
    ]
    t0 = time.perf_counter()
    try:
        done = subprocess.run(cmd, capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {kernel.source}:\n{done.stderr}"
            )
        kernel.build_log = done.stderr
        os.replace(tmp, path)
        # Build-watch: a build after warmup on the hot path is counted
        # as an unexpected recompile (devobs.py).
        DEVOBS.on_compile(time.perf_counter() - t0, kernel=kernel.name)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _load(kernel: Kernel) -> ctypes.CDLL:
    with _lock:
        if kernel.lib is None:
            kernel.lib = load_library(kernel)
        return kernel.lib


def load_library(kernel: Kernel, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (if needed) and bind one library of `kernel`. A wrapper
    launches whatever `kernel.lib` holds, so a measurement build can be
    swapped in there."""
    lib = ctypes.CDLL(build(kernel, defines))
    _bind(kernel, lib)
    return lib


def _bind(kernel: Kernel, lib: ctypes.CDLL) -> None:
    if kernel is STAGE1:
        f = lib.stage1_launch
        f.restype = ctypes.c_int
        f.argtypes = (
            [ctypes.c_void_p] * 11
            + [ctypes.c_int] * 6
            + [ctypes.c_float] * 2
            + [ctypes.c_int] * 2
            + [ctypes.c_void_p]
        )
    elif kernel is STAGE1_WGMMA or kernel is STAGE1_SELECT:
        select = kernel is STAGE1_SELECT
        f = getattr(lib, f"{kernel.name}_launch")
        f.restype = ctypes.c_int
        f.argtypes = (
            # stage1_select_launch takes the int8 scratch of the four 0/1
            # operands beside them, and its plan.
            [ctypes.c_void_p] * (15 if select else 11)
            + [ctypes.c_int] * 8
            + [ctypes.c_float]
            + [ctypes.c_int] * (6 if select else 2)
            + [ctypes.c_void_p]
        )
        if select:
            g = lib.stage1_select_layout_bytes
            g.restype = ctypes.c_int
            g.argtypes = [ctypes.c_int] * 9
    elif kernel is LEX_RANKS:
        f = lib.lex_ranks_launch
        f.restype = ctypes.c_int
        f.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]


def _check(x: torch.Tensor, name: str, dtype, device, shape) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _padded(x: torch.Tensor, width: int) -> torch.Tensor:
    """`x` with its columns zero-padded to `width` and rows 32-byte
    aligned, as the kernel's fragment loads need."""
    if x.shape[1] == width and x.data_ptr() % 32 == 0:
        return x
    out = torch.zeros((x.shape[0], width), dtype=x.dtype, device=x.device)
    out[:, : x.shape[1]] = x
    return out


def _round16(d: int) -> int:
    return -(-d // 16) * 16


def _check_stage1(uq, vv, col_mix, col_gidx, row_mix, row_slot, ue, ve, uv, vq):
    """Checks the stage-1 arguments shared by the three kernels; returns
    (a_pad, n, d, rev, with_emb)."""
    dev = uq.device
    if dev.type != "cuda":
        raise ValueError(f"stage1 kernel needs CUDA tensors, got {dev}")
    a_pad, d = uq.shape
    n = vv.shape[0]
    bf16, i32 = torch.bfloat16, torch.int32
    _check(uq, "uq", bf16, dev, (a_pad, d))
    _check(vv, "vv", bf16, dev, (n, d))
    _check(col_mix, "col_mix", i32, dev, (n,))
    _check(col_gidx, "col_gidx", i32, dev, (n,))
    _check(row_mix, "row_mix", i32, dev, (a_pad,))
    _check(row_slot, "row_slot", i32, dev, (a_pad,))
    rev = uv is not None
    with_emb = ue is not None
    if rev != (vq is not None) or with_emb != (ve is not None):
        raise ValueError("uv/vq and ue/ve come in pairs")
    if rev:
        _check(uv, "uv", bf16, dev, (a_pad, d))
        _check(vq, "vq", bf16, dev, (n, d))
    if with_emb:
        e = ue.shape[1]
        _check(ue, "ue", bf16, dev, (a_pad, e))
        _check(ve, "ve", bf16, dev, (n, e))
    return a_pad, n, d, rev, with_emb


def stage1(
    uq, vv, col_mix, col_gidx, row_mix, row_slot, *,
    f_tot: float, m: int, bn: int, emb_scale: float,
    ue=None, ve=None, uv=None, vq=None,
) -> torch.Tensor:
    """Launch the first stage-1 kernel (csrc/stage1.cu) on CUDA tensors.

    uq bf16 [A, D], vv bf16 [n, D]; col_mix/col_gidx i32 [n];
    row_mix/row_slot i32 [A]; ue bf16 [A, E] with ve bf16 [n, E] when
    embeddings score; uv bf16 [A, D] with vq bf16 [n, D] under mutual
    matching. Returns i32 [A, (n // bn) * m]: per bn-column block, each
    row's top-m packed words, descending, INT32_MIN-filled."""
    a_pad, n, d, rev, with_emb = _check_stage1(
        uq, vv, col_mix, col_gidx, row_mix, row_slot, ue, ve, uv, vq
    )
    dev, i32 = uq.device, torch.int32
    if bn % 128 or bn > 1024 or n % bn or a_pad % 32 or m < 1:
        raise ValueError(
            f"stage1 kernel needs bn % 128 == 0, bn <= 1024, n % bn == 0, "
            f"a_pad % 32 == 0, m >= 1 (bn={bn}, n={n}, a_pad={a_pad}, m={m})"
        )
    n_blocks = n // bn
    out = torch.empty((a_pad, n_blocks * m), dtype=i32, device=dev)
    if a_pad == 0:
        return out
    dp = _round16(d)
    ops = {"uq": _padded(uq, dp), "vv": _padded(vv, dp)}
    if rev:
        ops["uv"], ops["vq"] = _padded(uv, dp), _padded(vq, dp)
    de = 16
    if with_emb:
        de = _round16(ue.shape[1])
        ops["ue"], ops["ve"] = _padded(ue, de), _padded(ve, de)

    def ptr(name):
        t = ops.get(name)
        return None if t is None else t.data_ptr()

    lib = _load(STAGE1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.stage1_launch(
            ptr("uq"), ptr("vv"), ptr("uv"), ptr("vq"), ptr("ue"), ptr("ve"),
            col_mix.data_ptr(), col_gidx.data_ptr(), row_mix.data_ptr(),
            row_slot.data_ptr(), out.data_ptr(),
            a_pad, n, dp, de, bn, m, f_tot - 0.5, emb_scale,
            int(rev), int(with_emb), stream,
        )
    if rc != 0:
        raise RuntimeError(f"stage1 kernel launch failed: CUDA error {rc}")
    STAGE1.launches += 1
    return out


def int8_operand(x: torch.Tensor, width: int) -> torch.Tensor:
    """A 0/1 operand as int8 [rows, width], zero past its own columns, in
    one pass (rows start 16-byte aligned when `width` % 16 == 0, as TMA
    needs). Exact: every value is 0 or 1."""
    out = torch.empty((x.shape[0], width), dtype=torch.int8, device=x.device)
    out[:, : x.shape[1]].copy_(x)
    out[:, x.shape[1]:].zero_()
    return out


def compiled_select_layout_bytes(
    rev: bool, emb: bool, ncw: int, streamed: bool, kch: int, ek: int,
    stages: int, m: int, qcap: int,
) -> int:
    """`select_layout_bytes` as the built stage1_select.cu counts it (-1
    for a warpgroup count it has no instantiation of). Builds the kernel
    on first use."""
    return _load(STAGE1_SELECT).stage1_select_layout_bytes(
        int(rev), int(emb), ncw, int(streamed), kch, ek, stages, m, qcap
    )


def _stage1_hopper(
    kernel: Kernel, uq, vv, col_mix, col_gidx, row_mix, row_slot,
    *, f_tot: float, m: int, bn: int, emb_scale: float, ue, ve, uv, vq,
    plan: SelectPlan | None = None,
) -> torch.Tensor:
    """Launch one of the Hopper stage-1 kernels. stage1_wgmma.cu takes the
    0/1 operands as int8, converted here; stage1_select.cu takes them as
    they are, with int8 scratch that its C call converts them into, and
    the plan it is to lay them out by (`select_plan`'s unless given)."""
    a_pad, n, d, rev, with_emb = _check_stage1(
        uq, vv, col_mix, col_gidx, row_mix, row_slot, ue, ve, uv, vq
    )
    e = ue.shape[1] if with_emb else 0
    if bn % 128 or n % bn or d < 1 or m < 1:
        raise ValueError(
            f"{kernel.name} kernel needs m >= 1, D >= 1, bn % 128 == 0, "
            f"n % bn == 0 (m={m}, D={d}, bn={bn}, n={n})"
        )
    select = kernel is STAGE1_SELECT
    if select:
        plan = plan or select_plan(m, d, e, rev)
        if plan is None:
            raise ValueError(
                f"stage1_select kernel has no shared-memory plan for m={m}, "
                f"D={d}, E={e}, rev={rev} (E <= {SELECT_MAX_E}; m as far as "
                "its kept lists fit)"
            )
    elif m > WGMMA_MAX_M or d > WGMMA_MAX_D or e > WGMMA_MAX_E:
        raise ValueError(
            f"stage1_wgmma kernel needs m <= {WGMMA_MAX_M}, D <= "
            f"{WGMMA_MAX_D}, E <= {WGMMA_MAX_E} (m={m}, D={d}, E={e})"
        )
    dev = uq.device
    out = torch.empty((a_pad, (n // bn) * m), dtype=torch.int32, device=dev)
    if a_pad == 0 or n == 0:
        return out
    dp = _round16(d)
    ops = {}  # every operand the launch reads, held until it is enqueued
    if select:
        ops.update(uq=uq, vv=vv, uv=uv, vq=vq)
        rows = (a_pad, n, a_pad, n) if rev else (a_pad, n)
        scratch = torch.empty((sum(rows), dp), dtype=torch.int8, device=dev)
        for name, part in zip(("uq8", "vv8", "uv8", "vq8"), scratch.split(rows)):
            ops[name] = part
        names = ("uq", "vv", "uv", "vq", "uq8", "vv8", "uv8", "vq8")
        tail = (plan.ncw, plan.stages, plan.qcap, int(plan.streamed))
    else:
        ops.update(uq=int8_operand(uq, dp), vv=int8_operand(vv, dp))
        if rev:
            ops["uv"], ops["vq"] = int8_operand(uv, dp), int8_operand(vq, dp)
        names = ("uq", "vv", "uv", "vq")
        tail = ()
    ep = _round16(e)
    if with_emb:
        ops["ue"], ops["ve"] = _padded(ue, ep), _padded(ve, ep)

    def ptr(name):
        t = ops.get(name)
        return None if t is None else t.data_ptr()

    launch = getattr(_load(kernel), f"{kernel.name}_launch")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            *(ptr(name) for name in names), ptr("ue"), ptr("ve"),
            col_mix.data_ptr(), col_gidx.data_ptr(), row_mix.data_ptr(),
            row_slot.data_ptr(), out.data_ptr(),
            a_pad, n, dp, d, ep, bn, m, math.ceil(f_tot - 0.5), emb_scale,
            int(rev), int(with_emb), *tail, stream,
        )
    if rc != 0:
        raise RuntimeError(f"{kernel.name} kernel launch failed: error {rc}")
    kernel.launches += 1
    return out


def stage1_wgmma(
    uq, vv, col_mix, col_gidx, row_mix, row_slot, *,
    f_tot: float, m: int, bn: int, emb_scale: float,
    ue=None, ve=None, uv=None, vq=None,
) -> torch.Tensor:
    """Launch the Hopper stage-1 kernel (csrc/stage1_wgmma.cu) on CUDA
    tensors. Same arguments and result as `stage1`; the 0/1 operands are
    converted to int8 here (inside the call's time), the embeddings
    zero-padded to a multiple of 16 columns. Takes 1 <= m <= 8,
    D <= 1024, E <= 64, bn % 128 == 0, n % bn == 0, any row count, and
    col_gidx in [0, 2^18)."""
    return _stage1_hopper(
        STAGE1_WGMMA, uq, vv, col_mix, col_gidx, row_mix, row_slot,
        f_tot=f_tot, m=m, bn=bn, emb_scale=emb_scale, ue=ue, ve=ve, uv=uv,
        vq=vq,
    )


def stage1_select(
    uq, vv, col_mix, col_gidx, row_mix, row_slot, *,
    f_tot: float, m: int, bn: int, emb_scale: float,
    ue=None, ve=None, uv=None, vq=None, plan: SelectPlan | None = None,
) -> torch.Tensor:
    """Launch the Hopper stage-1 kernel for the shapes stage1_wgmma.cu
    does not take (csrc/stage1_select.cu) on CUDA tensors. Same arguments
    and result as `stage1`; the 0/1 operands are converted to int8 inside
    the call (one host round trip), the embeddings zero-padded to a
    multiple of 16 columns. Takes any m, D and E <= 128 for which
    `select_plan` finds a layout (raises ValueError where it finds none,
    RuntimeError where a given `plan` does not fit), bn % 128 == 0,
    n % bn == 0, any row count, and col_gidx in [0, 2^18)."""
    return _stage1_hopper(
        STAGE1_SELECT, uq, vv, col_mix, col_gidx, row_mix, row_slot,
        f_tot=f_tot, m=m, bn=bn, emb_scale=emb_scale, ue=ue, ve=ve, uv=uv,
        vq=vq, plan=plan,
    )


def lex_ranks(
    sorted_keys: torch.Tensor, q: torch.Tensor, n_iters: int
) -> torch.Tensor:
    """Launch csrc/lex_ranks.cu on CUDA tensors: for each query key of q
    (int32 [Q, 3]) the count of rows of sorted_keys (int32 [C, 3],
    lexicographically ascending) below it, by a 33-ary search (a warp a
    query) of at most `n_iters` steps; a depth that suffices for a
    binary search suffices. Returns int32 [Q]."""
    dev = sorted_keys.device
    if dev.type != "cuda":
        raise ValueError(f"lex_ranks kernel needs CUDA tensors, got {dev}")
    c, n_q = sorted_keys.shape[0], q.shape[0]
    _check(sorted_keys, "sorted_keys", torch.int32, dev, (c, 3))
    _check(q, "q", torch.int32, dev, (n_q, 3))
    if c >= 2**31 // 3:
        raise ValueError(f"lex_ranks kernel takes C < 2^31 / 3 rows, got {c}")
    out = torch.empty(n_q, dtype=torch.int32, device=dev)
    if n_q == 0:
        return out
    lib = _load(LEX_RANKS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.lex_ranks_launch(
            sorted_keys.data_ptr(), c, q.data_ptr(), n_q, int(n_iters),
            out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"lex_ranks kernel launch failed: CUDA error {rc}")
    LEX_RANKS.launches += 1
    return out

"""Device programs of the leaderboard rank engine (device.py), as
PyTorch on an explicit device: the counterpart of the JAX package's
`leaderboard/tpu.py`.

The rank structure on the card is a *sorted score tensor*: per board,
three int32 key columns (adjusted score, adjusted subscore, write seq —
the lexicographic key the host oracle keeps, minus the owner element
that the unique seq makes unreachable) plus the sort permutation
mapping sorted position -> slot. Dead and padding slots carry PAD_KEY
in every column, so they sort past every live key and never perturb a
rank. All programs are exact integer work:

- `scatter_keys` — in-place refresh of the staged dirty rows
  (`index_copy_` into the resident [C, 3] columns): the H2D payload is
  the dirty rows, never the board.
- `sort_boards` — the segmented sort: a lexicographic sort along the
  slot axis of a stacked [B, C, 3] tensor, done as three stable sorts
  (least significant column first), re-ranks B boards in one pass.
- `lex_ranks` — the batched read: a fixed-depth lower-bound binary
  search over the sorted columns answers Q owner-rank queries in
  `n_search_iters(C)` gather steps, one call per batch. The three keys
  are compared column by column: packing them into one int64 would
  lose a key. On a card it is the hand kernel `csrc/lex_ranks.cu`
  (`kernels.lex_ranks`: one launch, where the plain version
  `lex_ranks_plain` launches ~20 small kernels a step); on the CPU it
  is the plain version.
- `rank_of_slots` inverts the permutation (slot -> rank of every live
  entry at once) for full-board sweeps; `window_slots` slices it.

The JAX package pads every shape to a power of two to bound XLA
compiles; eager PyTorch compiles nothing per shape, so the port pads
only the board capacity (the slot allocator's growth unit).

`LAUNCHES` counts each PyTorch program's calls on a CUDA tensor (the
kernel counts its own, `kernels.LEX_RANKS.launches`), so a run can show
that its reads went through the card."""

from __future__ import annotations

import numpy as np
import torch

# Sentinel key for dead/padding slots: sorts after every live key.
# Live keys are range-checked at staging time (device.py flips the
# board host-only on overflow), so no live column ever equals PAD_KEY.
PAD_KEY = np.int32(2**31 - 1)

PROGRAMS = ("scatter_keys", "sort_boards", "rank_of_slots", "window_slots")
LAUNCHES = dict.fromkeys(PROGRAMS, 0)


def reset_launches() -> None:
    for name in PROGRAMS:
        LAUNCHES[name] = 0


def _count(name: str, t: torch.Tensor) -> None:
    if t.is_cuda:
        LAUNCHES[name] += 1


def scatter_keys(keys: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor):
    """In-place dirty-row refresh: keys [C, 3] <- rows [U, 3] at idx [U]
    (int64). Returns `keys`."""
    _count("scatter_keys", keys)
    return keys.index_copy_(0, idx, rows)


def sort_boards(keys: torch.Tensor):
    """Segmented lexicographic sort along the slot axis.

    keys [B, C, 3] -> (sorted_keys [B, C, 3], perm [B, C] int32) where
    perm[b, r] is the slot holding rank r of board b. Ascending by
    (k0, k1, k2); equal keys keep slot order, as the JAX lexsort does;
    PAD_KEY rows land past every live rank."""
    _count("sort_boards", keys)
    perm = torch.sort(keys[..., 2], dim=-1, stable=True).indices
    for col in (1, 0):
        k = torch.take_along_dim(keys[..., col], perm, dim=-1)
        perm = torch.take_along_dim(
            perm, torch.sort(k, dim=-1, stable=True).indices, dim=-1
        )
    sorted_keys = torch.take_along_dim(keys, perm[..., None], dim=-2)
    return sorted_keys, perm.to(torch.int32)


def lex_ranks(sorted_keys: torch.Tensor, q: torch.Tensor, n_iters: int):
    """Batched rank lookup: for each query key q[i] (int32 [Q, 3]), the
    count of keys in `sorted_keys` [C, 3] lexicographically below it —
    bisect_left, vectorized over the whole batch as a fixed-depth binary
    search (n_iters >= ceil(log2(C)) + 1). A query key present in the
    board returns exactly its sorted position. Returns int32 [Q]. CUDA
    tensors go to the hand kernel, CPU tensors to the plain version."""
    if sorted_keys.is_cuda:
        from .. import kernels

        return kernels.lex_ranks(sorted_keys, q, n_iters)
    return lex_ranks_plain(sorted_keys, q, n_iters)


def lex_ranks_plain(sorted_keys: torch.Tensor, q: torch.Tensor, n_iters: int):
    """The plain PyTorch version of `lex_ranks`, on any device: one
    masked step of the search over the whole batch at a time."""
    c = sorted_keys.shape[0]
    q0, q1, q2 = q[:, 0], q[:, 1], q[:, 2]
    lo = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    hi = torch.full((q.shape[0],), c, dtype=torch.int32, device=q.device)
    for _ in range(n_iters):
        mid = (lo + hi) >> 1  # lo < hi => mid <= C-1
        # Settled rows (lo == hi == C) would read past the end.
        v = sorted_keys[mid.clamp_max(c - 1).long()]  # [Q, 3] gather
        less = (v[:, 0] < q0) | (
            (v[:, 0] == q0)
            & ((v[:, 1] < q1) | ((v[:, 1] == q1) & (v[:, 2] < q2)))
        )
        active = lo < hi
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    return lo


def rank_of_slots(perm: torch.Tensor):
    """Inverse permutation, segmented over the board axis: perm [B, C]
    (rank -> slot) becomes [B, C] slot -> rank — the full-board scan a
    reward sweep reads (every live entry's final rank in one pass)."""
    _count("rank_of_slots", perm)
    b, c = perm.shape
    ranks = torch.arange(c, dtype=torch.int32, device=perm.device)
    out = torch.zeros((b, c), dtype=torch.int32, device=perm.device)
    return out.scatter_(1, perm.long(), ranks.expand(b, c))


def window_slots(perm: torch.Tensor, start: int, limit: int):
    """Around-owner / top-K window: perm [C] sliced [start, start+limit)
    on the card, so the D2H fetch is `limit` slots, never the board."""
    _count("window_slots", perm)
    return perm.narrow(0, start, limit)


def board_device_bytes(capacity: int) -> int:
    """Device footprint of one flushed board at `capacity` slots, as the
    JAX package counts it: the int32 scatter target [C, 3] + the sorted
    copy [C, 3] + the int32 rank permutation [C] — the per-board figure
    of the telemetry plane's `leaderboard.boards` ledger row."""
    return int(capacity) * (12 + 12 + 4)


def pad_pow2(n: int, floor: int = 8) -> int:
    """Pad `n` up to a power-of-two bucket (>= floor)."""
    n = max(int(n), floor)
    return 1 << (n - 1).bit_length()


def n_search_iters(capacity: int) -> int:
    """Binary-search depth covering a [0, capacity] interval."""
    return max(1, int(capacity).bit_length() + 1)

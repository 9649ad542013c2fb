"""PyTorch/CUDA port of nakama-tpu.

The JAX package `nakama_tpu` is the reference this port is held against;
the port imports nothing of it and keeps its own copies of the host-side
modules it needs. Entry points: `python -m nakama_tpu_torch` (the
server, `server.NakamaServer`: HTTP auth, `/ws` realtime sessions and the
socket matchmaker path) and `nakama_tpu_torch.matchmaker.LocalMatchmaker`
with `MatchmakerConfig(backend="cuda")` (the default), which runs the
matchmaker interval on `cuda:0`; the stage-1 prefilter is a hand-written
kernel for Hopper (`csrc/stage1_wgmma.cu`, bound in `kernels.py`).
"""

__version__ = "0.1.0"

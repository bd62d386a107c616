"""ConvLSTM recurrence: the hand-written CUDA kernel and its plain version.

:func:`convlstm_seq` is the port of the TPU kernel
``windtpu/ops/pallas_convlstm.py:convlstm_seq_fused``: pre-biased gate
activations ``zx`` (B, T, H, W, 4F) and a recurrent kernel ``rk``
(3, 3, F, 4F) in, the hidden-state sequence (B, T, H, W, F) out.  On a CUDA
tensor it runs ``csrc/convlstm.cu``: one host call enqueues the T launches of
a sequence, one per time step; on a CPU tensor it runs
:func:`convlstm_seq_plain`, the same arithmetic in plain PyTorch with the
same rounding points (f32 accumulation and gate math, h and c stored in the
I/O dtype between steps).  The kernel has two routes by dtype, each with
``rk`` first packed by :func:`pack_recurrent_kernel` for the tile the
route's rule picks: bf16 on the tensor cores through ``wgmma``
(:func:`choose_tile`, clusters of blocks sharing the packed slab), and f32
on the CUDA cores (:func:`choose_tile_f32`, which also splits the taps over
a cluster of blocks).  There is no fallback from the kernel to the plain
version.  The gradient comes from :class:`ConvLSTMSeqFunction`, whose
backward replays the recurrence.

The kernel library is built and bound at first use by
:mod:`windtpu_torch.ops._build`; nothing is compiled or loaded when this
module is imported.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from windtpu_torch.ops._build import bind
from windtpu_torch.utils.logging import span

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The bf16 route's stage depth and tiles: code -> (pixels BM, channels BJ,
# cluster), where a cluster of ``cluster`` blocks along the pixels shares
# each stage of the packed slab (one TMA multicast).  Each call passes BM,
# BJ, K_CHUNK and the cluster to the C entry, which refuses any that
# csrc/convlstm.cu does not build (BF16_BUILT, KC, clusters of 1, 2, 4).
K_CHUNK = 64
TILES = {0: (128, 32, 2), 1: (64, 16, 2)}
BF16_BUILT = {(128, 32), (64, 16)}
BF16_CLUSTERS = (1, 2, 4)


def bf16_blocks(m: int, f: int, bm: int, bj: int, cluster: int) -> int:
    """Output tiles per step of a bf16 tile: pixel tiles rounded up to
    whole clusters, times channel tiles."""
    tiles = -(-m // bm)
    return -(-tiles // cluster) * cluster * -(-f // bj)


def bf16_grid(m: int, f: int, code: int, sms: int = 132):
    """(output tiles, blocks) of one bf16 step with tile ``code``: the
    kernel is persistent, so it launches as many whole clusters as fit on
    the card at once (one block per SM for the 128-pixel tile, two for the
    64-pixel one; the C entry asks the runtime) and no more than the
    tiles."""
    bm, bj, cluster = TILES[code]
    tiles = bf16_blocks(m, f, bm, bj, cluster)
    per_sm = 1 if bm == 128 else 2
    return tiles, min(tiles, sms * per_sm // cluster * cluster)


def choose_tile(m: int, f: int, sms: int = 132) -> int:
    """The bf16 route's tile for M = B*H*W pixels and F channels: the large
    tile (two consumer warpgroups) where it gives at least one tile per
    SM, else the small one (one warpgroup, 4x the tiles)."""
    return 0 if bf16_blocks(m, f, *TILES[0]) >= sms else 1


def halo_windows(m0: int, bm: int, w: int):
    """The bf16 kernel's halo windows for the block of pixels m0 .. m0+bm-1
    of images W wide, as csrc/convlstm.cu computes them: (S, starts, p).
    Window rows are rows of hbuf (pixels); box i of ``p`` rows (bm + 2
    rounded up to 8) lands at window row i * p and starts at pixel
    ``starts[i]`` (rows outside hbuf read as zeros).  Tap (dy, dx) of pixel
    m is window row (dy + 1) * S + (m - m0) + 1 + dx: one window (S = W)
    where bm + 2W + 2 rows fit the 3 * p reserved, else one per tap row
    (S = p)."""
    p = -(-(bm + 2) // 8) * 8
    if 2 * w + bm + 2 <= 3 * p:
        boxes = -(-(2 * w + bm + 2) // p)
        return w, [m0 - w - 1 + i * p for i in range(boxes)], p
    return p, [m0 + (i - 1) * w - 1 for i in range(3)], p


def bf16_l2_bytes(m: int, f: int, w: int, bm: int, bj: int,
                  cluster: int) -> int:
    """Bytes one bf16 step reads from L2 into shared memory: each cluster's
    slab block once (multicast), each block's halo windows once per
    channel chunk (zx, c and the stores are not counted)."""
    fp = -(-f // K_CHUNK) * K_CHUNK
    blocks = bf16_blocks(m, f, bm, bj, cluster)
    _, starts, p = halo_windows(0, bm, w)
    slab = blocks // cluster * 9 * fp * 4 * bj * 2
    return slab + blocks * (fp // K_CHUNK) * len(starts) * p * K_CHUNK * 2


# The f32 route's stage depth and tiles: code -> (pixels BM, channels BJ,
# split), where a cluster of ``split`` blocks shares one BM x BJ output
# tile and each block multiplies 9 / split of the taps (split 3: one tap
# row each).  Each launch passes BM, BJ, F32_CHUNK and the split to the C
# entry, which refuses any that csrc/convlstm.cu does not build (BK,
# F32Large or F32Small, SPLIT 1 or 3).
F32_CHUNK = 16
F32_TILES = {0: (64, 32, 1), 1: (32, 32, 3)}


def f32_blocks(m: int, f: int, code: int) -> int:
    """Blocks per step of the f32 route's tile ``code``."""
    bm, bj, split = F32_TILES[code]
    return -(-m // bm) * -(-f // bj) * split


def choose_tile_f32(m: int, f: int, sms: int = 132) -> int:
    """The f32 route's tile for M = B*H*W pixels and F channels: the large
    tile without a split where it gives at least one block per SM, else the
    small tile split over the three tap rows (6x the blocks)."""
    return 0 if f32_blocks(m, f, 0) >= sms else 1


def pack_recurrent_kernel(rk: torch.Tensor, bj: int,
                          chunk: int = K_CHUNK, *,
                          k_major: bool = False) -> torch.Tensor:
    """(3, 3, F, 4F) -> a route's slab, Fp = F rounded up to the route's
    stage depth ``chunk`` (``K_CHUNK`` for bf16, ``F32_CHUNK`` for f32).
    Block ``jb`` of ``bj`` channels gets the 9 * Fp rows (tap, then channel
    ``k``) by 4 * bj columns (gate ``g``, then channel ``j``) holding
    ``rk[tap // 3, tap % 3, k, g*F + jb*bj + j]``, zero where ``k`` or
    ``jb*bj + j`` is not below F.  The f32 route reads it as
    (ceil(F/bj), 9*Fp, 4*bj), columns contiguous; with ``k_major`` it is
    (ceil(F/bj), 9, 4*bj, Fp), channels ``k`` contiguous, as the bf16
    route's wgmma reads it.  Plain torch ops, so it runs where ``rk`` lies
    and keeps its dtype."""
    if bj % 8:
        raise ValueError(f"bj must be a multiple of 8; got {bj}")
    f = rk.shape[2]
    fp = -(-f // chunk) * chunk
    nb = -(-f // bj)
    w = rk.reshape(9, f, 4, f)                       # tap, k, gate, j
    w = F.pad(w, (0, nb * bj - f, 0, 0, 0, fp - f))  # j, then k
    w = w.reshape(9, fp, 4, nb, bj)
    if k_major:
        return w.permute(3, 0, 2, 4, 1).reshape(nb, 9, 4 * bj,
                                                fp).contiguous()
    return w.permute(3, 0, 1, 2, 4).reshape(nb, 9 * fp, 4 * bj).contiguous()


def check_tile(dtype: torch.dtype, bm: int, bj: int, chunk: int,
               cluster: int) -> None:
    """Raise where the C entry would refuse the tile: the tiles, stage
    depths and clusters that csrc/convlstm.cu builds per route."""
    if dtype == torch.bfloat16:
        ok = ((bm, bj) in BF16_BUILT and chunk == K_CHUNK
              and cluster in BF16_CLUSTERS)
    else:
        ok = ((bm, bj) in {t[:2] for t in F32_TILES.values()}
              and chunk == F32_CHUNK and cluster in (1, 3))
    if not ok:
        raise ValueError(
            f"csrc/convlstm.cu builds no {dtype} tile BM {bm} x BJ {bj} "
            f"with stage depth {chunk} in clusters of {cluster}")


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Keras hard_sigmoid: clip(0.2*x + 0.5, 0, 1)."""
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def _check(zx: torch.Tensor, rk: torch.Tensor) -> int:
    """Validate what the kernel takes; returns F."""
    if zx.dim() != 5 or zx.shape[-1] % 4:
        raise ValueError(
            f"convlstm expects zx of shape (B, T, H, W, 4F); got "
            f"{tuple(zx.shape)}")
    f = zx.shape[-1] // 4
    if tuple(rk.shape) != (3, 3, f, 4 * f):
        raise ValueError(
            f"convlstm requires a (3, 3, F, 4F) recurrent kernel; got "
            f"{tuple(rk.shape)} for F={f}")
    if zx.dtype not in _DTYPE_CODES:
        raise TypeError(f"convlstm takes float32 or bfloat16 zx; got "
                        f"{zx.dtype}")
    if not zx.is_contiguous():
        raise ValueError("convlstm requires a contiguous zx")
    if rk.device != zx.device:
        raise ValueError(f"zx is on {zx.device} but rk is on {rk.device}")
    return f


def convlstm_seq_plain(zx: torch.Tensor, rk: torch.Tensor, *,
                       hard_sig: bool = True) -> torch.Tensor:
    """Plain PyTorch recurrence with the kernel's signature and rounding:
    a loop over t of ``F.conv2d`` in f32 plus the gate math in f32, with
    h and c rounded to ``zx.dtype`` after every step."""
    f = _check(zx, rk)
    b, t, h, w, _ = zx.shape
    dt = zx.dtype
    act = hard_sigmoid if hard_sig else torch.sigmoid
    # (4F, F, 3, 3); rounded to the I/O dtype first, as the kernel sees it.
    weight = rk.to(dt).float().permute(3, 2, 0, 1)
    c = torch.zeros((b, h, w, f), dtype=torch.float32, device=zx.device)
    h_prev = None
    ys = []
    for s in range(t):
        z = zx[:, s].float()
        if h_prev is not None:
            zh = F.conv2d(h_prev.float().permute(0, 3, 1, 2), weight,
                          padding=1)
            z = z + zh.permute(0, 2, 3, 1)
        zi, zf, zc, zo = z.split(f, dim=-1)
        c_new = act(zf) * c + act(zi) * torch.tanh(zc)
        h_new = act(zo) * torch.tanh(c_new)
        c = c_new.to(dt).float()
        h_prev = h_new.to(dt)
        ys.append(h_prev)
    return torch.stack(ys, dim=1)


_SEQ_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                 + [ctypes.c_int] * 10
                 + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])


def launch_sequence(entry, zx: torch.Tensor, rk: torch.Tensor,
                    hard_sig: bool, bm: int, bj: int,
                    cluster: int) -> torch.Tensor:
    """One call of ``entry`` (``windtpu_convlstm_seq`` of a built library)
    on ``zx``'s device and current stream: the T launches of a sequence with
    the given tile, ``rk`` packed for it.  The bf16 route also gets hbuf,
    its (2, B*H*W, Fp) copy of h with channels >= F zero.  Raises on a tile
    the C entry does not build, and on its error code, naming the step."""
    b, t, h, w, f4 = zx.shape
    f = f4 // 4
    bf16 = zx.dtype == torch.bfloat16
    chunk = K_CHUNK if bf16 else F32_CHUNK
    check_tile(zx.dtype, bm, bj, chunk, cluster)
    slab = pack_recurrent_kernel(rk.to(zx.dtype), bj, chunk, k_major=bf16)
    y = torch.empty((b, t, h, w, f), dtype=zx.dtype, device=zx.device)
    c = torch.empty((b, h, w, f), dtype=zx.dtype, device=zx.device)
    hbuf = None
    if bf16:
        fp = -(-f // chunk) * chunk
        hbuf = (torch.empty if fp == f else torch.zeros)(
            (2, b * h * w, fp), dtype=zx.dtype, device=zx.device)
    failed = ctypes.c_int(0)
    with torch.cuda.device(zx.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = entry(_DTYPE_CODES[zx.dtype], zx.data_ptr(), slab.data_ptr(),
                    y.data_ptr(), c.data_ptr(),
                    None if hbuf is None else hbuf.data_ptr(), b, t, h, w,
                    f, int(hard_sig), bm, bj, chunk, cluster, stream,
                    ctypes.byref(failed))
    if err:
        raise RuntimeError(f"convlstm kernel launch failed at step "
                           f"{failed.value}: CUDA error {err}")
    return y


def _launch_sequence(zx: torch.Tensor, rk: torch.Tensor,
                     hard_sig: bool) -> torch.Tensor:
    """The sequence with the tile the route's rule picks for the shape; the
    T launches are counted in ``convlstm_seq.launches``.  While a CUDA graph
    captures the stream nothing runs, so nothing is counted: the graph's
    replays launch K1 without this wrapper."""
    entry = bind("convlstm", "windtpu_convlstm_seq", _SEQ_ARGTYPES)
    b, t, h, w, f4 = zx.shape
    f = f4 // 4
    sms = torch.cuda.get_device_properties(zx.device).multi_processor_count
    if zx.dtype == torch.bfloat16:
        bm, bj, cluster = TILES[choose_tile(b * h * w, f, sms)]
    else:
        bm, bj, cluster = F32_TILES[choose_tile_f32(b * h * w, f, sms)]
    y = launch_sequence(entry, zx, rk, hard_sig, bm, bj, cluster)
    if not torch.cuda.is_current_stream_capturing():
        convlstm_seq.launches += t
    return y


class ConvLSTMSeqFunction(torch.autograd.Function):
    """The recurrence with the kernel as its forward.  The backward does
    what the TPU kernel's custom VJP does (``_make_fused`` in
    ``windtpu/ops/pallas_convlstm.py``): it replays the op-by-op recurrence
    ``models.layers.convlstm_scan`` on the saved inputs and takes that
    replay's gradient.  It can be differentiated once; the twice
    differentiated path (the critic's gradient penalty) is built on
    ``convlstm_scan`` itself."""

    @staticmethod
    def forward(ctx, zx, rk, hard_sig):
        ctx.save_for_backward(zx, rk)
        ctx.hard_sig = hard_sig
        if zx.device.type == "cpu":
            return convlstm_seq_plain(zx, rk, hard_sig=hard_sig)
        return _launch_sequence(zx, rk, hard_sig)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        # Lazy import: models.layers imports this module.
        from windtpu_torch.models.layers import convlstm_scan

        zx, rk = (a.detach().requires_grad_() for a in ctx.saved_tensors)
        with torch.enable_grad():
            y = convlstm_scan(zx, rk, hard_sig=ctx.hard_sig)
        wanted = [a for a, need in zip((zx, rk), ctx.needs_input_grad)
                  if need]
        grads = iter(torch.autograd.grad(y, wanted, grad.to(y.dtype)))
        return tuple(next(grads) if need else None
                     for need in ctx.needs_input_grad[:2]) + (None,)


def convlstm_seq(zx: torch.Tensor, rk: torch.Tensor, *,
                 hard_sig: bool = True) -> torch.Tensor:
    """ConvLSTM sequence: (B, T, H, W, 4F), (3, 3, F, 4F) -> (B, T, H, W, F).

    ``zx`` carries the input conv with the gate bias and the unit forget
    bias folded in.  CUDA tensors launch the kernel (one host call, T
    launches, counted in ``convlstm_seq.launches``) through
    :class:`ConvLSTMSeqFunction`, which gives the gradients for ``zx`` and
    ``rk``; CPU tensors take the plain version under ordinary autograd."""
    _check(zx, rk)
    with span("ops.k1"):
        if zx.device.type == "cpu":
            return convlstm_seq_plain(zx, rk, hard_sig=hard_sig)
        if zx.device.type != "cuda":
            raise ValueError(f"convlstm runs on CUDA or CPU tensors; got "
                             f"{zx.device}")
        return ConvLSTMSeqFunction.apply(zx, rk, hard_sig)


convlstm_seq.launches = 0

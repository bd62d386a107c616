"""The port's ConvLSTM recurrence (windtpu_torch/ops/convlstm.py) against
the JAX package's.

On the CPU the wrapper runs its plain version, which must reproduce the
JAX scan (windtpu/models/layers.py:_convlstm_scan) and the fused TPU
kernel (windtpu/ops/pallas_convlstm.py, run in interpret mode as
tests/test_pallas_convlstm.py runs it).  The gradient comes from
ConvLSTMSeqFunction, whose backward replays the port's convlstm_scan as
the TPU kernel's custom VJP replays the JAX scan.  The CUDA kernel itself
is held against the plain version by the gpu-marked tests, on the card.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from windtpu.models.layers import _convlstm_scan, hard_sigmoid
from windtpu.ops.pallas_convlstm import convlstm_seq_fused
from windtpu_torch.models.layers import convlstm_scan
from windtpu_torch.ops.convlstm import (
    _SEQ_ARGTYPES,
    BF16_BUILT,
    F32_CHUNK,
    F32_TILES,
    K_CHUNK,
    TILES,
    ConvLSTMSeqFunction,
    bf16_blocks,
    bf16_l2_bytes,
    check_tile,
    choose_tile,
    choose_tile_f32,
    convlstm_seq,
    convlstm_seq_plain,
    f32_blocks,
    halo_windows,
    launch_sequence,
    pack_recurrent_kernel,
)

torch.set_num_threads(2)


def _inputs(seed, b=2, t=3, h=8, w=8, f=128):
    rng = np.random.RandomState(seed)
    zx = rng.randn(b, t, h, w, 4 * f).astype(np.float32)
    rk = (0.1 * rng.randn(3, 3, f, 4 * f)).astype(np.float32)
    return zx, rk


@pytest.mark.parametrize("hard_sig", [True, False])
def test_plain_matches_scan_f32(hard_sig):
    zx, rk = _inputs(0, b=2, t=4, h=7, w=9, f=16)
    r_act = hard_sigmoid if hard_sig else jax.nn.sigmoid
    want = _convlstm_scan(jnp.asarray(zx), jnp.asarray(rk), 16,
                          r_act=r_act, unroll=1)
    got = convlstm_seq(torch.from_numpy(zx), torch.from_numpy(rk),
                       hard_sig=hard_sig)
    assert got.shape == want.shape == (2, 4, 7, 9, 16)
    # Same f32 arithmetic; only the conv's summation order differs
    # between XLA-CPU and ATen.
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_fused_tpu_kernel(dtype):
    zx, rk = _inputs(1)
    jdt = jnp.dtype(dtype)
    want = convlstm_seq_fused(jnp.asarray(zx, jdt), jnp.asarray(rk),
                              interpret=True)
    tdt = getattr(torch, dtype)
    got = convlstm_seq(torch.from_numpy(zx).to(tdt), torch.from_numpy(rk))
    assert got.dtype == tdt
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        # Both keep gates in f32 and round h and c to bf16 at the same
        # points; a summation-order difference can still flip one bf16
        # rounding of h (2**-8 relative, |h| < 1), which the next step
        # carries on: allow two ulps at magnitude 1.
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -7)


@pytest.mark.parametrize("case", ["kernel_5x5", "kernel_width", "float16",
                                  "non_contiguous", "rank"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    zx, rk = (torch.from_numpy(a) for a in _inputs(2, t=2, h=4, w=4, f=8))
    err = ValueError
    if case == "kernel_5x5":
        rk = torch.zeros(5, 5, 8, 32)
    elif case == "kernel_width":
        rk = torch.zeros(3, 3, 8, 16)
    elif case == "float16":
        zx, err = zx.half(), TypeError
    elif case == "non_contiguous":
        zx = zx.transpose(2, 3)
    elif case == "rank":
        zx = zx[0]
    with pytest.raises(err):
        convlstm_seq(zx, rk)


def test_cpu_tensors_take_the_plain_version_without_counting():
    zx, rk = (torch.from_numpy(a) for a in _inputs(3, t=2, h=4, w=4, f=8))
    before = convlstm_seq.launches
    got = convlstm_seq(zx, rk)
    assert convlstm_seq.launches == before
    torch.testing.assert_close(got, convlstm_seq_plain(zx, rk),
                               rtol=0, atol=0)


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel runs only on a card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # The f32 cases are the f32 paths' shapes at T = 3 (train_main, one of
    # its two ranks, the perceptual train_main, the downscale), a ragged one
    # and F % 4 != 0, which takes the element-by-element gather; the bf16
    # ones the training shape at T = 4, F = 40 and F = 12 (F % 8 != 0:
    # single-value epilogue).
    cases = [((2, 4, 24, 24, 128), torch.bfloat16, True, 2.0 ** -5),
             ((2, 4, 24, 24, 128), torch.float32, True, 1e-4),
             ((3, 5, 7, 7, 40), torch.float32, False, 1e-4),
             ((3, 5, 7, 7, 40), torch.bfloat16, True, 2.0 ** -5),
             ((2, 3, 5, 9, 12), torch.bfloat16, True, 2.0 ** -5),
             ((16, 3, 8, 8, 128), torch.float32, True, 1e-4),
             ((8, 3, 8, 8, 128), torch.float32, True, 1e-4),
             ((16, 3, 24, 24, 128), torch.float32, True, 1e-4),
             ((2, 3, 5, 9, 6), torch.float32, True, 1e-4)]
    for i, ((b, t, h, w, f), dtype, hard, tol) in enumerate(cases):
        zx, rk = _inputs(10 + i, b, t, h, w, f)
        zx = torch.from_numpy(zx).to("cuda", dtype)
        rk = torch.from_numpy(rk).cuda()
        before = convlstm_seq.launches
        got = convlstm_seq(zx, rk, hard_sig=hard)
        assert convlstm_seq.launches == before + t
        want = convlstm_seq_plain(zx, rk, hard_sig=hard)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol, (b, t, h, w, f, dtype, err)
        # No atomics: the f32 cluster adds its partial sums in rank order,
        # the bf16 route's K loop runs in one order.
        assert torch.equal(convlstm_seq(zx, rk, hard_sig=hard), got)
    # The C entry refuses a tile it does not build, before any launch.
    from windtpu_torch.ops._build import bind

    entry = bind("convlstm", "windtpu_convlstm_seq", _SEQ_ARGTYPES)
    zx = torch.zeros((1, 2, 4, 4, 32), device="cuda", dtype=torch.bfloat16)
    rk = torch.zeros((3, 3, 8, 32), device="cuda")
    slab = pack_recurrent_kernel(rk.bfloat16(), 16, K_CHUNK, k_major=True)
    y = torch.empty((1, 2, 4, 4, 8), device="cuda", dtype=torch.bfloat16)
    c = torch.empty((1, 4, 4, 8), device="cuda", dtype=torch.bfloat16)
    hbuf = torch.zeros((2, 16, K_CHUNK), device="cuda", dtype=torch.bfloat16)
    failed = ctypes.c_int(-1)
    stream = torch.cuda.current_stream().cuda_stream
    for bm, bj, chunk, cluster in ((144, 32, K_CHUNK, 1),
                                   (64, 16, 32, 1), (64, 16, K_CHUNK, 3)):
        assert entry(1, zx.data_ptr(), slab.data_ptr(), y.data_ptr(),
                     c.data_ptr(), hbuf.data_ptr(), 1, 2, 4, 4, 8, 1, bm,
                     bj, chunk, cluster, stream, ctypes.byref(failed)) != 0
        assert failed.value == 0


def _unpack(packed, f):
    """Inverse of pack_recurrent_kernel."""
    nb, k9, n4 = packed.shape
    bj, fp = n4 // 4, k9 // 9
    w = packed.reshape(nb, 9, fp, 4, bj).permute(1, 2, 3, 0, 4)
    return w.reshape(9, fp, 4, nb * bj)[:, :f, :, :f].reshape(3, 3, f, 4 * f)


def _packed_step(h, packed, f):
    """One step's recurrent product as the bf16 route computes it: the
    im2col of h (tap-major, channels zero-padded to Fp) times each block's
    slab, whose columns are [gate][channel of the block]."""
    b, hh, ww, _ = h.shape
    nb, k9, n4 = packed.shape
    bj, fp = n4 // 4, k9 // 9
    hp = torch.nn.functional.pad(h, (0, fp - f, 1, 1, 1, 1))
    cols = torch.stack([hp[:, dy:dy + hh, dx:dx + ww]
                        for dy in range(3) for dx in range(3)], dim=3)
    z = torch.einsum("mk,bkn->mbn", cols.reshape(b * hh * ww, 9 * fp),
                     packed)
    z = z.reshape(-1, nb, 4, bj).permute(0, 2, 1, 3).reshape(-1, 4, nb * bj)
    return z[:, :, :f].reshape(b, hh, ww, 4 * f)


@pytest.mark.parametrize("f", [8, 12, 40])
@pytest.mark.parametrize("bj", [8, 16, 32])
def test_packed_slab_gemm_is_the_conv_step(bj, f):
    # The bf16 slab is K-major, (nb, 9, 4*bj, Fp): the f32 route's
    # (nb, 9*Fp, 4*bj) with each tap's block transposed.
    rng = np.random.RandomState(11)
    rk = torch.from_numpy((0.1 * rng.randn(3, 3, f, 4 * f)).astype(
        np.float32))
    h = torch.from_numpy(rng.randn(2, 5, 6, f).astype(np.float32))
    packed = pack_recurrent_kernel(rk, bj, k_major=True)
    fp = -(-f // K_CHUNK) * K_CHUNK
    nb = -(-f // bj)
    assert packed.shape == (nb, 9, 4 * bj, fp)
    assert packed.is_contiguous() and packed.dtype == rk.dtype
    # Element (jb, tap, g*bj + j, k) is rk[tap // 3, tap % 3, k, g*F + jb*bj
    # + j].
    jb, tap, g, j, k = nb - 1, 5, 2, (f - 1) % bj, f - 1
    assert packed[jb, tap, g * bj + j, k] == rk[1, 2, k, g * f + jb * bj + j]
    n_major = packed.transpose(2, 3).reshape(nb, 9 * fp, 4 * bj)
    assert torch.equal(_unpack(n_major, f), rk)
    # The step of convlstm_seq_plain: F.conv2d with the (4F, F, 3, 3) view.
    want = torch.nn.functional.conv2d(
        h.permute(0, 3, 1, 2), rk.permute(3, 2, 0, 1), padding=1)
    got = _packed_step(h, n_major, f)
    torch.testing.assert_close(got, want.permute(0, 2, 3, 1), rtol=0,
                               atol=1e-5)


def test_packed_slab_pads_with_zeros_and_keeps_bf16():
    f, bj = 12, 16
    rk = torch.ones(3, 3, f, 4 * f, dtype=torch.bfloat16)
    packed = pack_recurrent_kernel(rk, bj, k_major=True).reshape(
        1, 9, 4, bj, K_CHUNK)
    assert packed.dtype == torch.bfloat16
    assert packed[..., :f, :f].eq(1).all()
    assert packed[..., f:].eq(0).all()            # channels k >= F
    assert packed[..., f:, :].eq(0).all()         # channels j >= F
    with pytest.raises(ValueError):
        pack_recurrent_kernel(rk, 12)


@pytest.mark.parametrize("shape,tile,blocks", [
    ((16, 24, 24, 128), 0, 288),   # downscale: 72 x 4 tiles of 128 x 32
    ((64, 24, 24, 128), 0, 1152),  # 4-member ensemble: 288 x 4
    ((2, 24, 24, 128), 1, 144),    # training: 18 x 8 tiles of 64 x 16
    ((3, 7, 7, 40), 1, 12),        # ragged: 3 tiles, 4 in clusters of 2
])
def test_tile_follows_the_shape(shape, tile, blocks):
    b, h, w, f = shape
    assert choose_tile(b * h * w, f) == tile
    assert bf16_blocks(b * h * w, f, *TILES[tile]) == blocks


@pytest.mark.parametrize("dtype,bm,bj,chunk,cluster", [
    (torch.bfloat16, 144, 32, 64, 2),   # PR 3's mma.sync tile
    (torch.bfloat16, 128, 32, 32, 2),   # PR 3's stage depth
    (torch.bfloat16, 128, 32, 64, 3),   # no multicast to 3 blocks
    (torch.float32, 64, 32, 16, 2),     # f32 splits by whole tap rows
    (torch.float32, 128, 32, 16, 1),
])
def test_entry_refuses_a_tile_it_does_not_build(dtype, bm, bj, chunk,
                                                cluster):
    with pytest.raises(ValueError, match="builds no"):
        check_tile(dtype, bm, bj, chunk, cluster)
    # launch_sequence runs the check before it reaches the C entry (its
    # stage depth is the route's own).
    if chunk == (K_CHUNK if dtype == torch.bfloat16 else F32_CHUNK):
        zx = torch.zeros((1, 2, 4, 4, 32), dtype=dtype)
        with pytest.raises(ValueError, match="builds no"):
            launch_sequence(None, zx, torch.zeros(3, 3, 8, 32), True, bm,
                            bj, cluster)
    for code, (bm, bj, cluster) in TILES.items():
        check_tile(torch.bfloat16, bm, bj, K_CHUNK, cluster)
        assert (bm, bj) in BF16_BUILT


@pytest.mark.parametrize("b,h,w,f,bm", [
    (3, 7, 7, 40, 64),      # images smaller than a tile
    (2, 5, 9, 12, 128),
    (1, 6, 24, 8, 128),     # the downscale width: one window, two boxes
    (2, 3, 150, 8, 128),    # wider than the window: three windows
])
def test_halo_window_rows_are_the_im2col(b, h, w, f, bm):
    # The bf16 kernel stages hbuf rows by TMA boxes (zeros outside hbuf)
    # into 128-byte swizzled rows, reads tap (dy, dx) of pixel m at window
    # row (dy + 1) * S + (m - m0) + 1 + dx through the swizzle, and zeroes
    # taps outside the image: that must be the im2col of h.
    m = b * h * w
    hb = np.random.RandomState(14).randn(m, K_CHUNK).astype(np.float32)
    hb[:, f:] = 0.0
    hp = np.pad(hb.reshape(b, h, w, K_CHUNK), ((0, 0), (1, 1), (1, 1),
                                               (0, 0)))
    want = np.stack([hp[:, dy:dy + h, dx:dx + w] for dy in range(3)
                     for dx in range(3)], axis=3).reshape(m, 9, K_CHUNK)
    for m0 in range(0, m, bm):
        s, starts, p = halo_windows(m0, bm, w)
        assert len(starts) * p <= 3 * p
        window = np.full((3 * p, 8, 8), np.nan, np.float32)
        rows = np.arange(p)
        for i, start in enumerate(starts):
            g = start + rows
            vals = np.where(((g >= 0) & (g < m))[:, None],
                            hb[np.clip(g, 0, m - 1)], 0.0)
            r = i * p + rows
            for j in range(8):       # 16-byte chunk j of row r at j ^ r % 8
                window[r, j ^ (r & 7)] = vals[:, 8 * j:8 * j + 8]
        pix = np.arange(m0, min(m0 + bm, m))
        py, px = pix % (h * w) // w, pix % w
        for tap in range(9):
            dy, dx = tap // 3 - 1, tap % 3 - 1
            r = (dy + 1) * s + (pix - m0) + 1 + dx
            got = np.concatenate([window[r, j ^ (r & 7)] for j in range(8)],
                                 axis=1)
            inside = ((py + dy >= 0) & (py + dy < h) & (px + dx >= 0)
                      & (px + dx < w))
            got = np.where(inside[:, None], got, 0.0)
            np.testing.assert_array_equal(got, want[pix, tap])


def test_bf16_l2_bytes_at_the_downscale_shape():
    # 36 clusters x 4 channel tiles read a 294,912-byte slab block each;
    # 288 blocks read two 136-row windows per 64-channel chunk.
    bm, bj, cluster = TILES[0]
    got = bf16_l2_bytes(9216, 128, 24, bm, bj, cluster)
    assert got == 36 * 4 * 294912 + 288 * 2 * 2 * 136 * 128


@pytest.mark.parametrize("f", [6, 40, 128])
def test_f32_packed_slab_gemm_is_the_conv_step(f):
    rng = np.random.RandomState(12)
    rk = torch.from_numpy((0.1 * rng.randn(3, 3, f, 4 * f)).astype(
        np.float32))
    h = torch.from_numpy(rng.randn(2, 5, 6, f).astype(np.float32))
    bj = F32_TILES[0][1]
    packed = pack_recurrent_kernel(rk, bj, F32_CHUNK)
    fp = -(-f // F32_CHUNK) * F32_CHUNK
    assert packed.shape == (-(-f // bj), 9 * fp, 4 * bj)
    assert packed.is_contiguous() and packed.dtype == torch.float32
    assert torch.equal(_unpack(packed, f), rk)
    want = torch.nn.functional.conv2d(
        h.permute(0, 3, 1, 2), rk.permute(3, 2, 0, 1), padding=1)
    # Sums of 9F products in another order than ATen's: at F = 128 their
    # magnitude reaches about 8, so the f32 rounding gap is relative.
    torch.testing.assert_close(_packed_step(h, packed, f),
                               want.permute(0, 2, 3, 1), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("shape,code,blocks", [
    ((16, 8, 8, 128), 1, 384),      # train_main: 32 x 4 tiles x 3 tap rows
    ((8, 8, 8, 128), 1, 192),       # one of its two ranks: 16 x 4 x 3
    ((2, 24, 24, 128), 1, 432),     # perceptual train_main: 36 x 4 x 3
    ((16, 24, 24, 128), 0, 576),    # downscale: 144 x 4, no split
])
def test_f32_tile_fills_the_card(shape, code, blocks):
    b, h, w, f = shape
    assert choose_tile_f32(b * h * w, f) == code
    assert f32_blocks(b * h * w, f, code) == blocks >= 132


def test_f32_tile_rule_splits_only_where_the_large_tile_leaves_sms_idle():
    assert F32_TILES == {0: (64, 32, 1), 1: (32, 32, 3)}
    assert choose_tile_f32(3 * 7 * 7, 40) == 1            # 30 blocks
    assert choose_tile_f32(16 * 8 * 8, 128, sms=64) == 0  # 64 blocks
    assert choose_tile_f32(16 * 8 * 8, 128, sms=65) == 1


def test_tap_row_partial_sums_add_up_to_the_step():
    # Split 3: rank r multiplies tap row dy = r - 1, rows [3r*Fp, 3(r+1)*Fp)
    # of the slab; rank 0 adds the partials as (p0 + p1) + p2.
    rng = np.random.RandomState(13)
    b, hh, ww, f = 2, 5, 7, 40
    rk = (0.1 * rng.randn(3, 3, f, 4 * f)).astype(np.float32)
    h = rng.randn(b, hh, ww, f).astype(np.float32)
    bj = F32_TILES[1][1]
    packed = pack_recurrent_kernel(torch.from_numpy(rk), bj,
                                   F32_CHUNK).numpy()
    nb, k9, n4 = packed.shape
    fp = k9 // 9
    hp = np.pad(h, ((0, 0), (1, 1), (1, 1), (0, fp - f)))
    parts = []
    for rank in range(3):
        cols = np.stack([hp[:, rank:rank + hh, dx:dx + ww]
                         for dx in range(3)], axis=3)
        rows = packed[:, 3 * rank * fp:3 * (rank + 1) * fp]
        parts.append(np.einsum("mk,bkn->mbn", cols.reshape(-1, 3 * fp),
                               rows))
    total = (parts[0] + parts[1]) + parts[2]
    got = total.reshape(-1, nb, 4, bj).transpose(0, 2, 1, 3).reshape(
        -1, 4, nb * bj)[:, :, :f].reshape(b, hh, ww, 4 * f)
    want = torch.nn.functional.conv2d(
        torch.from_numpy(h).permute(0, 3, 1, 2),
        torch.from_numpy(rk).permute(3, 2, 0, 1), padding=1)
    np.testing.assert_allclose(got, want.permute(0, 2, 3, 1).numpy(),
                               rtol=0, atol=1e-5)


def _jax_vjps(zx, rk, g, hard_sig):
    """(dzx, drk) from the fused TPU kernel's VJP and from the scan's."""
    r_act = hard_sigmoid if hard_sig else jax.nn.sigmoid
    f = rk.shape[2]
    _, fused_vjp = jax.vjp(
        lambda a, b: convlstm_seq_fused(a, b, hard_sig=hard_sig,
                                        interpret=True),
        jnp.asarray(zx), jnp.asarray(rk))
    _, scan_vjp = jax.vjp(
        lambda a, b: _convlstm_scan(a, b, f, r_act=r_act, unroll=1),
        jnp.asarray(zx), jnp.asarray(rk))
    return fused_vjp(jnp.asarray(g)), scan_vjp(jnp.asarray(g))


@pytest.mark.parametrize("route", ["wrapper", "function"])
@pytest.mark.parametrize("hard_sig", [True, False])
def test_gradients_match_jax_vjps(route, hard_sig):
    # The wrapper differentiates the plain version on the CPU; the
    # Function's backward replays convlstm_scan.  F = 128 so that the TPU
    # kernel takes the shape.
    zx, rk = _inputs(4, b=1, t=3, h=4, w=5, f=128)
    g = np.random.RandomState(5).randn(1, 3, 4, 5, 128).astype(np.float32)
    tzx = torch.from_numpy(zx).requires_grad_()
    trk = torch.from_numpy(rk).requires_grad_()
    if route == "wrapper":
        y = convlstm_seq(tzx, trk, hard_sig=hard_sig)
    else:
        y = ConvLSTMSeqFunction.apply(tzx, trk, hard_sig)
    dzx, drk = torch.autograd.grad(y, (tzx, trk), torch.from_numpy(g))
    for want_zx, want_rk in _jax_vjps(zx, rk, g, hard_sig):
        np.testing.assert_allclose(dzx.numpy(), np.asarray(want_zx),
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(drk.numpy(), np.asarray(want_rk),
                                   rtol=0, atol=1e-4)


def test_function_gives_only_the_gradients_asked_for():
    zx, rk = (torch.from_numpy(a) for a in _inputs(6, t=2, h=4, w=4, f=8))
    zx.requires_grad_()
    y = ConvLSTMSeqFunction.apply(zx, rk, True)
    dzx, = torch.autograd.grad(y.sum(), zx)
    ref = convlstm_scan(zx, rk)
    want, = torch.autograd.grad(ref.sum(), zx)
    torch.testing.assert_close(dzx, want, rtol=1e-5, atol=1e-6)


def test_second_differentiation_through_the_function_raises():
    zx, rk = (torch.from_numpy(a).requires_grad_()
              for a in _inputs(7, t=2, h=4, w=4, f=8))
    y = ConvLSTMSeqFunction.apply(zx, rk, True)
    dzx, = torch.autograd.grad(y.pow(2).sum(), zx, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dzx.sum().backward()


def test_no_grad_saves_nothing():
    zx, rk = (torch.from_numpy(a).requires_grad_()
              for a in _inputs(8, t=2, h=4, w=4, f=8))
    with torch.no_grad():
        y = ConvLSTMSeqFunction.apply(zx, rk, True)
    assert not y.requires_grad and y.grad_fn is None


@pytest.mark.parametrize("hard_sig", [True, False])
def test_scan_matches_jax_scan(hard_sig):
    zx, rk = _inputs(9, b=2, t=4, h=7, w=9, f=16)
    r_act = hard_sigmoid if hard_sig else jax.nn.sigmoid
    want = _convlstm_scan(jnp.asarray(zx), jnp.asarray(rk), 16,
                          r_act=r_act, unroll=1)
    got = convlstm_scan(torch.from_numpy(zx), torch.from_numpy(rk),
                        hard_sig=hard_sig)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_scan_gradcheck_and_double_backward():
    # f64 with the smooth sigmoid: hard_sigmoid has kinks.
    rng = np.random.RandomState(10)
    zx = torch.from_numpy(rng.randn(1, 3, 3, 3, 8)).requires_grad_()
    rk = torch.from_numpy(0.3 * rng.randn(3, 3, 2, 8)).requires_grad_()
    fn = lambda a, b: convlstm_scan(a, b, hard_sig=False)  # noqa: E731
    assert torch.autograd.gradcheck(fn, (zx, rk))
    assert torch.autograd.gradgradcheck(fn, (zx, rk))


@pytest.mark.gpu
def test_kernel_gradients_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel runs only on a card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # bf16 with the smooth sigmoid: with hard_sigmoid the replay's bf16
    # gates put single elements on the other side of a kink than the plain
    # version's f32 gates, which moves single gradient entries by O(1).
    cases = [((2, 4, 24, 24, 128), torch.bfloat16, False, 2.0 ** -5),
             ((2, 4, 12, 12, 40), torch.float32, True, 1e-4)]
    for i, ((b, t, h, w, f), dtype, hard, tol) in enumerate(cases):
        zx, rk = _inputs(20 + i, b, t, h, w, f)
        g = torch.from_numpy(
            np.random.RandomState(30 + i).randn(b, t, h, w, f).astype(
                np.float32)).to("cuda", dtype)
        grads = []
        for fn in (convlstm_seq, convlstm_seq_plain):
            a = torch.from_numpy(zx).to("cuda", dtype).requires_grad_()
            k = torch.from_numpy(rk).cuda().requires_grad_()
            before = convlstm_seq.launches
            y = fn(a, k, hard_sig=hard)
            assert (convlstm_seq.launches - before
                    == (t if fn is convlstm_seq else 0))
            grads.append(torch.autograd.grad(y, (a, k), g))
        torch.cuda.synchronize()
        for got, want in zip(*grads):
            scale = want.float().abs().max().item()
            err = (got.float() - want.float()).abs().max().item()
            assert err <= tol * max(scale, 1.0), (dtype, err, scale)

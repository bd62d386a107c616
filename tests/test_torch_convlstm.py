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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from windtpu.models.layers import _convlstm_scan, hard_sigmoid
from windtpu.ops.pallas_convlstm import convlstm_seq_fused
from windtpu_torch.models.layers import convlstm_scan
from windtpu_torch.ops.convlstm import (
    ConvLSTMSeqFunction,
    convlstm_seq,
    convlstm_seq_plain,
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
    cases = [((2, 4, 24, 24, 128), torch.bfloat16, True, 2.0 ** -5),
             ((2, 4, 24, 24, 128), torch.float32, True, 1e-4),
             ((3, 5, 7, 7, 40), torch.float32, False, 1e-4)]
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

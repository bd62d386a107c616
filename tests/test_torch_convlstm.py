"""The port's ConvLSTM recurrence (windtpu_torch/ops/convlstm.py) against
the JAX package's.

On the CPU the wrapper runs its plain version, which must reproduce the
JAX scan (windtpu/models/layers.py:_convlstm_scan) and the fused TPU
kernel (windtpu/ops/pallas_convlstm.py, run in interpret mode as
tests/test_pallas_convlstm.py runs it).  The CUDA kernel itself is held
against the plain version by the gpu-marked test, on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from windtpu.models.layers import _convlstm_scan, hard_sigmoid
from windtpu.ops.pallas_convlstm import convlstm_seq_fused
from windtpu_torch.ops.convlstm import convlstm_seq, convlstm_seq_plain

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

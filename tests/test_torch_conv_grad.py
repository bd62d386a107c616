"""windtpu_torch/ops/conv2d_grad.py: a convolution whose derivatives of every
order are the convolution's own fprop, dgrad and wgrad.

On the CPU: gradcheck and gradgradcheck in float64 at each geometry the
critic runs, gradients of order 1 and 2 against ``F.conv2d``'s in f32, the
aten calls the first and the double backward issue, the single
``F.conv2d`` with gradients off, and the critic's gradient-penalty loss
differentiated for every critic parameter against the same critic on
``F.conv2d``.  On a card (gpu-marked): the flagship-width critic's double
backward launches no ``implicit_convolve_sgemm``."""

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from windtpu_torch.core.config import ModelConfig
from windtpu_torch.models import layers as L
from windtpu_torch.models.discriminator import init_discriminator
from windtpu_torch.train.losses import gradient_penalty_from_grads

torch.set_num_threads(2)

# (kernel, strides, padding, in size): the critic's 3x3 SAME convs, its
# 7x7 stride-3 pyramid with padding 1, its 3x3 stride-2 VALID pyramid, the
# shortcut's 6x6 stride-11 conv with padding 4, and an asymmetric SAME
# (stride 2, 4x4 on 8 px: pads 1 and 2) through conv2d_nhwc's F.pad.
GEOMETRIES = {
    "same_3x3": (3, (1, 1), "SAME", 7),
    "pyramid_7x7_s3": (7, (3, 3), 1, 11),
    "valid_3x3_s2": (3, (2, 2), "VALID", 8),
    "shortcut_6x6_s11": (6, (11, 11), 4, 12),
    "asymmetric_same_4x4_s2": (4, (2, 2), "SAME", 8),
}


def plain_conv2d(monkeypatch):
    """conv2d_nhwc on F.conv2d whether or not autograd records."""
    monkeypatch.setattr(
        L.conv2d_grad, "conv2d",
        lambda x, w, stride, padding: F.conv2d(x, w, stride=stride,
                                               padding=padding))


def _inputs(geometry, dtype, seed=0, c_in=3, c_out=4):
    k, strides, padding, size = GEOMETRIES[geometry]
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, size, size, c_in, generator=g, dtype=dtype)
    w = torch.randn(k, k, c_in, c_out, generator=g, dtype=dtype) / k
    return x.requires_grad_(), w.requires_grad_(), strides, padding


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_gradcheck_and_gradgradcheck(geometry):
    x, w, strides, padding = _inputs(geometry, torch.float64)

    def fn(x, w):
        return L.conv2d_nhwc(x, w, strides, padding)

    # The NHWC result is a permuted view of the Function's output.
    conv_node = fn(x, w).grad_fn.next_functions[0][0]
    assert type(conv_node).__name__ == "_ConvBackward"
    assert torch.autograd.gradcheck(fn, (x, w))
    assert torch.autograd.gradgradcheck(fn, (x, w))


def _two_orders(x, w, strides, padding):
    """First-order gradients of a nonlinear loss, then the gradients of
    their squared norms: both orders for x and w."""
    y = torch.tanh(L.conv2d_nhwc(x, w, strides, padding))
    r = torch.linspace(-1, 1, y.numel(), dtype=y.dtype).reshape(y.shape)
    gx, gw = torch.autograd.grad((y * r).sum(), (x, w), create_graph=True)
    second = torch.autograd.grad((gx ** 2).sum() + (gw ** 2).sum(), (x, w))
    return [gx.detach(), gw.detach(), *second]


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_orders_one_and_two_equal_f_conv2d(geometry, monkeypatch):
    x, w, strides, padding = _inputs(geometry, torch.float32, seed=1)
    got = _two_orders(x, w, strides, padding)
    plain_conv2d(monkeypatch)
    want = _two_orders(x, w, strides, padding)
    for name, a, b in zip(("gx", "gw", "ggx", "ggw"), got, want):
        err = (a - b).abs().max() / b.abs().max()
        assert err <= 1e-5, (name, float(err))


class _ConvCalls(TorchDispatchMode):
    """The convolution ops dispatched inside, with their weight shapes and
    ``convolution_backward``'s output mask."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__
        if name.startswith("convolution"):
            mask = tuple(args[-1]) if "backward" in name else None
            self.calls.append((name.split(".")[0], tuple(args[1].shape),
                               mask))
        return func(*args, **(kwargs or {}))


def test_backward_passes_issue_fprop_dgrad_and_wgrad_only():
    # The penalty's pattern: the first backward for the image alone, with a
    # graph; the second for the weight through it.
    x = torch.randn(2, 12, 12, 3, requires_grad=True)
    w = torch.randn(3, 3, 3, 8, requires_grad=True)
    with _ConvCalls() as log:
        y = torch.tanh(L.conv2d_nhwc(x * 1.0, w * 1.0))
        gx, = torch.autograd.grad(y.sum(), x, create_graph=True)
        first = list(log.calls)
        del log.calls[:]
        torch.autograd.grad((gx ** 2).sum(), w)
        second = list(log.calls)
    nchw_x, oihw = (2, 3, 12, 12), (8, 3, 3, 3)
    assert first == [("convolution", oihw, None),
                     ("convolution_backward", nchw_x, (True, False, False))]
    # fprop of the image's gradient, and wgrads, against the 12x12-filter
    # fprop that aten::_convolution_double_backward would issue.
    assert sorted(second) == sorted([
        ("convolution", oihw, None),
        ("convolution_backward", nchw_x, (False, True, False)),
        ("convolution_backward", nchw_x, (False, True, False))])


def test_no_grad_is_one_f_conv2d():
    x = torch.randn(2, 12, 12, 3)
    w = torch.randn(3, 3, 3, 8, requires_grad=True)
    with torch.no_grad(), _ConvCalls() as log:
        y = L.conv2d_nhwc(x, w, (2, 2), "SAME")
    assert y.grad_fn is None
    assert [c[0] for c in log.calls] == ["convolution"]
    with _ConvCalls() as log:
        y = L.conv2d_nhwc(x, w.detach(), (2, 2), "SAME")
    assert y.grad_fn is None
    assert [c[0] for c in log.calls] == ["convolution"]


def _penalty_grads(critic, low, high, eps, fake):
    params = [p for _, p in critic.named_parameters()]
    mixed = (eps * high + (1 - eps) * fake).requires_grad_()
    scores = critic(low, mixed)
    g_img, = torch.autograd.grad(scores.sum(), mixed, create_graph=True)
    penalty, _ = gradient_penalty_from_grads(g_img, 100.0)
    loss = penalty + (critic(low, high) - critic(low, fake)).mean()
    return [g.detach() for g in torch.autograd.grad(loss, params)]


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_penalty_gradients_equal_the_plain_conv_critic(fused, monkeypatch):
    cfg = ModelConfig(image_size=24, in_channels=3, out_channels=2,
                      noise_channels=2, sequence_length=3,
                      generator_features=16, discriminator_features=4,
                      critic_fused_branches=fused)
    critic = init_discriminator(cfg, seed=7, device="cpu")
    g = torch.Generator().manual_seed(3)
    low = torch.randn(2, 3, 24, 24, 3, generator=g)
    high, fake = (torch.randn(2, 3, 24, 24, 2, generator=g) for _ in "ab")
    eps = torch.rand(2, 1, 1, 1, 1, generator=g)
    got = _penalty_grads(critic, low, high, eps, fake)
    plain_conv2d(monkeypatch)
    want = _penalty_grads(critic, low, high, eps, fake)
    names = [n for n, _ in critic.named_parameters()]
    assert len(got) == len(want) == len(names)
    for name, a, b in zip(names, got, want):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()),
                                   msg=name)


@pytest.mark.gpu
def test_flagship_critic_double_backward_avoids_legacy_gemm():
    """The penalty's double backward of the flagship-width critic in bf16
    at 96 px (T = 3) launches cuDNN's legacy implicit GEMM for no
    convolution at 96 px, where aten::_convolution_double_backward's
    96 x 96-filter weight terms ran on it.  The one conv that still picks
    it is pyr2's fprop on the 9 px map (128 -> 256, 7x7, stride 3), which
    cuDNN's own autotuner picks too."""
    if not torch.cuda.is_available():
        pytest.skip("cuDNN's kernels run only on a card")
    from torch.profiler import ProfilerActivity, profile

    cfg = ModelConfig(image_size=96, in_channels=3, out_channels=2,
                      noise_channels=20, sequence_length=3,
                      generator_features=128, discriminator_features=16,
                      discriminator_shortcut_min_iters=2,
                      compute_dtype="bfloat16")
    critic = init_discriminator(cfg, seed=0, device="cuda")
    params = list(critic.parameters())
    g = torch.Generator(device="cuda").manual_seed(0)
    low = torch.randn(8, 3, 96, 96, 3, generator=g, device="cuda")
    mixed = torch.randn(8, 3, 96, 96, 2, generator=g,
                        device="cuda").requires_grad_()

    def penalty():
        scores = critic(low, mixed, train=True)
        g_img, = torch.autograd.grad(scores.sum(), mixed, create_graph=True)
        return gradient_penalty_from_grads(g_img, 100.0)[0]

    torch.autograd.grad(penalty(), params, allow_unused=True)
    loss = penalty()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        torch.autograd.grad(loss, params, allow_unused=True)
        torch.cuda.synchronize()
    launched = [(k.name, e.name, e.input_shapes)
                for e in prof.events() for k in e.kernels]
    assert any("conv" in op for _, op, _ in launched)
    legacy = [(op, shapes) for name, op, shapes in launched
              if "implicit_convolve_sgemm" in name]
    assert all(shapes and shapes[0][2:] == [9, 9] for _, shapes in legacy), \
        legacy

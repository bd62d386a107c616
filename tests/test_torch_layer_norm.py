"""windtpu_torch/ops/layer_norm.py: LayerNorm over the last axis as three
autograd Functions (forward, backward, double backward), each a
hand-written CUDA kernel on a card and a plain stage on the CPU.

On the CPU: gradcheck and gradgradcheck of the Function chain in float64;
values and derivatives of orders 1 and 2 against ``F.layer_norm``'s in f32;
the gradients each backward computes; the no-grad path; the arguments it
refuses.  On a card (gpu-marked; skips where there is none): each kernel
against its plain stage at the flagship critic's 96 px map in bf16 and at
train_main's f32 widths, two runs bitwise equal, the launch counter, and a
captured and replayed CUDA graph equal to an eager call.  The gpu cases run
without JAX: ``python3 -m pytest --noconftest tests/test_torch_layer_norm.py``.
"""

import pytest
import torch
import torch.nn.functional as F

from windtpu_torch.models.layers import KerasLayerNorm
from windtpu_torch.ops import layer_norm as ln

torch.set_num_threads(2)

EPS = 1e-3
WIDTHS = (4, 16, 64, 256)


def _inputs(shape, dtype, seed=0, device="cpu", grad=True):
    g = torch.Generator().manual_seed(seed)
    n = shape[-1]
    x = 2.0 * torch.randn(shape, generator=g) + 0.5
    gamma = 1.0 + 0.3 * torch.randn(n, generator=g)
    beta = 0.3 * torch.randn(n, generator=g)
    out = [t.to(device=device, dtype=dtype) for t in (x, gamma, beta)]
    return [t.requires_grad_() for t in out] if grad else out


@pytest.mark.parametrize("n", WIDTHS)
def test_gradcheck_and_gradgradcheck(n):
    x, gamma, beta = _inputs((2, n), torch.float64)

    def fn(x, gamma, beta):
        return ln.layer_norm(x, gamma, beta, EPS)

    assert type(fn(x, gamma, beta).grad_fn).__name__ == "_LayerNormBackward"
    assert torch.autograd.gradcheck(fn, (x, gamma, beta))
    assert torch.autograd.gradgradcheck(fn, (x, gamma, beta))


def _orders(norm, x, gamma, beta):
    """Values, first derivatives (with a graph) of a nonlinear loss, and
    the gradients of their squared norms, for x, gamma and beta."""
    y = norm(x, gamma, beta)
    r = torch.linspace(-1, 1, y.numel(), dtype=y.dtype,
                       device=y.device).reshape(y.shape)
    first = torch.autograd.grad((torch.tanh(y) * r).sum(), (x, gamma, beta),
                                create_graph=True)
    second = torch.autograd.grad(sum((t ** 2).sum() for t in first),
                                 (x, gamma, beta))
    return [y.detach(), *(t.detach() for t in first), *second]


@pytest.mark.parametrize("n", WIDTHS)
def test_orders_zero_to_two_equal_f_layer_norm(n):
    x, gamma, beta = _inputs((3, 5, n), torch.float32, seed=n)
    got = _orders(lambda *a: ln.layer_norm(*a, EPS), x, gamma, beta)
    want = _orders(lambda x, g, b: F.layer_norm(x, (n,), g, b, eps=EPS),
                   x, gamma, beta)
    names = ("y", "dx", "dgamma", "dbeta", "ggx", "gggamma", "ggbeta")
    for name, a, b in zip(names, got, want):
        err = float((a - b).abs().max() / b.abs().max())
        assert err <= 2e-6, (name, err)


def test_second_order_of_the_gamma_and_beta_gradients():
    # Differentiating dgamma and dbeta exercises the double backward's
    # ggg and ggb inputs, which the gradient penalty never feeds.
    x, gamma, beta = _inputs((4, 6, 16), torch.float32, seed=3)
    want = []
    for norm in (lambda *a: ln.layer_norm(*a, EPS),
                 lambda x, g, b: F.layer_norm(x, (16,), g, b, eps=EPS)):
        y = norm(x, gamma, beta)
        dy = torch.sin(torch.arange(y.numel(), dtype=y.dtype)).reshape(
            y.shape).requires_grad_()
        dg, db = torch.autograd.grad(y, (gamma, beta), dy, create_graph=True)
        want.append(torch.autograd.grad(
            (dg ** 3).sum() + (db * dg).sum(), (x, dy)))
    for a, b in zip(*want):
        assert float((a - b).abs().max() / b.abs().max()) <= 2e-6


def test_keras_layer_norm_runs_the_function_chain():
    m = KerasLayerNorm(8)
    with torch.no_grad():
        m.ln.scale.copy_(torch.linspace(0.5, 1.5, 8))
        m.ln.bias.copy_(torch.linspace(-0.2, 0.2, 8))
    x = torch.randn(2, 3, 4, 4, 8, requires_grad=True)
    y = m(x)
    assert type(y.grad_fn).__name__ == "_LayerNormBackward"
    want = F.layer_norm(x, (8,), m.ln.scale, m.ln.bias, eps=EPS)
    torch.testing.assert_close(y, want, rtol=1e-6, atol=1e-6)
    # bf16 module: statistics in f32, the result rounded once to bf16.
    mb = KerasLayerNorm(8, dtype=torch.bfloat16)
    mb.load_state_dict(m.state_dict())
    yb = mb(x.detach())
    assert yb.dtype == torch.bfloat16
    torch.testing.assert_close(
        yb, F.layer_norm(x.detach().to(torch.bfloat16), (8,),
                         m.ln.scale.to(torch.bfloat16),
                         m.ln.bias.to(torch.bfloat16), eps=EPS),
        rtol=2 ** -7, atol=2 ** -7)


def test_backwards_compute_only_the_wanted_gradients(monkeypatch):
    calls = []
    plain_backward, plain_double = ln.backward_plain, ln.double_backward_plain

    def backward(*args):
        calls.append(("backward", args[-1]))
        return plain_backward(*args)

    def double_backward(*args):
        calls.append(("double", args[-1], args[5] is not None,
                      args[6] is not None, args[7] is not None))
        return plain_double(*args)

    monkeypatch.setattr(ln, "backward_plain", backward)
    monkeypatch.setattr(ln, "double_backward_plain", double_backward)
    # The penalty's pattern, gamma and beta cast as a bf16 critic casts
    # them: the first backward for the image alone, with a graph, then the
    # gradient of its norm for the parameters.
    scale = torch.randn(8, requires_grad=True)
    bias = torch.randn(8, requires_grad=True)
    image = torch.randn(2, 5, 8, requires_grad=True)
    y = ln.layer_norm(image * 1.0, scale * 1.0, bias * 1.0, EPS)
    g_img, = torch.autograd.grad(torch.tanh(y).sum(), image,
                                 create_graph=True)
    assert calls == [("backward", (True, False, False))]
    del calls[:]
    torch.autograd.grad((g_img ** 2).sum(), (scale, bias), allow_unused=True,
                        retain_graph=True)
    # ggx alone comes in.  The dy gradient flows on through tanh's backward
    # to y, and so to a first-order backward for scale and bias; the gamma
    # gradient goes to the scale; nothing of x's is asked for (image * 1.0
    # leads to no parameter).
    assert calls == [("double", (True, False, True), True, False, False),
                     ("backward", (False, True, True))]
    del calls[:]
    # A plain backward with no graph: all three, through no Function.
    torch.autograd.grad(torch.tanh(y).sum(), (image, scale, bias))
    assert calls == [("backward", (True, True, True))]


def test_no_grad_is_the_forward_stage_alone(monkeypatch):
    seen = []
    plain = ln.forward_plain
    monkeypatch.setattr(ln, "forward_plain",
                        lambda *a: seen.append(a) or plain(*a))
    x, gamma, beta = _inputs((3, 16), torch.float32, grad=False)
    y = ln.layer_norm(x, gamma, beta, EPS)
    assert y.grad_fn is None and len(seen) == 1
    gamma.requires_grad_()
    with torch.no_grad():
        assert ln.layer_norm(x, gamma, beta, EPS).grad_fn is None
    # A non-contiguous input is normalised as its contiguous copy.
    xt = torch.randn(16, 3).t()
    torch.testing.assert_close(ln.layer_norm(xt, gamma, beta, EPS),
                               F.layer_norm(xt, (16,), gamma, beta, eps=EPS))


def test_refuses_what_it_does_not_take():
    x, gamma, beta = _inputs((3, 16), torch.float32, grad=False)
    with pytest.raises(ValueError, match="gamma and beta"):
        ln.layer_norm(x, gamma[:8], beta, EPS)
    with pytest.raises(TypeError, match="one dtype"):
        ln.layer_norm(x, gamma.double(), beta, EPS)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ln.layer_norm(x.to("meta"), gamma.to("meta"), beta.to("meta"), EPS)
    # The kernels' own limits, checked before any launch.
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ln._width(x.half())
    with pytest.raises(ValueError, match="up to"):
        ln._width(torch.zeros(2, 130, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="up to"):
        ln._width(torch.zeros(2, 520, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="up to"):
        ln._width(torch.zeros(2, 260))
    assert ln._width(torch.zeros(2, 512, dtype=torch.bfloat16)) == 8
    assert ln._width(torch.zeros(2, 256)) == 4
    assert ln._width(torch.zeros(2, 12, dtype=torch.bfloat16)) == 1
    # A view that starts off a 16-byte boundary takes one element a vector.
    assert ln._width(torch.zeros(65)[1:].reshape(4, 16)) == 1


# -- on a card --------------------------------------------------------------

FLAGSHIP_MAP = (8, 24, 96, 96, 16)
# train_main's critic maps in f32 (32 px: 16, 64 and 128 channels), the
# flagship critic's pyramid maps in bf16 (64, 128 and 256 channels; its 16
# at 96 px above), the encoder's narrow widths, and rows whose width takes
# every other group of lanes, one-element vectors or two vectors a lane.
CARD_CASES = [((16, 6, 32, 32, 16), torch.float32),
              ((16, 6, 11, 11, 32), torch.float32),
              ((16, 6, 3, 3, 256), torch.float32),
              ((2, 24, 32, 32, 4), torch.bfloat16),
              ((2, 24, 11, 11, 8), torch.bfloat16),
              ((7, 13, 40), torch.bfloat16),
              ((5, 3, 3, 512), torch.bfloat16),
              ((37, 6), torch.float32),
              ((16, 6, 10, 10, 64), torch.float32),
              ((16, 6, 2, 2, 128), torch.float32),
              ((2, 24, 24, 24, 32), torch.bfloat16),
              ((8, 24, 31, 31, 64), torch.bfloat16),
              ((8, 24, 9, 9, 128), torch.bfloat16),
              ((8, 24, 2, 2, 256), torch.bfloat16)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("the layer-norm kernels run only on a card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _stage_inputs(shape, dtype, seed):
    x, gamma, beta = _inputs(shape, dtype, seed, device="cuda", grad=False)
    g = torch.Generator(device="cuda").manual_seed(seed)
    dy, ggx = (torch.randn(shape, generator=g, device="cuda").to(dtype)
               for _ in "ab")
    ggg, ggb = (torch.randn(shape[-1], generator=g, device="cuda").to(dtype)
                for _ in "ab")
    return x, gamma, beta, dy, ggx, ggg, ggb


def _all_stages(x, gamma, beta, dy, ggx, ggg, ggb, plain=False):
    """Every output of the three stages, kernels or (``plain``) the plain
    stages on the same card tensors."""
    want = (True, True, True)
    if plain:
        y, mean, rstd = ln.forward_plain(x, gamma, beta, EPS)
        first = ln.backward_plain(dy, x, gamma, mean, rstd, want)
        second = ln.double_backward_plain(dy, x, gamma, mean, rstd, ggx, ggg,
                                          ggb, want)
        penalty = ln.double_backward_plain(dy, x, gamma, mean, rstd, ggx,
                                           None, None, want)
    else:
        y, mean, rstd = ln._forward(x, gamma, beta, EPS, stats=True)
        first = ln._backward(dy, x, gamma, mean, rstd, want)
        second = ln._double_backward(dy, x, gamma, mean, rstd, ggx, ggg, ggb,
                                     want)
        penalty = ln._double_backward(dy, x, gamma, mean, rstd, ggx, None,
                                      None, want)
    return [y, mean, rstd, *first, *second, *penalty]


NAMES = ("y", "mean", "rstd", "dx", "dgamma", "dbeta", "gdy", "gx", "ggamma",
         "gdy (ggx only)", "gx (ggx only)", "ggamma (ggx only)")


def _hold(got, want, dtype):
    """Each output against the plain stage's.  Both round the same f32
    arithmetic, summed in another order, once to the output's dtype: a bf16
    output within one bf16 step (2^-7 of its value), an f32 one (and the f32
    statistics) within 2e-5; and within 2e-5 of the output's largest value,
    for entries left small by cancellation."""
    for name, a, b in zip(NAMES, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        rtol = 2 ** -7 if a.dtype == torch.bfloat16 else 2e-5
        a, b = a.float(), b.float()
        torch.testing.assert_close(a, b, rtol=rtol,
                                   atol=2e-5 * float(b.abs().max()),
                                   msg=name)


@pytest.mark.gpu
def test_kernels_equal_plain_stages_at_the_flagship_map():
    _card()
    inputs = _stage_inputs(FLAGSHIP_MAP, torch.bfloat16, seed=1)
    got = _all_stages(*inputs)
    want = _all_stages(*inputs, plain=True)
    torch.cuda.synchronize()
    _hold(got, want, torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", CARD_CASES,
                         ids=[f"{'x'.join(map(str, s))}-{str(d)[6:]}"
                              for s, d in CARD_CASES])
def test_kernels_equal_plain_stages(shape, dtype):
    _card()
    inputs = _stage_inputs(shape, dtype, seed=2)
    _hold(_all_stages(*inputs), _all_stages(*inputs, plain=True), dtype)


@pytest.mark.gpu
def test_two_runs_bitwise_equal_and_launches_counted():
    _card()
    inputs = _stage_inputs(FLAGSHIP_MAP, torch.bfloat16, seed=3)
    ln.layer_norm.launches = 0
    first = _all_stages(*inputs)
    # forward 1, backward 2 (with the gamma and beta sums), double backward
    # 2, the penalty's double backward 2.
    assert ln.layer_norm.launches == 7
    again = _all_stages(*inputs)
    torch.cuda.synchronize()
    for name, a, b in zip(NAMES, first, again):
        assert torch.equal(a, b), name


@pytest.mark.gpu
def test_captured_graph_replays_an_eager_call():
    _card()
    x0, gamma0, beta, dy, *_ = _stage_inputs((8, 24, 24, 24, 32),
                                             torch.bfloat16, seed=4)

    def penalty_pattern():
        # Leaves made anew on each call's stream, as the step's are.
        x = x0.detach().requires_grad_()
        gamma = gamma0.detach().requires_grad_()
        y = ln.layer_norm(x, gamma, beta, EPS)
        gx, = torch.autograd.grad(y, x, dy, create_graph=True)
        return [y, gx, *torch.autograd.grad((gx.float() ** 2).sum(),
                                            (x, gamma))]

    eager = penalty_pattern()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        penalty_pattern()   # a warm-up off the capture, as the step does
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    ln.layer_norm.launches = 0
    with torch.cuda.graph(graph, stream=stream):
        static = penalty_pattern()
    assert ln.layer_norm.launches == 0
    graph.replay()
    torch.cuda.synchronize()
    assert ln.layer_norm.launches == 0
    for a, b in zip(static, eager):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_orders_one_and_two_on_the_card_equal_f_layer_norm():
    """Against ``F.layer_norm`` in float64: over these 24,576 rows the
    per-channel sums in f32 move with their order, ATen's own f32 by up to
    3e-4 of the largest value from float64 (measured on the CPU), the plain
    stages' by under 1e-5."""
    _card()
    x, gamma, beta = _inputs((4, 6, 32, 32, 16), torch.float32, seed=5,
                             device="cuda")
    got = _orders(lambda *a: ln.layer_norm(*a, EPS), x, gamma, beta)
    want = _orders(lambda x, g, b: F.layer_norm(x, (16,), g, b, eps=EPS),
                   *(t.detach().double().requires_grad_()
                     for t in (x, gamma, beta)))
    names = ("y", "dx", "dgamma", "dbeta", "ggx", "gggamma", "ggbeta")
    for name, a, b in zip(names, got, want):
        err = float((a.double() - b).abs().max() / b.abs().max())
        assert err <= 5e-5, (name, err)

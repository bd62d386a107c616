"""A 2-D convolution whose every derivative, of any order, is the
convolution's own forward (fprop), input gradient (dgrad) or weight
gradient (wgrad).

PyTorch differentiates a convolution's backward with
``aten::_convolution_double_backward``, which takes the weight's term as a
forward convolution with batch and channels swapped and the output gradient
as the filter: at the critic's 96 px fields, a 96 x 96 filter with a 3 x 3
output, for which cuDNN has only its legacy implicit GEMM, off the tensor
cores.  Here the convolution and its two gradients are three autograd
Functions whose backwards are built from the same three, so the gradient
penalty's double backward runs on the kernels a first backward runs
(the construction of StyleGAN2-ADA's R1 penalty,
``torch_utils/ops/conv2d_gradfix.py``).  The arithmetic is the same; only
the algorithm cuDNN picks changes.

NCHW views, groups 1, dilation 1, symmetric integer padding; the caller
pads asymmetrically and adds the bias.  A backward computes only the
gradients its backward pass will use: the penalty's first backward, taken
for the image alone, runs no wgrad, as PyTorch's own convolution backward
does not.  A backward that records no graph calls the aten ops itself,
both gradients in one ``convolution_backward`` as PyTorch's does: the
Functions' Python cost is paid only where a graph is built.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.autograd import Function

Pair = Tuple[int, int]


def _conv(x: torch.Tensor, w: torch.Tensor, g) -> torch.Tensor:
    """conv(x, w): through :class:`_Conv` while a graph is recorded (a
    backward with ``create_graph``), else the plain call."""
    if torch.is_grad_enabled():
        return _Conv.apply(x, w, *g)
    return F.conv2d(x, w, stride=g[0], padding=g[1])


def _grads(gy: torch.Tensor, x: torch.Tensor, w: torch.Tensor, g,
           want_x: bool, want_w: bool):
    """(gx, gw) of conv(x, w) for the output gradient ``gy``, each None
    where not wanted: dgrad and wgrad through their Functions while a graph
    is recorded, else one ``aten.convolution_backward`` call.  A dgrad
    reads only the shape and layout of ``x``, a wgrad only those of ``w``."""
    if torch.is_grad_enabled():
        return (_ConvGradInput.apply(gy, w, x.detach(), *g) if want_x
                else None,
                _ConvGradWeight.apply(gy, x, w.detach(), *g) if want_w
                else None)
    if not (want_x or want_w):
        return None, None
    gx, gw, _ = torch.ops.aten.convolution_backward(
        gy, x, w, None, g[0], g[1], (1, 1), False, (0, 0), 1,
        (want_x, want_w, False))
    return gx, gw


def _wanted(ctx, i: int) -> bool:
    """Whether the running backward pass uses the gradient of the Function's
    input ``i`` (its tensor inputs come first, so ``next_functions`` and
    ``needs_input_grad`` share indices).  The engine cannot say it for a
    leaf's accumulator under ``autograd.grad``, as for a gradient handed in
    as a leaf (``gradgradcheck`` does): a leaf's gradient is computed."""
    if not ctx.needs_input_grad[i]:
        return False
    node = ctx.next_functions[i][0]
    if node is None:
        return False
    return (type(node).__name__ == "AccumulateGrad"
            or torch._C._will_engine_execute_node(node))


class _Conv(Function):
    """y = conv(x, w)."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.geometry = stride, padding
        return F.conv2d(x, w, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        return (*_grads(gy, x, w, ctx.geometry, _wanted(ctx, 0),
                        _wanted(ctx, 1)), None, None)


class _ConvGradInput(Function):
    """gx = dgrad(gy, w), bilinear: <ggx, gx> = <conv(ggx, w), gy>."""

    @staticmethod
    def forward(ctx, gy, w, x_like, stride, padding):
        ctx.save_for_backward(gy, w)
        ctx.geometry = stride, padding
        return _grads(gy, x_like, w, ctx.geometry, True, False)[0]

    @staticmethod
    def backward(ctx, ggx):
        gy, w = ctx.saved_tensors
        g = ctx.geometry
        g_gy = _conv(ggx, w, g) if _wanted(ctx, 0) else None
        g_w = _grads(gy, ggx, w, g, False, _wanted(ctx, 1))[1]
        return g_gy, g_w, None, None, None


class _ConvGradWeight(Function):
    """gw = wgrad(gy, x), bilinear: <ggw, gw> = <conv(x, ggw), gy>."""

    @staticmethod
    def forward(ctx, gy, x, w_like, stride, padding):
        ctx.save_for_backward(gy, x)
        ctx.geometry = stride, padding
        return _grads(gy, x, w_like, ctx.geometry, False, True)[1]

    @staticmethod
    def backward(ctx, ggw):
        gy, x = ctx.saved_tensors
        g = ctx.geometry
        g_gy = _conv(x, ggw, g) if _wanted(ctx, 0) else None
        g_x = _grads(gy, x, ggw, g, _wanted(ctx, 1), False)[0]
        return g_gy, g_x, None, None, None


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: Pair,
           padding: Pair) -> torch.Tensor:
    """``F.conv2d(x, w, stride=stride, padding=padding)`` (NCHW x, OIHW w),
    differentiable any number of times on fprop, dgrad and wgrad."""
    return _Conv.apply(x, w, tuple(stride), tuple(padding))

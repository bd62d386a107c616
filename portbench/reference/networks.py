"""The generator and the critic of the wind-downscaling GAN as plain
functions of a parameter dict and a state dict (spectral-norm ``u``,
BatchNorm running statistics), keyed by the names the published flax
model uses (``down1.kernel``, ``bn1.bn.mean``, ``convlstm.recurrent_kernel``,
``pyr1_conv_96.sn.u``, ...).

Each forward returns its output and the state entries it moved (only in
training).  Shapes follow the published model (reference ``gan/models.py``):

generator  concat(img, noise) -> SN conv 8x8/2 (pad 3), BN -> SN conv 4x4/2
           (pad 1), BN -> ConvLSTM(F) -> SN conv 3x3, BN -> concat ->
           SN convT 2x2/2, BN -> concat -> bilinear x2 -> convT 5x5 (F/8
           wide; a plain 3x3 conv when F/8 < outputs) -> BN -> conv 3x3.
critic     ConvLSTM over the high-res field and over [low, high]; each
           SN conv 3x3 + LN; concat; pyramids of SN conv 7x7/3 (pad 1) +
           LN while the size is >= 16, then >= 4 (plus a strided shortcut
           when the second ran twice or more), SN conv 3x3/2 + LN while
           > 2; dense per time step, mean over time.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from portbench.reference import layers as L
from portbench.reference.layers import Precision, State

Params = Dict[str, torch.Tensor]


def generator(p: Params, s: State, image, noise, prec: Precision,
              train: bool = False) -> Tuple[torch.Tensor, State]:
    new: State = {}
    x = torch.cat([image, noise], dim=-1).to(prec.dtype)
    res_2 = L.batch_norm(
        L.time_conv(x, p, s, "down1", prec, new, train, (2, 2), 3),
        p, s, "bn1", prec, new, train)
    res_4 = L.batch_norm(
        L.time_conv(res_2, p, s, "down2", prec, new, train, (2, 2), 1),
        p, s, "bn2", prec, new, train)
    x = L.convlstm(res_4, p, "convlstm", prec)
    x = L.batch_norm(L.time_conv(x, p, s, "mid", prec, new, train),
                     p, s, "bn3", prec, new, train)
    x = torch.cat([x, res_4], dim=-1)
    x = L.batch_norm(L.time_conv_transpose(x, p, s, "up1", prec, new, train,
                                           (2, 2), "VALID", sn=True),
                     p, s, "bn4", prec, new, train)
    x = L.bilinear_up2(torch.cat([x, res_2], dim=-1))
    if "up2.conv.kernel" in p:
        x = L.time_conv_transpose(x, p, s, "up2", prec, new, train, (1, 1),
                                  "SAME")
    else:
        x = L.time_conv(x, p, s, "up2_conv", prec, new, train, sn=False)
    x = L.batch_norm(x, p, s, "bn5", prec, new, train)
    out = L.time_conv(x, p, s, "out", prec, new, train, sn=False, act=False)
    return out.float(), new


def pyramid_sizes(size: int):
    """(stage1, stage2, stage3, last): each stage a list of (in, out)
    spatial sizes of the critic's three conv pyramids."""
    def step(n, k, st, pad):
        out = (n + 2 * pad - k) // st + 1
        if out <= 0:
            raise ValueError(f"critic pyramid collapses at {n} px")
        return out

    stages = [[], [], []]
    while size >= 16:
        stages[0].append((size, step(size, 7, 3, 1)))
        size = stages[0][-1][1]
    while size >= 4:
        stages[1].append((size, step(size, 7, 3, 1)))
        size = stages[1][-1][1]
    while size > 2:
        stages[2].append((size, (size - 3) // 2 + 1))
        size = stages[2][-1][1]
    return stages[0], stages[1], stages[2], size


def shortcut_geometry(in_size: int, target: int) -> Tuple[int, int]:
    """(stride, padding) of the strided conv that maps the first pyramid's
    output (``in_size`` px) onto the second's (``target`` px)."""
    if target == 1:
        return 1, 0
    stride = -(-(2 + in_size) // (target - 1))
    return stride, -(-(stride * (target - 1) - in_size) // 2) + 3


def critic(p: Params, s: State, low_res, high_res, prec: Precision,
           train: bool = False, shortcut_min_iters: int = 2
           ) -> Tuple[torch.Tensor, State]:
    new: State = {}
    low = low_res.to(prec.dtype)
    high = high_res.to(prec.dtype)
    hr = L.convlstm(high, p, "hr_convlstm", prec)
    mix = L.convlstm(torch.cat([low, high], dim=-1), p, "mix_convlstm", prec)
    hr = L.layer_norm(L.time_conv(hr, p, s, "hr_conv", prec, new, train),
                      p, "hr_ln", prec)
    mix = L.layer_norm(L.time_conv(mix, p, s, "mix_conv", prec, new, train),
                       p, "mix_ln", prec)
    x = torch.cat([hr, mix], dim=-1)
    st1, st2, st3, _ = pyramid_sizes(high.shape[2])
    for size, _ in st1:
        x = L.layer_norm(L.time_conv(x, p, s, f"pyr1_conv_{size}", prec, new,
                                     train, (3, 3), 1),
                         p, f"pyr1_ln_{size}", prec)
    shortcut = x
    for size, _ in st2:
        x = L.layer_norm(L.time_conv(x, p, s, f"pyr2_conv_{size}", prec, new,
                                     train, (3, 3), 1),
                         p, f"pyr2_ln_{size}", prec)
    if len(st2) >= shortcut_min_iters:
        stride, pad = shortcut_geometry(shortcut.shape[2], x.shape[2])
        x = x + L.layer_norm(
            L.time_conv(shortcut, p, s, "shortcut.conv", prec, new, train,
                        (stride, stride), pad), p, "shortcut.norm", prec)
    for size, _ in st3:
        x = L.layer_norm(L.time_conv(x, p, s, f"pyr3_conv_{size}", prec, new,
                                     train, (2, 2), "VALID"),
                         p, f"pyr3_ln_{size}", prec)
    b, t = x.shape[:2]
    w = prec.operand(p["score_dense.dense.kernel"])
    score = prec.operand(x.reshape(b, t, -1)) @ w \
        + p["score_dense.dense.bias"].to(prec.dtype)
    return score.mean(dim=1).float(), new

"""Names and shapes of the published networks' variables, from the widths
of a configuration: ``(params, state)``, each a dict name -> shape.  The
state holds the spectral-norm ``u`` vectors and the BatchNorm running
statistics.  Kernels are HWIO."""

from __future__ import annotations

from typing import Dict, Tuple

from portbench.reference.networks import pyramid_sizes, shortcut_geometry

Shapes = Dict[str, Tuple[int, ...]]


def _conv(p: Shapes, s: Shapes, name, kh, kw, cin, cout, sn=True,
          u_size=None):
    if sn:
        p[f"{name}.kernel"] = (kh, kw, cin, cout)
        p[f"{name}.bias"] = (cout,)
        s[f"{name}.sn.u"] = (u_size or cout,)
    else:
        p[f"{name}.conv.kernel"] = (kh, kw, cin, cout)
        p[f"{name}.conv.bias"] = (cout,)


def _bn(p, s, name, c):
    p[f"{name}.bn.scale"] = p[f"{name}.bn.bias"] = (c,)
    s[f"{name}.bn.mean"] = s[f"{name}.bn.var"] = (c,)


def _ln(p, name, c):
    p[f"{name}.ln.scale"] = p[f"{name}.ln.bias"] = (c,)


def _convlstm(p, name, cin, f):
    p[f"{name}.input_conv.kernel"] = (3, 3, cin, 4 * f)
    p[f"{name}.input_conv.bias"] = (4 * f,)
    p[f"{name}.recurrent_kernel"] = (3, 3, f, 4 * f)
    p[f"{name}.forget_bias"] = (f,)


def generator(in_channels: int, noise_channels: int, out_channels: int,
              features: int):
    p: Shapes = {}
    s: Shapes = {}
    f = features
    total = in_channels + noise_channels
    inter = min(8 * total, f)
    _conv(p, s, "down1", 8, 8, total, inter)
    _bn(p, s, "bn1", inter)
    _conv(p, s, "down2", 4, 4, inter, f)
    _bn(p, s, "bn2", f)
    _convlstm(p, "convlstm", f, f)
    _conv(p, s, "mid", 3, 3, f, f // 2)
    _bn(p, s, "bn3", f // 2)
    _conv(p, s, "up1", 2, 2, f // 2 + f, f // 4, u_size=f // 2 + f)
    _bn(p, s, "bn4", f // 4)
    if f // 8 >= out_channels:
        head = f // 8
        _conv(p, s, "up2", 5, 5, f // 4 + inter, head, sn=False)
    else:
        head = out_channels
        _conv(p, s, "up2_conv", 3, 3, f // 4 + inter, head, sn=False)
    _bn(p, s, "bn5", head)
    _conv(p, s, "out", 3, 3, head, out_channels, sn=False)
    return p, s


def critic(in_channels: int, out_channels: int, features: int,
           image_size: int, shortcut_min_iters: int = 2):
    p: Shapes = {}
    s: Shapes = {}
    f = features
    _convlstm(p, "hr_convlstm", out_channels, out_channels)
    _convlstm(p, "mix_convlstm", in_channels + out_channels, f)
    _conv(p, s, "hr_conv", 3, 3, out_channels, f)
    _ln(p, "hr_ln", f)
    _conv(p, s, "mix_conv", 3, 3, f, f)
    _ln(p, "mix_ln", f)
    st1, st2, st3, last = pyramid_sizes(image_size)
    ch = 2 * f
    for prefix, stage, k in (("pyr1", st1, 7), ("pyr2", st2, 7),
                             ("pyr3", st3, 3)):
        if prefix == "pyr2":
            sc_in, sc_size = ch, (st1[-1][1] if st1 else image_size)
        for size, _ in stage:
            _conv(p, s, f"{prefix}_conv_{size}", k, k, ch, 2 * ch)
            _ln(p, f"{prefix}_ln_{size}", 2 * ch)
            ch *= 2
        if prefix == "pyr2" and len(st2) >= shortcut_min_iters:
            target = st2[-1][1]
            stride, pad = shortcut_geometry(sc_size, target)
            k_sc = (sc_size if target == 1
                    else stride * (1 - target) + sc_size + 2 * pad)
            _conv(p, s, "shortcut.conv", k_sc, k_sc, sc_in, ch)
            _ln(p, "shortcut.norm", ch)
    p["score_dense.dense.kernel"] = (last * last * ch, 1)
    p["score_dense.dense.bias"] = (1,)
    return p, s

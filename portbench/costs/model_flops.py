"""Model FLOPs of a configuration's unit of work, counted once by
``torch.utils.flop_counter.FlopCounterMode`` over the plain reference on
meta tensors (shapes only, nothing computed): convolutions and matrix
products, forward and backward, the gradient penalty's double backward
included.  The counts are stored in the configuration's file
(``model_flops``); ``python3 -m portbench.costs.model_flops <config>``
prints them again.

- ``downscale_day``: the generator forwards of one day over the
  configuration's domain: its patch groups of ``group_size`` patches.
- ``train_step``: one WGAN-GP step on the global batch (the configuration's
  ``train.batch_size``).
"""

from __future__ import annotations

import json
import math
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.harness import BENCH
from portbench.reference import downscale as RD
from portbench.reference import networks as N
from portbench.reference import params as RP
from portbench.reference import wgan_gp as RW
from portbench.reference.layers import FP32

META = torch.device("meta")


def _tensors(shapes, grad=False):
    return {k: torch.empty(v, device=META, requires_grad=grad)
            for k, v in shapes.items()}


def _generator_shapes(m):
    return RP.generator(m["in_channels"], m["noise_channels"],
                        m["out_channels"], m["generator_features"])


def downscale_day(config: dict) -> int:
    m, inf = config["model"], config["inference"]
    dom = inf["domain"]
    h, w = RD.UP_LAT * dom["era5_lat"], RD.UP_LON * dom["era5_lon"]
    patches = len(RD.plan(h, w, dom["hours"], m["image_size"],
                          m["sequence_length"], inf["overlap_factor"]))
    groups = math.ceil(patches / inf["group_size"])
    p, s = (_tensors(x) for x in _generator_shapes(m))
    shape = (inf["group_size"], m["sequence_length"], m["image_size"],
             m["image_size"])
    x = torch.empty(shape + (m["in_channels"],), device=META)
    z = torch.empty(shape + (m["noise_channels"],), device=META)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        N.generator(p, s, x, z, FP32)
    return groups * counter.get_total_flops()


def train_step(config: dict) -> int:
    m, t = config["model"], config["train"]
    gp, gs = _generator_shapes(m)
    dp, ds = RP.critic(m["in_channels"], m["out_channels"],
                       m["discriminator_features"], m["image_size"])
    state = RW.new_state(_tensors(gp), _tensors(gs), _tensors(dp),
                         _tensors(ds))
    shape = (t["batch_size"], m["sequence_length"], m["image_size"],
             m["image_size"])
    low = torch.empty(shape + (m["in_channels"],), device=META)
    high = torch.empty(shape + (m["out_channels"],), device=META)

    def e(c):
        return torch.empty(shape + (c,), device=META)
    draws = {"critic": [{"noise": e(m["noise_channels"]),
                         "eps": torch.empty((shape[0], 1, 1, 1, 1),
                                            device=META),
                         "inst_real": e(m["out_channels"]),
                         "inst_fake": e(m["out_channels"])}
                        for _ in range(t["n_critic"])],
             "gen_noise": e(m["noise_channels"]),
             "eval_noise": e(m["noise_channels"])}
    hp = dict(n_critic=t["n_critic"], gp_weight=t["gp_weight"],
              noise_std=t["noise_std"], g_lr=t["g_learning_rate"],
              d_lr=t["d_learning_rate"], b1=t["adam_b1"], b2=t["adam_b2"],
              eps=t["adam_eps"])
    with FlopCounterMode(display=False) as counter:
        RW.step(state, low, high, draws, hp, FP32)
    return counter.get_total_flops()


def count(config: dict) -> dict:
    out = {}
    if "inference" in config:
        out["downscale_day"] = downscale_day(config)
    out["train_step"] = train_step(config)
    return out


if __name__ == "__main__":
    for name in sys.argv[1:]:
        cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
        print(name, json.dumps(count(cfg)))

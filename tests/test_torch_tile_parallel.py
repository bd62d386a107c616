"""Tile-parallel and ensemble x tile inference of the port
(windtpu_torch/infer/engine.py, api.predict on a mesh) with two real rank
processes joined by gloo on the CPU (tests/torch_ranks.py), against the
single-device port: the same output for the same seeds, noise included
(a rank skips the noise of the groups before its block), NaN cells alike.

Stand-in networks make the comparisons exact up to summation order, as in
the JAX package's tests/test_tile_parallel.py: the identity, a
noise-passthrough (any divergence in the per-group noise shows) and the
normalisation quirk; the identity cases are also held against JAX's
tile-parallel predictor on a 2-device mesh.  The ensemble x tile path at
ensemble 2, data 1 equals per-member runs.  ``api.downscale`` on a mesh
(auto) equals the single-device call, texture gate on, on every rank.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_ranks
from windtpu.core.config import InferenceConfig as JInferenceConfig
from windtpu.core.config import ModelConfig as JModelConfig
from windtpu.core.mesh import make_mesh as j_make_mesh
from windtpu.infer import engine as jengine
from windtpu.infer.tiling import plan_tiling as j_plan_tiling
from windtpu_torch import api as tapi
from windtpu_torch.core.config import (GANConfig, InferenceConfig,
                                       ModelConfig)
from windtpu_torch.infer import engine
from windtpu_torch.infer.tiling import plan_tiling
from windtpu_torch.io import dataset as tds
from windtpu_torch.models.texture_gate import load_gate_npz
from windtpu_torch.network import WindDownscalingGAN

torch.set_num_threads(2)

WORLD = 2
MODEL = dict(image_size=32, in_channels=3, noise_channels=2, out_channels=2,
             sequence_length=4, generator_features=16,
             discriminator_features=8)
INFER = dict(sequence_length=4, image_size=32, noise_channels=2,
             border_crop=2, group_size=2, overlap_factor=0.5,
             replicate_normalization_quirk=False)
NETWORK = dict(image_size=16, sequence_length=3, generator_features=16)
# (name, field shape, field seed, stand-in, generator seeds, mesh, icfg).
CASES = [
    ("identity", (4, 64, 72, 3), 0, "identity", [0], "data", {}),
    ("noise", (4, 64, 72, 3), 7, "noise", [5], "data", {}),
    ("quirk", (4, 48, 48, 3), 3, "identity", [1], "data",
     {"replicate_normalization_quirk": True}),
    ("members_tile", (4, 64, 72, 3), 13, "noise", [21, 22], "data", {}),
    ("ensemble_tile", (4, 64, 72, 3), 11, "noise", [9, 10], "ensemble", {}),
]
STAND_INS = {"identity": lambda p, n: p[..., :2],
             "noise": lambda p, n: n[..., :2]}
# Summation order only: the statistics and the canvas summed per rank,
# then over ranks (the JAX package's test holds its psums to the same).
ATOL = 1e-5


def _field(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _network():
    net = WindDownscalingGAN(GANConfig(model=ModelConfig(**NETWORK)),
                             device="cpu")
    net.texture_gate = load_gate_npz(tapi.BUNDLED_GATE)
    return net


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = tmp_path_factory.mktemp("tile")
    np.savez(work / "inputs.npz", **{
        f"{name}/field": _field(shape, seed)
        for name, shape, seed, *_ in CASES})
    (work / "config.json").write_text(json.dumps(dict(
        model=MODEL, inference=INFER, network=NETWORK,
        cases=[dict(name=c[0], apply=c[3], seeds=c[4], mesh=c[5], icfg=c[6])
               for c in CASES])))
    procs = torch_ranks.launch("tile", WORLD, work)
    try:
        single = {}
        for name, shape, seed, apply, seeds, _, extra in CASES:
            icfg = dataclasses.replace(InferenceConfig(**INFER), **extra)
            plan = plan_tiling(*shape[1:3], shape[0], icfg.image_size,
                               icfg.sequence_length, icfg.overlap_factor)
            predictor = engine.make_tiled_predictor(
                ModelConfig(**MODEL), icfg, plan, STAND_INS[apply], "cpu")
            gens = [torch.Generator().manual_seed(s) for s in seeds]
            field = torch.from_numpy(_field(shape, seed))
            if name == "ensemble_tile":   # against one-member runs
                pred = torch.stack([predictor(field, g)[0] for g in gens])
                counts = predictor(field, gens[0])[1]
            else:
                pred, counts = predictor(field, gens if len(gens) > 1
                                         else gens[0])
            single[name] = (pred.numpy(), counts.numpy())
        net = _network()
        for members in (1, WORLD):
            res = tapi.downscale(*torch_ranks.era5_and_dem(tds),
                                 network=net, seed=3,
                                 ensemble_members=members, device="cpu")
            for var in ("u10", "v10"):
                single[f"downscale{members}/{var}"] = np.asarray(
                    res[var].values)
    finally:
        torch_ranks.finish(procs)
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in range(WORLD)]
    infos = [json.loads((work / f"rank{r}.json").read_text())
             for r in range(WORLD)]
    return single, ranks, infos


def _assert_close(got, want):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert (~np.isnan(want)).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL,
                               equal_nan=True)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_tile_parallel_equals_single_device(run, name):
    single, ranks, _ = run
    want, counts = single[name]
    for r in ranks:
        np.testing.assert_array_equal(r[f"{name}/counts"], counts)
        _assert_close(r[f"{name}/pred"], want)
    np.testing.assert_array_equal(ranks[1][f"{name}/pred"],
                                  ranks[0][f"{name}/pred"])
    if "noise" in [c[3] for c in CASES if c[0] == name]:
        # Distinct groups (and members) drew distinct noise.
        assert np.nanstd(want) > 0
        if want.ndim == 5:
            assert np.nanstd(want[0] - want[1]) > 0


@pytest.mark.parametrize("name", ["identity", "quirk"])
def test_tile_parallel_identity_matches_jax(run, name):
    _, ranks, _ = run
    _, shape, seed, _, _, _, extra = next(c for c in CASES if c[0] == name)
    icfg = dataclasses.replace(JInferenceConfig(**INFER), **extra)
    plan = j_plan_tiling(*shape[1:3], shape[0], icfg.image_size,
                         icfg.sequence_length, icfg.overlap_factor)
    mesh = j_make_mesh({"data": WORLD}, devices=jax.devices()[:WORLD])
    predictor = jengine.make_tile_parallel_predictor(
        JModelConfig(**MODEL), icfg, plan, mesh,
        apply_fn=lambda v, p, n: p[..., :2])
    want, counts = predictor({}, jnp.asarray(_field(shape, seed)),
                             jax.random.key(0))
    np.testing.assert_array_equal(ranks[0][f"{name}/counts"],
                                  np.asarray(counts))
    _assert_close(ranks[0][f"{name}/pred"], np.asarray(want))


@pytest.mark.parametrize("members", [1, WORLD])
def test_downscale_on_a_mesh_equals_single_device(run, members):
    single, ranks, infos = run
    for var in ("u10", "v10"):
        key = f"downscale{members}/{var}"
        for r in ranks:
            _assert_close(r[key], single[key])
        np.testing.assert_array_equal(ranks[1][key], ranks[0][key])
    want = ({"mode": "tile", "mesh_axes": {"data": WORLD},
             "ensemble_sharded": False} if members == 1 else
            {"mode": "ensemble", "mesh_axes": {"ensemble": WORLD},
             "ensemble_sharded": True})
    for info in infos:
        assert info[str(members)] == {**want, "n_devices": WORLD,
                                      "texture_gate": True}


def test_downscale_reuses_its_mesh(run):
    """Three downscale calls over the ranks make no process group: the
    inference meshes are made once, and an axis over every rank holds the
    world's group."""
    _, _, infos = run
    for info in infos:
        assert info["meshes"] == {"groups_made": 0, "reused": [True, True],
                                  "world_groups": [True, True, True]}


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_grouped_origins_pad_like_jax(n):
    for h, w, t, group in ((64, 72, 4, 2), (48, 48, 4, 3), (97, 203, 9, 16)):
        plan = plan_tiling(h, w, t, 32, 4, 0.5)
        jplan = j_plan_tiling(h, w, t, 32, 4, 0.5)
        got = engine._grouped_origins(plan, group, group_multiple=n)
        want = jengine._grouped_origins(jplan, group, group_multiple=n)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert got[0].shape[0] % n == 0

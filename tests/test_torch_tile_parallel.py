"""Tile-parallel and ensemble x tile inference of the port
(windtpu_torch/infer/engine.py, api.predict on a mesh) with two and with
four real rank processes joined by gloo on the CPU (tests/torch_ranks.py),
against the single-device port: the same output for the same seeds, noise
included (a rank skips the noise of the groups before its block), NaN
cells alike.

Stand-in networks make the comparisons exact up to summation order, as in
the JAX package's tests/test_tile_parallel.py: the identity, a
noise-passthrough (any divergence in the per-group noise shows) and the
normalisation quirk; the identity cases are also held against JAX's
tile-parallel predictor on a 2-device mesh.  The ensemble x tile path
equals per-member runs at ensemble 2, data 1, and at 4 ranks on data 2 x
ensemble 2 (the counterpart of the JAX package's data 2 x ensemble 4
test), where each rank runs only its member and its groups, the identity
equals JAX's combined predictor on a 2 x 2 mesh, and downscale_field
routes there too.  ``api.downscale`` on a mesh (auto) equals the
single-device call, texture gate on, on every rank; at 4 ranks with 1, 2
and 4 members (tile, ensemble+tile, ensemble), reporting JAX's run info on
the 2 x 2 mesh.
"""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

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
from windtpu_torch.weights import export_flax_variables

torch.set_num_threads(2)

WORLD = 2
MODEL = dict(image_size=32, in_channels=3, noise_channels=2, out_channels=2,
             sequence_length=4, generator_features=16,
             discriminator_features=8)
INFER = dict(sequence_length=4, image_size=32, noise_channels=2,
             border_crop=2, group_size=2, overlap_factor=0.5,
             replicate_normalization_quirk=False)
NETWORK = dict(image_size=16, sequence_length=3, generator_features=16)
# (name, field shape, field seed, stand-in, generator seeds, mesh, icfg),
# by world size.  Meshes: "data" and "ensemble" over every rank, "2x2"
# data 2 x ensemble 2 (the counterpart of the JAX package's data 2 x
# ensemble 4 test at the 4 ranks here).
CASES = {
    WORLD: [
        ("identity", (4, 64, 72, 3), 0, "identity", [0], "data", {}),
        ("noise", (4, 64, 72, 3), 7, "noise", [5], "data", {}),
        ("quirk", (4, 48, 48, 3), 3, "identity", [1], "data",
         {"replicate_normalization_quirk": True}),
        ("members_tile", (4, 64, 72, 3), 13, "noise", [21, 22], "data", {}),
        ("ensemble_tile", (4, 64, 72, 3), 11, "noise", [9, 10], "ensemble",
         {}),
    ],
    4: [
        ("noise", (4, 64, 72, 3), 7, "noise", [5], "data", {}),
        ("ensemble_tile", (4, 64, 72, 3), 11, "noise", [9, 10, 11, 12],
         "ensemble", {}),
        ("ensemble_tile_2x2", (4, 64, 72, 3), 11, "noise", [9, 10], "2x2",
         {}),
        ("identity_2x2", (4, 64, 72, 3), 0, "identity", [9, 10], "2x2", {}),
        ("downscale_field_2x2", (4, 64, 72, 3), 13, "noise", [21, 22], "2x2",
         {}),
    ],
}
# Cases run through engine.downscale_field rather than the predictor.
VIA_DOWNSCALE_FIELD = {"downscale_field_2x2"}
# api.downscale's member counts at each world size.
MEMBERS = {WORLD: [1, WORLD], 4: [1, 2, 4]}
CASE_PARAMS = [pytest.param(world, c[0], id=c[0] if world == WORLD
                            else f"{c[0]}@{world}")
               for world, cases in CASES.items() for c in cases]
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


def _case(world, name):
    return next(c for c in CASES[world] if c[0] == name)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the ranks of both worlds, compute the single-device runs here
    meanwhile, and collect (single, ranks, infos) by world size."""
    works, procs = {}, {}
    for world, cases in CASES.items():
        works[world] = work = tmp_path_factory.mktemp(f"tile{world}")
        np.savez(work / "inputs.npz", **{
            f"{name}/field": _field(shape, seed)
            for name, shape, seed, *_ in cases})
        (work / "config.json").write_text(json.dumps(dict(
            model=MODEL, inference=INFER, network=NETWORK,
            members=MEMBERS[world],
            cases=[dict(name=c[0], apply=c[3], seeds=c[4], mesh=c[5],
                        icfg=c[6], via="downscale_field"
                        if c[0] in VIA_DOWNSCALE_FIELD else "predictor")
                   for c in cases])))
        procs[world] = torch_ranks.launch("tile", world, work)
    try:
        single = {}
        for world, cases in CASES.items():
            single[world] = want = {}
            for name, shape, seed, apply, seeds, mesh, extra in cases:
                icfg = dataclasses.replace(InferenceConfig(**INFER), **extra)
                plan = plan_tiling(*shape[1:3], shape[0], icfg.image_size,
                                   icfg.sequence_length, icfg.overlap_factor)
                predictor = engine.make_tiled_predictor(
                    ModelConfig(**MODEL), icfg, plan, STAND_INS[apply],
                    "cpu")
                gens = [torch.Generator().manual_seed(s) for s in seeds]
                field = torch.from_numpy(_field(shape, seed))
                if mesh != "data":   # against one-member runs
                    pred = torch.stack([predictor(field, g)[0]
                                        for g in gens])
                    counts = predictor(field, gens[0])[1]
                else:
                    pred, counts = predictor(field, gens if len(gens) > 1
                                             else gens[0])
                want[name] = (pred.numpy(), counts.numpy())
        net = _network()
        downscaled = {}
        for members in sorted({m for ms in MEMBERS.values() for m in ms}):
            res = tapi.downscale(*torch_ranks.era5_and_dem(tds),
                                 network=net, seed=3,
                                 ensemble_members=members, device="cpu")
            for var in ("u10", "v10"):
                downscaled[f"downscale{members}/{var}"] = np.asarray(
                    res[var].values)
        for world in CASES:
            single[world].update(downscaled)
    finally:
        for world in procs:
            torch_ranks.finish(procs[world])
    return {world: (single[world],
                    [dict(np.load(work / f"rank{r}.npz"))
                     for r in range(world)],
                    [json.loads((work / f"rank{r}.json").read_text())
                     for r in range(world)])
            for world, work in works.items()}


@pytest.fixture(scope="module")
def run(runs):
    return runs[WORLD]


def _assert_close(got, want):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert (~np.isnan(want)).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL,
                               equal_nan=True)


@pytest.mark.parametrize("world,name", CASE_PARAMS)
def test_tile_parallel_equals_single_device(runs, world, name):
    single, ranks, _ = runs[world]
    want, counts = single[name]
    for r in ranks:
        if name not in VIA_DOWNSCALE_FIELD:
            np.testing.assert_array_equal(r[f"{name}/counts"], counts)
        _assert_close(r[f"{name}/pred"], want)
        np.testing.assert_array_equal(r[f"{name}/pred"],
                                      ranks[0][f"{name}/pred"])
    if _case(world, name)[3] == "noise":
        # Distinct groups (and members) drew distinct noise.
        assert np.nanstd(want) > 0
        if want.ndim == 5:
            assert np.nanstd(want[0] - want[1]) > 0


@pytest.mark.parametrize("name", ["identity", "quirk"])
def test_tile_parallel_identity_matches_jax(run, name):
    _, ranks, _ = run
    _, shape, seed, _, _, _, extra = _case(WORLD, name)
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


@pytest.mark.parametrize("world,members", [
    pytest.param(world, m, id=str(m) if world == WORLD else f"{m}@{world}")
    for world, ms in MEMBERS.items() for m in ms])
def test_downscale_on_a_mesh_equals_single_device(runs, world, members):
    single, ranks, infos = runs[world]
    for var in ("u10", "v10"):
        key = f"downscale{members}/{var}"
        for r in ranks:
            _assert_close(r[key], single[key])
            np.testing.assert_array_equal(r[key], ranks[0][key])
    want = ({"mode": "tile", "mesh_axes": {"data": world},
             "ensemble_sharded": False} if members == 1 else
            {"mode": "ensemble", "mesh_axes": {"ensemble": world},
             "ensemble_sharded": True} if members == world else
            # data 2 x ensemble 2: the combined predictor.
            {"mode": "ensemble+tile",
             "mesh_axes": {"data": world // members, "ensemble": members},
             "ensemble_sharded": True})
    # Every rank predicts the gate's energies on its own device.
    for info in infos:
        assert info[str(members)] == {**want, "n_devices": world,
                                      "texture_gate": True,
                                      "gate": "device"}


@pytest.mark.parametrize("world", sorted(CASES))
def test_downscale_reuses_its_mesh(runs, world):
    """Several downscale calls over the ranks make no process group: the
    inference meshes are made once (at 4 ranks data 2 x ensemble 2 is
    the mesh the ranks made before), and an axis over every rank holds
    the world's group."""
    _, _, infos = runs[world]
    for info in infos:
        assert info["meshes"] == {"groups_made": 0, "reused": [True, True],
                                  "world_groups": [True, True, True]}


@pytest.mark.parametrize("name,mesh_axes", [
    ("ensemble_tile", {"data": 1, "ensemble": 4}),
    ("ensemble_tile_2x2", {"data": 2, "ensemble": 2}),
    ("identity_2x2", {"data": 2, "ensemble": 2}),
    ("downscale_field_2x2", {"data": 2, "ensemble": 2})])
def test_ensemble_tile_at_four_ranks_splits_members_and_groups(runs, name,
                                                                mesh_axes):
    """The combined predictor (and downscale_field, which routes a mesh
    with an ensemble axis to it) gives each rank only its members and its
    block of patch groups: members x patches split over the whole mesh,
    none run twice, as the JAX package's combined shard_map does."""
    _, ranks, _ = runs[4]
    _, shape, _, _, seeds, _, extra = _case(4, name)
    icfg = dataclasses.replace(InferenceConfig(**INFER), **extra)
    plan = plan_tiling(*shape[1:3], shape[0], icfg.image_size,
                       icfg.sequence_length, icfg.overlap_factor)
    n_data, n_ens = mesh_axes["data"], mesh_axes["ensemble"]
    groups = engine._grouped_origins(plan, icfg.group_size, n_data)[0]
    want = (groups.shape[0] // n_data) * icfg.group_size * (
        len(seeds) // n_ens)
    assert [int(r[f"{name}/rows"]) for r in ranks] == [want] * 4


def test_ensemble_tile_identity_matches_jax_combined_predictor(runs):
    """The identity network through the port's combined predictor on data
    2 x ensemble 2 equals JAX's make_ensemble_tile_parallel_predictor on a
    2 x 2 mesh of virtual devices, member for member."""
    from windtpu.infer.engine import make_ensemble_tile_parallel_predictor

    _, ranks, _ = runs[4]
    _, shape, seed, _, seeds, _, extra = _case(4, "identity_2x2")
    icfg = dataclasses.replace(JInferenceConfig(**INFER), **extra)
    plan = j_plan_tiling(*shape[1:3], shape[0], icfg.image_size,
                         icfg.sequence_length, icfg.overlap_factor)
    mesh = j_make_mesh({"data": 2, "ensemble": 2},
                       devices=jax.devices()[:4])
    predictor = make_ensemble_tile_parallel_predictor(
        JModelConfig(**MODEL), icfg, plan, mesh,
        apply_fn=lambda v, p, n: p[..., :2])
    want, counts = predictor({}, jnp.asarray(_field(shape, seed)),
                             jax.random.split(jax.random.key(0),
                                              len(seeds)))
    assert want.sharding.spec[0] == "ensemble"
    for r in ranks:
        np.testing.assert_array_equal(r["identity_2x2/counts"],
                                      np.asarray(counts))
        _assert_close(r["identity_2x2/pred"], np.asarray(want))


def test_downscale_on_a_2x2_mesh_reports_jax_run_info(runs):
    """api.downscale of 2 members at 4 ranks runs on data 2 x ensemble 2
    through the combined predictor, and says so as the JAX package's
    api.downscale does on a 2 x 2 mesh of virtual devices."""
    from windtpu import api as japi
    from windtpu.core.config import GANConfig as JGANConfig
    from windtpu.io import dataset as jds

    _, _, infos = runs[4]
    # What JAX's predict reads of a network, the port's generator weights
    # in the flat flax layout (cheaper than tracing JAX's initializer).
    flat = export_flax_variables(_network().generator)
    network = types.SimpleNamespace(
        cfg=JGANConfig(model=JModelConfig(**NETWORK)), texture_gate=None,
        generator_variables=unflatten_dict(
            {k: jnp.asarray(v) for k, v in flat.items()}, sep="/"))
    mesh = japi.inference_mesh(2, devices=jax.devices()[:4])
    japi.downscale(*torch_ranks.era5_and_dem(jds), network=network,
                   ensemble_members=2, mesh=mesh)
    want = japi.last_run_info()
    assert want["mode"] == "ensemble+tile"
    for info in infos:
        for k in ("mode", "mesh_axes", "ensemble_sharded", "n_devices"):
            assert info["2"][k] == want[k], k


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

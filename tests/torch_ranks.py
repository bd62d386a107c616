"""Rank processes for the port's multi-process tests
(tests/test_torch_parallel.py, test_torch_tile_parallel.py,
test_torch_multiprocess.py).

``launch(scenario, world, workdir)`` starts ``world`` real processes of
this file, joined by gloo on the CPU over a ``free_tcp_port()``
rendezvous, each running one scenario function below with one thread;
``finish`` waits for them and returns their outputs.  The test process
writes a scenario's inputs to ``workdir/inputs.npz`` first and reads
``workdir/rank<r>.npz`` (and ``rank<r>.json``) back.  The rank processes
import torch and the port only, never JAX; importing this module imports
neither.

A run of ranks has TIMEOUT seconds from its launch: ``finish`` kills every
rank at that deadline, or as soon as one rank fails, and each rank ends
itself at the same limit (dumping its stacks), so a hung rendezvous or a
rank left waiting on a dead peer fails the test instead of holding it.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
# About ten times the slowest run of ranks seen (the 4-rank train step
# scenario, beside a JAX compile in the test process).
TIMEOUT = 300


def launch(scenario: str, world: int, workdir):
    from windtpu_torch.utils.hostcpu import free_tcp_port

    port = free_tcp_port()
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
           "CUDA_VISIBLE_DEVICES": ""}
    deadline = time.monotonic() + TIMEOUT
    procs = []
    for rank in range(world):
        log = open(Path(workdir) / f"rank{rank}.log", "w")
        p = subprocess.Popen(
            [sys.executable, __file__, scenario, str(rank), str(world),
             str(port), str(workdir)],
            stdout=log, stderr=subprocess.STDOUT, text=True, cwd=REPO,
            env=env)
        log.close()
        p.log, p.deadline = Path(log.name), deadline
        procs.append(p)
    return procs


def finish(procs):
    """Each rank's output; raises with it where a rank failed or the run
    outlived its deadline.  Every rank is stopped on return."""
    try:
        while any(p.poll() is None for p in procs):
            if (time.monotonic() > procs[0].deadline
                    or any(p.returncode not in (None, 0) for p in procs)):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = [p.log.read_text() for p in procs]
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {rank} of {len(procs)} failed "
                                 f"(exit {p.returncode}):\n{out[-4000:]}")
    return outs


def era5_and_dem(mod, nt=7, nlat=3, nlon=4, seed=1):
    """A tiny ERA5 day and DEM as ``mod.Dataset``s (``mod``: either
    package's ``io.dataset``), from ``seed``."""
    import numpy as np

    rng = np.random.RandomState(seed)
    dims = ("time", "latitude", "longitude")
    era5 = mod.Dataset(
        {"u10": mod.DataArray(dims, (3 + rng.standard_normal(
            (nt, nlat, nlon))).astype(np.float32)),
         "v10": mod.DataArray(dims, rng.standard_normal(
             (nt, nlat, nlon)).astype(np.float32))},
        {"time": mod.DataArray(("time",), np.arange(
            "2016-04-01T00", "2016-04-01T07", dtype="datetime64[h]")[:nt]),
         "latitude": mod.DataArray(("latitude",), np.linspace(46, 45, nlat)),
         "longitude": mod.DataArray(("longitude",), np.linspace(6, 7,
                                                                nlon))})
    x, y = np.linspace(5.9, 7.1, 60), np.linspace(46.1, 44.9, 50)
    dem = mod.Dataset(
        {"band_data": mod.DataArray(("band", "y", "x"), (1500 + 700 * (
            rng.standard_normal((1, 50, 60)))).astype(np.float32))},
        {"band": mod.DataArray(("band",), np.array([1])),
         "y": mod.DataArray(("y",), y), "x": mod.DataArray(("x",), x)})
    return era5, dem


# ---- scenarios (run in the rank processes) ---------------------------------

def _draws(inputs, prefix):
    """A StepDraws from ``inputs`` keys ``prefix/critic<i>/<field>``,
    ``prefix/gen_noise`` and ``prefix/eval_noise``."""
    import torch

    from windtpu_torch.train.wgan_gp import CriticDraws, StepDraws

    def t(key):
        return torch.from_numpy(inputs[f"{prefix}/{key}"])

    n_critic = len({k.split("/")[-2] for k in inputs
                    if k.startswith(prefix + "/critic")})
    return StepDraws(
        critic=[CriticDraws(*(t(f"critic{i}/{f}") for f in
                              ("noise", "eps", "inst_real", "inst_fake")))
                for i in range(n_critic)],
        gen_noise=t("gen_noise"), eval_noise=t("eval_noise"))


def parallel(rank, world, workdir):
    """The data-parallel train steps named in the config from the same
    state ("a": the shard_map step, "b": the global-batch step, "c": "b"
    with ``remat="save_scans"``, whose recompute all-reduces BatchNorm's
    sums again in the backward), and the mesh and collective rules, at
    ``world`` ranks; at 4 ranks also the 2-D mesh (``two_d_mesh``)."""
    import dataclasses

    import numpy as np
    import torch

    from windtpu_torch.core.config import GANConfig, ModelConfig, TrainConfig
    from windtpu_torch.core.mesh import make_mesh, psum, shard_batch
    from windtpu_torch.metrics.metrics import extreme_weighted_rmse
    from windtpu_torch.models.layers import TimeBatchNorm
    from windtpu_torch.parallel import make_sharded_train_step
    from windtpu_torch.parallel.distributed import (agree,
                                                    global_data_mesh,
                                                    replicate_to_mesh)
    from windtpu_torch.train.state import create_train_state
    from windtpu_torch.train.wgan_gp import make_train_step
    from windtpu_torch.weights import export_train_state, load_train_state

    inputs = dict(np.load(workdir / "inputs.npz"))
    kw = json.loads((workdir / "config.json").read_text())
    cfg = GANConfig(model=ModelConfig(**kw["model"]),
                    train=TrainConfig(**kw["train"]))
    flat = {k[len("state/"):]: v for k, v in inputs.items()
            if k.startswith("state/")}
    mesh = make_mesh({"data": world})
    out, checks = {}, {}
    remat = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, remat="save_scans", remat_gp=True))
    makers = {"a": lambda: make_sharded_train_step(cfg, mesh),
              "b": lambda: make_train_step(cfg, mesh=mesh),
              "c": lambda: make_train_step(remat, mesh=mesh)}
    for name in kw["names"]:
        step = makers[name]()
        state = load_train_state(create_train_state(cfg, device="cpu"), flat)
        for s in range(kw["steps"]):
            lr, hr = shard_batch(mesh, (inputs[f"lr/{s}"], inputs[f"hr/{s}"]))
            # "c" takes "b"'s draws.
            prefix = f"a/{s}/{rank}" if name == "a" else f"b/{s}"
            state, metrics = step(state, lr, hr,
                                  draws=_draws(inputs, prefix))
            for k, v in metrics.items():
                out[f"{name}_metrics/{s}/{k}"] = v.numpy()
        for k, v in export_train_state(state).items():
            out[f"{name}/{k}"] = v

    # Mesh rules and collectives.
    checks["meshes"] = {
        str(spec): [m.shape, list(m.coords or ())] for spec, m in [
            (None, make_mesh()), ({"data": -1}, make_mesh({"data": -1})),
            ({"data": 1, "ensemble": world},
             make_mesh({"data": 1, "ensemble": world})),
            ({"data": 1}, make_mesh({"data": 1}))]}
    checks["global_data_mesh"] = global_data_mesh(world).shape
    try:
        make_mesh({"data": world + 1})
    except ValueError as e:
        checks["too_big"] = str(e)
    x = torch.full((3,), float(rank))
    replicate_to_mesh(mesh, [x])
    checks["replicated"] = x.tolist()
    try:
        agree(7 + rank, "the seed")
    except RuntimeError as e:
        checks["seed_disagreement"] = str(e)
    checks["seed"] = agree(7, "the seed")
    v = torch.tensor(float(rank + 1), requires_grad=True)
    (psum(v, mesh.group("data")) * (rank + 1)).backward()
    checks["psum_grad"] = float(v.grad)

    # The extreme-weighted RMSE's global denominator and BatchNorm's
    # global statistics, on this rank's rows of one global batch.
    rng = np.random.default_rng(0)
    real = torch.from_numpy(rng.standard_normal((4, 2, 5, 5, 2),
                                                dtype=np.float32))
    fake = torch.from_numpy(rng.standard_normal((4, 2, 5, 5, 2),
                                                dtype=np.float32))
    out["rmse"] = extreme_weighted_rmse(
        *shard_batch(mesh, (real, fake)), group=mesh.group("data")).numpy()
    bn = TimeBatchNorm(3)
    with torch.no_grad():
        bn.bn.scale.fill_(1.5)
        bn.bn.bias.fill_(0.25)
        bn.bn.mean.zero_()
        bn.bn.var.fill_(1.0)
    xb = torch.from_numpy(2 + 3 * rng.standard_normal((4, 2, 5, 5, 3),
                                                      dtype=np.float32))
    xb = shard_batch(mesh, xb).clone().requires_grad_()
    y = bn(xb, train=True, group=mesh.group("data"))
    (y * torch.arange(1.0, 4.0)).sum().backward()
    out["bn_y"], out["bn_grad"] = y.detach().numpy(), xb.grad.numpy()
    out["bn_mean"], out["bn_var"] = bn.bn.mean.numpy(), bn.bn.var.numpy()
    if world == 4:
        checks["two_d_mesh"] = two_d_mesh(rank, out)
    np.savez(workdir / f"rank{rank}.npz", **out)
    (workdir / f"rank{rank}.json").write_text(json.dumps(checks))


def two_d_mesh(rank, out):
    """``make_mesh({"data": 2, "ensemble": 2})`` at 4 ranks: this rank's
    coordinates, the process groups made by the first and by a second
    call, and ``psum`` (with its gradient), ``pmean`` and ``all_reduce``
    over each axis's sub-group of a tensor that names the rank (into
    ``out``)."""
    import torch
    import torch.distributed as dist

    from windtpu_torch.core.mesh import all_reduce, make_mesh, pmean, psum

    axes = {"data": 2, "ensemble": 2}
    made = []
    new_group = dist.new_group
    dist.new_group = lambda *a, **k: made.append(a) or new_group(*a, **k)
    try:
        mesh = make_mesh(axes)
        first = len(made)
        again = make_mesh(dict(axes))
    finally:
        dist.new_group = new_group
    x = torch.tensor([rank + 1.0, 10.0 * (rank + 1) ** 2])
    grads = {}
    for axis in axes:
        group = mesh.group(axis)
        v = x.clone().requires_grad_()
        y = psum(v, group)
        (y * (rank + 1)).sum().backward()
        out[f"two_d/psum/{axis}"] = y.detach().numpy()
        out[f"two_d/pmean/{axis}"] = pmean([x], group)[0].numpy()
        out[f"two_d/all_reduce/{axis}"] = all_reduce(x.clone(),
                                                     group).numpy()
        grads[axis] = v.grad.tolist()
    return dict(coords=list(mesh.coords), groups_made=first,
                groups_made_again=len(made) - first, reused=again is mesh,
                group_sizes={a: dist.get_world_size(mesh.group(a))
                             for a in axes},
                psum_grad=grads)


def tile(rank, world, workdir):
    """Tile-parallel and ensemble x tile inference with stand-in networks
    (each case's mesh: "data" over every rank, "ensemble" over every rank,
    or "2x2", data 2 x ensemble 2; through the predictor or through
    ``downscale_field``), counting the patch rows this rank's network
    ran, and api.predict on a mesh, at ``world`` ranks."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from windtpu_torch import api
    from windtpu_torch.core.config import (GANConfig, InferenceConfig,
                                           ModelConfig)
    from windtpu_torch.core.mesh import make_mesh
    from windtpu_torch.infer import engine
    from windtpu_torch.infer.tiling import plan_tiling
    from windtpu_torch.io import dataset as tds
    from windtpu_torch.models.texture_gate import load_gate_npz
    from windtpu_torch.network import WindDownscalingGAN

    kw = json.loads((workdir / "config.json").read_text())
    inputs = dict(np.load(workdir / "inputs.npz"))
    mcfg = ModelConfig(**kw["model"])
    icfg = InferenceConfig(**kw["inference"])
    funcs = {"identity": lambda p, n: p[..., :2],
             "noise": lambda p, n: n[..., :2]}
    data = make_mesh({"data": world})
    ens = make_mesh({"data": 1, "ensemble": world})
    meshes = {"data": data, "ensemble": ens}
    if world == 4:
        meshes["2x2"] = make_mesh({"data": 2, "ensemble": 2})
    out, info = {}, {}

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    for case in kw["cases"]:
        field = torch.from_numpy(inputs[f"{case['name']}/field"])
        cfg = dataclasses.replace(icfg, **case.get("icfg", {}))
        plan = plan_tiling(*field.shape[1:3], field.shape[0],
                           cfg.image_size, cfg.sequence_length,
                           cfg.overlap_factor)
        rows = []

        def apply_fn(p, n, f=funcs[case["apply"]]):
            rows.append(p.shape[0])
            return f(p, n)
        seeds = case["seeds"]
        mesh = meshes[case["mesh"]]
        if case.get("via") == "downscale_field":
            pred, _ = engine.downscale_field(
                apply_fn, field, mcfg, cfg, plan=plan, mesh=mesh,
                ensemble_generators=[gen(s) for s in seeds], device="cpu")
            counts = torch.zeros(0)
        elif case["mesh"] != "data":
            run = engine.make_ensemble_tile_parallel_predictor(
                mcfg, cfg, plan, mesh, apply_fn, device="cpu")
            pred, counts = run(field, [gen(s) for s in seeds])
        else:
            run = engine.make_tile_parallel_predictor(
                mcfg, cfg, plan, data, apply_fn, device="cpu")
            pred, counts = run(field, [gen(s) for s in seeds]
                               if len(seeds) > 1 else gen(seeds[0]))
        out[f"{case['name']}/pred"] = pred.numpy()
        out[f"{case['name']}/counts"] = counts.numpy()
        out[f"{case['name']}/rows"] = np.sum(rows)

    net = WindDownscalingGAN(GANConfig(model=ModelConfig(**kw["network"])),
                             device="cpu")
    net.texture_gate = load_gate_npz(api.BUNDLED_GATE)
    made = []
    new_group = dist.new_group
    dist.new_group = lambda *a, **k: made.append(a) or new_group(*a, **k)
    try:
        for members in kw["members"] + [1]:
            res = api.downscale(*era5_and_dem(tds), network=net, seed=3,
                                ensemble_members=members, device="cpu")
            info[str(members)] = api.last_run_info()
            for var in ("u10", "v10"):
                out[f"downscale{members}/{var}"] = np.asarray(
                    res[var].values)
    finally:
        dist.new_group = new_group
    # predict(mesh="auto") reuses the meshes made above, whose axes over
    # every rank hold the world's group.
    info["meshes"] = dict(
        groups_made=len(made),
        reused=[api.inference_mesh(1) is data,
                api.inference_mesh(world) is api.inference_mesh(world)],
        world_groups=[data.group("data") is dist.group.WORLD,
                      ens.group("ensemble") is dist.group.WORLD,
                      ens.group("data") is None])
    np.savez(workdir / f"rank{rank}.npz", **out)
    (workdir / f"rank{rank}.json").write_text(json.dumps(info))


def multiprocess(rank, world, workdir):
    """cli.train_main across the ranks, then again where the ranks see
    different checkpoints, and cli.main under torchrun's variables, at
    ``world`` ranks."""
    import numpy as np

    from windtpu_torch import api, cli
    from windtpu_torch.core.config import GANConfig, ModelConfig
    from windtpu_torch.network import WindDownscalingGAN
    from windtpu_torch.weights import export_train_state

    kw = json.loads((workdir / "config.json").read_text())
    flags = ["--coordinator-address", f"localhost:{sys.argv[4]}",
             "--num-processes", str(world), "--process-id", str(rank),
             # Each rank its own directory: rank 0 alone writes into its.
             "--checkpoint-dir", str(workdir / f"ck_rank{rank}")]
    state = cli.train_main(kw["train_argv"] + flags)
    np.savez(workdir / f"rank{rank}.npz", **export_train_state(state))
    checks = {}
    try:   # rank 0 now finds step 2, the others nothing
        cli.train_main(kw["train_argv"] + flags)
    except RuntimeError as e:
        checks["disagreement"] = str(e)

    # cli.main as torchrun starts it: the process group named by torchrun's
    # variables (here already joined), the tiny network, rank 0 writing.
    net = WindDownscalingGAN(GANConfig(model=ModelConfig(**kw["network"])),
                             device="cpu")
    api.get_network = lambda weights_path=None, device=None: net
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=sys.argv[4])
    cli.main(kw["main_argv"])
    (workdir / f"rank{rank}.json").write_text(json.dumps(checks))


SCENARIOS = {"parallel": parallel, "tile": tile,
             "multiprocess": multiprocess}


def main():
    scenario, rank, world, port, workdir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    import faulthandler

    import torch
    import torch.distributed as dist

    from windtpu_torch.parallel.distributed import initialize_distributed

    torch.set_num_threads(1)
    # Past the run's deadline this rank prints its stacks and exits.
    faulthandler.dump_traceback_later(TIMEOUT, exit=True)
    initialize_distributed(f"localhost:{port}", world, rank, device="cpu")
    SCENARIOS[scenario](rank, world, Path(workdir))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()

"""Console entry points of the port, run as ``python -m windtpu_torch.cli
[train|prepare] ...``.

``main`` (``downscale``, the default) has the contract of
``windtpu/cli.py:main`` (``--era --dem --date --lon --lat -o``: reads
``{date}*surface*.nc`` ERA5 files and a GeoTIFF DEM, writes a NetCDF of
downscaled u10/v10, with ``--ensemble N`` members), plus ``--device``
(default: the card).

``train_main`` (``train``) is ``windtpu/cli.py:train_main``: it reads
``x_{date}.nc`` / ``y_{date}.nc`` days (or synthetic ones) through
``data.BatchGenerator`` and trains with ``train.loop.train``;
``--reconstruction-coefficient`` adds the perceptual loss.  With
``--coordinator-address/--num-processes/--process-id`` (or under
``torchrun``) every process is one rank of a data-parallel run on its own
card (``--device``, ``--backend``): each takes its rows of the global
``--batch-size``, and the run equals a single process training on the
whole batch.

Under ``python -m torch.distributed.run --nproc-per-node N -m
windtpu_torch.cli ...``, ``main`` splits the patch groups (and the members
of an ensemble) over the N ranks, and rank 0 writes the NetCDF.

``prepare_main`` (``prepare topo|daily``) is ``windtpu/cli.py:prepare_main``:
``topo`` turns a DEM GeoTIFF into the eight ``topo_<name>.nc`` descriptor
files (stencils on ``--device``, default the card), ``daily`` builds the
``x_{date}.nc`` / ``y_{date}.nc`` training days from ERA5, COSMO-1 and
those descriptors (on the host).
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Downscale ERA5 wind fields to ~1 km")
    parser.add_argument("--era", required=True,
                        help="path to folder with ERA5 data")
    parser.add_argument("--dem", required=True, help="path to DEM data file")
    parser.add_argument("--date", required=True,
                        help="date to downscale in YYYYMMDD format")
    parser.add_argument("--lon", default=None,
                        help="longitude range (ex: 45.6:46.2)")
    parser.add_argument("--lat", default=None,
                        help="latitude range (ex: 45.6:46.2)")
    parser.add_argument("-o", "--output", default="downscaled.nc",
                        help="output path for the downscaled map (*.nc)")
    parser.add_argument("--weights", default=None,
                        help=".npz generator weights, or a step_*.pt "
                             "checkpoint (or a directory of them)")
    parser.add_argument("--ensemble", type=int, default=1,
                        help="number of stochastic ensemble members")
    parser.add_argument("--overlap-factor", type=float, default=0.01)
    parser.add_argument("--no-texture-gate", action="store_true",
                        help="disable the flow-conditional texture gate "
                             "(raw generator output)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; 'cpu' to run "
                             "on the CPU)")
    args = parser.parse_args(argv)

    from windtpu_torch import api
    from windtpu_torch.core.device import resolve_device
    from windtpu_torch.core.mesh import world
    from windtpu_torch.io.dataset import open_mfdataset
    from windtpu_torch.io.geotiff import open_rasterio
    from windtpu_torch.parallel.distributed import initialize_distributed

    # A no-op outside torchrun; under it, every rank takes its own card
    # before anything resolves a device.
    initialize_distributed(device=args.device)
    device = resolve_device(args.device)  # fail before reading any input

    longitude_r = tuple(map(float, args.lon.split(":"))) if args.lon else None
    latitude_r = tuple(map(float, args.lat.split(":"))) if args.lat else None

    era5 = open_mfdataset(str(Path(args.era) / f"{args.date}*surface*.nc"))
    raster = open_rasterio(args.dem)
    network = api.get_network(args.weights, device=device)
    result = api.downscale(
        era5, raster, range_lon=longitude_r, range_lat=latitude_r,
        overlap_factor=args.overlap_factor, network=network,
        ensemble_members=args.ensemble, device=device,
        texture_gate=False if args.no_texture_gate else "auto")
    if world()[0] == 0:   # every rank holds the same result
        result.to_netcdf(args.output)
        print(f"wrote {args.output}")


def train_main(argv=None):
    parser = argparse.ArgumentParser(description="Train the downscaling GAN")
    parser.add_argument("--inputs", required=True,
                        help="dir with x_{date}.nc training inputs")
    parser.add_argument("--outputs", required=True,
                        help="dir with y_{date}.nc training targets")
    parser.add_argument("--checkpoint-dir", required=True)
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--patch-size", type=int, default=32)
    parser.add_argument("--sequence-length", type=int, default=6)
    parser.add_argument("--start-date", default=None)
    parser.add_argument("--end-date", default=None)
    parser.add_argument("--synthetic", action="store_true",
                        help="train on synthetic data (smoke test)")
    parser.add_argument("--checkpoint-every", type=int, default=200)
    parser.add_argument("--profile-dir", default=None)
    parser.add_argument("--g-lr", type=float, default=None,
                        help="generator Adam learning rate (default 1e-4)")
    parser.add_argument("--d-lr", type=float, default=None,
                        help="critic Adam learning rate (default 4e-4)")
    parser.add_argument("--n-critic", type=int, default=None,
                        help="critic updates per generator update "
                             "(default 3)")
    parser.add_argument("--reconstruction-coefficient", type=float,
                        default=None,
                        help="perceptual reconstruction loss weight "
                             "(default 0 = off; uses the bundled encoder)")
    parser.add_argument("--steps-per-call", type=int, default=None,
                        help="optimizer steps per call of the step "
                             "function (K=1 default keeps per-step "
                             "logging)")
    parser.add_argument("--spatial-ks", action="store_true",
                        help="port only; the JAX CLI has no such flag "
                             "and its train_main never computes the metric: "
                             "compute the spatially convolved KS metric in "
                             "every step (TrainConfig.compute_spatial_ks). "
                             "chip_smoke.py sets it so that train_main "
                             "launches the spatial KS kernel")
    parser.add_argument("--steps-per-call-unroll", action="store_true",
                        help="accepted for the JAX CLI's sake; no effect "
                             "in eager PyTorch, which has no scan to "
                             "unroll")
    parser.add_argument("--coordinator-address", default=None,
                        help="host:port of rank 0 (multi-process data "
                             "parallelism)")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--backend", default=None,
                        help="torch.distributed backend of a multi-process "
                             "run (default: nccl on the card, gloo on the "
                             "CPU; gloo also lets ranks share one card)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: this rank's card; "
                             "'cpu' to run on the CPU)")
    args = parser.parse_args(argv)

    # First, before anything resolves a device: every rank joins the
    # group and takes its card (a no-op in one process).
    from windtpu_torch.parallel.distributed import initialize_distributed
    multi = initialize_distributed(
        args.coordinator_address, args.num_processes, args.process_id,
        backend=args.backend, device=args.device)

    from windtpu_torch.core.config import (DataConfig, GANConfig,
                                           ModelConfig, TrainConfig)
    from windtpu_torch.core.device import resolve_device
    from windtpu_torch.core.mesh import make_mesh, world
    from windtpu_torch.data import (BatchGenerator, LocalFileProvider,
                                    SyntheticDayProvider)
    from windtpu_torch.train.loop import train

    device = resolve_device(args.device)  # fail before reading any input
    dcfg = DataConfig(sequence_length=args.sequence_length,
                      patch_size=args.patch_size,
                      batch_size=args.batch_size)
    overrides = {
        k: v for k, v in {
            "g_learning_rate": args.g_lr,
            "d_learning_rate": args.d_lr,
            "n_critic": args.n_critic,
            "reconstruction_coefficient": args.reconstruction_coefficient,
            "steps_per_call": args.steps_per_call,
        }.items() if v is not None}
    if args.steps_per_call_unroll:
        overrides["steps_per_call_unroll"] = True
    if args.spatial_ks:
        overrides["compute_spatial_ks"] = True
    cfg = GANConfig(
        model=ModelConfig(image_size=args.patch_size,
                          in_channels=len(dcfg.input_variables),
                          sequence_length=args.sequence_length),
        train=TrainConfig(batch_size=args.batch_size, **overrides),
        data=dcfg,
        checkpoint_dir=args.checkpoint_dir,
    )
    if args.synthetic:
        dates = [f"2020010{i}" for i in range(1, 8)]
        in_prov = SyntheticDayProvider(dates, dcfg.input_variables,
                                       ny=64, nx=64, nt=24)
        out_prov = SyntheticDayProvider(dates, dcfg.output_variables,
                                        ny=64, nx=64, nt=24, seed=7)
    else:
        in_prov = LocalFileProvider(args.inputs, "x_{date}.nc")
        out_prov = LocalFileProvider(args.outputs, "y_{date}.nc")
    # Seeded, so that every rank builds the same global batches and takes
    # its rows of them.
    bg = BatchGenerator(in_prov, output_provider=out_prov,
                        start_date=args.start_date, end_date=args.end_date,
                        config=dcfg, num_workers=2, seed=cfg.seed)
    mesh = None
    if multi:
        n = world()[1]
        if args.batch_size % n:
            raise SystemExit(
                f"--batch-size {args.batch_size} must be divisible by the "
                f"{n} processes of a multi-process run")
        mesh = make_mesh({"data": n})
    state, _ = train(cfg, bg.as_device_iterator(device, mesh=mesh),
                     num_steps=args.steps,
                     checkpoint_every=args.checkpoint_every,
                     profile_dir=args.profile_dir, device=device, mesh=mesh)
    print(f"done at step {int(state.step)}")
    return state


def prepare_main(argv=None):
    parser = argparse.ArgumentParser(
        description="Preprocess DEM + ERA5 + COSMO into daily training files")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_topo = sub.add_parser("topo", help="DEM -> topographic descriptors")
    p_topo.add_argument("--dem", required=True)
    p_topo.add_argument("--device", default=None,
                        help="torch device of the stencils (default: cuda; "
                             "'cpu' to run on the CPU)")

    p_daily = sub.add_parser("daily", help="build daily x_/y_ NetCDF files")
    p_daily.add_argument("--processed", required=True)
    p_daily.add_argument("--era5", required=True)
    p_daily.add_argument("--cosmo", required=True)
    p_daily.add_argument("--dem-dir", required=True)
    p_daily.add_argument("--start", required=True)
    p_daily.add_argument("--end", required=True)
    p_daily.add_argument("--blurred", action="store_true",
                         help="COSMO-blurred self-downscaling variant")

    args = parser.parse_args(argv)
    from windtpu_torch.preprocess import daily, topo

    if args.cmd == "topo":
        from windtpu_torch.core.device import resolve_device

        topo.process_topographic_variables_file(
            args.dem, device=resolve_device(args.device))
    elif args.blurred:
        daily.process_imgs_cosmoblurred(
            args.processed, args.cosmo, args.dem_dir, args.start, args.end)
    else:
        daily.process_imgs(args.processed, args.era5, args.cosmo,
                           args.dem_dir, args.start, args.end)


if __name__ == "__main__":
    import sys

    commands = {"train": train_main, "prepare": prepare_main}
    if sys.argv[1:2] and sys.argv[1] in commands:
        commands[sys.argv[1]](sys.argv[2:])
    else:
        main()

"""Train driver: ``windtpu_torch.train.loop.train`` in a closed loop.

Set-up builds one train state (the port's generator, critic and Adam
optimizers) with weights drawn from the seed on the card, and one feed:
``batches`` host batches from the seed taken in turn, or the data
pipeline ``train_main --synthetic`` builds (``SyntheticDayProvider``,
``BatchGenerator`` with its workers, ``as_device_iterator``).  It drives
that state through the loop's first three steps on that feed, keeping each
step's metrics, Adam's first moments after step 1 and the parameters after
step 3.  The window hands the same state and feed to the loop again; the
loop logs every step, so each step ends in the host reading its metrics.
After the window the plain reference runs the same three steps in float32
from the same weights, batches and draws.

With a mesh (``train_ranks``) every rank runs this on its rows of the
global batch and rank 0's decision to close the window reaches all ranks
after each step.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
from typing import Dict, List, Optional

import torch

from portbench import compare, inputs
from portbench import harness as H
from portbench.drivers.downscale import full_f32
from portbench.reference import data as RDATA
from portbench.reference import params as RP
from portbench.reference import wgan_gp as RW
from portbench.reference.layers import FP32, Precision

CHECKED_STEPS = 3
# The configuration's ``model_flops`` key of one unit of the window.
FLOPS_UNIT = "train_step"


class WindowClosed(Exception):
    """Raised by the feed when the window has closed."""


def gan_config(cell: H.Cell, seed: int):
    from windtpu_torch.core.config import (DataConfig, GANConfig,
                                           ModelConfig, TrainConfig)

    c = cell.config
    data = c.get("data", {})
    return GANConfig(
        model=ModelConfig(**c["model"]), train=TrainConfig(**c["train"]),
        data=DataConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                           for k, v in data.items()}),
        seed=H.subseed(seed, 5))


def hyper(cfg) -> Dict:
    t = cfg.train
    return dict(n_critic=t.n_critic, gp_weight=t.gp_weight,
                noise_std=t.noise_std, g_lr=t.g_learning_rate,
                d_lr=t.d_learning_rate, b1=t.adam_b1, b2=t.adam_b2,
                eps=t.adam_eps)


def weight_shapes(cfg):
    m = cfg.model
    return (RP.generator(m.in_channels, m.noise_channels, m.out_channels,
                         m.generator_features),
            RP.critic(m.in_channels, m.out_channels,
                      m.discriminator_features, m.image_size,
                      m.discriminator_shortcut_min_iters))


def train_state(cfg, seed: int, device):
    """The port's train state with the seed's weights, and a copy of them
    for the reference."""
    from windtpu_torch.models.discriminator import Discriminator
    from windtpu_torch.models.generator import Generator
    from windtpu_torch.train import optim
    from windtpu_torch.train.state import GANTrainState

    (gp, gs), (dp, ds) = weight_shapes(cfg)
    g_w = inputs.weights(gp, gs, H.subseed(seed, 10), device)
    d_w = inputs.weights(dp, ds, H.subseed(seed, 11), device)
    gen = Generator(cfg.model).to(device)
    gen.load_state_dict({**g_w[0], **g_w[1]})
    disc = Discriminator(cfg.model).to(device)
    disc.load_state_dict({**d_w[0], **d_w[1]})
    state = GANTrainState(
        step=0, generator=gen.eval(),
        g_opt=optim.generator_optimizer(gen, cfg.train),
        discriminator=disc.eval(),
        d_opt=optim.discriminator_optimizer(disc, cfg.train))
    copy = {k: {n: t.clone() for n, t in w.items()} for k, w in
            (("g", g_w[0]), ("gs", g_w[1]), ("d", d_w[0]), ("ds", d_w[1]))}
    return state, copy


def pipeline_seeds(seed: int):
    return (H.subseed(seed, 6) % (1 << 31), H.subseed(seed, 7) % (1 << 31),
            H.subseed(seed, 8) % (1 << 32))


def make_feed(cell: H.Cell, cfg, seed: int, device, mesh):
    """The cell's feed and the global batches of the checked steps."""
    tr = cell.traffic
    if tr["feed"] == "batches":
        m = cfg.model
        shape = (cfg.train.batch_size, m.sequence_length, m.image_size,
                 m.image_size)
        batches = inputs.train_batches(seed, tr["batches"], shape,
                                       m.in_channels, m.out_channels, device)

        def cycle():
            while True:
                yield from batches
        return cycle(), batches[:CHECKED_STEPS], None
    from windtpu_torch.data import BatchGenerator, SyntheticDayProvider

    dcfg = cfg.data
    in_seed, out_seed, pipe_seed = pipeline_seeds(seed)
    dates = list(tr["dates"])
    in_prov = SyntheticDayProvider(dates, dcfg.input_variables,
                                   ny=tr["day_px"], nx=tr["day_px"],
                                   nt=tr["day_hours"], seed=in_seed)
    out_prov = SyntheticDayProvider(dates, dcfg.output_variables,
                                    ny=tr["day_px"], nx=tr["day_px"],
                                    nt=tr["day_hours"], seed=out_seed)
    bg = BatchGenerator(in_prov, output_provider=out_prov, config=dcfg,
                        num_workers=tr["workers"], seed=pipe_seed)
    feed = bg.as_device_iterator(device, mesh=mesh)
    return feed, None, feed


def reference_batches(cell: H.Cell, cfg, seed: int, device):
    """The checked steps' global batches, worked out again."""
    tr, d = cell.traffic, cfg.data
    in_seed, out_seed, pipe_seed = pipeline_seeds(seed)
    days = []
    for date in sorted(tr["dates"]):
        kw = dict(ny=tr["day_px"], nx=tr["day_px"], nt=tr["day_hours"])
        days.append((RDATA.synthetic_day(date, d.input_variables, in_seed,
                                         **kw),
                     RDATA.synthetic_day(date, d.output_variables, out_seed,
                                         **kw)))
    out = []
    for i in range(CHECKED_STEPS):
        x, y = RDATA.batch(days, i, pipe_seed, d.batch_size,
                           d.sequence_length, d.patch_size,
                           d.input_variables, d.output_variables)
        out.append((torch.as_tensor(x, device=device),
                    torch.as_tensor(y, device=device)))
    return out


def reference_steps(cfg, weights: Dict, batches, device,
                    prec: Precision = FP32) -> Dict:
    """The reference's three steps: per-step metrics, Adam's first moments
    after step 1, each parameter's change after step 3."""
    st = RW.new_state(weights["g"], weights["gs"], weights["d"],
                      weights["ds"])
    rng = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    hp = hyper(cfg)
    losses, grad = [], None
    with full_f32():
        for k, (low, high) in enumerate(batches):
            dr = RW.draws(hp["n_critic"], cfg.model.noise_channels,
                          low.shape, high.shape[-1], rng,
                          cfg.train.compute_metrics)
            st, metrics = RW.step(st, low, high, dr, hp, prec)
            losses.append({k2: float(v) for k2, v in metrics.items()})
            if k == 0:
                grad = {"g": dict(st["g_mu"]), "d": dict(st["d_mu"])}
    change = {net: {k: st[net][k] - weights[net][k] for k in weights[net]}
              for net in ("g", "d")}
    return {"losses": losses, "grad": grad, "change": change}


def _sync(device):
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


@dataclasses.dataclass
class RankResult:
    """One rank's share of a run."""
    outcome_run: H.Run
    window: H.Window
    setup_s: float
    memory_peak: int
    program: Optional[Dict]      # the checked steps (rank 0)
    weights: Optional[Dict]
    batches: Optional[List]
    cfg: object
    busy_s: Optional[float]


def run_rank(cell: H.Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device, mesh=None, stop=None) -> RankResult:
    """Set-up, the checked steps and the window on this rank; ``stop``
    (a function of rank 0's decision, returning all ranks' decision)
    makes the ranks leave the window after the same step."""
    import windtpu_torch.models.generator as gen_mod
    from windtpu_torch.core.mesh import all_reduce
    from windtpu_torch.train.loop import train

    sync = _sync(device)
    cfg = gan_config(cell, seed)
    spans = H.Spans()
    window = H.Window(seconds)
    tracer = H.Tracer(trace, 1, int(cell.spec["trace_units"]), spans, sync)
    with contextlib.ExitStack() as patches:
        if trace:
            patches.enter_context(spans.k1(gen_mod))
        state, weights = train_state(cfg, seed, device)
        source, batches, closable = make_feed(cell, cfg, seed, device, mesh)
        waits: List[float] = spans.times.setdefault("data_wait", [])
        mode = {"window": False, "closed": False, "i": 0}

        class Feed:
            def __iter__(self):
                return self

            def __next__(self):
                if mode["closed"]:
                    raise WindowClosed
                if mode["window"]:
                    if window.t0 is None:
                        window.begin()
                    tracer.before_unit(mode["i"])
                t0 = time.perf_counter()
                item = next(source)
                if mode["window"]:
                    waits.append(time.perf_counter() - t0)
                return item

        checked: List[Dict] = []
        first_mu: Dict = {}

        def record(step, metrics):
            checked.append(dict(metrics))
            if len(checked) == 1:
                first_mu["g"] = dict(zip(state.g_opt.names, [
                    t.clone() for t in state.g_opt.state["mu"]]))
                first_mu["d"] = dict(zip(state.d_opt.names, [
                    t.clone() for t in state.d_opt.state["mu"]]))

        def hook(step, metrics):
            window.end_unit()
            tracer.after_unit(mode["i"])
            mode["i"] += 1
            closed = window.closed
            mode["closed"] = stop(closed) if stop else closed

        feed = Feed()
        train(cfg, feed, CHECKED_STEPS, state=state, log_every=1,
              log_fn=record, device=device, mesh=mesh)
        sync()
        after = {"g": {k: v.detach().clone() for k, v in
                       state.generator.named_parameters()},
                 "d": {k: v.detach().clone() for k, v in
                       state.discriminator.named_parameters()}}
        setup_s = time.perf_counter() - t_start
        bytes0 = all_reduce.bytes
        mode["window"] = True
        try:
            train(cfg, feed, 1 << 40, state=state, log_every=1,
                  log_fn=hook, device=device, mesh=mesh)
        except WindowClosed:
            pass
        tracer.stop()
        if closable is not None:
            closable.close()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    n = window.units
    counters = {"all_reduce_bytes": (all_reduce.bytes - bytes0) / n}
    program = {"losses": checked,
               "grad": first_mu,
               "change": {net: {k: after[net][k] - weights[net][k]
                                for k in after[net]} for net in after}}
    del state
    run_ = H.Run(cell, n, window.durations(), spans, counters, tracer.data,
                 tracer.unit_s)
    busy = H.busy_s(tracer.data) if tracer.data is not None else None
    return RankResult(run_, window, setup_s, int(peak), program, weights,
                      batches, cfg, busy)


def outcome(cell: H.Cell, seed: int, r: RankResult, device,
            memory_peak: int) -> H.Outcome:
    """Rank 0's result: end-to-end metrics and the checked steps against
    the reference."""
    if device.type == "cuda":
        torch.cuda.empty_cache()
    batches = r.batches or reference_batches(cell, r.cfg, seed, device)
    ref = reference_steps(r.cfg, r.weights, batches, device)
    numbers = compare.train(r.program, ref)
    out = compare.excluded_leaves(ref)
    print(f"# train: {r.window.units} steps in {r.window.elapsed:.3f} s; "
          f"change_gap leaves out {len(out)} leaves {out[:8]}; "
          f"later_loss_gap {numbers['later_loss_gap']!r} (not compared)",
          file=sys.stderr)
    steps = r.window.durations()
    mean = r.window.elapsed / r.window.units
    # A cell's step metrics: the 90th percentile of the step times where
    # the name says p90, else all the window's time over its steps.
    e2e = {k: H.percentile(steps, 90) if "_p90_" in k else mean
           for k in cell.end_to_end if k != "setup_s"}
    return H.Outcome(
        run=r.outcome_run,
        end_to_end=e2e,
        setup_s=r.setup_s, attempted=r.window.units, failed=0,
        memory_peak=memory_peak,
        checks=H.checks_from(numbers, cell.spec["limits"]))


def run(cell: H.Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device=None) -> H.Outcome:
    device = torch.device(device or "cuda")
    r = run_rank(cell, seed, seconds, trace, t_start, device)
    r.outcome_run.busy_s = r.busy_s
    return outcome(cell, seed, r, device, r.memory_peak)

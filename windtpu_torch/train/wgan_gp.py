"""WGAN-GP optimization step (counterpart of ``windtpu/train/wgan_gp.py``).

One step is ``n_critic`` critic updates (gradient penalty on
eps-interpolates + instance-noised real/fake scoring), one generator update
and a metric recompute with ``train=False``, in the JAX step's order of
operations, because state moves on every training forward:

* the generator's BatchNorm running statistics and spectral-norm ``u``
  advance in each of the ``n_critic`` generator forwards and in the
  generator update;
* the critic's ``u`` advances in the gradient-penalty call, then in the
  scoring call (once with ``fused_scoring``, which scores real and fake in
  one doubled batch, twice without), then once more inside the generator
  loss;
* the GP norm reduces over axes (1, 2, 3) and leaves per-channel norms;
* instance noise (std = noise_std, out_channels wide) is added to BOTH
  critic inputs when scoring;
* ``detach_gp=True`` logs the penalty without training the critic on it;
* ``TrainConfig.remat`` recomputes the chosen training forwards in the
  backward instead of keeping their activations (:func:`remat_modes`);
  the state they write moves once all the same.

The random draws are split from the arithmetic: :func:`draw_step_noise`
draws everything a step needs from a ``torch.Generator``, and the step
takes the draws, so a test can hand the same numbers to this step and to
the JAX one.  Gradients are taken with ``torch.autograd.grad`` for the
updated network's parameters only; ``.grad`` fields are never filled.

Across the ranks of a mesh axis (one process per device) the step runs on
each rank's rows of the batch, with one of the JAX package's two
data-parallel semantics:

* the global batch (``make_train_step(cfg, mesh=mesh)``, what JAX's
  sharded ``jit`` computes and ``train_main`` runs): every rank draws the
  global batch's random numbers from the same generator and keeps its
  rows, the generator's BatchNorm takes the global batch's statistics
  (the generator's ``group`` argument), and the gradients and metrics
  are averaged over the ranks.  The critic normalises per sample, so this equals the
  single-process step on the whole batch up to summation order;
* the ``shard_map`` step (``pmean_step=True``,
  :func:`windtpu_torch.parallel.make_sharded_train_step`): each rank draws
  its own numbers, BatchNorm takes the local batch, gradients, losses and
  metrics are averaged over the ranks, and the running statistics once at
  the end of the step.

Both average with explicit all-reduces (``core.mesh.pmean``): DDP's
``broadcast_buffers`` would copy rank 0's BatchNorm statistics instead of
averaging them.

On one card without a mesh the ``n_critic`` critic updates, some ten
thousand small launches each at the flagship's size, run as one CUDA graph
(:func:`critic_graph`): the first step of a shape runs them and captures
them, later steps copy their batch and draws in and replay.  Every other
step (on the CPU, or on a mesh, whose all-reduces sit inside the updates)
runs them op by op.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import (Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import torch
from torch import nn

from windtpu_torch.core.config import GANConfig, TrainConfig
from windtpu_torch.core.mesh import Mesh, pmean
from windtpu_torch.metrics import metrics as M
from windtpu_torch.models.layers import TimeBatchNorm
from windtpu_torch.train.losses import (
    discriminator_loss,
    generator_adversarial_loss,
    gradient_penalty_from_grads,
    highpass_energy_ratio_loss,
    reconstruction_loss,
)
from windtpu_torch.train.state import GANTrainState
from windtpu_torch.utils.logging import span


@dataclasses.dataclass
class CriticDraws:
    noise: torch.Tensor    # (B, T, H, W, noise_channels), unit normal
    eps: torch.Tensor      # (B, 1, 1, 1, 1), uniform in [0, 1)
    inst_real: torch.Tensor   # (B, T, H, W, out_channels), unit normal
    inst_fake: torch.Tensor


@dataclasses.dataclass
class StepDraws:
    """Every random number of one train step, before scaling by
    ``noise_std``."""
    critic: List[CriticDraws]
    gen_noise: torch.Tensor
    eval_noise: Optional[torch.Tensor]   # None without compute_metrics


def draw_step_noise(cfg: GANConfig, low_res_shape: Sequence[int],
                    out_channels: int, rng: torch.Generator,
                    device=None) -> StepDraws:
    """Draw one step's random numbers from ``rng`` (on its own device) and
    move them to ``device``.  Shapes come from the batch, not from
    ``ModelConfig``: the networks are fully convolutional."""
    b, t, h, w = low_res_shape[:4]
    noise_shape = (b, t, h, w, cfg.model.noise_channels)
    inst_shape = (b, t, h, w, out_channels)

    def normal(shape):
        return torch.randn(shape, generator=rng,
                           device=rng.device).to(device)

    critic = [CriticDraws(
        noise=normal(noise_shape),
        eps=torch.rand((b, 1, 1, 1, 1), generator=rng,
                       device=rng.device).to(device),
        inst_real=normal(inst_shape), inst_fake=normal(inst_shape))
        for _ in range(cfg.train.n_critic)]
    return StepDraws(
        critic=critic, gen_noise=normal(noise_shape),
        eval_noise=(normal(noise_shape) if cfg.train.compute_metrics
                    else None))


REMAT_MODES = (False, True, "d_only", "save_scans")


def remat_modes(tcfg: TrainConfig) -> Tuple[Union[bool, str], ...]:
    """The ``remat`` argument of the generator's training forward, of the
    critic's scoring calls and of its gradient-penalty call, from
    ``TrainConfig.remat`` and ``remat_gp``, call site by call site as the
    JAX step wraps them: ``True`` both networks, ``"d_only"`` the critic,
    ``"save_scans"`` both but for their ConvLSTMs; the gradient-penalty
    call, differentiated twice, only with ``remat_gp``."""
    remat = tcfg.remat
    if remat not in REMAT_MODES:
        raise ValueError(f"TrainConfig.remat must be one of {REMAT_MODES}; "
                         f"got {remat!r}")
    g_remat = remat if remat is True or remat == "save_scans" else False
    d_remat = True if remat == "d_only" else g_remat
    return g_remat, d_remat, (d_remat if tcfg.remat_gp else False)


def _grads_or_zeros(loss: torch.Tensor,
                    params: List[nn.Parameter]) -> List[torch.Tensor]:
    """d loss / d params, with zeros where the loss does not reach a
    parameter (or is a constant)."""
    if not loss.requires_grad:
        return [torch.zeros_like(p) for p in params]
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


def _tensor_mean_sq(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """Mean over parameter tensors of mean(g^2): the gradient diagnostic."""
    return torch.stack([torch.mean(g.float() ** 2) for g in grads]).mean()


def _batch(state: GANTrainState, cfg: GANConfig, low_res,
           high_res) -> Tuple[torch.Tensor, torch.Tensor]:
    device = state.device
    low_res = torch.as_tensor(low_res, dtype=torch.float32, device=device)
    high_res = torch.as_tensor(high_res, dtype=torch.float32, device=device)
    if low_res.shape[-1] != cfg.model.in_channels:
        raise ValueError(
            f"batch has {low_res.shape[-1]} input channels but the "
            f"generator was built for ModelConfig.in_channels="
            f"{cfg.model.in_channels}; align DataConfig.input_variables "
            f"with ModelConfig")
    return low_res, high_res


def _generator_metrics(high_res: torch.Tensor, fake: torch.Tensor,
                       group=None) -> Dict[str, torch.Tensor]:
    return {
        "g_acd": torch.mean(M.angular_cosine_distance(high_res, fake)),
        "g_lsd": torch.mean(M.log_spectral_distance(high_res, fake)),
        "g_extreme_rmse": torch.mean(
            M.extreme_weighted_rmse(high_res, fake, group)),
        "g_ws_weighted_rmse": torch.mean(
            M.wind_speed_weighted_rmse(high_res, fake)),
        "g_ws_rmse": torch.mean(M.wind_speed_rmse(high_res, fake)),
    }


FeatureFn = Callable[[torch.Tensor], torch.Tensor]


def _rows(draws: StepDraws, start: int, size: int) -> StepDraws:
    """The draws of batch rows [start, start + size)."""
    def cut(x):
        return None if x is None else x[start:start + size]

    return StepDraws(
        critic=[CriticDraws(*(cut(getattr(d, f.name))
                              for f in dataclasses.fields(d)))
                for d in draws.critic],
        gen_noise=cut(draws.gen_noise), eval_noise=cut(draws.eval_noise))


def _critic_inputs(low_res, high_res,
                   critic: Sequence[CriticDraws]) -> List[torch.Tensor]:
    """The critic updates' tensor inputs laid end to end."""
    return [low_res, high_res] + [getattr(d, f.name) for d in critic
                                  for f in dataclasses.fields(d)]


def _critic_args(inputs: Sequence[torch.Tensor], n: int):
    """(low_res, high_res, critic draws) back from :func:`_critic_inputs`."""
    k = len(dataclasses.fields(CriticDraws))
    draws = [CriticDraws(*inputs[2 + i * k:2 + (i + 1) * k])
             for i in range(n)]
    return inputs[0], inputs[1], draws


def critic_graph_key(state: GANTrainState, settings: tuple,
                     inputs: Sequence[torch.Tensor]) -> tuple:
    """What a graph of the critic updates holds fixed besides its code: the
    inputs' device, shapes and dtypes, the step's ``settings``, the
    algorithm choices of cuDNN and cuBLAS, and, by address, every tensor
    of the state that the updates read or write (both networks'
    parameters and buffers, the critic optimizer's slots and count).  A
    load that copies in place keeps the key; a new state or a replaced
    tensor changes it."""
    tensors = itertools.chain(
        state.generator.parameters(), state.generator.buffers(),
        state.discriminator.parameters(), state.discriminator.buffers(),
        state.d_opt.tensors())
    backends = (torch.backends.cudnn.deterministic,
                torch.backends.cudnn.benchmark,
                torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32,
                torch.are_deterministic_algorithms_enabled())
    return (inputs[0].device, tuple((t.shape, t.dtype) for t in inputs),
            settings, backends,
            tuple((t.data_ptr(), t.requires_grad) for t in tensors))


@dataclasses.dataclass
class _CriticGraph:
    key: tuple
    graph: "torch.cuda.CUDAGraph"
    inputs: List[torch.Tensor]     # static, copied into before a replay
    outputs: Tuple[torch.Tensor, ...]


def critic_graph(state: GANTrainState, updates: Callable, settings: tuple,
                 low_res: torch.Tensor, high_res: torch.Tensor,
                 critic: Sequence[CriticDraws]):
    """``updates(state, low_res, high_res, critic)``, the step's critic
    updates on one card, replayed as one CUDA graph.

    The state keeps one graph, under :func:`critic_graph_key`.  A call
    with another key runs the updates (a real step, on the stream the
    capture then uses, so that cuDNN, cuBLAS, K1 and the allocator meet
    the capture set up), then captures them into the graph's own memory
    pool; the capture runs nothing, so it leaves the state as it found
    it.  A call with the same key copies the batch and draws into the
    graph's inputs, replays it, and returns copies of its outputs, which
    the next replay overwrites.  The optimizer's count lives on the device
    and follows the updates that ran: the capture records its increments
    and runs none, a replay runs them.  Counters:
    ``critic_graph.captures``, ``critic_graph.replays``."""
    inputs = _critic_inputs(low_res, high_res, critic)
    key = critic_graph_key(state, settings, inputs)
    held = state.critic_graph
    if held is not None and held.key == key:
        with span("step.critic"), span("critic.replay"):
            for dst, src in zip(held.inputs, inputs):
                dst.copy_(src)
            held.graph.replay()
            out = tuple(t.clone() for t in held.outputs)
        critic_graph.replays += 1
        return out

    state.critic_graph = None      # its memory goes before the next graph
    main = torch.cuda.current_stream(low_res.device)
    side = torch.cuda.Stream(low_res.device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        out = updates(state, low_res, high_res, critic)
    main.wait_stream(side)
    static = [torch.empty_like(t) for t in inputs]
    graph = torch.cuda.CUDAGraph()
    with span("critic.capture"), torch.cuda.graph(graph, stream=side):
        outputs = updates(state, *_critic_args(static, len(critic)))
    state.critic_graph = _CriticGraph(key, graph, static, tuple(outputs))
    critic_graph.captures += 1
    return out


critic_graph.captures = 0
critic_graph.replays = 0


def make_train_step(cfg: GANConfig, feature_fn: Optional[FeatureFn] = None,
                    detach_gp: Optional[bool] = None,
                    mesh: Optional[Mesh] = None, axis: str = "data",
                    pmean_step: bool = False):
    """Build ``step(state, low_res, high_res, rng=None, *, draws=None) ->
    (state, metrics)``.  ``state`` is updated in place.  The step draws its
    random numbers from ``rng`` (a ``torch.Generator``) unless ``draws``
    (a :class:`StepDraws`) hands them in.  ``metrics`` maps the JAX
    package's metric names to 0-d tensors on the state's device.

    With ``mesh`` the batch is this rank's rows, the ``axis`` ranks
    together holding the batch, and the step runs one of the two
    data-parallel semantics of the module docstring: the global batch by
    default (``draws`` then holds the global batch's numbers, and ``rng``
    must be seeded alike on every rank), the ``shard_map`` step with
    ``pmean_step=True`` (``draws`` holds this rank's; from ``rng`` each
    rank seeds its own generator with one of ``axis_size`` seeds drawn
    alike on every rank, the counterpart of ``fold_in(rng,
    axis_index)``).  The state must be the same on every rank.

    ``feature_fn`` maps a (B, T, H, W, 2) field to (B, T, latent)
    perceptual features (:func:`windtpu_torch.features.get_encoder_fn`);
    with it and ``reconstruction_coefficient > 0`` the generator loss adds
    the reconstruction loss of ``low_res[..., :2]`` against the fake, and
    reports it as ``g_reco_loss``.  Without it the loss is off, as in the
    JAX step."""
    tcfg = cfg.train
    g_remat, d_remat, gp_remat = remat_modes(tcfg)
    reco_fn = (reconstruction_loss(feature_fn,
                                   tcfg.reconstruction_coefficient)
               if feature_fn is not None
               and tcfg.reconstruction_coefficient > 0 else None)
    detach = tcfg.detach_gp if detach_gp is None else detach_gp
    std = tcfg.noise_std
    group = mesh.group(axis) if mesh is not None else None
    n_shards = mesh.axis_size(axis) if mesh is not None else 1
    shard = mesh.axis_index(axis) if mesh is not None else 0
    global_batch = mesh is not None and not pmean_step
    bn_group = group if global_batch else None
    # What the critic updates read of the configuration: part of their
    # graph's key.
    settings = (tcfg.n_critic, tcfg.gp_weight, std, detach, tcfg.remat,
                tcfg.remat_gp, tcfg.fused_scoring)

    def step_draws(state, low_res, high_res, rng, draws):
        b = low_res.shape[0]
        if draws is None and pmean_step:
            seeds = torch.randint(0, 2 ** 62, (n_shards,), generator=rng,
                                  device=rng.device)
            rng = torch.Generator(device=rng.device).manual_seed(
                int(seeds[shard]))
        if draws is None:
            rows = b * n_shards if global_batch else b
            draws = draw_step_noise(cfg, (rows,) + tuple(low_res.shape[1:]),
                                    high_res.shape[-1], rng, state.device)
        if global_batch and n_shards > 1:
            draws = _rows(draws, shard * b, b)
        return draws

    def train_step(state: GANTrainState, low_res, high_res,
                   rng: Optional[torch.Generator] = None, *,
                   draws: Optional[StepDraws] = None):
        with span("step"):
            low_res, high_res = _batch(state, cfg, low_res, high_res)
            with span("step.draws"):
                draws = step_draws(state, low_res, high_res, rng, draws)
            return body(state, low_res, high_res, draws)

    def critic_updates(state, low_res, high_res, critic):
        """The ``n_critic`` critic updates on the draws ``critic``; returns
        the last one's (gradient-penalty norm, loss, gradient
        diagnostic)."""
        gen, critic_net = state.generator, state.discriminator
        d_params = state.d_opt.params
        b = low_res.shape[0]
        zero = torch.zeros((), device=state.device)
        gp_mean_norm = d_loss_val = d_grad_diag = zero
        for d in critic:
            with span("step.critic"):
                with span("critic.fake"), torch.no_grad():
                    fake = gen(low_res, std * d.noise, train=True,
                               group=bn_group)
                    mixed = d.eps * high_res + (1.0 - d.eps) * fake
                mixed.requires_grad_()
                with span("critic.penalty"):
                    # Gradient penalty: the critic differentiated for its
                    # image input, inside the loss that is differentiated
                    # for d_params.
                    scores = critic_net(low_res, mixed, train=True,
                                        remat=gp_remat)
                    grads_img, = torch.autograd.grad(
                        scores.sum(), mixed, create_graph=not detach)
                    penalty, gp_mean_norm = gradient_penalty_from_grads(
                        grads_img, tcfg.gp_weight)
                    if detach:
                        penalty = penalty.detach()
                with span("critic.score"):
                    real_in = high_res + std * d.inst_real
                    fake_in = fake + std * d.inst_fake
                    if tcfg.fused_scoring:
                        # One critic call on the doubled batch: the critic
                        # has no cross-sample op, so the scores are those
                        # of two calls.
                        both = critic_net(torch.cat([low_res, low_res]),
                                          torch.cat([real_in, fake_in]),
                                          train=True, remat=d_remat)
                        rs, fs = both[:b], both[b:]
                    else:
                        rs = critic_net(low_res, real_in, train=True,
                                        remat=d_remat)
                        fs = critic_net(low_res, fake_in, train=True,
                                        remat=d_remat)
                    loss = discriminator_loss(rs, fs) + penalty
                with span("critic.backward"):
                    # The penalty's double backward runs here.
                    *d_grads, d_loss_val, gp_mean_norm = pmean(
                        _grads_or_zeros(loss, d_params)
                        + [loss.detach(), gp_mean_norm.detach()], group)
                with span("critic.adam"):
                    state.d_opt.step(d_grads)
                    d_grad_diag = _tensor_mean_sq(d_grads)
        return gp_mean_norm, d_loss_val, d_grad_diag

    def body(state, low_res, high_res, draws):
        gen, critic = state.generator, state.discriminator
        g_params = state.g_opt.params
        zero = torch.zeros((), device=state.device)

        # ---- critic updates --------------------------------------------
        if mesh is None and low_res.is_cuda and tcfg.n_critic:
            gp_mean_norm, d_loss_val, d_grad_diag = critic_graph(
                state, critic_updates, settings, low_res, high_res,
                draws.critic)
        else:
            gp_mean_norm, d_loss_val, d_grad_diag = critic_updates(
                state, low_res, high_res, draws.critic)

        # ---- generator update ------------------------------------------
        with span("step.generator"):
            with span("generator.forward"):
                fake = gen(low_res, std * draws.gen_noise, train=True,
                           group=bn_group, remat=g_remat)
                g_adv = g_reco = g_sharp = zero
                if tcfg.adversarial_coefficient > 0:   # 0: no critic call
                    scores = critic(low_res, fake, train=True, remat=d_remat)
                    g_adv = (tcfg.adversarial_coefficient
                             * generator_adversarial_loss(scores))
                if reco_fn is not None:
                    g_reco = reco_fn(low_res[..., :2], fake)
                if tcfg.sharpness_coefficient > 0:
                    g_sharp = (tcfg.sharpness_coefficient
                               * highpass_energy_ratio_loss(
                                   fake, high_res,
                                   sigma=tcfg.sharpness_sigma,
                                   group=bn_group))
                g_loss = g_adv + g_reco + g_sharp
            with span("generator.backward"):
                *g_grads, g_loss, g_adv, g_reco, g_sharp = pmean(
                    _grads_or_zeros(g_loss, g_params)
                    + [g_loss.detach(), g_adv.detach(), g_reco.detach(),
                       g_sharp.detach()], group)
                if pmean_step:
                    # BatchNorm's running statistics moved with each rank's
                    # own batch; the moving average is linear in the batch
                    # statistics, so one mean at the end equals the global
                    # batch's moves.
                    stats = [b for m in gen.modules()
                             if isinstance(m, TimeBatchNorm)
                             for b in (m.bn.mean, m.bn.var)]
                    with torch.no_grad():
                        for buf, mean in zip(stats, pmean(stats, group)):
                            buf.copy_(mean)
            with span("generator.adam"):
                state.g_opt.step(g_grads)

        metrics = {
            "g_loss": g_loss,
            "g_disc_loss": g_adv,
            "g_reco_loss": g_reco,
            "g_sharp_loss": g_sharp,
            "d_gradient_pen": gp_mean_norm,
            "g_gradient_param": _tensor_mean_sq(g_grads),
            "d_gradient_param": d_grad_diag,
        }
        del fake, g_loss, g_adv, g_reco, g_sharp, g_grads

        # ---- metric recompute, train=False, on the updated parameters --
        if tcfg.compute_metrics:
            with span("step.eval"), torch.no_grad():
                hr_score = critic(low_res, high_res)
                fake_e = gen(low_res, std * draws.eval_noise)
                fk_score = critic(low_res, fake_e)
                evals = dict(
                    d_loss=discriminator_loss(hr_score, fk_score),
                    d_real=torch.mean(hr_score),
                    d_fake=torch.mean(fk_score),
                    **_generator_metrics(high_res, fake_e, group))
                if tcfg.compute_spatial_ks:
                    evals["g_spatial_ks"] = M.spatial_ks_scalar(
                        high_res, fake_e)
                metrics.update(zip(evals, pmean(evals.values(), group)))
        else:
            metrics["d_loss"] = d_loss_val
        state.step += 1
        return state, metrics

    return train_step


def make_multi_train_step(cfg: GANConfig, steps_per_call: int,
                          feature_fn: Optional[FeatureFn] = None,
                          detach_gp: Optional[bool] = None,
                          mesh: Optional[Mesh] = None):
    """``(state, low_res_k, high_res_k, rng) -> (state, metrics)`` where the
    batch arguments are length-K sequences; K steps run and the metrics are
    those of the LAST one.  ``mesh``: the global-batch step of
    :func:`make_train_step`."""
    inner = make_train_step(cfg, feature_fn=feature_fn, detach_gp=detach_gp,
                            mesh=mesh)
    if steps_per_call <= 1:
        return inner

    def multi(state, low_res_k, high_res_k, rng):
        metrics = None
        for low_res, high_res in zip(low_res_k, high_res_k):
            state, metrics = inner(state, low_res, high_res, rng)
        return state, metrics

    return multi


def make_eval_step(cfg: GANConfig):
    """Build ``eval_step(state, low_res, high_res, rng=None, *, noise=None)
    -> metrics``: the critic loss on real against generated, and the
    generator metric suite, with ``train=False``.  ``noise`` (unit normal,
    (B, T, H, W, noise_channels)) replaces the draw from ``rng``."""
    mcfg, tcfg = cfg.model, cfg.train

    @torch.no_grad()
    def eval_step(state: GANTrainState, low_res, high_res,
                  rng: Optional[torch.Generator] = None, *,
                  noise: Optional[torch.Tensor] = None):
        low_res, high_res = _batch(state, cfg, low_res, high_res)
        if noise is None:
            noise = torch.randn(
                tuple(low_res.shape[:4]) + (mcfg.noise_channels,),
                generator=rng, device=rng.device).to(state.device)
        gen, critic = state.generator, state.discriminator
        true_scores = critic(low_res, high_res)
        generated = gen(low_res, tcfg.noise_std * noise)
        fake_scores = critic(low_res, generated)
        return {
            "loss": discriminator_loss(true_scores, fake_scores),
            "d_real": torch.mean(true_scores),
            "d_fake": torch.mean(fake_scores),
            **_generator_metrics(high_res, generated),
        }

    return eval_step

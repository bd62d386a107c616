"""The train step's critic updates replayed as one CUDA graph
(``windtpu_torch/train/wgan_gp.critic_graph``) against the same updates
run op by op, on a card (gpu-marked; skips where there is none).

At a tiny bf16 and a tiny f32 configuration, from one state, four batches
and four steps' draws, with cuDNN's deterministic algorithms on both
sides: steps whose critic updates are captured once and replayed three
times against steps whose critic updates run op by op (the step's path
off the card, here forced on it).  Held bitwise:

* with the generator frozen (``adversarial_coefficient`` 0: its update
  takes zero gradients), four free-running steps each: every parameter,
  Adam slot and count, spectral-norm ``u``, BatchNorm statistic and
  metric;
* with the generator trained, each step from the same state: all that the
  critic updates write or read back (the critic, its optimizer, every
  ``u`` and BatchNorm statistic) and the metrics taken before the
  generator's backward.  The generator's update runs op by op on both
  sides and is left out: the bilinear upsample's backward adds with
  atomics, so two op-by-op runs differ there too.

A second ``make_train_step`` on the same state replays the graph; another
batch shape captures a new one.  Runs without JAX, so the card's machine
runs it: ``python3 -m pytest --noconftest tests/test_torch_critic_graph.py``.
"""

import numpy as np
import pytest
import torch

from windtpu_torch.core.config import GANConfig, ModelConfig, TrainConfig
from windtpu_torch.train import wgan_gp
from windtpu_torch.train.state import create_train_state
from windtpu_torch.train.wgan_gp import draw_step_noise, make_train_step
from windtpu_torch.weights import export_train_state, load_train_state

TINY = dict(image_size=24, in_channels=3, noise_channels=2, out_channels=2,
            sequence_length=2, generator_features=16,
            discriminator_features=4)
STEPS = 4
# What the critic updates write, and what reads only it: held bitwise
# while the generator trains.
CRITIC_SIDE = ("step", "d_params", "d_spectral", "d_opt", "g_batch_stats",
               "g_spectral")
CRITIC_METRICS = ("d_gradient_pen", "d_gradient_param", "d_real", "g_loss",
                  "g_disc_loss", "g_reco_loss", "g_sharp_loss")


def _op_by_op(state, updates, settings, *args):
    """The critic updates as the step runs them off the card."""
    return updates(state, *args)


def _config(dtype, **train):
    return GANConfig(model=ModelConfig(**TINY, compute_dtype=dtype),
                     train=TrainConfig(batch_size=2, n_critic=3, **train))


def _batches(cfg, n, b, seed):
    gen = torch.Generator().manual_seed(seed)
    shape = (b, TINY["sequence_length"], TINY["image_size"],
             TINY["image_size"])
    out = []
    for _ in range(n):
        low = torch.randn(shape + (TINY["in_channels"],), generator=gen)
        high = 3.0 * torch.randn(shape + (TINY["out_channels"],),
                                 generator=gen)
        draws = draw_step_noise(cfg, low.shape, high.shape[-1], gen, "cuda")
        out.append((low.cuda(), high.cuda(), draws))
    return out


def _unequal(got_state, want_state, got_metrics, want_metrics,
             groups=None, metrics=None):
    """Names of the state's tensors (in ``groups``) and of the metrics (in
    ``metrics``) that are not bitwise equal."""
    got, want = export_train_state(got_state), export_train_state(want_state)
    names = [k for k in want if groups is None or k.split("/")[0] in groups]
    out = [k for k in names if not np.array_equal(got[k], want[k])]
    return out + [k for k in want_metrics if (metrics is None or k in metrics)
                  and not torch.equal(got_metrics[k], want_metrics[k])]


def _skip_without_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("a CUDA graph needs a card")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_replays_equal_op_by_op_steps_of_a_frozen_generator(dtype,
                                                             monkeypatch):
    _skip_without_card(monkeypatch)
    cfg = _config(dtype, adversarial_coefficient=0.0)
    batches = _batches(cfg, STEPS, 2, seed=1)
    graphed, op_by_op = (create_train_state(cfg, seed=2, device="cuda")
                         for _ in range(2))
    counters = wgan_gp.critic_graph
    captures, replays = counters.captures, counters.replays

    step = make_train_step(cfg)
    for low, high, d in batches:
        _, got = step(graphed, low, high, draws=d)
    assert counters.captures - captures == 1
    assert counters.replays - replays == STEPS - 1
    with monkeypatch.context() as m:
        m.setattr(wgan_gp, "critic_graph", _op_by_op)
        step = make_train_step(cfg)
        for low, high, d in batches:
            _, want = step(op_by_op, low, high, draws=d)
    assert graphed.d_opt.count == op_by_op.d_opt.count == STEPS * 3
    assert int(graphed.d_opt.count_t) == graphed.d_opt.count
    assert _unequal(graphed, op_by_op, got, want) == []

    # A new step function on the same state replays the same graph.
    low, high, d = batches[0]
    make_train_step(cfg)(graphed, low, high, draws=d)
    assert counters.captures - captures == 1
    assert counters.replays - replays == STEPS
    # Another batch shape is another graph.
    low, high, d = _batches(cfg, 1, 3, seed=5)[0]
    make_train_step(cfg)(graphed, low, high, draws=d)
    assert counters.captures - captures == 2
    assert counters.replays - replays == STEPS


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_replays_equal_op_by_op_critic_updates_step_by_step(dtype,
                                                            monkeypatch):
    _skip_without_card(monkeypatch)
    cfg = _config(dtype)
    graphed, op_by_op = (create_train_state(cfg, seed=2, device="cuda")
                         for _ in range(2))
    counters = wgan_gp.critic_graph
    captures, replays = counters.captures, counters.replays
    graph_step = make_train_step(cfg)
    for i, (low, high, d) in enumerate(_batches(cfg, STEPS, 2, seed=3)):
        load_train_state(op_by_op, export_train_state(graphed))
        _, got = graph_step(graphed, low, high, draws=d)
        with monkeypatch.context() as m:
            m.setattr(wgan_gp, "critic_graph", _op_by_op)
            _, want = make_train_step(cfg)(op_by_op, low, high, draws=d)
        assert _unequal(graphed, op_by_op, got, want, CRITIC_SIDE,
                        CRITIC_METRICS) == [], f"step {i + 1}"
    assert counters.captures - captures == 1
    assert counters.replays - replays == STEPS - 1

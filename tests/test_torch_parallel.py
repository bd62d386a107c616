"""The port's data-parallel training (windtpu_torch/core/mesh.py,
parallel/, train/wgan_gp.py with a mesh) against the JAX package's, with
two and with four real rank processes joined by gloo on the CPU
(tests/torch_ranks.py).

From the same perturbed state, batches and draws, over two steps:

* the shard_map step (``make_sharded_train_step``): each rank gets its
  shard's JAX draws, ``fold_in(fold_in(key, step), axis_index)``, and the
  ranks match JAX's ``make_sharded_train_step`` on a 2-device mesh at the
  tolerances of tests/test_torch_train.py;
* the global-batch step (``make_train_step(cfg, mesh=mesh)``): the ranks
  hold identical parameters, equal to the port's single-process step on
  the whole batch and to JAX's ``make_train_step`` under sharded ``jit``,
  at 2 ranks and at 4 (on 4 devices there).

At 4 ranks also the 2-D mesh ``{"data": 2, "ensemble": 2}``: coordinates
in JAX's device order, each axis's sub-group summing as JAX's psum over
that axis, and no new process group on a second call.  The rank processes
of both worlds start once, while the JAX side compiles here.  The mesh
rules are checked against JAX's for worlds 1 to 8 without processes.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tests import torch_ranks
from tests.test_torch_autoencoder import _jax_state
from tests.test_torch_train import (_STATE_FIELDS, assert_metrics_close,
                                    assert_states_close, batch, configs,
                                    jax_draws)
from windtpu.api import inference_mesh as j_inference_mesh
from windtpu.core.mesh import make_mesh as j_make_mesh
from windtpu.parallel import make_sharded_train_step as j_sharded_step
from windtpu.train import make_train_step as j_make_train_step
from windtpu_torch import api as tapi
from windtpu_torch.core import mesh as tmesh
from windtpu_torch.metrics.metrics import extreme_weighted_rmse
from windtpu_torch.models.layers import TimeBatchNorm
from windtpu_torch.parallel import distributed
from windtpu_torch.train.state import create_train_state
from windtpu_torch.train.wgan_gp import make_train_step
from windtpu_torch.weights import export_train_state, load_train_state

torch.set_num_threads(2)

WORLD = 2
STEPS = 2
# The train steps each world runs ("a": the shard_map step, "b": the
# global-batch step, "c": "b" under remat="save_scans"); at 4 ranks the
# global-batch step, each rank with one row of the batch of 4.
NAMES = {WORLD: ["a", "b", "c"], 4: ["b"]}
TRAIN = dict(n_critic=1)
# The state after two steps, at the tolerance tests/test_torch_train.py
# holds its second step to.
STATE_ATOL = 5e-4
# The global-batch step against the single process on the whole batch:
# the same arithmetic but for the order of the sums (BatchNorm's
# statistics and the gradient means over two ranks), two Adam steps.
SINGLE_ATOL = 2e-5


def perturbed_flat(tcfg, seed):
    """The port's fresh train state, flat, with parameters, statistics and
    spectral vectors moved off their initial values."""
    rng = np.random.default_rng(seed)
    flat = export_train_state(create_train_state(tcfg, device="cpu"))
    for k, v in flat.items():
        if k.split("/")[0] in _STATE_FIELDS:
            moved = v + 0.05 * rng.standard_normal(v.shape)
            flat[k] = (np.abs(moved) + 0.1 if k.endswith("/var")
                       else moved).astype(np.float32)
    return flat


def _as_arrays(draws, prefix):
    out = {f"{prefix}/gen_noise": draws.gen_noise.numpy(),
           f"{prefix}/eval_noise": draws.eval_noise.numpy()}
    for i, d in enumerate(draws.critic):
        for f in ("noise", "eps", "inst_real", "inst_fake"):
            out[f"{prefix}/critic{i}/{f}"] = getattr(d, f).numpy()
    return out


def _port_state(tcfg, flat):
    return load_train_state(create_train_state(tcfg, device="cpu"), flat)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the ranks of both worlds on the inputs, run the JAX steps and
    the port's single-process step here meanwhile, and collect everything,
    by world size."""
    jcfg, tcfg = configs(**TRAIN)
    flat = perturbed_flat(tcfg, seed=1)
    key = jax.random.key(3)
    inputs = {f"state/{k}": v for k, v in flat.items()}
    batches, global_draws = [], []
    for s in range(STEPS):
        lr, hr = batch(seed=10 + s, b=4)
        batches.append((lr, hr))
        inputs[f"lr/{s}"], inputs[f"hr/{s}"] = lr, hr
        global_draws.append(jax_draws(jcfg, key, s, lr, hr))
        inputs.update(_as_arrays(global_draws[-1], f"b/{s}"))
        per = lr.shape[0] // WORLD
        for i in range(WORLD):
            rows = slice(i * per, (i + 1) * per)
            rng = jax.random.fold_in(jax.random.fold_in(key, s), i)
            inputs.update(_as_arrays(
                jax_draws(jcfg, rng, None, lr[rows], hr[rows]),
                f"a/{s}/{i}"))
    works, procs = {}, {}
    for world, names in NAMES.items():
        works[world] = work = tmp_path_factory.mktemp(f"parallel{world}")
        np.savez(work / "inputs.npz", **inputs)
        (work / "config.json").write_text(json.dumps(dict(
            model=dict(tcfg.model.__dict__), train=dict(tcfg.train.__dict__),
            steps=STEPS, names=names)))
        procs[world] = torch_ranks.launch("parallel", world, work)
    try:
        want = {"a": [], **{f"b{world}": [] for world in NAMES}}
        ja = _jax_state(jcfg, flat)
        step_a = j_sharded_step(jcfg, _jax_mesh(WORLD))
        step_b = j_make_train_step(jcfg)
        jb, shardings = {}, {}
        for world in NAMES:
            mesh = _jax_mesh(world)
            shardings[world] = (NamedSharding(mesh, P()),
                                NamedSharding(mesh, P("data")))
            jb[world] = jax.device_put(_jax_state(jcfg, flat),
                                       shardings[world][0])
        single = _port_state(tcfg, flat)
        tstep = make_train_step(tcfg)
        single_metrics = []
        for s, (lr, hr) in enumerate(batches):
            ja, ma = step_a(ja, lr, hr, key)
            want["a"].append((jax.device_get(ja), jax.device_get(ma)))
            for world, (rep, rows) in shardings.items():
                jb[world], mb = step_b(jb[world], jax.device_put(lr, rows),
                                       jax.device_put(hr, rows),
                                       jax.device_put(key, rep))
                want[f"b{world}"].append((jax.device_get(jb[world]),
                                          jax.device_get(mb)))
            single, m = tstep(single, lr, hr, draws=global_draws[s])
            single_metrics.append(m)
    finally:
        for world in procs:
            torch_ranks.finish(procs[world])
    out = {}
    for world, work in works.items():
        out[world] = dict(
            world=world, tcfg=tcfg, single=single,
            single_metrics=single_metrics,
            want={"a": want["a"], "b": want[f"b{world}"]},
            ranks=[dict(np.load(work / f"rank{r}.npz"))
                   for r in range(world)],
            checks=[json.loads((work / f"rank{r}.json").read_text())
                    for r in range(world)])
    return out


@pytest.fixture(scope="module")
def run(runs):
    return runs[WORLD]


def _jax_mesh(world):
    return j_make_mesh({"data": world}, devices=jax.devices()[:world])


def _rank_state(run, rank, name):
    prefix = f"{name}/"
    return _port_state(run["tcfg"], {k[len(prefix):]: v for k, v in
                                     run["ranks"][rank].items()
                                     if k.startswith(prefix)})


def _rank_metrics(run, rank, name, step):
    prefix = f"{name}_metrics/{step}/"
    return {k[len(prefix):]: v for k, v in run["ranks"][rank].items()
            if k.startswith(prefix)}


def _assert_ranks_identical(run, name):
    r0 = run["ranks"][0]
    keys = [k for k in r0 if k.split("/")[0] in (name, f"{name}_metrics")]
    assert keys
    for r in run["ranks"][1:]:
        assert sorted(keys) == sorted(
            k for k in r if k.split("/")[0] in (name, f"{name}_metrics"))
        for k in keys:
            np.testing.assert_allclose(r[k], r0[k], rtol=0, atol=0,
                                       err_msg=k)


def test_shard_map_step_matches_jax(run):
    _assert_ranks_identical(run, "a")
    for rank in range(WORLD):
        for s in range(STEPS):
            assert_metrics_close(_rank_metrics(run, rank, "a", s),
                                 run["want"]["a"][s][1])
        assert_states_close(_rank_state(run, rank, "a"),
                            run["want"]["a"][-1][0], STATE_ATOL)


@pytest.mark.parametrize("world", sorted(NAMES))
def test_global_batch_step_ranks_equal_the_single_process_step(runs, world):
    run = runs[world]
    _assert_ranks_identical(run, "b")
    got = export_train_state(_rank_state(run, 0, "b"))
    want = export_train_state(run["single"])
    assert sorted(got) == sorted(want)
    for k in want:
        # As tests/test_torch_train.py holds them: Adam's moments relative
        # to the tensor's largest entry, everything else absolutely.
        scale = (max(1.0, float(np.abs(want[k]).max()))
                 if "_opt/" in k else 1.0)
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=SINGLE_ATOL * scale, err_msg=k)
    for s in range(STEPS):
        got_m = _rank_metrics(run, 0, "b", s)
        assert sorted(got_m) == sorted(run["single_metrics"][s])
        for k, v in run["single_metrics"][s].items():
            np.testing.assert_allclose(got_m[k], float(v), rtol=1e-5,
                                       atol=SINGLE_ATOL, err_msg=k)


def test_global_batch_step_under_save_scans_equals_the_plain_step(run):
    """remat="save_scans" with remat_gp at two ranks: the recompute
    all-reduces BatchNorm's sums again in the backward, in the same order
    on both ranks; nothing deadlocks and nothing is counted twice."""
    _assert_ranks_identical(run, "c")
    got = export_train_state(_rank_state(run, 0, "c"))
    want = export_train_state(_rank_state(run, 0, "b"))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    for s in range(STEPS):
        got_m, want_m = (_rank_metrics(run, 0, n, s) for n in ("c", "b"))
        assert sorted(got_m) == sorted(want_m)
        for k, v in want_m.items():
            np.testing.assert_allclose(got_m[k], v, rtol=1e-6, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("world", sorted(NAMES))
def test_global_batch_step_matches_jax_sharded_jit(runs, world):
    run = runs[world]
    for s in range(STEPS):
        assert_metrics_close(_rank_metrics(run, 0, "b", s),
                             run["want"]["b"][s][1])
    assert_states_close(_rank_state(run, 0, "b"), run["want"]["b"][-1][0],
                        STATE_ATOL)


def test_mesh_and_collectives_at_two_ranks(run):
    for rank, checks in enumerate(run["checks"]):
        meshes = checks["meshes"]
        assert meshes["None"] == [{"data": WORLD}, [rank]]
        assert meshes[str({"data": -1})] == [{"data": WORLD}, [rank]]
        assert meshes[str({"data": 1, "ensemble": WORLD})] == [
            {"data": 1, "ensemble": WORLD}, [0, rank]]
        # Rank 1 lies outside a one-rank mesh, as JAX leaves devices out.
        assert meshes[str({"data": 1})] == [{"data": 1},
                                            [0] if rank == 0 else []]
        assert checks["global_data_mesh"] == {"data": 1, "ensemble": WORLD}
        assert "needs 3 devices, only 2" in checks["too_big"]
        assert checks["replicated"] == [0.0] * 3
        assert "disagree on the seed: [7, 8]" in checks["seed_disagreement"]
        assert checks["seed"] == 7
        # d/dv of sum_r (r + 1) * psum(v): every rank's v feeds all.
        assert checks["psum_grad"] == 3.0


@pytest.mark.parametrize("world", sorted(NAMES))
def test_extreme_rmse_takes_the_global_denominator(runs, world):
    run = runs[world]
    rng = np.random.default_rng(0)
    real = torch.from_numpy(rng.standard_normal((4, 2, 5, 5, 2),
                                                dtype=np.float32))
    fake = torch.from_numpy(rng.standard_normal((4, 2, 5, 5, 2),
                                                dtype=np.float32))
    got = np.concatenate([r["rmse"] for r in run["ranks"]])
    np.testing.assert_allclose(got, extreme_weighted_rmse(real, fake),
                               rtol=1e-6)


@pytest.mark.parametrize("world", sorted(NAMES))
def test_batch_norm_takes_the_global_batch_statistics(runs, world):
    run = runs[world]
    rng = np.random.default_rng(0)
    rng.standard_normal((4, 2, 5, 5, 2), dtype=np.float32)
    rng.standard_normal((4, 2, 5, 5, 2), dtype=np.float32)
    bn = TimeBatchNorm(3)
    with torch.no_grad():
        bn.bn.scale.fill_(1.5)
        bn.bn.bias.fill_(0.25)
        bn.bn.mean.zero_()
        bn.bn.var.fill_(1.0)
    x = torch.from_numpy(2 + 3 * rng.standard_normal((4, 2, 5, 5, 3),
                                                     dtype=np.float32))
    x.requires_grad_()
    y = bn(x, train=True)
    (y * torch.arange(1.0, 4.0)).sum().backward()
    # f32 sums in another order: a few ulps of the O(1) outputs.
    for name, want in (("bn_y", y.detach()), ("bn_grad", x.grad)):
        got = np.concatenate([r[name] for r in run["ranks"]])
        np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-5)
    for r in run["ranks"]:
        np.testing.assert_allclose(r["bn_mean"], bn.bn.mean.numpy(),
                                   rtol=1e-5)
        np.testing.assert_allclose(r["bn_var"], bn.bn.var.numpy(), rtol=1e-5)


def test_two_d_mesh_at_four_ranks_matches_jax(runs):
    """make_mesh({"data": 2, "ensemble": 2}) at 4 ranks: rank r sits where
    JAX's mesh of the same axes over 4 devices puts device r, each axis's
    sub-group sums what JAX's psum over that axis sums (pmean and
    all_reduce alike, psum's gradient too), a second call makes no process
    group, and the 1-D mesh rules hold as at two ranks."""
    from jax import shard_map

    run = runs[4]
    jm = j_make_mesh({"data": 2, "ensemble": 2}, devices=jax.devices()[:4])
    where = {d.id: idx for idx, d in np.ndenumerate(jm.devices)}
    xs = np.stack([[r + 1.0, 10.0 * (r + 1) ** 2] for r in range(4)])
    grid = np.zeros(jm.devices.shape + (2,), np.float32)
    for r in range(4):
        grid[where[jax.devices()[r].id]] = xs[r]
    spec = P("data", "ensemble")
    for axis in ("data", "ensemble"):
        summed = np.asarray(shard_map(
            lambda a, axis=axis: jax.lax.psum(a, axis), mesh=jm,
            in_specs=spec, out_specs=spec)(jnp.asarray(grid)))
        for rank, (checks, out) in enumerate(zip(run["checks"],
                                                 run["ranks"])):
            mesh = checks["two_d_mesh"]
            at = where[jax.devices()[rank].id]
            assert tuple(mesh["coords"]) == at
            want = summed[at]
            np.testing.assert_array_equal(out[f"two_d/psum/{axis}"], want)
            np.testing.assert_array_equal(
                out[f"two_d/all_reduce/{axis}"], want)
            np.testing.assert_allclose(out[f"two_d/pmean/{axis}"],
                                       want / 2, rtol=1e-7)
            # d/dv of sum over the group of (r + 1) * psum(v).
            peers = [r for r in range(4) if
                     [c for a, c in zip(("data", "ensemble"),
                                        where[jax.devices()[r].id])
                      if a != axis] ==
                     [c for a, c in zip(("data", "ensemble"), at)
                      if a != axis]]
            assert mesh["psum_grad"][axis] == [float(sum(
                r + 1 for r in peers))] * 2
    for rank, checks in enumerate(run["checks"]):
        mesh = checks["two_d_mesh"]
        # Two groups per axis, every rank calling new_group for each.
        assert mesh["groups_made"] == 4 and mesh["groups_made_again"] == 0
        assert mesh["reused"] is True
        assert mesh["group_sizes"] == {"data": 2, "ensemble": 2}
        meshes = checks["meshes"]
        assert meshes["None"] == [{"data": 4}, [rank]]
        assert meshes[str({"data": 1, "ensemble": 4})] == [
            {"data": 1, "ensemble": 4}, [0, rank]]
        assert checks["global_data_mesh"] == {"data": 1, "ensemble": 4}
        assert "needs 5 devices, only 4" in checks["too_big"]
        assert checks["replicated"] == [0.0] * 3
        assert ("disagree on the seed: [7, 8, 9, 10]"
                in checks["seed_disagreement"])
        assert checks["psum_grad"] == 10.0


# ---- the mesh rules, without processes --------------------------------------

@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_rules_match_jax(n):
    devices = jax.devices()[:n]
    specs = [None, {"data": -1}, {"data": 1}, {"data": n},
             {"data": -1, "ensemble": 2}, {"data": 2, "ensemble": 2},
             {"ensemble": n}, {"data": n + 1}]
    for spec in specs:
        try:
            jm = j_make_mesh(spec, devices=devices)
            want = dict(zip(jm.axis_names, jm.devices.shape))
        except ValueError as e:
            with pytest.raises(ValueError, match="needs"):
                tmesh.mesh_axes(spec, n)
            assert "needs" in str(e)
            continue
        assert tmesh.mesh_axes(spec, n) == want, spec
    for members in range(1, 9):
        jm = j_inference_mesh(members, devices=devices)
        want = (None if jm is None
                else dict(zip(jm.axis_names, jm.devices.shape)))
        assert tapi.inference_mesh_axes(members, n) == want, members


def test_one_process_mesh_needs_no_group():
    mesh = tmesh.make_mesh()
    assert mesh.shape == {"data": 1} and mesh.coords == (0,)
    assert mesh.group("data") is None
    assert mesh.axis_size("ensemble") == 1 and mesh.axis_index("ensemble") == 0
    assert tapi.inference_mesh(4) is None
    x = np.arange(6.0).reshape(6, 1)
    np.testing.assert_array_equal(tmesh.shard_batch(mesh, x), x)


def test_initialize_distributed_noop_single_process(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize_distributed() is False
    assert distributed.initialize_distributed(device="cpu") is False


@pytest.mark.parametrize("device,backend,want", [
    (None, None, "nccl"), ("cuda", None, "nccl"), ("cpu", None, "gloo"),
    (None, "gloo", "gloo")])
def test_initialize_distributed_backend_is_explicit(monkeypatch, device,
                                                    backend, want):
    """NCCL on the card, gloo on the CPU, another only when named; a CUDA
    rank takes its card before the group exists."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", calls.append)
    monkeypatch.setattr(distributed.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert distributed.initialize_distributed(
        "host:1234", 8, 6, backend=backend, device=device)
    (args, kwargs) = calls[-1]
    assert args == (want,)
    assert kwargs["init_method"] == "tcp://host:1234"
    assert (kwargs["world_size"], kwargs["rank"]) == (8, 6)
    if device != "cpu":
        assert calls[0] == torch.device("cuda", 2)   # rank 6 of 4 cards


@pytest.mark.parametrize("backend,device_ids", [("nccl", [3]),
                                                ("gloo", None)])
def test_loop_barrier_names_the_card_under_nccl(monkeypatch, backend,
                                                device_ids):
    """The barrier before a multi-rank run's first step names this rank's
    card under NCCL (torch otherwise takes the current CUDA context and
    warns) and none under gloo."""
    from windtpu_torch.train import loop

    calls = []
    monkeypatch.setattr(loop, "world", lambda: (0, 2))
    monkeypatch.setattr(loop, "agree", lambda value, what: value)
    monkeypatch.setattr(loop, "replicate_to_mesh", lambda mesh, tree: tree)
    monkeypatch.setattr(loop.dist, "get_backend", lambda: backend)
    monkeypatch.setattr(loop.dist, "barrier", lambda **kw: calls.append(kw))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    _, tcfg = configs(**TRAIN)
    loop.train(tcfg, iter(()), 0, device="cpu", mesh=tmesh.make_mesh())
    assert calls == [{"device_ids": device_ids}]


def test_initialize_distributed_raises_without_a_card_or_flags(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize_distributed("localhost:1", 2, 0)
    for kwargs in ({"num_processes": 2}, {"coordinator_address": "h:1"},
                   {"num_processes": 2, "process_id": 2,
                    "coordinator_address": "h:1"}):
        with pytest.raises(ValueError):
            distributed.initialize_distributed(device="cpu", **kwargs)
    assert not torch.distributed.is_initialized()


def test_failed_nccl_init_raises():
    """No fallback: NCCL that cannot start (no card here) raises, and no
    process group is left behind."""
    from windtpu_torch.utils.hostcpu import free_tcp_port

    with pytest.raises((RuntimeError, ValueError)):
        distributed.initialize_distributed(
            f"localhost:{free_tcp_port()}", 1, 0, backend="nccl",
            device="cpu")
    assert not torch.distributed.is_initialized()

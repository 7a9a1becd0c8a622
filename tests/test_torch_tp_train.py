"""The port's tensor-parallel training against the JAX package, on the CPU.

The port runs one world of 4 gloo processes for the file
(``tests/torch_parallel_worker.py``, suite ``tp_train``), each rank with
its TP shard of JAX's ``init_params`` (fp32, crossing as numpy); JAX runs
on 4 of conftest's 8 virtual CPU devices.

Twins of ``tests/test_train_parallel.py``'s cases: the TP x DP loss and
gradients against single-device autodiff (the oracle's gradients permuted
into the TP layout and cut as JAX places them), dense and MoE (2 whole
experts a rank, the router's gradient equal on every rank), ``grad_accum``,
six steps that lower the loss, and the trained shards served by the TP
decode step. And a TP x CP step (``model`` 2 x ``seq`` 2, the ring) against
JAX's ``make_tp_cp_train_step`` on the same mesh, and one MoE step of
``make_tp_dp_train_step`` and of ``make_tp_cp_train_step`` against JAX's.
JAX's steps run an optax transformation that is SGD at ``worker.LR``
keeping the gradients as its state; the port's SGD with momentum starts
from zero, so after one step its momentum is the reduced gradients and its
update plain SGD's.

Tolerances: fp32, sums in another order: losses, gradients and params
within 2e-5 of each leaf's peak; every rank's loss equal bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JMesh

from starflashattention_tpu.models import llama as j_llama
from starflashattention_tpu.models.train import loss_fn as j_loss_fn
from starflashattention_tpu.parallel import tp as j_tp
from starflashattention_tpu.parallel.train import make_tp_cp_train_step as j_make_tp_cp_train_step
from starflashattention_tpu.parallel.train import make_tp_dp_train_step as j_make_tp_dp_train_step
from starflashattention_tpu.runtime.params import ModelConfig as JConfig

import torch_parallel_worker as worker

torch.set_num_threads(1)

RTOL = 2e-5
N = worker.WORLD


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= RTOL * max(np.abs(want).max(), 1e-12), np.abs(got - want).max()


def _setup(moe=False):
    cfg = JConfig.tiny(**worker.TP_CFG, **(worker.TPT_MOE if moe else {}))
    params = j_llama.init_params(cfg, jax.random.PRNGKey(0))
    cos, sin = j_llama.rope_tables(cfg)
    rng = np.random.default_rng(0)
    batch = rng.integers(0, cfg.vocab_size, (worker.TPT_BATCH, worker.TPT_SEQ + 1)).astype(np.int32)
    return cfg, params, cos, sin, batch


def _jax_mesh(name):
    axes = worker.TPT_MESHES[name]
    return JMesh(np.array(jax.devices()[:N]).reshape(tuple(axes.values())), tuple(axes))


def _shard_of(arr, rank):
    for sh in arr.addressable_shards:
        if sh.device.id == rank:
            return np.asarray(sh.data)
    raise KeyError(rank)


def _keep_grads_sgd(lr):
    """optax SGD at ``lr`` whose state is the last gradients."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(lambda g: -lr * g, grads), grads))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    _, params, _, _, batch = _setup()
    _, moe_params, _, _, _ = _setup(moe=True)
    inputs = {**worker.encode(jax.tree.map(np.asarray, params), "params"),
              **worker.encode(jax.tree.map(np.asarray, moe_params), "moe_params"), "batch": batch}
    return worker.run_world("tp_train", inputs, tmp_path_factory.mktemp("tp_train_world"))


def _check_shards(results, prefix, want_sharded):
    """Each rank's tree under ``prefix`` against the blocks of JAX's sharded
    tree on the device at its position."""
    for r, res in enumerate(results):
        want = worker.flatten(jax.tree.map(lambda a: _shard_of(a, r), want_sharded), prefix)
        assert {k for k in res if k.startswith(prefix + "/")} == set(want)
        for key, w in want.items():
            _close(res[key], w)


@pytest.mark.parametrize("name", ["vg", "vg_accum"])
def test_tp_dp_grads_match_single_device(world, name):
    """Twin of ``test_sharded_grads_match_single_device`` (dense): the TP x
    DP loss and every rank's gradients against ``jax.value_and_grad`` of
    the same loss on one device, its gradients permuted into the TP layout
    and cut by JAX's ``shard_params``; with ``grad_accum=2`` the same."""
    cfg, params, cos, sin, batch = _setup()
    loss, grads = jax.value_and_grad(j_loss_fn)(params, jnp.asarray(batch), cfg, cos, sin)
    for res in world:
        assert res[f"{name}/loss"] == world[0][f"{name}/loss"]
    _close(world[0][f"{name}/loss"], loss)
    _check_shards(world, f"{name}/grads", j_tp.shard_params(grads, _jax_mesh("dp2_tp2"), cfg))


def test_tp_dp_step_matches_jax(world):
    """One TP x DP step against JAX's ``make_tp_dp_train_step``: the
    reduced gradients and the params after it; then twin of
    ``test_sharded_train_step_lowers_loss``: six steps lower the loss."""
    cfg, params, cos, sin, batch = _setup()
    mesh = _jax_mesh("dp2_tp2")
    opt = _keep_grads_sgd(worker.LR)
    p_n = j_tp.shard_params(params, mesh, cfg)
    step = j_make_tp_dp_train_step(mesh, cfg, opt, donate=False)
    new, grads, _ = step(p_n, opt.init(p_n), jnp.asarray(batch), cos, sin)
    _check_shards(world, "step/grads", grads)
    _check_shards(world, "step/params", new)
    losses = world[0]["step/losses"]
    for res in world:
        np.testing.assert_array_equal(res["step/losses"], losses)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_trained_shards_serve(world):
    """Twin of ``test_trained_sharded_params_serve``: the trained shards
    drop into the TP decode step as they are; finite logits, equal on every
    rank."""
    logits = world[0]["serve/logits"]
    for res in world:
        np.testing.assert_array_equal(res["serve/logits"], logits)
    assert np.isfinite(logits).all()


def test_tp_cp_step_matches_jax(world):
    """One TP x CP step (``model`` 2 x ``seq`` 2: Megatron's f and g over
    model, the ring over seq) against JAX's ``make_tp_cp_train_step`` on the
    same mesh: the loss, every rank's gradients and params."""
    cfg, params, cos, sin, batch = _setup()
    mesh = _jax_mesh("tp2_sp2")
    opt = _keep_grads_sgd(worker.LR)
    p_n = j_tp.shard_params(params, mesh, cfg)
    step = j_make_tp_cp_train_step(mesh, cfg, opt, donate=False)
    new, grads, loss = step(p_n, opt.init(p_n), jnp.asarray(batch), cos, sin)
    for res in world:
        assert res["tp_cp/loss"] == world[0]["tp_cp/loss"]
    _close(world[0]["tp_cp/loss"], loss)
    _check_shards(world, "tp_cp/grads", grads)
    _check_shards(world, "tp_cp/params", new)


def test_tp_training_refuses_moe(world):
    """Once the MoE case's refusal, now the ``moe=True`` twin of
    ``test_sharded_grads_match_single_device``: the TP x DP loss and every
    rank's gradients (2 whole experts a rank of ``model``) against
    ``jax.value_and_grad`` on one device, cut as JAX places them; the
    replicated router's gradient, each rank's partial summed by Megatron's
    f on the router weight, equal bit for bit on every rank."""
    cfg, params, cos, sin, batch = _setup(moe=True)
    loss, grads = jax.value_and_grad(j_loss_fn)(params, jnp.asarray(batch), cfg, cos, sin)
    for res in world:
        assert res["moe_vg/loss"] == world[0]["moe_vg/loss"]
        np.testing.assert_array_equal(res["moe_vg/grads/layers/moe_router"],
                                      world[0]["moe_vg/grads/layers/moe_router"])
    _close(world[0]["moe_vg/loss"], loss)
    _check_shards(world, "moe_vg/grads", j_tp.shard_params(grads, _jax_mesh("dp2_tp2"), cfg))
    assert np.abs(world[0]["moe_vg/grads/layers/moe_router"]).max() > 0


@pytest.mark.parametrize("name", ["moe_step", "moe_tp_cp"])
def test_moe_tp_steps_match_jax(world, name):
    """One MoE step of ``make_tp_dp_train_step`` (data 2 x model 2) and of
    ``make_tp_cp_train_step`` (model 2 x seq 2, the ring) against JAX's on
    the same mesh: the loss, every rank's gradients and params."""
    cfg, params, cos, sin, batch = _setup(moe=True)
    mesh = _jax_mesh("dp2_tp2" if name == "moe_step" else "tp2_sp2")
    opt = _keep_grads_sgd(worker.LR)
    p_n = j_tp.shard_params(params, mesh, cfg)
    make = j_make_tp_dp_train_step if name == "moe_step" else j_make_tp_cp_train_step
    new, grads, loss = make(mesh, cfg, opt, donate=False)(p_n, opt.init(p_n), jnp.asarray(batch), cos, sin)
    for res in world:
        assert res[f"{name}/loss"] == world[0][f"{name}/loss"]
    _close(world[0][f"{name}/loss"], loss)
    _check_shards(world, f"{name}/grads", grads)
    _check_shards(world, f"{name}/params", new)

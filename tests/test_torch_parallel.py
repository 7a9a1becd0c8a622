"""The port's meshes, sequence-sharded decode and context-parallel training
against the JAX package, on the CPU.

Covered: ``parallel.mesh.make_mesh`` (each rank's coordinates against the
JAX mesh's device layout), ``parallel.distributed_decode.
make_seq_sharded_decode`` (bf16, head-chunked, int8 KV: twins of
``tests/test_parallel.py::test_seq_sharded_decode_*``) and
``parallel.train.make_cp_train_step`` (CP, CP x DP, the window, the window
with sinks across a chunk edge, ``grad_accum`` and Gemma-2: twins of
``tests/test_train_cp.py``'s cases), and the refusals. JAX runs its
functions on 4 of conftest's 8 virtual CPU devices (Pallas in interpret
mode); the port runs on a world of 4 gloo processes with ``device="cpu"``
(``tests/torch_parallel_worker.py``), spawned once for the file by a module
fixture that runs every case and returns each rank's arrays. The params
are JAX's ``llama.init_params``, crossing as numpy.

The training step is compared on the loss, the gradients and the params
after one step. JAX's step runs an optax transformation that is SGD at
``worker.LR`` and keeps the reduced gradients as its state; the port's SGD
with momentum starts from zero momentum, so its momentum after the step is
its reduced gradients and its update is plain SGD's.

Tolerances: fp32 on both sides, sums in another order: decode outputs,
losses, gradients and params within 2e-5 of each peak (each leaf's); mesh
coordinates and errors exact; every rank holds the same replicated results
bit for bit.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from starflashattention_tpu.core.reference import decode_reference
from starflashattention_tpu.models import llama as j_llama
from starflashattention_tpu.models import train as j_train
from starflashattention_tpu.parallel import make_mesh as j_make_mesh
from starflashattention_tpu.parallel import make_seq_sharded_decode as j_make_seq_sharded_decode
from starflashattention_tpu.parallel.train import make_cp_train_step as j_make_cp_train_step
from starflashattention_tpu.runtime.params import ModelConfig as JConfig
from starflashattention_tpu_torch import parallel as t_parallel
from starflashattention_tpu_torch.models import llama as t_llama
from starflashattention_tpu_torch.models import train as t_train
from starflashattention_tpu_torch.runtime.params import ModelConfig as TConfig
from starflashattention_tpu_torch.utils import bridge

import torch_parallel_worker as worker

torch.set_num_threads(1)

RTOL = 2e-5
N = worker.WORLD


def _assert_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= RTOL * max(np.abs(want).max(), 1e-12), np.abs(got - want).max()


def _decode_inputs():
    rng = np.random.default_rng(3)
    d = worker.DECODE
    q = rng.standard_normal((d["b"], d["hq"], d["d"]), dtype=np.float32)
    k, v = (rng.standard_normal((d["b"], d["hkv"], d["s"], d["d"]), dtype=np.float32) for _ in range(2))
    scales = {}
    for name, x in (("k", k), ("v", v)):  # per-KV-head absmax int8
        s = np.abs(x).max(axis=(0, 2, 3)) / 127.0
        scales[name] = (s.astype(np.float32), np.clip(np.round(x / s[None, :, None, None]), -127, 127)
                        .astype(np.int8))
    out = dict(q=q, k=k, v=v, lengths=np.array([50, d["s"]], np.int32),  # sequence 0: 3 shards empty
               k_scales=scales["k"][0], v_scales=scales["v"][0], k8=scales["k"][1], v8=scales["v"][1])
    return {f"decode_{n}": a for n, a in out.items()}


def _train_setup(name):
    """(JAX config, JAX params, cos, sin, batch) of a training config."""
    preset, overrides, b, s = worker.TRAIN_CONFIGS[name]
    cfg = getattr(JConfig, preset)(**overrides)
    params = j_llama.init_params(cfg, jax.random.PRNGKey(3 if name == "gemma2" else 0))
    cos, sin = j_llama.rope_tables(cfg)
    rng = np.random.default_rng(len(name))
    batch = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return cfg, params, cos, sin, batch


def _inputs():
    inputs = _decode_inputs()
    for name in worker.TRAIN_CONFIGS:
        _, params, _, _, batch = _train_setup(name)
        inputs.update(worker.flatten(jax.tree.map(np.asarray, params), f"params_{name}"))
        inputs[f"batch_{name}"] = batch
    return inputs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case on the port's 4 ranks, once: (inputs, [each rank's arrays])."""
    inputs = _inputs()
    return inputs, worker.run_world("parallel", inputs, tmp_path_factory.mktemp("parallel_world"))


@pytest.mark.parametrize("axes", [{"seq": 4}, {"data": 2, "seq": 2}])
def test_make_mesh_matches_jax(world, axes):
    """Each rank's index along each axis and its group's ranks: rank r sits
    where device r sits in JAX's mesh."""
    name = "seq4" if axes == {"seq": 4} else "dp2_seq2"
    jmesh = j_make_mesh(axes, devices=jax.devices()[:N])
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for r, res in enumerate(world[1]):
        coords = np.argwhere(ids == r)[0]
        for i, ax in enumerate(axes):
            size, index, *ranks = res[f"mesh_{name}/{ax}"].tolist()
            idx = list(coords)
            idx[i] = slice(None)
            assert (size, index) == (axes[ax], coords[i])
            assert ranks == ids[tuple(idx)].tolist()


@pytest.mark.parametrize("case", list(worker.DECODE_CASES))
def test_seq_sharded_decode_matches_jax(world, case):
    """Twins of ``test_seq_sharded_decode_matches_reference`` and
    ``test_seq_sharded_decode_head_chunked_matches``, and int8 KV: every
    rank's merged output against JAX's sharded decode (and JAX's
    ``decode_reference`` for the bf16 cases)."""
    inputs, results = world
    d = worker.DECODE
    kw = dict(worker.DECODE_CASES[case])
    mesh = j_make_mesh({"seq": N}, devices=jax.devices()[:N])
    fn = j_make_seq_sharded_decode(mesh, seq_axis="seq", num_splits=d["num_splits"], block_k=d["block_k"], **kw)
    a = {n: jnp.asarray(inputs[f"decode_{n}"]) for n in ("q", "k", "v", "k8", "v8", "k_scales", "v_scales",
                                                      "lengths")}
    if kw.get("quantized"):
        want = np.asarray(fn(a["q"], a["k8"], a["v8"], a["lengths"], a["k_scales"], a["v_scales"]))
    else:
        want = np.asarray(fn(a["q"], a["k"], a["v"], a["lengths"]))
        _assert_close(want, decode_reference(a["q"], a["k"], a["v"], a["lengths"]))
    for res in results:
        np.testing.assert_array_equal(res[f"decode_{case}/o"], results[0][f"decode_{case}/o"])
    _assert_close(results[0][f"decode_{case}/o"], want)


def _keep_grads_sgd(lr):
    """optax SGD at ``lr`` whose state is the last gradients."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(lambda g: -lr * g, grads), grads))


_JAX_STEPS = {}


def _jax_step(cfg_name, axes):
    """JAX's CP step from the config's params: (loss, grads, params)."""
    key = (cfg_name, tuple(axes))
    if key not in _JAX_STEPS:
        cfg, params, cos, sin, batch = _train_setup(cfg_name)
        mesh = j_make_mesh(axes, devices=jax.devices()[:N])
        opt = _keep_grads_sgd(worker.LR)
        step = j_make_cp_train_step(mesh, cfg, opt, data_axis="data" if "data" in axes else None,
                                    donate=False)
        new, grads, loss = step(params, opt.init(params), jnp.asarray(batch), cos, sin)
        _JAX_STEPS[key] = (float(loss), jax.tree.map(np.asarray, grads), jax.tree.map(np.asarray, new))
    return _JAX_STEPS[key]


def _check_tree(results, prefix, want):
    flat_want = worker.flatten(want, prefix)
    for key, w in flat_want.items():
        for res in results:
            np.testing.assert_array_equal(res[key], results[0][key])  # replicated: equal on every rank
        _assert_close(results[0][key], w)
    assert {k for k in results[0] if k.startswith(prefix + "/")} == set(flat_want)


@pytest.mark.parametrize("case", list(worker.TRAIN_CASES))
def test_cp_step_matches_jax(world, case):
    """Twins of ``test_cp_step_matches_single_device``,
    ``test_cp_dp_step_matches_single_device``, ``test_cp_sliding_window``,
    ``test_grad_accum_matches_full_batch`` (the CP half: ``grad_accum=2``
    against JAX's whole-batch step) and
    ``test_gemma2_cp_step_matches_single_device``, and Mistral-style sinks
    across a chunk edge: the loss, every gradient and every param after one
    step, equal on every rank."""
    _, results = world
    cfg_name, axes, _ = worker.TRAIN_CASES[case]
    loss, grads, params = _jax_step(cfg_name, axes)
    for res in results:
        assert res[f"train_{case}/loss"] == results[0][f"train_{case}/loss"]
    _assert_close(results[0][f"train_{case}/loss"], loss)
    _check_tree(results, f"train_{case}/grads", grads)
    _check_tree(results, f"train_{case}/params", params)


def test_cp_grad_accum_matches_whole_batch(world):
    """``grad_accum=2`` on the port equals the port's whole-batch step
    (the math is the same: a mean of equal microbatch means)."""
    res = world[1][0]
    _assert_close(res["train_cp_accum/loss"], res["train_cp/loss"])
    for key in res:
        if key.startswith("train_cp/"):
            _assert_close(res[key.replace("train_cp/", "train_cp_accum/")], res[key])


def test_cp_requires_flash():
    """As JAX: context-parallel training without the flash path is refused
    before anything runs."""
    jcfg = JConfig.tiny(dtype="float32")
    jparams = j_llama.init_params(jcfg, jax.random.PRNGKey(0))
    jcos, jsin = j_llama.rope_tables(jcfg)
    inp = jnp.zeros((1, 8), jnp.int32)
    with pytest.raises(ValueError, match="context-parallel training requires the flash path"):
        j_train.loss_tokens(jparams, inp, inp, jcfg, jcos, jsin, use_flash=False, seq_axis_name="seq")
    tcfg = TConfig.tiny(dtype="float32")
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    cos, sin = t_llama.rope_tables(tcfg, device="cpu")
    tinp = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="context-parallel training requires the flash path"):
        t_train.loss_tokens(params, tinp, tinp, tcfg, cos, sin, use_flash=False, seq_axis_name=object())


def _fake_mesh(axes):
    """A mesh as its rank 0 sees it, without a process group: enough for
    what raises before any collective."""
    from starflashattention_tpu_torch.parallel.mesh import Axis, Mesh

    return Mesh({name: Axis(name, size, 0, tuple(range(size)), None, "gloo") for name, size in axes.items()},
                torch.device("cpu"))


@pytest.mark.parametrize("name", ["make_tp_dp_value_and_grad", "make_tp_dp_train_step",
                                  "make_tp_cp_train_step", "make_tp_decode_step", "make_pp_decode_step"])
def test_tensor_parallel_entries_refused(name):
    """The tensor-parallel and pipeline entry points are ported
    (tests/test_torch_tp.py, tests/test_torch_tp_train.py); given KV heads
    that the model axis does not divide they raise JAX's own error, as the
    JAX entries do on a mesh of the same shape."""
    jcfg = JConfig.tiny(dtype="float32", num_kv_heads=2)
    tcfg = TConfig.tiny(dtype="float32", num_kv_heads=2)
    axes = {"pipe": 2, "model": 4} if name == "make_pp_decode_step" else {"data": 2, "model": 4}
    if name == "make_tp_cp_train_step":
        axes = {"seq": 2, "model": 4}
    extra = {"make_tp_dp_train_step": (optax.sgd(0.1),), "make_tp_cp_train_step": (optax.sgd(0.1),),
             "make_pp_decode_step": (j_llama.init_params(jcfg, jax.random.PRNGKey(0)),)}.get(name, ())
    jmesh = j_make_mesh(axes, devices=jax.devices()[:8])
    jfn = getattr(importlib.import_module("starflashattention_tpu.parallel"), name)
    with pytest.raises(ValueError, match="num_kv_heads 2 not divisible by model-axis size 4"):
        jfn(jmesh, jcfg, *extra)
    lr = {"make_tp_dp_train_step": (0.1,), "make_tp_cp_train_step": (0.1,)}.get(name, ())
    with pytest.raises(ValueError, match="num_kv_heads 2 not divisible by model-axis size 4"):
        getattr(t_parallel, name)(_fake_mesh(axes), tcfg, *lr)

"""The port's tensor, expert and pipeline parallelism against the JAX
package, on the CPU.

The port runs one world of 4 gloo processes for the file
(``tests/torch_parallel_worker.py``, suite ``tp``, ``device="cpu"``: the
ops take their plain twins), spawned once by a module fixture; each rank
holds its own shard. JAX runs its sharded programs on 4 of conftest's 8
virtual CPU devices (Pallas in interpret mode) on the same mesh shape, rank
r standing where device r stands. The params are JAX's ``init_params``
(quantized by JAX where a case says so), crossing as numpy.

Twins of ``tests/test_parallel.py``'s TP cases (decode, prefill then
decode, int8 / int4 weights, int8 KV, W8A8 / W4A8 prefill, the int4 group
misalignment) and expert parallelism (Mixtral- and DeepSeek-style MoE,
dense and int8 experts), with the shard layouts against JAX's placements.
The serving twins are ``tests/test_torch_tp_serving.py``, the pipeline's
``tests/test_torch_pp.py``.

Tolerances: fp32. Greedy streams, int8 bytes, row scales and errors exact;
logits and caches within 2e-5 of the reference's peak (sums over the model
axis in another order). The W8A8 / W4A8 prefills hold the logits within
1e-4 absolute, as ``tests/test_torch_quant.py`` holds JAX's jitted W8A8
model: XLA may compute a row scale as ``absmax * (1 / 127)``, one fp32 ulp
from the eager division, which can move one int8 step. Every rank holds
the replicated results (logits, streams) bit for bit the same.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from starflashattention_tpu.cache import contiguous as j_cache
from starflashattention_tpu.models import llama as j_llama
from starflashattention_tpu.parallel import tp as j_tp
from starflashattention_tpu.parallel.mesh import make_mesh as j_make_mesh
from starflashattention_tpu.runtime.params import ModelConfig as JConfig
from starflashattention_tpu_torch import parallel as t_parallel
from starflashattention_tpu_torch.cache import contiguous as t_cache
from starflashattention_tpu_torch.models import llama as t_llama
from starflashattention_tpu_torch.ops.quant_matmul import quantize_rows
from starflashattention_tpu_torch.runtime.params import ModelConfig as TConfig
from starflashattention_tpu_torch.utils import bridge

import torch_parallel_worker as worker

j_qmm = importlib.import_module("starflashattention_tpu.ops.quant_matmul")

torch.set_num_threads(1)

RTOL = 2e-5
A8_ATOL = 1e-4
N = worker.WORLD
STEP_KEYS = {"decode": 0, "decode_tp4": 0, "prefill": 1, "int8w_decode": 3, "int8w_prefill": 4,
             "int8kv_decode": 2, "int4_decode": 11, "w8a8_prefill": 9, "w4a8_prefill": 10, "moe_decode": 5,
             "moe_int8_decode": 6, "deepseek_decode": 7}
STEP_QUANT = {"int8w_decode": ("int8", {}), "int8w_prefill": ("int8", {}), "int4_decode": ("int4", {"int4_group": 16}),
              "w8a8_prefill": ("int8", {}), "w4a8_prefill": ("int4", {"int4_group": 16}),
              "moe_int8_decode": ("int8", {})}


def _close(got, want, rel=RTOL, atol=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = atol if atol is not None else rel * max(np.abs(want).max(), 1e-12)
    assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)


def _jax_mesh(axes):
    """JAX's mesh of the same shape on the first 4 virtual devices; the TP
    programs need a data axis, so a model-only mesh gets one of size 1."""
    if set(axes) == {"model"}:
        axes = {"data": 1, **axes}
    return JMesh(np.array(jax.devices()[:N]).reshape(tuple(axes.values())), tuple(axes))


def _shard_of(arr, rank):
    """The block of a sharded JAX array that device ``rank`` holds."""
    for sh in arr.addressable_shards:
        if sh.device.id == rank:
            return np.asarray(sh.data)
    raise KeyError(rank)


def _step_cfg(case):
    return JConfig.tiny(**worker.TP_CFG, **worker.TP_STEPS[case][0])


def _quantized(params, spec):
    if spec is None:
        return params
    mode, kw = spec
    return j_llama.quantize_model_weights(params, mode, **kw)


def _step_inputs(case):
    cfg = _step_cfg(case)
    _, _, b, sp = worker.TP_STEPS[case]
    params = _quantized(j_llama.init_params(cfg, jax.random.PRNGKey(STEP_KEYS[case])), STEP_QUANT.get(case))
    rng = np.random.default_rng(STEP_KEYS[case])
    out = {}
    if sp:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, sp)).astype(np.int32)
        out["plens"] = np.array([sp, 3] if b == 2 else [sp, 100, sp, 37][:b], np.int32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
    return cfg, params, out


def _inputs():
    inputs = {}
    for case in worker.TP_STEPS:
        cfg, params, arrays = _step_inputs(case)
        inputs.update(worker.encode(jax.tree.map(np.asarray, params), f"{case}/params"))
        inputs.update({f"{case}/{k}": v for k, v in arrays.items()})
        if worker.TP_STEPS[case][3]:
            inputs[f"{case}/next"] = _jax_prefill_then_next(case)
    inputs["rows/x"] = _row_inputs()
    return inputs


def _row_inputs():
    """(rows, H) activations whose row maxima lie in different quarters."""
    rng = np.random.default_rng(21)
    rows, h = worker.ROW_SCALES
    x = rng.standard_normal((rows, h)).astype(np.float32)
    x[np.arange(rows), rng.integers(0, h, rows)] *= 9.0
    return x


_JAX_STEPS = {}


def _jax_step(case):
    """JAX's TP step on the same mesh shape: {prefill_logits, logits, cache}."""
    if case in _JAX_STEPS:
        return _JAX_STEPS[case]
    cfg, params, arrays = _step_inputs(case)
    _, mesh_name, b, sp = worker.TP_STEPS[case]
    mesh = _jax_mesh(worker.TP_MESHES[mesh_name])
    wq = j_tp._params_are_weight_quant(params)
    quant_kv = cfg.quant_mode != "none"
    cos, sin = j_llama.rope_tables(cfg)
    kw = dict(calibration_scale=8.0, quant_mode=cfg.quant_mode) if quant_kv else dict(dtype=jnp.float32)
    cache = j_tp.shard_cache(j_cache.init_cache(cfg.num_layers, b, cfg.num_kv_heads, cfg.max_seq_len,
                                                cfg.head_dim, **kw), mesh)
    p_n = j_tp.shard_params(params, mesh, cfg)
    res = {}
    toks = jnp.asarray(arrays["tokens"])
    if sp:
        pre = j_tp.make_tp_prefill(mesh, cfg, quantized=quant_kv, weight_quant=wq)
        res["prefill_logits"], cache = pre(p_n, cache, toks, jnp.asarray(arrays["plens"]), cos, sin)
        toks = jnp.argmax(res["prefill_logits"], -1).astype(jnp.int32)
    step = j_tp.make_tp_decode_step(mesh, cfg, quantized=quant_kv, weight_quant=wq)
    res["logits"], cache = step(p_n, cache, toks, cos, sin)
    res["cache"] = cache
    _JAX_STEPS[case] = res
    return res


def _jax_prefill_then_next(case):
    return np.asarray(jnp.argmax(_jax_step(case)["prefill_logits"], -1).astype(jnp.int32))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case on the port's 4 ranks, once: [each rank's arrays]."""
    return worker.run_world("tp", _inputs(), tmp_path_factory.mktemp("tp_world"))


def _replicated(results, key):
    for res in results:
        np.testing.assert_array_equal(res[key], results[0][key])
    return results[0][key]


# ----------------------------------------------------------------- TP steps


def _one_process(case):
    """The port's single-process prefill and decode of a step case: (logits
    of each, the whole cache)."""
    cfg, params, arrays = _step_inputs(case)
    tcfg = TConfig.tiny(**worker.TP_CFG, **worker.TP_STEPS[case][0])
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params))
    b = worker.TP_STEPS[case][2]
    cache = t_cache.init_cache(tcfg.num_layers, b, tcfg.num_kv_heads, tcfg.max_seq_len, tcfg.head_dim,
                               dtype=torch.float32, device="cpu")
    cos, sin = t_llama.rope_tables(tcfg, device="cpu")
    pre, cache = t_llama.prefill(tparams, cache, torch.from_numpy(arrays["tokens"]),
                                 torch.from_numpy(arrays["plens"]), cos, sin, tcfg)
    logits, cache = t_llama.decode_step(tparams, cache, torch.from_numpy(_jax_prefill_then_next(case).copy()), cos,
                                        sin, tcfg)
    return pre.numpy(), logits.numpy(), cache.k.numpy()


@pytest.mark.parametrize("case", list(worker.TP_STEPS))
def test_tp_step_matches_jax(world, case):
    """Twins of ``test_tp_decode_matches_single_chip``,
    ``test_tp_prefill_then_decode``, ``test_tp_decode_quantized_weights``,
    ``test_tp_prefill_quantized_weights``, ``test_tp_decode_quantized``,
    ``test_tp_decode_int4_weights``, ``test_tp_prefill_w8a8_bitmatch`` and
    ``test_tp_prefill_w4a8_int4_bitmatch``, and expert parallelism (whole
    experts a rank, Mixtral's and DeepSeek's routers with its shared expert
    and dense first layer on index 0): each rank's logits (equal on every
    rank) and its cache shard against JAX's TP step on the same mesh. The
    W8A8 / W4A8 prefills hold the logits to JAX's within 1e-4 (see the
    module doc), and to the port's single process within 2e-5 of the
    peak, as layer 0's cache shard: both sides quantize layer 0's rows with
    the same full-row scales. Deeper layers' rows come after a sum over the
    model axis in another order, which can move an activation on a
    rounding boundary by one int8 step, so their caches are not held to
    2e-5."""
    want = _jax_step(case)
    a8 = case.startswith(("w8a8", "w4a8"))
    tol = dict(atol=A8_ATOL) if a8 else {}
    if "prefill_logits" in want:
        _close(_replicated(world, f"{case}/prefill_logits"), want["prefill_logits"], **tol)
    _close(_replicated(world, f"{case}/logits"), want["logits"], **tol)
    if a8:
        pre, logits, k = _one_process(case)
        _close(world[0][f"{case}/prefill_logits"], pre)
        _close(world[0][f"{case}/logits"], logits)
        mesh = worker.TP_MESHES[worker.TP_STEPS[case][1]]
    for r, res in enumerate(world):
        if a8:
            c = worker.mesh_coords(mesh, r)
            rows, heads = k.shape[1] // mesh.get("data", 1), k.shape[2] // mesh["model"]
            d, m = c.get("data", 0), c["model"]
            _close(res[f"{case}/k"][0], k[0, d * rows:(d + 1) * rows, m * heads:(m + 1) * heads])
        else:
            _close(res[f"{case}/k"], _shard_of(want["cache"].k, r))
        np.testing.assert_array_equal(res[f"{case}/lengths"], _shard_of(want["cache"].lengths, r))


def test_tp_row_scales_are_the_full_rows(world):
    """W8A8 / W4A8 under TP quantize with the full row's scale: each rank's
    int8 bytes of its quarter of every row and the row scales equal the
    single process's ``quantize_rows`` (and JAX's) bit for bit."""
    x = _row_inputs()
    x8, rs = quantize_rows(torch.from_numpy(x))
    j8, jrs = j_qmm.quantize_rows(jnp.asarray(x))
    np.testing.assert_array_equal(x8.numpy(), np.asarray(j8))
    np.testing.assert_array_equal(rs.numpy(), np.asarray(jrs))
    c = x.shape[1] // N
    for r, res in enumerate(world):
        np.testing.assert_array_equal(res["rows/x8"], x8.numpy()[:, r * c:(r + 1) * c])
        np.testing.assert_array_equal(res["rows/rs"], rs.numpy())
    assert all(int(res["host_bytes"]) == 0 for res in world)


def test_tp_int4_group_misalignment_raises():
    """Twin of ``test_tp_int4_group_misalignment_raises``: a row-parallel
    group count the model axis does not divide is refused, as in JAX."""
    cfg = JConfig.tiny(**worker.TP_CFG)
    params = j_llama.quantize_model_weights(j_llama.init_params(cfg, jax.random.PRNGKey(12)), "int4",
                                            int4_group=128)
    with pytest.raises(ValueError, match="scale groups"):
        j_tp.shard_params(params, j_make_mesh({"data": 2, "model": 4}), cfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params))
    with pytest.raises(ValueError, match="scale groups"):
        t_parallel.shard_params(tparams, worker.fake_mesh({"data": 1, "model": 4}, 0), TConfig.tiny(**worker.TP_CFG))


@pytest.mark.parametrize("tp", [2, 4])
def test_permute_params_for_tp_matches_jax(tp):
    """The one-time fused-column permutation (``[q_t|k_t|v_t]``,
    ``[gate_t|up_t]``, the QKV bias) equals JAX's, quantized payloads and
    scales included."""
    cfg = JConfig.tiny(**worker.TP_CFG, attention_bias=True)
    params = j_llama.quantize_model_weights(j_llama.init_params(cfg, jax.random.PRNGKey(6)), "int8")
    want = worker.flatten(jax.tree.map(np.asarray, j_tp.permute_params_for_tp(params, cfg, tp)), "p")
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params))
    got = worker.flatten(bridge.params_to_numpy(
        t_parallel.tp.permute_params_for_tp(tparams, TConfig.tiny(**worker.TP_CFG, attention_bias=True), tp)), "p")
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key], got[key].dtype), err_msg=key)


@pytest.mark.parametrize("weights", ["dense", "int8", "int4"])
def test_shard_params_matches_jax_shards(weights):
    """Every rank's local params are the blocks JAX's ``shard_params``
    places on the device at its position (permuted fused columns,
    quantized payloads and scales, int4 groups, the vocab-sharded head)."""
    cfg = JConfig.tiny(**worker.TP_CFG, attention_bias=True)
    params = j_llama.init_params(cfg, jax.random.PRNGKey(4))
    if weights != "dense":
        params = j_llama.quantize_model_weights(params, weights, lm_head=True,
                                                **({"int4_group": 16} if weights == "int4" else {}))
    axes = {"data": 2, "model": 2}
    j_local = j_tp.shard_params(params, _jax_mesh(axes), cfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params))
    tcfg = TConfig.tiny(**worker.TP_CFG, attention_bias=True)
    for r in range(N):
        got = worker.flatten(bridge.params_to_numpy(t_parallel.shard_params(tparams, worker.fake_mesh(axes, r), tcfg)),
                             "p")
        want = worker.flatten(jax.tree.map(lambda a: _shard_of(a, r), j_local), "p")
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], np.asarray(want[key], got[key].dtype), err_msg=key)



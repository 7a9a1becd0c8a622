"""The port's pipeline parallelism against the JAX package, on the CPU.

The port runs one world of 4 gloo processes for the file
(``tests/torch_parallel_worker.py``, suite ``pp``, ``device="cpu"``): each
rank holds its stage's layers (and on a (pipe, model) mesh its TP shard of
them) of JAX's ``init_params``, crossing as numpy, and the cache JAX's
prefill left. JAX runs its single-device decode, as ``tests/test_pp.py``
holds its own PP step to it.

Twins of ``tests/test_pp.py``: stages x microbatches ((4, 4), (4, 2) and
(2, 2) on a (data 2, pipe 2) mesh), int8 weights, MoE, PP x TP (dense and
int8), indivisible layers, Gemma-2's alternating windows; and
``pp_param_specs`` leaf for leaf.

Tolerances: fp32. Tokens exact; logits and caches within 2e-5 of the
reference's peak; every rank's tokens and logits equal bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starflashattention_tpu.cache import contiguous as j_cache
from starflashattention_tpu.models import llama as j_llama
from starflashattention_tpu.parallel import pp as j_pp
from starflashattention_tpu.parallel.mesh import make_mesh as j_make_mesh
from starflashattention_tpu.runtime.params import ModelConfig as JConfig
from starflashattention_tpu_torch import parallel as t_parallel
from starflashattention_tpu_torch.runtime.params import ModelConfig as TConfig
from starflashattention_tpu_torch.utils import bridge

import torch_parallel_worker as worker

torch.set_num_threads(1)

RTOL = 2e-5
N = worker.WORLD


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= RTOL * max(np.abs(want).max(), 1e-12), np.abs(got - want).max()


def _replicated(results, key):
    for res in results:
        np.testing.assert_array_equal(res[key], results[0][key])
    return results[0][key]


def _pp_cfg(case):
    if case == "pp2_gemma2":
        return JConfig.gemma2_9b(**worker.PP_GEMMA2)
    return JConfig.tiny(dtype="float32", **worker.PP_CASES[case][0])


def _pp_setup(case):
    """(cfg, params, cache after a prefill, the first decoded tokens) as
    tests/test_pp.py's ``_setup`` makes them."""
    cfg = _pp_cfg(case)
    weights = "dense" if case == "pp2_gemma2" else worker.PP_CASES[case][3]
    params = j_llama.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    cos, sin = j_llama.rope_tables(cfg)
    b, plen = worker.PP_BATCH, 12 if case == "pp2_gemma2" else worker.PP_PROMPT
    cache = j_cache.init_cache(cfg.num_layers, b, cfg.num_kv_heads, cfg.max_seq_len, cfg.head_dim,
                               dtype=jnp.float32)
    toks = (jnp.arange(b * plen, dtype=jnp.int32).reshape(b, plen) * 7 + 3) % cfg.vocab_size
    logits0, cache = j_llama.prefill(params, cache, toks, jnp.full((b,), plen, jnp.int32), cos, sin, cfg)
    nxt = jnp.argmax(logits0, -1).astype(jnp.int32)
    if weights == "int8":
        params = j_llama.quantize_model_weights(params)
    return cfg, params, cache, nxt


def _inputs():
    inputs = {}
    for case in [*worker.PP_CASES, "pp2_gemma2"]:
        _, params, cache, nxt = _pp_setup(case)
        inputs.update(worker.encode(jax.tree.map(np.asarray, params), f"{case}/params"))
        for name in ("k", "v", "lengths"):
            inputs[f"{case}/cache_{name}"] = np.asarray(getattr(cache, name))
        inputs[f"{case}/next"] = np.asarray(nxt)
    return inputs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case on the port's 4 ranks, once: [each rank's arrays]."""
    return worker.run_world("pp", _inputs(), tmp_path_factory.mktemp("pp_world"))


_JAX_PP = {}


def _jax_pp_stream(case):
    """JAX's single-device stream of PP_STEPS greedy decode steps:
    (tokens (n + 1, B), last logits, cache)."""
    if case not in _JAX_PP:
        cfg, params, cache, nxt = _pp_setup(case)
        cos, sin = j_llama.rope_tables(cfg)
        out = [nxt]
        for _ in range(worker.PP_STEPS):
            logits, cache = j_llama.decode_step(params, cache, out[-1], cos, sin, cfg)
            out.append(jnp.argmax(logits, -1).astype(jnp.int32))
        _JAX_PP[case] = (np.stack([np.asarray(t) for t in out]), np.asarray(logits), cache)
    return _JAX_PP[case]


@pytest.mark.parametrize("case", [*worker.PP_CASES, "pp2_gemma2"])
def test_pp_decode_matches_jax(world, case):
    """Twins of ``test_pp_decode_matches_single_chip`` (stages x
    microbatches: (4, 4), (4, 2), (2, 2)), ``test_pp_with_quantized_weights``,
    ``test_pp_with_moe``, ``test_pp_tp_2d_mesh_matches_single_chip`` (dense
    and int8) and ``test_pp_gemma2_alternating_windows_match_single_chip``:
    every rank's tokens equal JAX's single-device stream, its logits (equal
    on every rank) within 2e-5 of the peak, and its cache shard (its
    stage's layers, its heads) equal to JAX's below the lengths. The port
    runs no idle pipeline tick, so the row JAX sacrifices is not compared."""
    toks, logits, cache = _jax_pp_stream(case)
    mesh_name = "dp2_pp2" if case == "pp2_gemma2" else worker.PP_CASES[case][1]
    np.testing.assert_array_equal(_replicated(world, f"{case}/tokens"), toks)
    _close(_replicated(world, f"{case}/logits"), logits)
    k, lengths = np.asarray(cache.k), np.asarray(cache.lengths)
    stages = worker.PP_MESHES[mesh_name]["pipe"]
    l_local = k.shape[0] // stages
    rows = int(lengths.max())
    assert (lengths == rows).all()
    for r, res in enumerate(world):
        c = worker.mesh_coords(worker.PP_MESHES[mesh_name], r)
        want = k[c["pipe"] * l_local:(c["pipe"] + 1) * l_local]
        if "model" in c:
            h = want.shape[2] // 2
            want = want[:, :, c["model"] * h:(c["model"] + 1) * h]
        _close(res[f"{case}/k"][..., :rows, :], want[..., :rows, :])
        np.testing.assert_array_equal(res[f"{case}/lengths"], lengths)


def test_pp_refusals():
    """Twin of ``test_pp_rejects_indivisible_layers``, and DeepSeek's
    ``first_k_dense`` stays refused under PP, as in JAX."""
    jcfg = JConfig.tiny(dtype="float32", num_layers=3)
    with pytest.raises(ValueError, match="not divisible"):
        j_pp.make_pp_decode_step(j_make_mesh({"pipe": 2}, devices=jax.devices()[:2]), jcfg,
                                 j_llama.init_params(jcfg, jax.random.PRNGKey(0)))
    mesh = worker.fake_mesh({"pipe": 2}, 0)
    with pytest.raises(ValueError, match="not divisible"):
        t_parallel.make_pp_decode_step(mesh, TConfig.tiny(dtype="float32", num_layers=3))
    ds = TConfig.tiny(dtype="float32", num_layers=2, num_experts=4, first_k_dense=1, dense_inter_size=96)
    with pytest.raises(NotImplementedError, match="first_k_dense"):
        t_parallel.make_pp_decode_step(mesh, ds)


def test_pp_specs_match_jax():
    """``pp_param_specs`` names the axes JAX's does, leaf for leaf, on a
    pipe mesh and on a (pipe, model) mesh."""
    cfg = JConfig.tiny(dtype="float32", num_layers=4, num_q_heads=8, num_kv_heads=4)
    params = j_llama.quantize_model_weights(j_llama.init_params(cfg, jax.random.PRNGKey(0)))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params))
    tcfg = TConfig.tiny(dtype="float32", num_layers=4, num_q_heads=8, num_kv_heads=4)

    def strip(spec):  # trailing Nones name no axis
        spec = list(spec)
        while spec and spec[-1] is None:
            spec.pop()
        return tuple(spec)

    for axes in ({"pipe": 4}, {"pipe": 2, "model": 2}):
        jmesh = j_make_mesh(axes, devices=jax.devices()[:N])
        want = worker.flatten(jax.tree.map(lambda s: strip(s), j_pp.pp_param_specs(params, cfg, jmesh),
                                           is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)), "p")
        got = worker.flatten(t_parallel.pp_param_specs(tparams, tcfg, worker.fake_mesh(axes, 0)), "p")
        assert {k: strip(v) for k, v in got.items()} == want

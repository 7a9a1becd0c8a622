"""The port's tensor- and data-parallel serving against the JAX package, on
the CPU.

The port runs one world of 4 gloo processes for the file
(``tests/torch_parallel_worker.py``, suite ``tp_serving``,
``device="cpu"``): ``Engine(mesh=)`` / ``PagedEngine(mesh=)`` on a
(data 2, model 2) mesh, every rank with the full params of JAX's
``init_params`` (quantized by JAX where a case says so), crossing as numpy.

Twins of ``tests/test_tp_serving.py`` (engine, quantized weights, fp8
weights + int8 KV, paged, per-shard preemption, chunked prefill on both
engines, the int8 lm_head, int4, the refusals), and speculative decoding
under the mesh (prompt lookup; a draft model replicated on every rank) and
sampled requests. Greedy streams exact, against the single-device JAX
engine (JAX's own tests hold its mesh engines to it exactly); every rank's
streams equal bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from starflashattention_tpu.models import llama as j_llama
from starflashattention_tpu.runtime.params import ModelConfig as JConfig
from starflashattention_tpu.serving import Engine as JEngine
from starflashattention_tpu.serving import PagedEngine as JPagedEngine
from starflashattention_tpu_torch.core import sampling as t_sampling
from starflashattention_tpu_torch.models import llama as t_llama
from starflashattention_tpu_torch.models import lora as t_lora
from starflashattention_tpu_torch.runtime.params import ModelConfig as TConfig
from starflashattention_tpu_torch.serving import Engine as TEngine
from starflashattention_tpu_torch.serving import PagedEngine as TPagedEngine
from starflashattention_tpu_torch.utils import bridge

import torch_parallel_worker as worker

torch.set_num_threads(1)

ENGINE_KEYS = {"engine": 0, "int8w": 1, "fp8w_int8kv": 5, "paged": 3, "paged_preempt": 4, "chunked": 7,
               "chunked_paged": 8, "int8_lm_head": 7, "int4": 7, "spec_ngram": 12, "spec_draft": 13, "sampled": 0}
ENGINE_QUANT = {"int8w": ("int8", {}), "fp8w_int8kv": ("fp8", {}), "int8_lm_head": ("int8", {"lm_head": True}),
                "int4": ("int4", {"int4_group": 16})}


def _quantized(params, spec):
    if spec is None:
        return params
    mode, kw = spec
    return j_llama.quantize_model_weights(params, mode, **kw)


def _engine_setup(case):
    over, eng_name, kw, lens, n_new = worker.TP_ENGINES[case]
    cfg = JConfig.tiny(**{**worker.TP_CFG, **over})
    params = _quantized(j_llama.init_params(cfg, jax.random.PRNGKey(ENGINE_KEYS[case])), ENGINE_QUANT.get(case))
    rng = np.random.default_rng(ENGINE_KEYS[case])
    if case.startswith("spec"):  # motifs that repeat, so prompt lookup finds drafts
        motif = rng.integers(0, cfg.vocab_size, 4).tolist()
        prompts = [(motif * 4)[:n] for n in lens]
    else:
        prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)] for n in lens]
    draft = None
    if case == "spec_draft":
        dcfg = JConfig.tiny(**{**worker.TP_CFG, **over, "num_layers": 1})
        draft = (j_llama.init_params(dcfg, jax.random.PRNGKey(99)), dcfg)
    return cfg, params, prompts, draft


def _inputs():
    inputs = {}
    for case in worker.TP_ENGINES:
        _, params, prompts, draft = _engine_setup(case)
        inputs.update(worker.encode(jax.tree.map(np.asarray, params), f"eng_{case}/params"))
        if draft is not None:
            inputs.update(worker.encode(jax.tree.map(np.asarray, draft[0]), f"eng_{case}/draft"))
        inputs[f"eng_{case}/lens"] = np.array([len(p) for p in prompts])
        inputs[f"eng_{case}/prompts"] = np.array([t for p in prompts for t in p], np.int32)
    return inputs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case on the port's 4 ranks, once: [each rank's arrays]."""
    return worker.run_world("tp_serving", _inputs(), tmp_path_factory.mktemp("tp_serving_world"))


_JAX_ENGINES = {}


def _expected_streams(case):
    """The single-device JAX engine's streams (JAX's own tests hold its
    mesh engines to these exactly)."""
    if case not in _JAX_ENGINES:
        cfg, params, prompts, draft = _engine_setup(case)
        over, eng_name, kw, _, n_new = worker.TP_ENGINES[case]
        kw = {k: v for k, v in kw.items() if k not in ("num_pages",)}
        if eng_name == "PagedEngine":
            kw["num_slots"] = 2
            eng = JPagedEngine(params, cfg, **kw)
        else:
            eng = JEngine(params, cfg, **kw, **({"draft_model": draft} if draft else {}))
        _JAX_ENGINES[case] = eng.generate(prompts, max_new_tokens=n_new)
    return _JAX_ENGINES[case]


def _streams(res, case):
    flat = res[f"eng_{case}/streams"].tolist()
    out, cur = [], []
    for t in flat:
        if t == -1:
            out.append(cur)
            cur = []
        else:
            cur.append(t)
    return out


@pytest.mark.parametrize("case", [c for c in worker.TP_ENGINES if c not in ("fp8w_int8kv", "sampled")])
def test_tp_engine_matches_jax(world, case):
    """Twins of ``test_tp_engine_matches_single_chip``,
    ``test_tp_engine_quantized_weights``, ``test_tp_paged_engine_matches_
    single_chip``, ``test_tp_paged_engine_per_shard_preemption``,
    ``test_tp_chunked_prefill_matches`` (both engines),
    ``test_tp_engine_quantized_lm_head`` and ``test_tp_engine_int4_weights``,
    and speculative decoding under the mesh (prompt lookup, a draft model
    replicated on every rank): ``Engine`` / ``PagedEngine`` on the 2 x 2
    (data, model) mesh, every rank's streams equal and equal to JAX's."""
    want = _expected_streams(case)
    streams = [_streams(res, case) for res in world]
    assert all(s == streams[0] for s in streams)
    assert streams[0] == want
    res = world[0]
    assert int(res[f"eng_{case}/finished"]) == len(want)
    if case == "paged_preempt":
        assert int(res[f"eng_{case}/preemptions"]) > 0
    if case.startswith("spec"):
        assert int(res[f"eng_{case}/spec_steps"]) > 0
    if f"eng_{case}/free_pages" in res:  # every page back in its shard's pool
        *free, num_pages = res[f"eng_{case}/free_pages"].tolist()
        assert len(free) == 2 and free == [num_pages - 1] * 2


@pytest.mark.parametrize("case", ["fp8w_int8kv", "sampled"])
def test_tp_engine_matches_one_process(world, case):
    """``test_tp_engine_fp8_weights_int8_kv``'s bf16 model with fp8 weights
    and an int8 cache, and sampled requests (temperature 0.8, top-p 0.9,
    a seed a request): every rank's streams equal the port's single-process
    engine's. bf16 rounds differently in the two frameworks, and the port's
    sampling noise is its own hash of (seed, position), so the yardstick is
    the port on one process."""
    cfg, params, prompts, _ = _engine_setup(case)
    over, _, kw, _, n_new = worker.TP_ENGINES[case]
    tcfg = TConfig.tiny(**{**worker.TP_CFG, **over})
    samp = None
    if kw.get("enable_sampling"):
        samp = [t_sampling.SamplingParams(temperature=0.8, top_p=0.9, seed=11 + i) for i in range(3)]
    eng = TEngine(bridge.params_from_numpy(jax.tree.map(np.asarray, params)), tcfg, device="cpu", **kw)
    want = eng.generate(prompts, max_new_tokens=n_new, sampling=samp)
    for res in world:
        assert _streams(res, case) == want


def test_tp_engine_refusals():
    """JAX's refusals, kept: ``num_slots`` not divisible by the data axis,
    ``prefix_cache`` with a mesh (``ValueError``) and an MLA model with a
    mesh. Multi-LoRA with a mesh is served now: the engine constructs on
    rank 1's view of the mesh and holds that rank's shard of the stacked
    adapters (``tp.shard_lora``); ``tests/test_torch_multi_lora.py``
    serves it over the 4 ranks."""
    tcfg = TConfig.tiny(**worker.TP_CFG)
    params = t_llama.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    mesh = worker.fake_mesh({"data": 2, "model": 2}, 0)
    with pytest.raises(ValueError, match="divisible by data axis"):
        TEngine(params, tcfg, num_slots=3, mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="prefix_cache"):
        TPagedEngine(params, tcfg, num_slots=2, mesh=mesh, prefix_cache=True, device="cpu")
    mla = TConfig.deepseek_v2_lite(num_layers=1, vocab_size=256, max_seq_len=64)
    with pytest.raises(NotImplementedError, match="MLA"):
        TEngine({}, mla, mesh=mesh, device="cpu")
    adapter = t_lora.init_lora(tcfg, torch.Generator().manual_seed(0), rank=4, device="cpu")
    eng = TEngine(params, tcfg, num_slots=2, mesh=worker.fake_mesh({"data": 2, "model": 2}, 1),
                  lora_adapters=[adapter], device="cpu")
    hd = tcfg.head_dim
    layers = eng.lora["layers"]
    assert layers["wqkv"]["b"].shape[-1] == (tcfg.num_q_heads + 2 * tcfg.num_kv_heads) * hd // 2
    assert layers["wo"]["a"].shape[2] == tcfg.num_q_heads * hd // 2
    assert layers["w_gate_up"]["b"].shape[-1] == tcfg.intermediate_size
    assert layers["w_down"]["a"].shape[2] == tcfg.intermediate_size // 2



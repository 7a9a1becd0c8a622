"""One rank of the port's parallel tests: a world of processes on the CPU
over gloo, spawned by ``tests/test_torch_ring.py``,
``tests/test_torch_parallel.py``, ``tests/test_torch_tp.py``,
``tests/test_torch_tp_serving.py``, ``tests/test_torch_pp.py``,
``tests/test_torch_tp_train.py`` and ``tests/test_torch_multi_lora.py`` (one
world per file, through :func:`run_world`).

Each rank reads the seeded numpy inputs the test wrote (``inputs.npz``),
joins the group, runs every case of its suite on its shard through the
port's ``parallel`` package (``device="cpu"``: the ops take their plain
twins) and writes its arrays to ``rank<r>.npz`` as ``<case>/<name>``. The
module imports neither JAX nor the JAX package; the tests import its
constants and :func:`run_world`.

Usage: python torch_parallel_worker.py <suite> <rank> <world> <port> <dir>
"""

from __future__ import annotations

import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

WORLD = 4
# the ring / Ulysses inputs: (B, Hq, S, D) q over (B, Hkv, S, D) k and v, S / 4 rows a rank
ATTN = dict(b=2, hq=8, hkv=4, s=64, d=16)
RING_CASES = {  # name: (ring keyword arguments)
    "causal": dict(),
    "noncausal": dict(causal=False),
    "window": dict(window=24),
    "window_sinks": dict(window=24, sinks=20),  # the sinks cross the first chunk's edge (16 rows)
}
ULYSSES_CASES = {"plain": dict(), "window_sinks": dict(window=24, sinks=4)}
GRAD_CASES = {"causal": dict(), "window_sinks": dict(window=24, sinks=20)}
# the sequence-sharded decode: q (B, Hq, D) over a (B, Hkv, S, D) cache
DECODE = dict(b=2, hq=8, hkv=4, s=256, d=32, num_splits=2, block_k=32)
DECODE_CASES = {"dense": dict(head_chunks=1), "chunks2": dict(head_chunks=2),
                "chunks4": dict(head_chunks=4), "int8": dict(head_chunks=1, quantized=True)}
# context-parallel training: (config preset, its overrides, batch rows, sequence length)
TRAIN_CONFIGS = {
    "tiny": ("tiny", dict(dtype="float32", num_q_heads=8, num_kv_heads=4), 4, 32),
    "window": ("tiny", dict(dtype="float32", num_q_heads=8, num_kv_heads=4, sliding_window=12), 4, 32),
    # the sinks cross the first chunk's edge (8 rows a rank)
    "sinks": ("tiny", dict(dtype="float32", num_q_heads=8, num_kv_heads=4, sliding_window=12,
                           attention_sinks=10), 4, 32),
    "gemma2": ("gemma2_9b", dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=4,
                                 num_q_heads=2, num_kv_heads=1, head_dim=16, max_seq_len=128,
                                 dtype="float32", block_k=16, sliding_window=16), 2, 64),
    "moe": ("tiny", dict(dtype="float32", num_q_heads=8, num_kv_heads=4, num_experts=4, num_experts_per_tok=2),
            4, 32),
}
TRAIN_CASES = {  # name: (config, mesh axes, step keyword arguments)
    "cp": ("tiny", {"seq": 4}, dict()),
    "cp_dp": ("tiny", {"data": 2, "seq": 2}, dict(data_axis="data")),
    "cp_accum": ("tiny", {"seq": 4}, dict(grad_accum=2)),
    "window": ("window", {"seq": 4}, dict()),
    "sinks": ("sinks", {"seq": 4}, dict()),
    "gemma2": ("gemma2", {"seq": 4}, dict()),
    "cp_moe": ("moe", {"seq": 4}, dict()),
}
LR = 1e-2

# ---- tensor, expert and pipeline parallelism (tests/test_torch_tp.py, tests/test_torch_pp.py)
# the JAX tests' model: KV heads divisible by the model axis, fp32
TP_CFG = dict(num_q_heads=8, num_kv_heads=4, dtype="float32")
TP_MESHES = {"dp2_tp2": {"data": 2, "model": 2}, "tp4": {"model": 4}}
PP_MESHES = {"pp4": {"pipe": 4}, "dp2_pp2": {"data": 2, "pipe": 2}, "pp2_tp2": {"pipe": 2, "model": 2}}
# one-step cases: (config overrides, mesh, batch rows, prompt length or 0 for a decode step)
TP_STEPS = {
    "decode": (dict(), "dp2_tp2", 4, 0),
    "decode_tp4": (dict(), "tp4", 4, 0),
    "prefill": (dict(), "dp2_tp2", 2, 6),
    "int8w_decode": (dict(), "dp2_tp2", 2, 0),
    "int8w_prefill": (dict(), "dp2_tp2", 2, 5),
    "int8kv_decode": (dict(quant_mode="int8"), "dp2_tp2", 2, 0),
    "int4_decode": (dict(), "dp2_tp2", 2, 0),
    "w8a8_prefill": (dict(max_seq_len=512, w8a8_prefill=True), "dp2_tp2", 4, 256),
    "w4a8_prefill": (dict(max_seq_len=512, w8a8_prefill=True), "tp4", 4, 256),
    "moe_decode": (dict(num_experts=4, num_experts_per_tok=2, num_splits=1), "tp4", 4, 0),
    "moe_int8_decode": (dict(num_experts=4, num_experts_per_tok=2, num_splits=1), "dp2_tp2", 4, 0),
    "deepseek_decode": (dict(num_experts=4, num_experts_per_tok=2, num_splits=1, router_pre_softmax=True,
                             routed_scaling_factor=1.5, n_shared_experts=1, first_k_dense=1,
                             dense_inter_size=96), "tp4", 4, 0),
}
ROW_SCALES = (64, 128)  # quantize_rows on shards of (rows, H)
# engines: (config overrides, engine, keyword arguments, prompt lengths, new tokens)
TP_ENGINES = {
    "engine": (dict(), "Engine", dict(num_slots=2, steps_per_round=3), (3, 7, 5), 6),
    "int8w": (dict(), "Engine", dict(num_slots=2, steps_per_round=2), (4, 4, 4), 4),
    "fp8w_int8kv": (dict(dtype="bfloat16", quant_mode="int8"), "Engine", dict(num_slots=2, steps_per_round=3),
                    (4, 6, 3), 5),
    "paged": (dict(pages_per_compute_block=2), "PagedEngine", dict(num_slots=4, steps_per_round=2,
                                                                   page_size=16), (3, 7, 5, 4), 5),
    "paged_preempt": (dict(pages_per_compute_block=2), "PagedEngine",
                      dict(num_slots=4, steps_per_round=3, page_size=16, num_pages=4), (9, 9, 9, 9), 12),
    "chunked": (dict(), "Engine", dict(num_slots=2, steps_per_round=2, prefill_chunk=4), (3, 9, 6), 4),
    "chunked_paged": (dict(pages_per_compute_block=2), "PagedEngine",
                      dict(num_slots=2, steps_per_round=2, page_size=16, prefill_chunk=4), (3, 9, 6), 4),
    "int8_lm_head": (dict(), "Engine", dict(num_slots=2, steps_per_round=2), (5, 3, 6), 5),
    "int4": (dict(), "Engine", dict(num_slots=2, steps_per_round=2), (4, 4, 4), 4),
    "spec_ngram": (dict(num_splits=1), "Engine", dict(num_slots=2, steps_per_round=2, spec_decode=3),
                   (12, 9, 14), 8),
    "spec_draft": (dict(num_splits=1), "Engine", dict(num_slots=2, steps_per_round=2, spec_decode=3),
                   (12, 9, 14), 8),
    "sampled": (dict(), "Engine", dict(num_slots=2, steps_per_round=3, enable_sampling=True), (3, 7, 5), 6),
}
# pipeline decode: (config overrides, mesh, microbatches, weights)
PP_CASES = {
    "pp4_m4": (dict(num_splits=1, num_layers=8), "pp4", 4, "dense"),
    "pp4_m2": (dict(num_splits=1, num_layers=8), "pp4", 2, "dense"),
    "pp2_m2": (dict(num_splits=1, num_layers=8), "dp2_pp2", 2, "dense"),
    "pp4_int8": (dict(num_splits=1, num_layers=8), "pp4", 4, "int8"),
    "pp4_moe": (dict(num_splits=1, num_layers=4, num_experts=4, num_experts_per_tok=2), "pp4", 2, "dense"),
    "pp2_tp2": (dict(num_splits=1, num_layers=8, num_q_heads=8, num_kv_heads=4), "pp2_tp2", 4, "dense"),
    "pp2_tp2_int8": (dict(num_splits=1, num_layers=8, num_q_heads=8, num_kv_heads=4), "pp2_tp2", 2, "int8"),
}
PP_GEMMA2 = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=4, num_q_heads=2,
                 num_kv_heads=1, head_dim=16, max_seq_len=64, dtype="float32", block_k=16, sliding_window=8)
PP_BATCH, PP_PROMPT, PP_STEPS = 8, 5, 4

# ---- tensor-parallel training (tests/test_torch_tp_train.py)
TPT_MESHES = {"dp2_tp2": {"data": 2, "model": 2}, "tp2_sp2": {"model": 2, "seq": 2}}
TPT_BATCH, TPT_SEQ, TPT_STEPS = 4, 16, 6
TPT_MOE = dict(num_experts=4, num_experts_per_tok=2)  # the MoE cases: 2 whole experts a rank of model 2

# ---- multi-LoRA serving under TP x DP (tests/test_torch_multi_lora.py): JAX's tests' model and adapters
LORA_TP_CFG = dict(TP_CFG, num_splits=1)
LORA_TP_RANKS = (4, 8)
LORA_TP_PROMPTS = (5, 9, 12, 7)
# (engine, keyword arguments, each prompt's adapter, new tokens)
LORA_TP_CASES = {
    "engine": ("Engine", dict(num_slots=4, steps_per_round=3), (0, 1, None, 0), 5),
    "paged_topk": ("PagedEngine", dict(num_slots=4, steps_per_round=3, page_size=16, topk_logprobs=3),
                   (0, 1, None, 1), 5),
}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_world(suite: str, inputs: dict, workdir: Path, timeout: float = 300.0) -> list[dict]:
    """Write ``inputs``, run the suite on ``WORLD`` ranks, and return each
    rank's ``{"case/name": array}``; raises with every rank's output if a
    rank fails."""
    workdir = Path(workdir)
    np.savez(workdir / "inputs.npz", **inputs)
    port = free_port()
    procs = [subprocess.Popen([sys.executable, __file__, suite, str(r), str(WORLD), str(port), str(workdir)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"--- rank {r} (rc {p.returncode}) ---\n{out}" for r, (p, out) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    if failed:
        raise RuntimeError("parallel worker failed:\n" + "\n".join(failed))
    results = []
    for r in range(WORLD):
        with np.load(workdir / f"rank{r}.npz") as f:
            results.append({k: f[k] for k in f.files})
    return results


def unflatten(flat: dict, prefix: str) -> dict:
    """The nested dict stored under ``prefix/`` (keys joined by '/')."""
    tree: dict = {}
    for key, arr in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def flatten(tree, prefix: str) -> dict:
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in flatten(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


_VIEWS = {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8}  # dtypes np.savez cannot name


def encode(tree, prefix: str) -> dict:
    """:func:`flatten`, with bf16 and fp8 leaves stored as integer views
    under ``key@dtype``."""
    out = {}
    for key, arr in flatten(tree, prefix).items():
        arr = np.asarray(arr)
        view = _VIEWS.get(arr.dtype.name)
        out[key if view is None else f"{key}@{arr.dtype.name}"] = arr if view is None else arr.view(view)
    return out


def decode_params(flat: dict, prefix: str):
    """The port's params tree stored by :func:`encode` under ``prefix``."""
    import torch

    from starflashattention_tpu_torch.utils import bridge

    views = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn}
    tree: dict = {}
    for key, arr in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        key, _, dtype = key.partition("@")
        if dtype:
            int_view = torch.from_numpy(arr.astype(np.int16) if dtype == "bfloat16" else arr.copy())
            t = int_view.view(views[dtype])
        else:
            t = bridge.tensor_from_numpy(arr)
        node = tree
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    return tree


def _chunk(x, idx, n, dim=2):
    c = x.shape[dim] // n
    return x.narrow(dim, idx * c, c)


def _ring_suite(inp):
    import torch

    from starflashattention_tpu_torch.parallel import make_mesh, make_ring_prefill, make_ulysses_prefill
    from starflashattention_tpu_torch.parallel.ring import ring_attention, zigzag_permutation
    from starflashattention_tpu_torch.parallel.ulysses import ulysses_attention

    mesh = make_mesh({"seq": WORLD}, device="cpu")
    axis = mesh.axis("seq")
    i, n = axis.index, axis.size
    q, k, v, w = (torch.from_numpy(inp[name]) for name in ("q", "k", "v", "w"))
    lengths = torch.from_numpy(inp["lengths"])
    mine = [_chunk(x, i, n) for x in (q, k, v)]
    out = {}
    for name, kw in RING_CASES.items():
        out[f"ring_{name}/o"] = make_ring_prefill(mesh, seq_axis="seq", **kw)(*mine, lengths)
    perm = zigzag_permutation(q.shape[2], n)
    rows = torch.from_numpy(perm[i * (q.shape[2] // n):(i + 1) * (q.shape[2] // n)])
    out["zigzag/o"] = make_ring_prefill(mesh, seq_axis="seq", balanced=True)(
        *(x[:, :, rows] for x in (q, k, v)), lengths)
    out["zigzag/rows"] = rows
    for name, kw in ULYSSES_CASES.items():
        out[f"ulysses_{name}/o"] = make_ulysses_prefill(mesh, seq_axis="seq", **kw)(*mine, lengths)
    for kind, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        for name, kw in GRAD_CASES.items():
            if kind == "ulysses":
                if name != "causal":
                    continue
                kw = dict(kw, differentiable=True)
            leaves = [x.clone().requires_grad_() for x in mine]
            o = fn(*leaves, lengths, axis_name=axis, **kw)
            grads = torch.autograd.grad((o * _chunk(w, i, n)).sum(), leaves)
            for g_name, g in zip(("dq", "dk", "dv"), grads):
                out[f"{kind}_grads_{name}/{g_name}"] = g
    return out


def _parallel_suite(inp):
    import torch

    from starflashattention_tpu_torch.models import llama
    from starflashattention_tpu_torch.parallel import init_opt_state, make_cp_train_step, make_mesh
    from starflashattention_tpu_torch.parallel import make_seq_sharded_decode
    from starflashattention_tpu_torch.runtime.params import ModelConfig
    from starflashattention_tpu_torch.utils import bridge

    meshes = {"seq4": make_mesh({"seq": WORLD}, device="cpu"),
              "dp2_seq2": make_mesh({"data": 2, "seq": 2}, device="cpu")}
    out = {}
    for name, mesh in meshes.items():
        for ax in mesh.axis_names:
            a = mesh.axis(ax)
            out[f"mesh_{name}/{ax}"] = np.array([a.size, a.index, *a.ranks])
    # the sequence-sharded decode
    seq = meshes["seq4"].axis("seq")
    q, k, v, k8, v8, ks, vs = (torch.from_numpy(inp[f"decode_{n}"]) for n in
                               ("q", "k", "v", "k8", "v8", "k_scales", "v_scales"))
    lengths = torch.from_numpy(inp["decode_lengths"])
    for name, kw in DECODE_CASES.items():
        fn = make_seq_sharded_decode(meshes["seq4"], seq_axis="seq", num_splits=DECODE["num_splits"],
                                     block_k=DECODE["block_k"], **kw)
        if kw.get("quantized"):
            o = fn(q, _chunk(k8, seq.index, seq.size), _chunk(v8, seq.index, seq.size), lengths, ks, vs)
        else:
            o = fn(q, _chunk(k, seq.index, seq.size), _chunk(v, seq.index, seq.size), lengths)
        out[f"decode_{name}/o"] = o
    # context-parallel training: one step from each config's JAX-initialized params
    for name, (cfg_name, axes, kw) in TRAIN_CASES.items():
        preset, overrides, _, _ = TRAIN_CONFIGS[cfg_name]
        cfg = getattr(ModelConfig, preset)(**overrides)
        params = bridge.params_from_numpy(unflatten(inp, f"params_{cfg_name}"))
        cos, sin = llama.rope_tables(cfg, device="cpu")
        mesh = meshes["seq4"] if axes == {"seq": WORLD} else meshes["dp2_seq2"]
        state = init_opt_state(params)
        step = make_cp_train_step(mesh, cfg, LR, **kw)
        params, state, loss = step(params, state, torch.from_numpy(inp[f"batch_{cfg_name}"]), cos, sin)
        out[f"train_{name}/loss"] = loss
        out.update(flatten(bridge.params_to_numpy(params), f"train_{name}/params"))
        out.update(flatten(bridge.params_to_numpy(state), f"train_{name}/grads"))  # momentum from 0: the grads
    return out


def _prompts(inp, key):
    lens = inp[f"{key}/lens"]
    flat = inp[f"{key}/prompts"]
    offs = np.concatenate([[0], np.cumsum(lens)])
    return [flat[offs[i]:offs[i + 1]].tolist() for i in range(len(lens))]


def _tp_suite(inp):
    import torch

    from starflashattention_tpu_torch import parallel
    from starflashattention_tpu_torch.cache import contiguous
    from starflashattention_tpu_torch.models import llama
    from starflashattention_tpu_torch.ops.quant_matmul import quantize_rows
    from starflashattention_tpu_torch.parallel import comm, tp
    from starflashattention_tpu_torch.runtime.params import ModelConfig

    meshes = {name: parallel.make_mesh(axes, device="cpu") for name, axes in TP_MESHES.items()}
    out = {}

    def cache_for(cfg, b, scale=None):
        kw = {} if scale is None else dict(calibration_scale=scale)
        return contiguous.init_cache(cfg.num_layers, b, cfg.num_kv_heads, cfg.max_seq_len, cfg.head_dim,
                                     dtype=torch.float32, quant_mode=cfg.quant_mode, device="cpu", **kw)

    for case, (over, mesh_name, b, sp) in TP_STEPS.items():
        cfg = ModelConfig.tiny(**TP_CFG, **over)
        mesh = meshes[mesh_name]
        params = tp.shard_params(decode_params(inp, f"{case}/params"), mesh, cfg)
        cos, sin = llama.rope_tables(cfg, device="cpu")
        cache = tp.shard_cache(cache_for(cfg, b, 8.0 if cfg.quant_mode != "none" else None), mesh)
        toks = torch.from_numpy(inp[f"{case}/tokens"])
        if sp:
            fn = parallel.make_tp_prefill(mesh, cfg)
            logits, cache = fn(params, cache, toks, torch.from_numpy(inp[f"{case}/plens"]), cos, sin)
            out[f"{case}/prefill_logits"] = logits
            toks = torch.from_numpy(inp[f"{case}/next"])
        logits, cache = parallel.make_tp_decode_step(mesh, cfg)(params, cache, toks, cos, sin)
        out[f"{case}/logits"] = logits
        out[f"{case}/k"], out[f"{case}/lengths"] = cache.k, cache.lengths
    # W8A8 / W4A8 row scales: a shard of each row quantized with the row's scale
    model = meshes["tp4"].axis("model")
    x = torch.from_numpy(inp["rows/x"])
    c = x.shape[1] // model.size
    x8, rs = quantize_rows(x[:, model.index * c:(model.index + 1) * c], axis=model)
    out["rows/x8"], out["rows/rs"] = x8, rs
    out["host_bytes"] = np.array(comm.host_bytes)  # CPU tensors never go through the host path
    return out


def _tp_serving_suite(inp):
    from starflashattention_tpu_torch import parallel
    from starflashattention_tpu_torch.core import sampling
    from starflashattention_tpu_torch.runtime.params import ModelConfig
    from starflashattention_tpu_torch.serving import Engine, PagedEngine

    mesh = parallel.make_mesh(TP_MESHES["dp2_tp2"], device="cpu")
    out = {}
    for case, (over, eng_name, kw, _lens, n_new) in TP_ENGINES.items():
        cfg = ModelConfig.tiny(**{**TP_CFG, **over})
        cls = Engine if eng_name == "Engine" else PagedEngine
        kw = dict(kw)
        if case == "spec_draft":
            dcfg = ModelConfig.tiny(**{**TP_CFG, **over, "num_layers": 1})
            kw["draft_model"] = (decode_params(inp, f"eng_{case}/draft"), dcfg)
        eng = cls(decode_params(inp, f"eng_{case}/params"), cfg, mesh=mesh, device="cpu", **kw)
        samp = None
        if kw.get("enable_sampling"):
            samp = [sampling.SamplingParams(temperature=0.8, top_p=0.9, seed=11 + i) for i in range(3)]
        streams = eng.generate(_prompts(inp, f"eng_{case}"), max_new_tokens=n_new, sampling=samp)
        out[f"eng_{case}/streams"] = np.array([t for s in streams for t in s + [-1]])
        out[f"eng_{case}/finished"] = np.array(eng.stats.finished)
        out[f"eng_{case}/preemptions"] = np.array(eng.stats.preemptions)
        out[f"eng_{case}/spec_steps"] = np.array(eng.stats.spec_steps)
        if isinstance(eng, PagedEngine):
            out[f"eng_{case}/free_pages"] = np.array([p.free_pages for p in eng.pools] + [eng.num_pages])
    return out


def _pp_suite(inp):
    import torch

    from starflashattention_tpu_torch import parallel
    from starflashattention_tpu_torch.cache import contiguous
    from starflashattention_tpu_torch.models import llama
    from starflashattention_tpu_torch.parallel import pp
    from starflashattention_tpu_torch.runtime.params import ModelConfig

    meshes = {name: parallel.make_mesh(axes, device="cpu") for name, axes in PP_MESHES.items()}
    out = {}
    for case, (over, mesh_name, m, _w) in {**PP_CASES, "pp2_gemma2": (None, "dp2_pp2", 2, "dense")}.items():
        cfg = ModelConfig.gemma2_9b(**PP_GEMMA2) if over is None else ModelConfig.tiny(dtype="float32", **over)
        mesh = meshes[mesh_name]
        full = decode_params(inp, f"{case}/params")
        cache = contiguous.KVCache(*(torch.from_numpy(inp[f"{case}/cache_{n}"]) for n in ("k", "v", "lengths")))
        cache = pp.shard_cache_pp(cache, mesh)
        params = pp.shard_params_pp(full, mesh, cfg)
        step = pp.make_pp_decode_step(mesh, cfg, full, num_microbatches=m)
        cos, sin = llama.rope_tables(cfg, device="cpu")
        tok = torch.from_numpy(inp[f"{case}/next"])
        toks = [tok]
        for _ in range(PP_STEPS):
            logits, cache = step(params, cache, toks[-1], cos, sin)
            toks.append(torch.argmax(logits, -1).to(torch.int32))
        out[f"{case}/tokens"] = torch.stack(toks)
        out[f"{case}/logits"] = logits
        out[f"{case}/k"], out[f"{case}/lengths"] = cache.k, cache.lengths
    return out


def _tp_train_suite(inp):
    import dataclasses

    import torch

    from starflashattention_tpu_torch import parallel
    from starflashattention_tpu_torch.cache import contiguous
    from starflashattention_tpu_torch.models import llama, train
    from starflashattention_tpu_torch.parallel import tp
    from starflashattention_tpu_torch.runtime.params import ModelConfig

    meshes = {name: parallel.make_mesh(axes, device="cpu") for name, axes in TPT_MESHES.items()}
    cfg = ModelConfig.tiny(**TP_CFG)
    full = decode_params(inp, "params")
    cos, sin = llama.rope_tables(cfg, device="cpu")
    batch = torch.from_numpy(inp["batch"])
    out = {}
    mesh = meshes["dp2_tp2"]
    for name, accum in (("vg", 1), ("vg_accum", 2)):
        vg, _ = parallel.make_tp_dp_value_and_grad(mesh, cfg, grad_accum=accum)
        loss, grads = vg(tp.shard_params(full, mesh, cfg), batch, cos, sin)
        out[f"{name}/loss"] = loss
        out.update(flatten(grads, f"{name}/grads"))
    params = tp.shard_params(full, mesh, cfg)
    state = parallel.init_opt_state(params)
    step = parallel.make_tp_dp_train_step(mesh, cfg, LR)
    losses = []
    for t in range(TPT_STEPS):
        params, state, loss = step(params, state, batch, cos, sin)
        losses.append(float(loss))
        if t == 0:
            out.update(flatten(train.tree_map(torch.clone, params), "step/params"))  # updated in place later
            out.update(flatten(train.tree_map(torch.clone, state), "step/grads"))  # momentum from 0: the grads
    out["step/losses"] = np.array(losses)
    serve_cfg = dataclasses.replace(cfg, num_splits=1)
    cache = tp.shard_cache(contiguous.init_cache(cfg.num_layers, 4, cfg.num_kv_heads, cfg.max_seq_len, cfg.head_dim,
                                                 dtype=torch.float32, device="cpu"), mesh)
    logits, _ = parallel.make_tp_decode_step(mesh, serve_cfg)(params, cache, torch.zeros(4, dtype=torch.int32),
                                                              cos, sin)
    out["serve/logits"] = logits
    # TP x CP: the ring over seq, Megatron over model
    mesh = meshes["tp2_sp2"]
    params = tp.shard_params(full, mesh, cfg)
    state = parallel.init_opt_state(params)
    step = parallel.make_tp_cp_train_step(mesh, cfg, LR)
    params, state, loss = step(params, state, batch, cos, sin)
    out["tp_cp/loss"] = loss
    out.update(flatten(params, "tp_cp/params"))
    out.update(flatten(state, "tp_cp/grads"))
    # MoE, expert-parallel over model: the loss and gradients, one TP x DP step, one TP x CP step
    cfg = ModelConfig.tiny(**TP_CFG, **TPT_MOE)
    full = decode_params(inp, "moe_params")
    mesh = meshes["dp2_tp2"]
    vg, _ = parallel.make_tp_dp_value_and_grad(mesh, cfg)
    loss, grads = vg(tp.shard_params(full, mesh, cfg), batch, cos, sin)
    out["moe_vg/loss"] = loss
    out.update(flatten(grads, "moe_vg/grads"))
    for name, make in (("moe_step", parallel.make_tp_dp_train_step), ("moe_tp_cp", parallel.make_tp_cp_train_step)):
        mesh = meshes["dp2_tp2" if name == "moe_step" else "tp2_sp2"]
        params = tp.shard_params(full, mesh, cfg)
        state = parallel.init_opt_state(params)
        params, state, loss = make(mesh, cfg, LR)(params, state, batch, cos, sin)
        out[f"{name}/loss"] = loss
        out.update(flatten(params, f"{name}/params"))
        out.update(flatten(state, f"{name}/grads"))
    return out


def lora_requests(prompts, adapters, n_new):
    """One request a prompt, on its adapter (None: the base model)."""
    from starflashattention_tpu_torch.serving import Request

    return [Request(uid=i, prompt=list(p), max_new_tokens=n_new, adapter=a)
            for i, (p, a) in enumerate(zip(prompts, adapters))]


def lora_outputs(reqs, prefix: str) -> dict:
    """Each request's stream (-1 after each) and, where recorded, its top-k
    ids and logprobs a token."""
    out = {f"{prefix}/streams": np.array([t for r in reqs for t in r.output + [-1]])}
    if reqs[0].topk:
        out[f"{prefix}/topk_ids"] = np.array([ids for r in reqs for ids, _ in r.topk])
        out[f"{prefix}/topk_vals"] = np.array([vals for r in reqs for _, vals in r.topk])
    return out


def _multi_lora_suite(inp):
    from starflashattention_tpu_torch import parallel
    from starflashattention_tpu_torch.runtime.params import ModelConfig
    from starflashattention_tpu_torch.serving import Engine, PagedEngine

    mesh = parallel.make_mesh(TP_MESHES["dp2_tp2"], device="cpu")
    cfg = ModelConfig.tiny(**LORA_TP_CFG)
    params = decode_params(inp, "lora_tp/params")
    loras = [decode_params(inp, f"lora_tp/lora{i}") for i in range(len(LORA_TP_RANKS))]
    prompts = _prompts(inp, "lora_tp")
    out = {}
    for case, (eng_name, kw, adapters, n_new) in LORA_TP_CASES.items():
        cls = Engine if eng_name == "Engine" else PagedEngine
        eng = cls(params, cfg, mesh=mesh, lora_adapters=loras, device="cpu", **kw)
        reqs = lora_requests(prompts, adapters, n_new)
        for r in reqs:
            eng.submit(r)
        eng.run()
        out.update(lora_outputs(reqs, case))
        out[f"{case}/finished"] = np.array(eng.stats.finished)
    return out


def fake_mesh(axes: dict, rank: int):
    """A ``parallel.mesh.Mesh`` as rank ``rank`` sees it, without a process
    group: enough for what raises before any collective."""
    import torch

    from starflashattention_tpu_torch.parallel.mesh import Axis, Mesh

    sizes = list(axes.values())
    grid = np.arange(int(np.prod(sizes))).reshape(sizes)
    coords = mesh_coords(axes, rank)
    out = {}
    for i, name in enumerate(axes):
        idx = [coords[n] for n in axes]
        idx[i] = slice(None)
        out[name] = Axis(name, sizes[i], coords[name], tuple(int(v) for v in grid[tuple(idx)]), None, "gloo")
    return Mesh(out, torch.device("cpu"))


def mesh_coords(axes: dict, rank: int) -> dict:
    """Rank ``rank``'s index along each axis (ranks row-major over the axes)."""
    coords = np.argwhere(np.arange(int(np.prod(list(axes.values())))).reshape(tuple(axes.values())) == rank)[0]
    return dict(zip(axes, coords.tolist()))


SUITES = {"ring": _ring_suite, "parallel": _parallel_suite, "tp": _tp_suite, "tp_serving": _tp_serving_suite,
          "pp": _pp_suite, "tp_train": _tp_train_suite, "multi_lora": _multi_lora_suite}


def main(suite, rank, world, port, workdir):
    repo = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(repo))
    import torch

    from starflashattention_tpu_torch.parallel import init_distributed

    torch.set_num_threads(1)
    init_distributed(f"tcp://localhost:{port}", backend="gloo", world_size=world, rank=rank, device="cpu")
    with np.load(Path(workdir) / "inputs.npz") as f:
        inp = {k: f[k] for k in f.files}
    out = SUITES[suite](inp)
    arrays = {k: (v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)) for k, v in out.items()}
    np.savez(Path(workdir) / f"rank{rank}.npz", **arrays)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])

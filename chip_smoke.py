#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``starflashattention_tpu_torch``) on
one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Device and build: prints the card's name and power limit, then builds
   every kernel in ``starflashattention_tpu_torch/csrc`` with ``nvcc`` for
   sm_90a, one process per source, all at once.
2. Kernel vs plain: each kernel against its plain PyTorch twin on the card,
   in bf16 at the shapes the 7B-GQA path gives it, with the error printed
   beside its tolerance; kernel, plain and library-call times (CUDA events,
   L2 flushed before each launch, the device kept busy while the host
   enqueues it) beside the byte / operation bound.
3. Slice: full-width ``ModelConfig.llama_7b_gqa`` (32 layers,
   max_seq_len 1024, random int8 weights and int8 lm_head from a seeded
   generator, bf16 KV cache): greedy ``generate`` on 8 ragged prompts for
   32 tokens, at ``num_splits=1`` and at the default split count. Launch
   counters are zeroed just before each run and must equal the expected
   counts just after; prefill and decode are then timed on their own.
4. Path vs path: 4 layers at full width, one prefill and 4 decode steps
   through the kernels and through the plain versions; logits compared.
5. Only with ``--phases ...,5``: bench.py's decode chain (B=16, every
   sequence at 512 cache rows) timed, then traced with torch.profiler for
   device time by kernel and the device's idle share.

The line before the last is a JSON object ``{"kernels": [...]}``; the last
is ``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA device,
or when the package is not beside the script.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
import sys
import time

import torch

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
L2_FLUSH_BYTES = 128 * 1024 * 1024  # > the 50 MB L2

SLICE_LAYERS = 32
SLICE_SEQ = 1024
SLICE_BATCH = 8
SLICE_NEW_TOKENS = 32
SEED = 0
QMM_ENTRY = {16: "quant_matmul (small-M, decode rows)", 2048: "quant_matmul (tiled, prefill rows)"}


def log(*args):
    print(*args, flush=True)


# ---------------------------------------------------------------- timing


class Timer:
    """Median time of a callable on the card: CUDA events around each
    launch, with the L2 cache flushed before it (a real caller streams the
    weights and the cache from device memory). A spin of about a
    millisecond keeps the device busy while the host enqueues the start
    event and the call, so the events time the device's work and not the
    wrapper's host time before its first launch."""

    SPIN_CYCLES = 2_000_000

    def __init__(self, device):
        self.flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=device)

    def __call__(self, fn, iters=20, warmup=3):
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        times.sort()
        return times[len(times) // 2]


def bound_ms(n_bytes, n_ops):
    """Least time for the work: the larger of bytes over HBM rate and
    operations over the bf16 tensor-core rate."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_BF16_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phase 1


def phase_device_and_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    from starflashattention_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build()
    secs = time.perf_counter() - t0
    log(f"[build] {len(built)} sources in {secs:.1f} s (parallel nvcc, sm_90a): "
        + ", ".join(f"{n} {r['seconds']:.1f} s" for n, r in built.items()))
    for name, r in built.items():
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", r["ptxas"])]
        spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill stores", r["ptxas"]))
        log(f"[build] {name}: {len(regs)} kernels, registers per thread up to {max(regs, default=0)}, "
            f"spill stores {spills} bytes")
    return smi


# ---------------------------------------------------------------- phase 2


def _check(name, err, tol):
    ok = err <= tol
    log(f"[kernel] {name}: max_abs_err {err:.3e} (tolerance {tol:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version ({err} > {tol})")


def phase_kernels(dev, timer):
    """Each kernel against its plain twin at main-path shapes; returns
    {entry name: measurements} for the kernels line."""
    import torch.nn.functional as F

    from starflashattention_tpu_torch.core.reference import repeat_kv
    from starflashattention_tpu_torch.ops.cache_append import append_rows_kv, append_rows_kv_plain
    from starflashattention_tpu_torch.ops.flash_decode import (
        flash_decode, flash_decode_plain, flash_decode_with_stats, flash_decode_with_stats_plain)
    from starflashattention_tpu_torch.ops.flash_prefill import flash_prefill, flash_prefill_plain
    from starflashattention_tpu_torch.ops.quant_matmul import quant_matmul, quant_matmul_plain

    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16
    res = {}

    # -- decode attention: B=16, Hq=32, Hkv=8, S=1024, D=128, 2-layer table, layer 1
    b, hq, hkv, s, d, n_layers, layer = 16, 32, 8, 1024, 128, 2, 1
    q = torch.randn((b, hq, d), generator=gen, device=dev, dtype=bf16)
    k_tab = torch.randn((n_layers, b, hkv, s, d), generator=gen, device=dev, dtype=bf16)
    v_tab = torch.randn((n_layers, b, hkv, s, d), generator=gen, device=dev, dtype=bf16)
    lengths = torch.randint(1, s + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
    lengths[0], lengths[1] = 1, s
    n_valid = int(lengths.sum())
    dec_bytes = 2 * q.numel() * 2 + 2 * n_valid * hkv * d * 2 + b * 4
    dec_ops = 4 * hq * d * n_valid
    kv_rep = repeat_kv(k_tab[layer], hq // hkv), repeat_kv(v_tab[layer], hq // hkv)
    sdpa_mask = (torch.arange(s, device=dev)[None, :] < lengths[:, None])[:, None, None, :]

    def sdpa_decode():
        return F.scaled_dot_product_attention(q[:, :, None], kv_rep[0], kv_rep[1], attn_mask=sdpa_mask)

    lib_ms = timer(sdpa_decode)
    # bf16 outputs of two fp32 computations over the same bf16 inputs: each
    # rounds once, and their fp32 sums run in another order, so they may
    # differ by one bf16 ulp of |o| <= 4.
    tol = 2.0**-8 * 4
    for splits, entry in ((1, "flash_decode (1 split, fused)"), (4, "flash_decode (split-KV partials)")):
        kw = dict(layer=layer, num_splits=splits, block_k=256)
        out = flash_decode(q, k_tab, v_tab, lengths, **kw)
        ref = flash_decode_plain(q, k_tab, v_tab, lengths, **kw)
        _check(f"{entry} B={b} Hq={hq} Hkv={hkv} S={s} D={d}",
               (out.float() - ref.float()).abs().max().item(), tol)
        bnd, by = bound_ms(dec_bytes, dec_ops)  # the wrapper's inputs and output
        res[entry] = dict(
            max_abs_err=(out.float() - ref.float()).abs().max().item(),
            ms=timer(lambda: flash_decode(q, k_tab, v_tab, lengths, **kw)),
            plain_ms=timer(lambda: flash_decode_plain(q, k_tab, v_tab, lengths, **kw), iters=5),
            bound_ms=bnd, bound_by=by, library_ms=lib_ms)
    o, m, l = flash_decode_with_stats(q, k_tab, v_tab, lengths, layer=layer, num_splits=4, block_k=256)
    o_r, m_r, l_r = flash_decode_with_stats_plain(q, k_tab, v_tab, lengths, layer=layer,
                                                  num_splits=4, block_k=256)
    live = m_r > -1e30  # splits that hold a valid position
    # fp32 partials of the same products, summed in another order
    _check("flash_decode_with_stats m", (m - m_r)[live].abs().max().item(), 1e-4)
    _check("flash_decode_with_stats l (relative)", ((l - l_r) / l_r.clamp(min=1))[live].abs().max().item(), 1e-4)
    _check("flash_decode_with_stats o (relative to l)",
           ((o - o_r) / l_r.clamp(min=1)[..., None])[live].abs().max().item(), 1e-4)
    _check("flash_decode_with_stats dead splits", float(l[~live].abs().max().item() if (~live).any() else 0), 0.0)

    # -- cache append on the same table, whole-table equality
    k_new = torch.randn((b, hkv, d), generator=gen, device=dev, dtype=bf16)
    v_new = torch.randn((b, hkv, d), generator=gen, device=dev, dtype=bf16)
    pos = torch.clamp(lengths, max=s - 1)
    ka, va = k_tab.clone(), v_tab.clone()
    kp, vp = k_tab.clone(), v_tab.clone()
    append_rows_kv(ka, va, k_new, v_new, layer, pos)
    append_rows_kv_plain(kp, vp, k_new, v_new, layer, pos)
    same = torch.equal(ka, kp) and torch.equal(va, vp)
    _check("append_rows_kv whole table", 0.0 if same else float("inf"), 0.0)
    bnd, by = bound_ms(2 * 2 * b * hkv * d * 2 + b * 4, 0)
    res["append_rows_kv"] = dict(
        max_abs_err=0.0,
        ms=timer(lambda: append_rows_kv(ka, va, k_new, v_new, layer, pos)),
        plain_ms=timer(lambda: append_rows_kv_plain(kp, vp, k_new, v_new, layer, pos)),
        bound_ms=bnd, bound_by=by, library_ms=None)
    del k_tab, v_tab, ka, va, kp, vp, kv_rep

    # -- quant_matmul: the five projection shapes, stacked L=4, layer 3
    h, inter, vocab = 4096, 11008, 32000
    shapes = {"wqkv": (h, (hq + 2 * hkv) * d, bf16), "wo": (hq * d, h, torch.float32),
              "w_gate_up": (h, 2 * inter, bf16), "w_down": (inter, h, torch.float32),
              "lm_head": (h, vocab, torch.float32)}
    from starflashattention_tpu_torch.core.quant import quantize_weight

    for mode, wdtype in (("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
        for name, (kdim, ndim, out_dtype) in shapes.items():
            wq = quantize_weight(torch.randn((4, kdim, ndim), generator=gen, device=dev), mode)
            w, scale = wq["w"], wq["scale"]
            assert w.dtype == wdtype
            w_deq = (w[3].float() * scale[3][None, :]).to(bf16)
            for rows in (16, 2048):
                x = torch.randn((rows, kdim), generator=gen, device=dev, dtype=bf16)
                out = quant_matmul(x, w, scale, layer=3, out_dtype=out_dtype)
                ref = quant_matmul_plain(x, w, scale, layer=3, out_dtype=out_dtype)
                err = (out.float() - ref.float()).abs().max().item()
                peak = ref.float().abs().max().item()
                # fp32 sums of up to 11008 exact products, in another order
                # (f32 out: measured up to 1.1e-5 of the peak at K=11008);
                # plus one bf16 rounding on each side (bf16 out)
                rel = 2.0**-7 if out_dtype == bf16 else 1e-4
                _check(f"quant_matmul {mode} {name} rows={rows} K={kdim} N={ndim} out={out_dtype}",
                       err, rel * peak)
                if mode != "int8":
                    continue
                fn = lambda: quant_matmul(x, w, scale, layer=3, out_dtype=out_dtype)  # noqa: E731
                t = timer(fn)
                t_plain = timer(lambda: quant_matmul_plain(x, w, scale, layer=3, out_dtype=out_dtype), iters=5)
                t_lib = timer(lambda: torch.matmul(x, w_deq))
                n_bytes = x.numel() * 2 + kdim * ndim + ndim * 4 + rows * ndim * out.element_size()
                n_ops = 2 * rows * kdim * ndim
                bnd, by = bound_ms(n_bytes, n_ops)
                log(f"[time] quant_matmul int8 {name} rows={rows}: kernel {t:.4f} ms, plain {t_plain:.4f} ms, "
                    f"torch.matmul(bf16 dequantized) {t_lib:.4f} ms, bound {bnd:.4f} ms ({by})")
                key = QMM_ENTRY[rows]
                agg = res.setdefault(key, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
                                               n_bytes=0, n_ops=0))
                agg["max_abs_err"] = max(agg["max_abs_err"], err)
                agg["ms"] += t
                agg["plain_ms"] += t_plain
                agg["library_ms"] += t_lib
                agg["n_bytes"] += n_bytes
                agg["n_ops"] += n_ops
            del w, scale, w_deq, wq
    for rows in (16, 2048):
        agg = res[QMM_ENTRY[rows]]
        agg["bound_ms"], agg["bound_by"] = bound_ms(agg.pop("n_bytes"), agg.pop("n_ops"))

    # -- prefill attention: B=2, Sq=512, Skv=1024, q_offsets [0, 300]
    b, sq, skv = 2, 512, 1024
    q = torch.randn((b, hq, sq, d), generator=gen, device=dev, dtype=bf16)
    k = torch.randn((b, hkv, skv, d), generator=gen, device=dev, dtype=bf16)
    v = torch.randn((b, hkv, skv, d), generator=gen, device=dev, dtype=bf16)
    q_off = torch.tensor([0, 300], dtype=torch.int32, device=dev)
    lens = q_off + sq
    out = flash_prefill(q, k, v, lens, q_offsets=q_off)
    ref = flash_prefill_plain(q, k, v, lens, q_offsets=q_off)
    err = (out.float() - ref.float()).abs().max().item()
    # the kernel rounds P to bf16 for the PV product (as the TPU kernel does),
    # the plain version keeps it fp32; both round the output to bf16
    _check(f"flash_prefill B={b} Sq={sq} Skv={skv} q_offsets=[0,300]", err, 2e-2)
    n_pairs = sum(int(lo) * sq + sq * (sq + 1) // 2 for lo in q_off.tolist())
    n_bytes = 2 * q.numel() * 2 + 2 * int(lens.sum()) * hkv * d * 2
    bnd, by = bound_ms(n_bytes, 4 * d * hq * n_pairs)
    kk, vv = repeat_kv(k, hq // hkv), repeat_kv(v, hq // hkv)
    qpos = q_off[:, None] + torch.arange(sq, device=dev)[None, :]
    kpos = torch.arange(skv, device=dev)
    mask = ((kpos[None, None, :] <= qpos[:, :, None]) & (kpos[None, None, :] < lens[:, None, None]))[:, None]
    res["flash_prefill"] = dict(
        max_abs_err=err,
        ms=timer(lambda: flash_prefill(q, k, v, lens, q_offsets=q_off)),
        plain_ms=timer(lambda: flash_prefill_plain(q, k, v, lens, q_offsets=q_off), iters=5),
        bound_ms=bnd, bound_by=by,
        library_ms=timer(lambda: F.scaled_dot_product_attention(q, kk, vv, attn_mask=mask)))
    for name, r in res.items():
        log(f"[time] {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"{'n/a' if r['library_ms'] is None else format(r['library_ms'], '.4f') + ' ms'}, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), max_abs_err {r['max_abs_err']:.3e}")
    return res


# ---------------------------------------------------------------- phase 3


def _counters():
    from starflashattention_tpu_torch.ops.cache_append import append_rows_kv
    from starflashattention_tpu_torch.ops.flash_decode import flash_decode
    from starflashattention_tpu_torch.ops.flash_prefill import flash_prefill
    from starflashattention_tpu_torch.ops.quant_matmul import quant_matmul

    return {"append_rows_kv": append_rows_kv, "flash_decode": flash_decode,
            "flash_prefill": flash_prefill, "quant_matmul": quant_matmul}


def reset_counts():
    for fn in _counters().values():
        fn.launches = 0
    _counters()["quant_matmul"].launches_tiled = 0


def read_counts():
    counts = {name: fn.launches for name, fn in _counters().items()}
    counts["quant_matmul_tiled"] = _counters()["quant_matmul"].launches_tiled
    return counts


def _prompts(cfg, dev, gen):
    lengths = torch.linspace(16, 256, SLICE_BATCH).round().to(torch.int32)
    lengths = lengths[torch.randperm(SLICE_BATCH, generator=torch.Generator().manual_seed(SEED))]
    prompts = torch.randint(0, cfg.vocab_size, (SLICE_BATCH, int(lengths.max())), generator=gen,
                            device=dev, dtype=torch.int32)
    return prompts, lengths.to(dev)


def build_model(cfg, dev):
    from starflashattention_tpu_torch.models import llama

    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = llama.init_params(cfg, gen, quantize="int8", device=dev)
    return llama.quantize_model_weights(params, "int8", lm_head=True, consume=True), gen


def phase_slice(dev):
    from starflashattention_tpu_torch.cache import contiguous
    from starflashattention_tpu_torch.models import llama
    from starflashattention_tpu_torch.runtime.params import ModelConfig

    base = ModelConfig.llama_7b_gqa(num_layers=SLICE_LAYERS, max_seq_len=SLICE_SEQ)
    t0 = time.perf_counter()
    params, gen = build_model(base, dev)
    torch.cuda.synchronize()
    log(f"[slice] llama_7b_gqa L={base.num_layers} H={base.hidden_size} Hq={base.num_q_heads} "
        f"Hkv={base.num_kv_heads} D={base.head_dim} I={base.intermediate_size} V={base.vocab_size}, "
        f"int8 weights + int8 lm_head, built in {time.perf_counter() - t0:.1f} s")
    prompts, lengths = _prompts(base, dev, gen)
    log(f"[slice] prompt lengths {lengths.tolist()}, {SLICE_NEW_TOKENS} greedy tokens")
    n_layers, steps = base.num_layers, SLICE_NEW_TOKENS - 1
    # per prefill: one attention and four projections a layer, plus the
    # lm_head (8 rows: the small-M kernel); per decode step: one append,
    # one attention and four projections a layer, plus the lm_head
    expected = {"flash_prefill": n_layers, "append_rows_kv": steps * n_layers,
                "flash_decode": steps * n_layers, "quant_matmul": (4 * n_layers + 1) * (steps + 1),
                "quant_matmul_tiled": 4 * n_layers}
    runs, streams = {}, {}
    for splits in (1, base.num_splits):
        cfg = ModelConfig.llama_7b_gqa(num_layers=SLICE_LAYERS, max_seq_len=SLICE_SEQ, num_splits=splits)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        toks = llama.generate(params, cfg, prompts, lengths, SLICE_NEW_TOKENS, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        log(f"[slice] num_splits={splits}: generate {wall * 1e3:.1f} ms; launches {counts}")
        if counts != expected:
            raise AssertionError(f"launch counts {counts} != expected {expected}")
        if toks.shape != (SLICE_BATCH, SLICE_NEW_TOKENS) or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
            raise AssertionError(f"bad token stream {toks.shape}")
        streams[splits] = toks

        # timing on its own: prefill, then decode steps
        hkv, d = cfg.kv_cache_dims()
        cache = contiguous.init_cache(cfg.num_layers, SLICE_BATCH, hkv, cfg.max_seq_len, d, device=dev)
        cos, sin = llama.rope_tables(cfg, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = llama.prefill(params, cache, prompts, lengths, cos, sin, cfg)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("non-finite prefill logits")
        tok = llama.sample(logits)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = llama.decode_step(params, cache, tok, cos, sin, cfg)
            tok = llama.sample(logits)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("non-finite decode logits")
        runs[splits] = dict(prefill_ms=prefill_ms, decode_ms_per_step=step_ms,
                            decode_tok_s=SLICE_BATCH / step_ms * 1e3,
                            prefill_tok_s=int(lengths.sum()) / prefill_ms * 1e3, counts=counts)
        log(f"[slice] num_splits={splits}: prefill {prefill_ms:.1f} ms "
            f"({runs[splits]['prefill_tok_s']:.0f} prompt tok/s), decode {step_ms:.3f} ms/step "
            f"({runs[splits]['decode_tok_s']:.1f} tok/s at B={SLICE_BATCH}), "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
        del cache
    agree = (streams[1] == streams[base.num_splits]).float().mean().item()
    log(f"[slice] token agreement between num_splits=1 and {base.num_splits}: {agree:.3f}")
    del params
    torch.cuda.empty_cache()
    return runs


# ---------------------------------------------------------------- phase 4


@contextlib.contextmanager
def plain_ops():
    """Route the model's op calls to the plain PyTorch twins (on the card)."""
    from starflashattention_tpu_torch.cache import contiguous
    from starflashattention_tpu_torch.models import llama
    from starflashattention_tpu_torch.ops import cache_append, flash_decode, flash_prefill, quant_matmul

    swaps = [(llama, "flash_decode", flash_decode.flash_decode_plain),
             (llama, "flash_prefill", flash_prefill.flash_prefill_plain),
             (llama, "quant_matmul", quant_matmul.quant_matmul_plain),
             (contiguous, "append_rows_kv", cache_append.append_rows_kv_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def phase_path_vs_path(dev):
    from starflashattention_tpu_torch.cache import contiguous
    from starflashattention_tpu_torch.models import llama
    from starflashattention_tpu_torch.runtime.params import ModelConfig

    cfg = ModelConfig.llama_7b_gqa(num_layers=4, max_seq_len=SLICE_SEQ)
    params, gen = build_model(cfg, dev)
    prompts, lengths = _prompts(cfg, dev, gen)
    cos, sin = llama.rope_tables(cfg, device=dev)

    def run():
        hkv, d = cfg.kv_cache_dims()
        cache = contiguous.init_cache(cfg.num_layers, SLICE_BATCH, hkv, cfg.max_seq_len, d, device=dev)
        logits, cache = llama.prefill(params, cache, prompts, lengths, cos, sin, cfg)
        out = [logits]
        tok = llama.sample(logits)
        for _ in range(4):
            logits, cache = llama.decode_step(params, cache, tok, cos, sin, cfg)
            out.append(logits)
            tok = llama.sample(logits)
        return torch.stack(out), cache

    kern, kcache = run()
    with plain_ops():
        plain, pcache = run()
    err = (kern - plain).abs().max().item()
    peak = plain.abs().max().item()
    # bf16 activations: where the kernel and the plain version round a sum
    # to bf16 on either side of a tie, the flip propagates through the
    # layers; a few percent of the logit range bounds that at 4 layers.
    tol = 0.05 * peak
    _check(f"path vs path (4 layers, prefill + 4 decode steps) logits (max |logit| {peak:.2f})", err, tol)
    same_argmax = (kern.argmax(-1) == plain.argmax(-1)).float().mean().item()
    log(f"[path] argmax agreement {same_argmax:.3f}; cache lengths {kcache.lengths.tolist()} "
        f"vs {pcache.lengths.tolist()}")
    if not torch.equal(kcache.lengths, pcache.lengths):
        raise AssertionError("cache lengths differ")
    return err, tol


# ---------------------------------------------------------------- phase 5


def phase_decode_profile(dev):
    """bench.py's canonical decode chain on the port: full-width 7B-GQA,
    B=16, every sequence at 512 of 1024 cache rows, int8 weights and
    lm_head, greedy steps. Times the step on the host clock, then traces a
    few steps with torch.profiler for device time by kernel and the device's
    idle share. Not part of the default run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from starflashattention_tpu_torch.cache import contiguous
    from starflashattention_tpu_torch.models import llama
    from starflashattention_tpu_torch.runtime.params import ModelConfig

    batch, start_len, steps, traced = 16, 512, 32, 8
    for splits in (1, ModelConfig.llama_7b_gqa().num_splits):
        cfg = ModelConfig.llama_7b_gqa(max_seq_len=SLICE_SEQ, num_splits=splits)
        params, _ = build_model(cfg, dev)
        hkv, d = cfg.kv_cache_dims()
        cache = contiguous.init_cache(cfg.num_layers, batch, hkv, cfg.max_seq_len, d, device=dev)
        cos, sin = llama.rope_tables(cfg, device=dev)
        tok = torch.zeros((batch,), dtype=torch.int32, device=dev)

        def run(n, tok):
            for _ in range(n):
                logits, _ = llama.decode_step(params, cache, tok, cos, sin, cfg)
                tok = llama.sample(logits)
            return tok

        cache.lengths.fill_(start_len)
        tok = run(3, tok)  # warm-up
        cache.lengths.fill_(start_len)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok = run(steps, tok)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
        log(f"[profile] num_splits={splits}: decode B={batch} at {start_len}+ rows: {step_ms:.3f} ms/step "
            f"({batch / step_ms * 1e3:.1f} tok/s), host clock over {steps} steps")

        cache.lengths.fill_(start_len)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tok = run(traced, tok)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = {}
        for evt in prof.key_averages():
            if getattr(evt, "device_type", None) != DeviceType.CUDA:
                continue
            us = getattr(evt, "self_device_time_total", None)
            us = evt.self_cuda_time_total if us is None else us
            kernels[evt.key] = (us / 1e3 / traced, evt.count / traced)
        if not kernels:
            log(f"[profile] num_splits={splits}: the profiler saw no device time; kernel breakdown not measured")
        else:
            busy = sum(ms for ms, _ in kernels.values())
            launches = sum(n for _, n in kernels.values())
            log(f"[profile] num_splits={splits}: traced {traced} steps, {wall_ms / traced:.3f} ms/step wall, "
                f"device busy {busy:.3f} ms/step in {launches:.0f} kernel launches/step, "
                f"idle share {1 - busy * traced / wall_ms:.3f}")
            for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]:
                log(f"[profile]   {ms:8.3f} ms/step  {n:6.1f} launches/step  {name[:110]}")
        del params, cache
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- main

REPLACES = {
    "flash_decode (1 split, fused)": ("starflashattention_tpu/ops/flash_decode.py:213", "flash_decode.cu"),
    "flash_decode (split-KV partials)": ("starflashattention_tpu/ops/flash_decode.py:141", "flash_decode.cu"),
    "append_rows_kv": ("starflashattention_tpu/ops/cache_append.py:86", "cache_append.cu"),
    "quant_matmul (small-M, decode rows)": ("starflashattention_tpu/ops/quant_matmul.py:35", "quant_matmul.cu"),
    "quant_matmul (tiled, prefill rows)": ("starflashattention_tpu/ops/quant_matmul.py:35", "quant_matmul.cu"),
    "flash_prefill": ("starflashattention_tpu/ops/flash_prefill.py:67", "flash_prefill.cu"),
}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default="1,2,3,4",
                        help="comma-separated phases to run (default 1,2,3,4; phase 5, "
                             "a profile of bench.py's decode chain, runs only when named)")
    args = parser.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import starflashattention_tpu_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    phase_device_and_build()
    timer = Timer(dev)
    kernels = phase_kernels(dev, timer) if 2 in phases else {}
    runs = phase_slice(dev) if 3 in phases else {}
    if 4 in phases:
        phase_path_vs_path(dev)
    if 5 in phases:
        phase_decode_profile(dev)

    launches = {}
    if runs:
        fused, split = runs[1]["counts"], runs[max(runs)]["counts"]
        launches = {"flash_decode (1 split, fused)": fused["flash_decode"],
                    "flash_decode (split-KV partials)": split["flash_decode"],
                    "append_rows_kv": split["append_rows_kv"],
                    "quant_matmul (small-M, decode rows)": split["quant_matmul"] - split["quant_matmul_tiled"],
                    "quant_matmul (tiled, prefill rows)": split["quant_matmul_tiled"],
                    "flash_prefill": split["flash_prefill"]}
    line = []
    for name, r in kernels.items():
        replaces, src = REPLACES[name]
        line.append({"name": name, "route": "cuda", "source": f"starflashattention_tpu_torch/csrc/{src}",
                     "replaces": replaces, "launches": launches.get(name),
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

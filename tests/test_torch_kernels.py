"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode), carries
the ``cuda`` marker and skips without one. The module imports neither JAX
nor the JAX package, so on a machine with a card and no JAX it runs alone::

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -o addopts="" -p no:cacheprovider

Tolerances, each against the plain twin on the same card and inputs:
- bf16 attention outputs: both sides compute in fp32 and round once to
  bf16, so they may differ by one bf16 ulp (2^-8 relative) of |o| <= 4;
- prefill attention: the kernel also rounds P to bf16 for the PV product
  (as the TPU kernel does), so 2e-2 absolute;
- quant_matmul, fp32 out: fp32 sums of the same exact products in another
  order, 1e-5 of the output's peak; bf16 out adds one bf16 rounding;
- cache append: equal bytes.
"""

import pytest
import torch

from starflashattention_tpu_torch.cache import contiguous
from starflashattention_tpu_torch.core import quant
from starflashattention_tpu_torch.models import llama
from starflashattention_tpu_torch.ops import cache_append, flash_decode, flash_prefill, quant_matmul
from starflashattention_tpu_torch.runtime.params import ModelConfig

pytestmark = pytest.mark.cuda

BF16_ULP = 2.0**-8


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gen(dev):
    return torch.Generator(device=dev).manual_seed(0)


def _max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("num_splits", [1, 4])
def test_flash_decode_kernel_matches_plain(cuda, dtype, d, num_splits):
    gen = _gen(cuda)
    b, hq, hkv, s = 4, 8, 2, 512
    q = torch.randn((b, hq, d), generator=gen, device=cuda, dtype=dtype)
    k = torch.randn((2, b, hkv, s, d), generator=gen, device=cuda, dtype=dtype)
    v = torch.randn((2, b, hkv, s, d), generator=gen, device=cuda, dtype=dtype)
    lengths = torch.tensor([1, 512, 77, 300], dtype=torch.int32, device=cuda)
    kw = dict(layer=1, num_splits=num_splits, block_k=128)
    before = flash_decode.flash_decode.launches
    out = flash_decode.flash_decode(q, k, v, lengths, **kw)
    assert flash_decode.flash_decode.launches == before + 1
    ref = flash_decode.flash_decode_plain(q, k, v, lengths, **kw)
    tol = 4 * BF16_ULP if dtype == torch.bfloat16 else 1e-5
    assert _max_err(out, ref) <= tol


def test_flash_decode_partials_match_plain(cuda):
    gen = _gen(cuda)
    q = torch.randn((3, 8, 128), generator=gen, device=cuda, dtype=torch.bfloat16)
    k = torch.randn((1, 3, 2, 1024, 128), generator=gen, device=cuda, dtype=torch.bfloat16)
    v = torch.randn_like(k)
    lengths = torch.tensor([1, 600, 1024], dtype=torch.int32, device=cuda)
    kw = dict(layer=0, num_splits=4, block_k=256)
    o, m, l = flash_decode.flash_decode_with_stats(q, k, v, lengths, **kw)
    o_r, m_r, l_r = flash_decode.flash_decode_with_stats_plain(q, k, v, lengths, **kw)
    live = m_r > -1e30  # splits that hold a valid position
    assert torch.equal(live, m > -1e30)
    assert (m - m_r)[live].abs().max().item() <= 1e-4
    assert ((l - l_r) / l_r.clamp(min=1))[live].abs().max().item() <= 1e-4
    assert ((o - o_r) / l_r.clamp(min=1)[..., None])[live].abs().max().item() <= 1e-4
    assert torch.all(l[~live] == 0) and torch.all(o[~live] == 0)


def test_flash_decode_length_zero_row_gives_zero(cuda):
    gen = _gen(cuda)
    q = torch.randn((2, 4, 128), generator=gen, device=cuda, dtype=torch.bfloat16)
    k = torch.randn((1, 2, 1, 256, 128), generator=gen, device=cuda, dtype=torch.bfloat16)
    lengths = torch.tensor([0, 9], dtype=torch.int32, device=cuda)
    for splits in (1, 4):
        out = flash_decode.flash_decode(q, k, k, lengths, layer=0, num_splits=splits, block_k=64)
        assert torch.all(out[0] == 0) and torch.all(torch.isfinite(out))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8])
def test_append_rows_kv_kernel_matches_plain(cuda, dtype):
    gen = _gen(cuda)
    shape = (2, 4, 2, 64, 128)
    k = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    v = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    kn = torch.randn((4, 2, 128), generator=gen, device=cuda).to(dtype)
    vn = torch.randn((4, 2, 128), generator=gen, device=cuda).to(dtype)
    pos = torch.tensor([0, 63, 5, 9], dtype=torch.int32, device=cuda)
    k2, v2 = k.clone(), v.clone()
    cache_append.append_rows_kv(k, v, kn, vn, 1, pos)
    cache_append.append_rows_kv_plain(k2, v2, kn, vn, 1, pos)
    assert torch.equal(k, k2) and torch.equal(v, v2)
    one = k.clone()
    cache_append.append_rows(one, vn, 0, pos)
    cache_append.append_rows_kv_plain(k2, None, vn, None, 0, pos)
    assert torch.equal(one, k2)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("rows", [1, 16, 40, 64, 65, 200])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_quant_matmul_kernel_matches_plain(cuda, mode, rows, out_dtype):
    gen = _gen(cuda)
    wq = quant.quantize_weight(torch.randn((2, 512, 384), generator=gen, device=cuda), mode)
    x = torch.randn((rows, 512), generator=gen, device=cuda, dtype=torch.bfloat16)
    out = quant_matmul.quant_matmul(x, wq["w"], wq["scale"], layer=1, out_dtype=out_dtype)
    ref = quant_matmul.quant_matmul_plain(x, wq["w"], wq["scale"], layer=1, out_dtype=out_dtype)
    assert out.dtype == out_dtype and out.shape == (rows, 384)
    rel = 1e-5 if out_dtype == torch.float32 else BF16_ULP
    assert _max_err(out, ref) <= rel * ref.float().abs().max().item()


@pytest.mark.parametrize("hq,hkv,d", [(8, 2, 128), (8, 8, 64), (16, 2, 128)])
def test_flash_prefill_kernel_matches_plain(cuda, hq, hkv, d):
    gen = _gen(cuda)
    q = torch.randn((2, hq, 100, d), generator=gen, device=cuda, dtype=torch.bfloat16)
    k = torch.randn((2, hkv, 256, d), generator=gen, device=cuda, dtype=torch.bfloat16)
    v = torch.randn_like(k)
    q_off = torch.tensor([0, 130], dtype=torch.int32, device=cuda)
    lengths = torch.tensor([90, 230], dtype=torch.int32, device=cuda)  # row 0: 10 padded queries
    out = flash_prefill.flash_prefill(q, k, v, lengths, q_offsets=q_off)
    ref = flash_prefill.flash_prefill_plain(q, k, v, lengths, q_offsets=q_off)
    valid = [90, 100]
    for bi, n in enumerate(valid):
        assert _max_err(out[bi, :, :n], ref[bi, :, :n]) <= 2e-2


def test_generate_runs_on_the_kernels(cuda):
    """A narrow model whose head_dim the kernels take: greedy generate on
    the card launches every kernel, and its prefill + decode logits agree
    with the same model run on the CPU through the plain twins (bf16
    activations round at other places on the two devices: 5% of the
    logit range)."""
    cfg = ModelConfig.tiny(hidden_size=256, intermediate_size=512, num_q_heads=4, num_kv_heads=2,
                           head_dim=64, max_seq_len=256, dtype="bfloat16")
    params = llama.quantize_model_weights(
        llama.init_params(cfg, _gen(cuda), device=cuda), "int8", lm_head=True)
    prompts = torch.randint(0, cfg.vocab_size, (3, 40), generator=_gen(cuda), device=cuda,
                            dtype=torch.int32)
    lengths = torch.tensor([40, 17, 1], dtype=torch.int32, device=cuda)
    counters = (cache_append.append_rows_kv, flash_decode.flash_decode,
                flash_prefill.flash_prefill, quant_matmul.quant_matmul)
    before = [fn.launches for fn in counters]
    toks = llama.generate(params, cfg, prompts, lengths, 4, device=cuda)
    assert toks.shape == (3, 4) and toks.dtype == torch.int32
    grew = [fn.launches - b for fn, b in zip(counters, before)]
    n_layers, steps = cfg.num_layers, 3
    assert grew == [steps * n_layers, steps * n_layers, n_layers, (4 * n_layers + 1) * (steps + 1)]

    def to(tree, dev):
        return {k: to(v, dev) for k, v in tree.items()} if isinstance(tree, dict) else tree.to(dev)

    def logits_on(dev):
        p = to(params, dev)
        cache = contiguous.init_cache(n_layers, 3, cfg.num_kv_heads, cfg.max_seq_len, cfg.head_dim,
                                      dtype=torch.bfloat16, device=dev)
        cos, sin = llama.rope_tables(cfg, device=dev)
        logits, cache = llama.prefill(p, cache, prompts.to(dev), lengths.to(dev), cos, sin, cfg)
        out = [logits]
        for tok in toks[:, :2].T:
            logits, cache = llama.decode_step(p, cache, tok.to(dev), cos, sin, cfg)
            out.append(logits)
        return torch.stack(out).float().cpu()

    kern, plain = logits_on(cuda), logits_on(torch.device("cpu"))
    assert _max_err(kern, plain) <= 0.05 * plain.abs().max().item()

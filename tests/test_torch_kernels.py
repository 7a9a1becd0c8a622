"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode), carries
the ``cuda`` marker and skips without one. The module imports neither JAX
nor the JAX package, so on a machine with a card and no JAX it runs alone::

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -o addopts="" -p no:cacheprovider

Quantized cases: K4 and K6's split-K forms (up to 64 rows: ragged splits,
partial bands, every n8 tile count, the same bits on two runs and the
arrival counters back at zero), K6 (int4 weight-only; its tiled form at
partial tiles and groups that end inside a stage), K4's tiled form on int8 and fp8 weights at
partial tiles and a TP shard's K, K10 / K11 (W8A8 / W4A8; both also at
phase 14's TP-4 shard shapes, K10 byte for byte its twin at ragged tiles), the int8 / fp8 options of K1, K2 and K7, and
K8 on 1-byte pools; the decode step's append folded into K1, K2 and K7
(bit for bit the standalone K3 / K8 followed by the decode, output and
whole tables, at D 64, 128, 256 and 640, on fp32, bf16, int8 and fp8 KV,
plain and with the variants, and at Mistral's and Gemma-2's variant
shapes); the verify step's block append folded into K1's verify launch
(bit for bit K9 followed by the verify, output and whole tables, at D 64,
128 and 256, fp32 and bf16 q, on fp32, bf16, int8 and fp8 KV, plain and
with the variants, spans across tile and chunk edges, clamped and inactive
rows, and at Gemma-2's verify shape; windowed spans clamped past S held
to the plain twins; D 640 refuses a span); quantized deployments
through ``generate`` and both engines. Decode at head_dim 64, 128 and 256
(one kernel, the KV walk split across blocks, the quantized KV's scales
folded in it): decode, verify and paged decode at the edge cases of
``tests/test_torch_split_decode.py``, on bf16, int8 and fp8 KV.

Tolerances, each against the plain twin on the same card and inputs:
- bf16 attention outputs: both sides compute in fp32 and round once to
  bf16, so they may differ by one bf16 ulp (2^-8 relative) of |o| <= 4;
  on int8 / fp8 KV also elementwise, in ulps of each element's own value;
- prefill attention: the kernel also rounds P to bf16 for the PV product
  (as the TPU kernel does), so 2e-2 absolute;
- quant_matmul, fp32 out: fp32 sums of the same exact products in another
  order, 1e-5 of the output's peak; bf16 out adds one bf16 rounding;
- cache append (contiguous and paged): equal bytes.

Paged tests use a shuffled page table (physical page != logical page), a
row of length 0 and a row that fills all ``pages_per_seq`` pages.

Training: K5 with the LSE (causal and not) at G in {1, 2, 4, 8} and D in
{64, 128, 256}, the two K12 kernels at G in {1, 2, 4, 8} and D in {64, 128}
(and 256 below), lengths that are no tile multiple, q offsets and a
zero-length sequence, K12's bytes across two runs; K12's dq at groups
that leave rows of its block idle (G 3, 5, 6, 7); K12's dk/dv with each KV
tile's q walk split across blocks and with none split; a band whose first
tile follows 1-3 sink tiles in K5's K/V ring; gradients through
``flash_attention`` against autograd of the plain forward, and a bf16
training step of a 2-layer model (launch counts, falling loss); with the
attention variants, K5's LSE and K12 under the window, sinks and softcap
at D 64, 128 and 256 (K/V rows below every band set to NaN change no bit
of dq), K12 at D 256 without options, each option's visible effect on the
gradients, and training steps of narrow Gemma-2, Mistral with sinks and
Gemma models. MLA's latent row (D 640, 4 or 16 query heads on one KV head):
K1, K7, K2 and K5 against their twins on the split kernel's chunk edges,
the forms they refuse, and a narrow
DeepSeek-style model (MLA, int4 experts) through ``generate`` and both
engines. Ring context parallelism's ``kv_offset``: K5 with the LSE and K12
on a chunk whose sinks' boundary the offset moves, with a KV chunk in the
rows' future and a sequence of length 0 beside it. Each tolerance is
stated at its test.
"""

import pytest
import torch

from starflashattention_tpu_torch.cache import contiguous
from starflashattention_tpu_torch.core import quant
from starflashattention_tpu_torch.models import llama, train
from starflashattention_tpu_torch.ops import (cache_append, flash_bwd, flash_decode, flash_prefill,
                                              paged_decode, quant_matmul)
from starflashattention_tpu_torch.runtime.params import ModelConfig
from starflashattention_tpu_torch.serving import Engine, PagedEngine, SamplingParams

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


def _ulps(out, ref):
    """Largest |out - ref| in bf16 ulps of each element's own |ref| (2^-7
    |ref|, an upper bound of its ulp), with a floor of 1e-3 of the peak of
    its (sequence, head) row for elements near 0, where the two sides' fp32
    sums in different orders dominate."""
    out, ref = out.float(), ref.float()
    floor = 1e-3 * ref.abs().amax(dim=-1, keepdim=True)
    return ((out - ref).abs() / (2.0**-7 * ref.abs() + floor).clamp(min=1e-30)).max().item()


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


def _paged_setup(dev, dtype, page_size, d=128, b=4, hkv=2, pages_per_seq=6, layers=2):
    """Pools with a shuffled page table; lengths: 0, a full table, ragged."""
    gen = _gen(dev)
    num_pages = b * pages_per_seq + 3  # page 0 is the null page; a few spare
    shape = (layers, hkv, num_pages, page_size, d)
    k = torch.randn(shape, generator=gen, device=dev).to(dtype)
    v = torch.randn(shape, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(num_pages - 1, generator=torch.Generator().manual_seed(1))[: b * pages_per_seq] + 1
    table = perm.reshape(b, pages_per_seq).to(device=dev, dtype=torch.int32)
    full = pages_per_seq * page_size
    lengths = torch.tensor([0, full, 1 + page_size // 2, full - page_size - 3][:b], dtype=torch.int32,
                           device=dev)
    return k, v, table, lengths


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("page_size", [16, 128])
def test_paged_flash_decode_kernel_matches_plain(cuda, dtype, page_size):
    k, v, table, lengths = _paged_setup(cuda, dtype, page_size)
    q = torch.randn((4, 8, 128), generator=_gen(cuda), device=cuda).to(dtype)
    before = paged_decode.paged_flash_decode.launches
    out = paged_decode.paged_flash_decode(q, k, v, table, lengths, layer=1)
    assert paged_decode.paged_flash_decode.launches == before + 1
    ref = paged_decode.paged_flash_decode_plain(q, k, v, table, lengths, layer=1)
    tol = 4 * BF16_ULP if dtype == torch.bfloat16 else 1e-5
    assert out.dtype == dtype and _max_err(out, ref) <= tol
    assert torch.all(out[0] == 0)  # the row of length 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("page_size", [16, 128])
def test_append_rows_paged_kernel_matches_plain(cuda, dtype, page_size):
    k, v, table, lengths = _paged_setup(cuda, dtype, page_size)
    gen = _gen(cuda)
    kn = torch.randn((4, 2, 128), generator=gen, device=cuda).to(dtype)
    vn = torch.randn((4, 2, 128), generator=gen, device=cuda).to(dtype)
    pos = torch.clamp(lengths, max=table.shape[1] * page_size - 1)  # the full row writes its last slot
    k2, v2 = k.clone(), v.clone()
    before = cache_append.append_rows_paged_kv.launches
    cache_append.append_rows_paged_kv(k, v, kn, vn, 1, table, pos)
    assert cache_append.append_rows_paged_kv.launches == before + 1
    cache_append.append_rows_paged_kv_plain(k2, v2, kn, vn, 1, table, pos)
    assert torch.equal(k, k2) and torch.equal(v, v2)


# ----------------------------------------------------------------- the folded append

# (write position, attended rows) at S 512: a first token, an inactive row
# (a stale write, 0 rows), a write clamped to S - 1, writes on each side of
# the 128-row chunk edge, a length-0 row
FOLD_S, FOLD_ROWS = 512, ((0, 1), (37, 0), (517, 512), (128, 129), (0, 0), (127, 128))
FOLD_VARIANTS = dict(window=64, sinks=4, softcap=30.0)


def _bits_equal(a, b):
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
    return a.shape == b.shape and torch.equal(a.contiguous().view(ints[a.element_size()]),
                                              b.contiguous().view(ints[b.element_size()]))


def _fold_case(dev, d, kv, s=FOLD_S, rows=FOLD_ROWS, hq=None, hkv=None):
    """q, the (2, B, Hkv, S, D) tables, the new rows, write positions,
    lengths and the scales keyword arguments of one fold case: bf16 q on
    bf16 / int8 / fp8 KV (quantized against 5 / qmax), fp32 q on fp32 KV."""
    from starflashattention_tpu_torch.core.quant import quantize_value

    gen = _gen(dev)
    hq, hkv = hq or (16 if d == 640 else 8), hkv or (1 if d == 640 else 2)
    b = len(rows)
    q_dtype = torch.float32 if kv == "float32" else torch.bfloat16
    q = torch.randn((b, hq, d), generator=gen, device=dev, dtype=q_dtype)
    tensors = [torch.randn(shape, generator=gen, device=dev, dtype=q_dtype)
               for shape in ((2, b, hkv, s, d),) * 2 + ((b, hkv, d),) * 2]
    sc = {}
    if kv in ("int8", "fp8"):
        scales = torch.full((hkv,), 5.0 / (127.0 if kv == "int8" else 448.0), device=dev)
        tensors = [quantize_value(t, scales, kv, head_axis=2 if t.dim() == 5 else 1) for t in tensors]
        sc = dict(k_scales=scales, v_scales=scales)
    wpos = torch.tensor([p for p, _ in rows], dtype=torch.int32, device=dev)
    lengths = torch.tensor([n for _, n in rows], dtype=torch.int32, device=dev)
    return q, *tensors, wpos, lengths, sc


def _fold_matches(tables, fused, sequence):
    """The fused launch and the standalone append then the decode, each on
    its own clones of ``tables``: equal output and tables, bit for bit."""
    a, b = [t.clone() for t in tables], [t.clone() for t in tables]
    out_f, out_s = fused(*a), sequence(*b)
    assert _bits_equal(out_f, out_s)
    assert all(_bits_equal(x, y) for x, y in zip(a, b))
    return out_f


def _fold_modes(d):
    modes = ["merging", "partials", "paged"]
    return modes if d == 640 else modes + ["variants", "paged variants"]


@pytest.mark.parametrize("d,kv,mode", [(d, kv, mode) for d in (64, 128, 256, 640)
                                       for kv in (("bfloat16",) if d == 640 else
                                                  ("bfloat16", "float32", "int8", "fp8"))
                                       for mode in _fold_modes(d)])
def test_folded_append_equals_append_then_decode(cuda, d, kv, mode):
    """K3 folded into K1 (merging), K2 (4 splits) and K8 into K7 (a
    shuffled table; the inactive and length-0 rows' entries the null page
    0), plain and with window 64, 4 sinks and softcap 30: bit for bit the
    standalone append followed by the decode, output and whole tables;
    one launch, counted by both counters."""
    q, k, v, kn, vn, wpos, lengths, sc = _fold_case(cuda, d, kv)
    opts = FOLD_VARIANTS if "variants" in mode else {}
    pos = torch.clamp(wpos, max=FOLD_S - 1)
    if mode.startswith("paged"):
        ps = 16
        b = q.shape[0]
        full = (torch.randperm(b * FOLD_S // ps, generator=torch.Generator().manual_seed(2)) + 1).reshape(b, -1)
        full = full.to(device=cuda, dtype=torch.int32)
        pools = []
        for t in (k, v):
            pool = torch.zeros((2, t.shape[2], b * FOLD_S // ps + 1, ps, d), dtype=t.dtype, device=cuda)
            pool.view(torch.uint8)[:, :, full.reshape(-1).long()] = t.view(torch.uint8).reshape(
                2, b, t.shape[2], FOLD_S // ps, ps, d * t.element_size()).transpose(1, 2).reshape(
                2, t.shape[2], -1, ps, d * t.element_size())
            pools.append(pool)
        table = full.clone()
        table[lengths == 0] = 0
        kw = dict(layer=1, **sc, **opts)
        before = (paged_decode.paged_flash_decode.launches, paged_decode.paged_flash_decode_append.launches)
        _fold_matches(pools, lambda a, b_: paged_decode.paged_flash_decode_append(q, a, b_, table, kn, vn, wpos,
                                                                                  lengths, **kw),
                      lambda a, b_: (cache_append.append_rows_paged_kv(a, b_, kn, vn, 1, table, pos),
                                     paged_decode.paged_flash_decode(q, a, b_, table, lengths, **kw))[1])
        assert (paged_decode.paged_flash_decode.launches - before[0],
                paged_decode.paged_flash_decode_append.launches - before[1]) == (2, 1)
        return
    kw = dict(layer=1, num_splits=4 if mode == "partials" else 1, block_k=256, **sc, **opts)
    before = (flash_decode.flash_decode.launches, flash_decode.flash_decode_append.launches)
    out = _fold_matches((k, v), lambda a, b_: flash_decode.flash_decode_append(q, a, b_, kn, vn, wpos, lengths, **kw),
                        lambda a, b_: (cache_append.append_rows_kv(a, b_, kn, vn, 1, pos),
                                       flash_decode.flash_decode(q, a, b_, lengths, **kw))[1])
    assert (flash_decode.flash_decode.launches - before[0],
            flash_decode.flash_decode_append.launches - before[1]) == (2, 1)
    assert torch.all(out[lengths == 0] == 0)


@pytest.mark.parametrize("family", ["mistral", "gemma2"])
def test_folded_append_at_the_variant_shapes(cuda, family):
    """Mistral-7B's window 4096 + 4 sinks (D 128, G 4) and Gemma-2-9B's
    softcap 50 on a sliding (window 4096) layer at D 256 (G 2), S 8192,
    writes past the window, inside the sink tile and at the table's end:
    bit for bit K3 then K1."""
    d, hq, hkv, opts = ((128, 32, 8, dict(window=4096, sinks=4)) if family == "mistral"
                        else (256, 16, 8, dict(window=4096, softcap=50.0)))
    rows = ((6000, 6001), (20, 21), (8191, 8192), (5000, 0))
    q, k, v, kn, vn, wpos, lengths, _ = _fold_case(cuda, d, "bfloat16", s=8192, rows=rows, hq=hq, hkv=hkv)
    kw = dict(layer=1, num_splits=1, **opts)
    _fold_matches((k, v), lambda a, b_: flash_decode.flash_decode_append(q, a, b_, kn, vn, wpos, lengths, **kw),
                  lambda a, b_: (cache_append.append_rows_kv(a, b_, kn, vn, 1, wpos),
                                 flash_decode.flash_decode(q, a, b_, lengths, **kw))[1])


def test_folded_append_refusals(cuda):
    """A verify span and rows the kernel does not take raise; nothing is
    copied to fit."""
    q, k, v, kn, vn, wpos, lengths, _ = _fold_case(cuda, 128, "bfloat16")
    run = lambda *a: flash_decode.flash_decode_append(*a, layer=1, num_splits=1)  # noqa: E731
    with pytest.raises(ValueError, match="verify span"):
        run(q[:, :, None].expand(-1, -1, 3, -1).contiguous(), k, v, kn, vn, wpos, lengths)
    with pytest.raises(ValueError, match="contiguous"):
        run(q, k, v, kn, vn.transpose(1, 2).contiguous().transpose(1, 2), wpos, lengths)
    unaligned = torch.empty(vn.numel() + 1, dtype=vn.dtype, device=cuda)[1:].view(vn.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        run(q, k, v, kn, unaligned, wpos, lengths)
    with pytest.raises(ValueError, match="does not match"):
        run(q, k, v, kn.float(), vn, wpos, lengths)


# (first write position, rows to write) of a verify span of T 5 at S 512:
# across the 32-row tile edge, across the 128-row chunk edge, at the
# table's start, clamped to S - T from S - 2 and from S, a partial span, an
# inactive row (n_valid 0); token 0 attends pos + 1 rows
VERIFY_FOLD_T = 5
VERIFY_FOLD_ROWS = ((30, 5), (126, 5), (0, 5), (FOLD_S - 2, 5), (FOLD_S, 5), (200, 3), (40, 0))
VERIFY_FOLD_KV = [(torch.float32, "float32"), (torch.bfloat16, "bfloat16"), (torch.float32, "int8"),
                  (torch.bfloat16, "int8"), (torch.float32, "fp8"), (torch.bfloat16, "fp8")]


def _verify_fold_case(dev, d, q_dtype, kv):
    """q (B, Hq, T, D), the (2, B, Hkv, S, D) tables, the new (B, Hkv, T, D)
    rows, write positions, n_valid, lengths and the scales keyword
    arguments of one verify fold case (Hq 8, Hkv 2): K / V in q's dtype, or
    int8 / fp8 quantized against 5 / qmax."""
    from starflashattention_tpu_torch.core.quant import quantize_value

    gen = _gen(dev)
    b, hq, hkv, t = len(VERIFY_FOLD_ROWS), 8, 2, VERIFY_FOLD_T
    q = torch.randn((b, hq, t, d), generator=gen, device=dev, dtype=q_dtype)
    tensors = [torch.randn(shape, generator=gen, device=dev, dtype=q_dtype)
               for shape in ((2, b, hkv, FOLD_S, d),) * 2 + ((b, hkv, t, d),) * 2]
    sc = {}
    if kv in ("int8", "fp8"):
        scales = torch.full((hkv,), 5.0 / (127.0 if kv == "int8" else 448.0), device=dev)
        tensors = [quantize_value(x, scales, kv, head_axis=2 if x.dim() == 5 else 1) for x in tensors]
        sc = dict(k_scales=scales, v_scales=scales)
    pos = torch.tensor([p for p, _ in VERIFY_FOLD_ROWS], dtype=torch.int32, device=dev)
    n_valid = torch.tensor([n for _, n in VERIFY_FOLD_ROWS], dtype=torch.int32, device=dev)
    return q, *tensors, pos, n_valid, pos + 1, sc


def _verify_fold_matches(q, k, v, kn, vn, pos, n_valid, lengths, **kw):
    """The fused verify launch against K9 at min(pos, S - T) then the
    verify, each on its own clones of the tables (``_fold_matches``)."""
    clamped = torch.clamp(pos, max=k.shape[3] - q.shape[2])
    return _fold_matches((k, v), lambda a, b_: flash_decode.flash_verify_append(q, a, b_, kn, vn, pos, n_valid,
                                                                                lengths, **kw),
                         lambda a, b_: (cache_append.append_block_kv(a, b_, kn, vn, kw["layer"], clamped, n_valid),
                                        flash_decode.flash_verify(q, a, b_, lengths, **kw))[1])


@pytest.mark.parametrize("variants", [False, True])
@pytest.mark.parametrize("q_dtype,kv", VERIFY_FOLD_KV, ids=[f"{str(q)[6:]}-{kv}" for q, kv in VERIFY_FOLD_KV])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_folded_block_append_equals_append_then_verify(cuda, d, q_dtype, kv, variants):
    """K9 folded into K1's verify launch (the chunk grid of S 512, 128-row
    chunks), plain and in the VARIANTS form (window 64 + 4 sinks, and a
    softcap of 30 at D 256): bit for bit the standalone block append at
    min(pos, S - T) followed by the verify, output and whole tables; one
    launch, counted by both counters."""
    q, k, v, kn, vn, pos, n_valid, lengths, sc = _verify_fold_case(cuda, d, q_dtype, kv)
    opts = {}
    if variants:
        opts = dict(window=64, sinks=4, **(dict(softcap=30.0) if d == 256 else {}))
    counters = (flash_decode.flash_verify, flash_decode.flash_verify_append, cache_append.append_block_kv)
    before = [c.launches for c in counters]
    out = _verify_fold_matches(q, k, v, kn, vn, pos, n_valid, lengths, layer=1, **sc, **opts)
    assert [c.launches - b_ for c, b_ in zip(counters, before)] == [2, 1, 1]
    assert out.shape == q.shape and bool(torch.isfinite(out.float()).all())


def test_folded_block_append_without_n_valid_writes_every_row(cuda):
    """n_valid None writes all T rows, as K9 does without it."""
    q, k, v, kn, vn, pos, _, lengths, _ = _verify_fold_case(cuda, 128, torch.bfloat16, "bfloat16")
    _verify_fold_matches(q, k, v, kn, vn, pos, None, lengths, layer=1)


def test_folded_block_append_at_gemma2_verify_shape(cuda):
    """Gemma-2-9B's verify step (D 256, Hq 16, Hkv 8, softcap 50, window
    4096) at S 8192: spans past the window, at the table's start, across a
    chunk edge (256-row chunks) and clamped at the table's end."""
    gen = _gen(cuda)
    b, hq, hkv, d, s, t = 4, 16, 8, 256, 8192, VERIFY_FOLD_T
    q = torch.randn((b, hq, t, d), generator=gen, device=cuda, dtype=torch.bfloat16)
    k, v = (torch.randn((2, b, hkv, s, d), generator=gen, device=cuda, dtype=torch.bfloat16) for _ in range(2))
    kn, vn = (torch.randn((b, hkv, t, d), generator=gen, device=cuda, dtype=torch.bfloat16) for _ in range(2))
    pos = torch.tensor([6000, 2, 510, s - 3], dtype=torch.int32, device=cuda)
    n_valid = torch.tensor([t, t, t, t], dtype=torch.int32, device=cuda)
    _verify_fold_matches(q, k, v, kn, vn, pos, n_valid, pos + 1, layer=1, window=4096, softcap=50.0)


@pytest.mark.parametrize("window", [8, 64])
@pytest.mark.parametrize("q_dtype,kv", [(torch.float32, "float32"), (torch.bfloat16, "bfloat16"),
                                        (torch.bfloat16, "int8")], ids=["fp32", "bf16", "bf16-int8"])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_folded_block_append_past_the_table_matches_plain(cuda, d, q_dtype, kv, window):
    """Windowed verify spans clamped past S (start S - 2 and S: token j
    attends pos + 1 + j rows, up to S + 4) with 4 sinks (and a softcap of 30
    at D 256): ``flash_verify_append`` and ``flash_verify`` against their
    plain twins, every row of every span. Each token's rows stop at S and
    its band starts at the unclamped pos + 1 + j - window; a band started
    at the clamped length takes up to T - 1 rows more."""
    q, k, v, kn, vn, pos, n_valid, lengths, sc = _verify_fold_case(cuda, d, q_dtype, kv)
    assert bool((lengths + VERIFY_FOLD_T - 1 > FOLD_S).any())
    kw = dict(layer=1, window=window, sinks=4, **sc, **(dict(softcap=30.0) if d == 256 else {}))
    tables, plain_tables = [t.clone() for t in (k, v)], [t.clone() for t in (k, v)]
    out = flash_decode.flash_verify_append(q, *tables, kn, vn, pos, n_valid, lengths, **kw)
    ref = flash_decode.flash_verify_append_plain(q, *plain_tables, kn, vn, pos, n_valid, lengths, **kw)
    assert all(_bits_equal(a, b_) for a, b_ in zip(tables, plain_tables))
    tol = 1e-5 if q_dtype == torch.float32 else 4 * BF16_ULP
    assert _max_err(out, ref) <= tol
    alone = flash_decode.flash_verify(q, *tables, lengths, **kw)
    assert _max_err(alone, flash_decode.flash_verify_plain(q, *tables, lengths, **kw)) <= tol


def test_folded_block_append_refusals(cuda):
    """D 640 takes no verify span, and rows the kernel does not take raise;
    nothing is copied to fit."""
    q, k, v, kn, vn, pos, n_valid, lengths, _ = _verify_fold_case(cuda, 128, torch.bfloat16, "bfloat16")
    run = lambda *a: flash_decode.flash_verify_append(*a, layer=1)  # noqa: E731
    with pytest.raises(ValueError, match="contiguous"):
        run(q, k, v, kn, vn.transpose(2, 3).contiguous().transpose(2, 3), pos, n_valid, lengths)
    with pytest.raises(ValueError, match="does not match"):
        run(q, k, v, kn[:, :, 0].contiguous(), vn, pos, n_valid, lengths)
    b, t = q.shape[0], VERIFY_FOLD_T
    ql = torch.zeros((b, 16, t, 640), dtype=torch.bfloat16, device=cuda)
    kl = torch.zeros((2, b, 1, FOLD_S, 640), dtype=torch.bfloat16, device=cuda)
    nl = torch.zeros((b, 1, t, 640), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="verify span"):
        run(ql, kl, kl.clone(), nl, nl.clone(), pos, n_valid, lengths)


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


@pytest.mark.parametrize("rows", [1, 16, 40, 64, 65, 200])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [128, 32])
def test_quant_matmul_int4_kernel_matches_plain(cuda, rows, out_dtype, group):
    """K6, small-M and tiled: 3 (g128) or 12 (g32) groups."""
    gen = _gen(cuda)
    wq = quant.quantize_weight_int4(torch.randn((2, 384, 96), generator=gen, device=cuda), group)
    x = torch.randn((rows, 384), generator=gen, device=cuda, dtype=torch.bfloat16)
    before = quant_matmul.quant_matmul_int4.launches
    out = quant_matmul.quant_matmul_int4(x, wq["w"], wq["scale"], layer=1, out_dtype=out_dtype)
    assert quant_matmul.quant_matmul_int4.launches == before + 1
    ref = quant_matmul.quant_matmul_int4_plain(x, wq["w"], wq["scale"], layer=1, out_dtype=out_dtype)
    assert out.dtype == out_dtype and out.shape == (rows, 96)
    rel = 1e-5 if out_dtype == torch.float32 else BF16_ULP
    assert _max_err(out, ref) <= rel * ref.float().abs().max().item()


def _split_k_call(fn, x, w, scale, out_dtype, half, splits):
    """Two launches of the split-K form (``splits`` None: the default grid)
    -> (out, out again); asserts that both counted as split-K launches, gave
    the same bits and left every arrival counter at zero, and that ``splits``
    gives a ragged last split."""
    if splits is not None:
        k, unit = x.shape[1], 2 * half or 16
        _, n_splits, split = quant_matmul.small_m_grid(x.shape[0], k, w.shape[-1], 2 * half or None,
                                                       splits=splits)
        assert n_splits > 1 and k % split and split % unit == 0
    before = (fn.launches, fn.launches_tiled)
    outs = [quant_matmul._launch(fn, x, w, scale, 1, out_dtype, half, splits) for _ in range(2)]
    assert (fn.launches, fn.launches_tiled) == (before[0] + 2, before[1])
    torch.cuda.synchronize()
    bits = torch.int32 if out_dtype == torch.float32 else torch.int16
    assert torch.equal(outs[0].view(bits), outs[1].view(bits))
    assert all(not ws["arrivals"].any() for ws in quant_matmul._SMALL_M_WORKSPACE.values())
    return outs[0]


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("rows", [1, 4, 16, 17, 33, 64])
@pytest.mark.parametrize("k,n", [(11008, 96), (1408, 2816)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", [None, 5])
def test_quant_matmul_split_k_matches_plain(cuda, mode, rows, k, n, out_dtype, splits):
    """K4's split-K form (up to 64 rows): every n8 tile count (1, 2, 4, 8
    for 1-8, 9-16, 17-32, 33-64 rows), one band of 96 columns (a partial
    band) or 22 bands, on the default grid and on 5 splits whose last is
    shorter. Two runs give the same bits and leave the arrival counters at
    zero (``_split_k_call``); the output is within 1e-5 of the plain twin's
    peak (fp32 sums in another order), one bf16 ulp more for bf16 out."""
    gen = _gen(cuda)
    wq = quant.quantize_weight(torch.randn((2, k, n), generator=gen, device=cuda), mode)
    x = torch.randn((rows, k), generator=gen, device=cuda, dtype=torch.bfloat16)
    out = _split_k_call(quant_matmul.quant_matmul, x, wq["w"], wq["scale"], out_dtype, 0, splits)
    ref = quant_matmul.quant_matmul_plain(x, wq["w"], wq["scale"], layer=1, out_dtype=out_dtype)
    assert out.dtype == out_dtype and out.shape == (rows, n)
    rel = 1e-5 if out_dtype == torch.float32 else BF16_ULP
    assert _max_err(out, ref) <= rel * ref.float().abs().max().item()


@pytest.mark.parametrize("group", [32, 64, 96, 128])
@pytest.mark.parametrize("rows", [1, 4, 16, 17, 33, 64])
@pytest.mark.parametrize("n", [96, 2816])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", [None, 5])
def test_quant_matmul_int4_split_k_matches_plain(cuda, group, rows, n, out_dtype, splits):
    """K6's split-K form: K = 11 groups (K 1408 at g128, as DeepSeek-V2-Lite's
    expert down projection; at g96 the groups end inside the ring's 64-row
    stages), on the default grid and on splits of 3, 3, 3 and 2 groups (5
    asked for, whole groups); the checks of the K4 case above."""
    gen = _gen(cuda)
    k = 11 * group
    wq = quant.quantize_weight_int4(torch.randn((2, k, n), generator=gen, device=cuda), group)
    x = torch.randn((rows, k), generator=gen, device=cuda, dtype=torch.bfloat16)
    out = _split_k_call(quant_matmul.quant_matmul_int4, x, wq["w"], wq["scale"], out_dtype, group // 2, splits)
    ref = quant_matmul.quant_matmul_int4_plain(x, wq["w"], wq["scale"], layer=1, out_dtype=out_dtype)
    assert out.dtype == out_dtype and out.shape == (rows, n)
    rel = 1e-5 if out_dtype == torch.float32 else BF16_ULP
    assert _max_err(out, ref) <= rel * ref.float().abs().max().item()


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quant_matmul_65_rows_take_the_tiled_form(cuda, mode):
    """65 rows is one past the split-K form: the entry counts a tiled launch."""
    gen = _gen(cuda)
    w = torch.randn((2, 512, 384), generator=gen, device=cuda)
    wq = quant.quantize_weight_int4(w, 128) if mode == "int4" else quant.quantize_weight(w, "int8")
    fn = quant_matmul.quant_matmul_int4 if mode == "int4" else quant_matmul.quant_matmul
    x = torch.randn((65, 512), generator=gen, device=cuda, dtype=torch.bfloat16)
    before = (fn.launches, fn.launches_tiled)
    fn(x, wq["w"], wq["scale"], layer=1)
    assert (fn.launches, fn.launches_tiled) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("rows", [65, 127, 300, 2048])
@pytest.mark.parametrize("n", [96, 4096])
@pytest.mark.parametrize("group", [32, 64, 96, 128])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_quant_matmul_int4_tiled_kernel_matches_plain(cuda, rows, n, group, out_dtype):
    """K6's tiled form (more than 64 rows): 128 x 128 tiles, a partial row
    tile, a partial column tile (N 96), groups that end inside a stage (32,
    64, 96: 48 packed rows a group) or fill one (128), K = 384 (3 stages) and
    K = 416 at group 32 (a last stage of one chunk). One launch a call."""
    gen = _gen(cuda)
    k = 416 if group == 32 else 384
    wq = quant.quantize_weight_int4(torch.randn((2, k, n), generator=gen, device=cuda), group)
    assert wq["scale"].shape[1] == k // group
    x = torch.randn((rows, k), generator=gen, device=cuda, dtype=torch.bfloat16)
    before = (quant_matmul.quant_matmul_int4.launches, quant_matmul.quant_matmul_int4.launches_tiled)
    out = quant_matmul.quant_matmul_int4(x, wq["w"], wq["scale"], layer=1, out_dtype=out_dtype)
    after = (quant_matmul.quant_matmul_int4.launches, quant_matmul.quant_matmul_int4.launches_tiled)
    assert after == (before[0] + 1, before[1] + 1)
    ref = quant_matmul.quant_matmul_int4_plain(x, wq["w"], wq["scale"], layer=1, out_dtype=out_dtype)
    assert out.dtype == out_dtype and out.shape == (rows, n)
    rel = 1e-5 if out_dtype == torch.float32 else BF16_ULP
    assert _max_err(out, ref) <= rel * ref.float().abs().max().item()


# The tiled matmuls' tolerance, relative to the output's peak: fp32 sums of
# the same exact products in another order (fp32 out); bf16 out rounds both
# sides once, and where their fp32 sums straddle a rounding boundary the two
# differ by one bf16 ulp of the element, up to 2^-7 of its magnitude (a peak
# just below a power of two and an element just above half of it).
_TILED_REL = {torch.float32: 1e-5, torch.bfloat16: 2 * BF16_ULP}


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("rows", [65, 127, 300, 2048])
@pytest.mark.parametrize("k,n", [(96, 96), (96, 4096), (96, 5504), (2752, 96), (2752, 4096), (2752, 5504)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_quant_matmul_tiled_kernel_matches_plain(cuda, mode, rows, k, n, out_dtype):
    """K4's tiled form (more than 64 rows): 128 x 256 tiles with a partial
    row tile, partial column tiles (N 96; 5504 is no multiple of 256), K 96
    (a last stage of 32 rows) and 2752 (a TP-4 shard of 7B's w_down: 43
    stages). One launch a call, counted in ``launches_tiled``."""
    gen = _gen(cuda)
    wq = quant.quantize_weight(torch.randn((2, k, n), generator=gen, device=cuda), mode)
    x = torch.randn((rows, k), generator=gen, device=cuda, dtype=torch.bfloat16)
    fn = quant_matmul.quant_matmul
    before = (fn.launches, fn.launches_tiled)
    out = fn(x, wq["w"], wq["scale"], layer=1, out_dtype=out_dtype)
    assert (fn.launches, fn.launches_tiled) == (before[0] + 1, before[1] + 1)
    ref = quant_matmul.quant_matmul_plain(x, wq["w"], wq["scale"], layer=1, out_dtype=out_dtype)
    assert out.dtype == out_dtype and out.shape == (rows, n)
    assert _max_err(out, ref) <= _TILED_REL[out_dtype] * ref.float().abs().max().item()


# phase 14's TP-4 shards of 7B at int4 group 64 (wqkv, wo, w_gate_up, w_down);
# group 128 where it divides K
W4A8_SHARDS = [(4096, 1536, 64), (1024, 4096, 64), (4096, 5504, 64), (2752, 4096, 64),
               (4096, 1536, 128), (1024, 4096, 128), (4096, 5504, 128)]


@pytest.mark.parametrize("rows", [65, 127, 300, 2048])
@pytest.mark.parametrize("k,n,group", W4A8_SHARDS)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_quant_matmul_w4a8_kernel_matches_plain_at_shards(cuda, rows, k, n, group, out_dtype):
    """K11 (64 x 256 tiles, a chunk of 32 packed rows per k32 pair; the G128
    form at group 128): exact int32 sums on both sides, the fp32 group sums
    in another order, so 1e-5 of the peak (fp32 out). N 1536 and 5504 end in
    a partial column tile, 2752 / 64 = 43 groups an odd count of chunks."""
    gen = _gen(cuda)
    wq = quant.quantize_weight_int4(torch.randn((2, k, n), generator=gen, device=cuda), group)
    x = torch.randn((rows, k), generator=gen, device=cuda, dtype=torch.bfloat16)
    fn = quant_matmul.quant_matmul_w4a8
    before = fn.launches
    out = fn(x, wq["w"], wq["scale"], layer=1, out_dtype=out_dtype)
    assert fn.launches == before + 1
    ref = quant_matmul.quant_matmul_w4a8_plain(x, wq["w"], wq["scale"], layer=1, out_dtype=out_dtype)
    assert out.shape == (rows, n) and _max_err(out, ref) <= _TILED_REL[out_dtype] * ref.float().abs().max().item()


@pytest.mark.parametrize("entry", ["w8a8", "w4a8"])
@pytest.mark.parametrize("rows", [1, 63, 256, 300])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_quant_matmul_a8_kernels_match_plain(cuda, entry, rows, out_dtype):
    """K10 and K11: exact int32 sums on both sides; the fp32 epilogue in
    another order (K11's group sums), so 1e-5 of the peak (f32 out)."""
    gen = _gen(cuda)
    w = torch.randn((2, 512, 160), generator=gen, device=cuda)
    wq = quant.quantize_weight(w, "int8") if entry == "w8a8" else quant.quantize_weight_int4(w)
    x = torch.randn((rows, 512), generator=gen, device=cuda, dtype=torch.bfloat16)
    fn = getattr(quant_matmul, "quant_matmul_" + entry)
    before = fn.launches
    out = fn(x, wq["w"], wq["scale"], layer=1, out_dtype=out_dtype)
    assert fn.launches == before + 1
    ref = getattr(quant_matmul, f"quant_matmul_{entry}_plain")(x, wq["w"], wq["scale"], layer=1,
                                                                out_dtype=out_dtype)
    rel = 1e-5 if out_dtype == torch.float32 else BF16_ULP
    assert out.dtype == out_dtype and _max_err(out, ref) <= rel * ref.float().abs().max().item()


@pytest.mark.parametrize("rows,k,n", [(200, 192, 384), (300, 2752, 1536), (129, 1024, 5504), (64, 128, 160),
                                      (2048, 4096, 5504)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_quant_matmul_w8a8_kernel_equals_plain_bytes(cuda, rows, k, n, out_dtype):
    """K10 (128 x 256 tiles, stages of 128 K columns) at ragged row tiles,
    half column tiles (N 384, 5504), a half last stage (K 192, 2752) and a
    TP-4 rank's shapes: exact int32 sums and the same two fp32 multiplies,
    so the plain twin's bytes; and its built tiles are ``W8A8_TILE``."""
    gen = _gen(cuda)
    wq = quant.quantize_weight(torch.randn((2, k, n), generator=gen, device=cuda), "int8")
    x = torch.randn((rows, k), generator=gen, device=cuda, dtype=torch.bfloat16)
    kw = dict(layer=1, out_dtype=out_dtype)
    out = quant_matmul.quant_matmul_w8a8(x, wq["w"], wq["scale"], **kw)
    assert torch.equal(out, quant_matmul.quant_matmul_w8a8_plain(x, wq["w"], wq["scale"], **kw))
    built = quant_matmul.w8a8_built_geometry()
    assert built[:3] == quant_matmul.W8A8_TILE and built[3] <= 232_448


@pytest.mark.parametrize("entry", ["quant_matmul", "quant_matmul_int4", "quant_matmul_w8a8",
                                   "quant_matmul_w4a8"])
def test_quant_matmul_zero_rows_launch_nothing(cuda, entry):
    """A call with no rows returns an empty output and counts no launch."""
    w = torch.randn((512, 160), generator=_gen(cuda), device=cuda)
    wq = quant.quantize_weight_int4(w) if entry.endswith(("int4", "w4a8")) else quant.quantize_weight(w, "int8")
    fn = getattr(quant_matmul, entry)
    before = fn.launches
    out = fn(torch.zeros((0, 512), device=cuda, dtype=torch.bfloat16), wq["w"], wq["scale"])
    assert out.shape == (0, 160) and fn.launches == before


def test_quant_matmul_int4_refuses_geometry(cuda):
    wq = quant.quantize_weight_int4(torch.randn((384, 64), device=cuda), 48)  # group/2 = 24
    with pytest.raises(ValueError, match="group/2"):
        quant_matmul.quant_matmul_int4(torch.zeros((4, 384), device=cuda, dtype=torch.bfloat16),
                                       wq["w"], wq["scale"])


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 8, 9, 16, 17, 40, 64, 100])
def test_fused_mlp_kernel_matches_plain(cuda, mode, x_dtype, rows):
    """K13, one launch a call, on a stacked (L, ...) pair at layer 1 (I 320,
    an odd number of 64-row chunks of w2), at row counts on both sides of
    the 8-, 16- and 32-row tiles (bf16 x: the split-K form's 8- to 64-row
    tiles, two of 64 at 100 rows). fp32 x: the same exact
    products summed in another order, 2e-5 of the peak; bf16 x: ``act`` is
    rounded to bf16 between the matmuls and may land on the other side of a
    tie, 4e-3 of the peak."""
    from starflashattention_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_plain

    gen = _gen(cuda)
    h, inter = 256, 320
    w1 = quant.quantize_weight(torch.randn((3, h, 2 * inter), generator=gen, device=cuda), mode)
    w2 = quant.quantize_weight(torch.randn((3, inter, h), generator=gen, device=cuda), mode)
    x = torch.randn((rows, h), generator=gen, device=cuda).to(x_dtype)
    before = fused_mlp.launches
    out = fused_mlp(x, w1["w"], w1["scale"], w2["w"], w2["scale"], layer=1)
    torch.cuda.synchronize()
    assert fused_mlp.launches == before + 1
    ref = fused_mlp_plain(x, w1["w"], w1["scale"], w2["w"], w2["scale"], layer=1)
    rel = 2e-5 if x_dtype == torch.float32 else 4e-3
    assert out.dtype == torch.float32 and _max_err(out, ref) <= rel * ref.abs().max().item()
    # the barrier counter (fp32 x) or the split-K counters (bf16 x) were left at rest, the bands' flags wait
    # for the next call's epoch
    again = fused_mlp(x, w1["w"], w1["scale"], w2["w"], w2["scale"], layer=1)
    assert torch.equal(again, out)


def test_fused_mlp_refuses_geometry(cuda):
    from starflashattention_tpu_torch.ops.fused_mlp import fused_mlp

    w1 = quant.quantize_weight(torch.randn((96, 128), device=cuda), "int8")  # H 96: not a multiple of 64
    w2 = quant.quantize_weight(torch.randn((64, 96), device=cuda), "int8")
    with pytest.raises(ValueError, match="multiples of 64"):
        fused_mlp(torch.zeros((2, 96), device=cuda), w1["w"], w1["scale"], w2["w"], w2["scale"])


def _quantized(t, mode, scales, head_axis):
    return quant.quantize_value(t, scales, mode, head_axis=head_axis)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("num_splits", [1, 4])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_decode_quantized_kernel_matches_plain(cuda, mode, num_splits, d):
    """K1 / K2 on int8 / fp8 tables: the kernel reads 1-byte values and
    folds the scales itself, in the order the plain route folds them."""
    gen = _gen(cuda)
    b, hq, hkv, s = 4, 8, 2, 512
    qmax = 127.0 if mode == "int8" else 448.0
    ks = torch.tensor([5.0 / qmax, 6.0 / qmax], device=cuda)
    vs = torch.tensor([4.0 / qmax, 5.0 / qmax], device=cuda)
    q = torch.randn((b, hq, d), generator=gen, device=cuda, dtype=torch.bfloat16)
    k = _quantized(torch.randn((2, b, hkv, s, d), generator=gen, device=cuda), mode, ks, 2)
    v = _quantized(torch.randn((2, b, hkv, s, d), generator=gen, device=cuda), mode, vs, 2)
    lengths = torch.tensor([1, 512, 77, 300], dtype=torch.int32, device=cuda)
    kw = dict(layer=1, num_splits=num_splits, block_k=128, k_scales=ks, v_scales=vs)
    before = flash_decode.flash_decode.launches
    out = flash_decode.flash_decode(q, k, v, lengths, **kw)
    assert flash_decode.flash_decode.launches == before + 1
    ref = flash_decode.flash_decode_plain(q, k, v, lengths, **kw)
    assert _max_err(out, ref) <= 4 * BF16_ULP
    # elementwise: one bf16 rounding (split partials) or two (fused: the
    # output, then times v_scale), each of which may fall either side
    assert _ulps(out, ref) <= (3 if num_splits == 1 else 2)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("page_size", [16, 128])
def test_paged_flash_decode_quantized_kernel_matches_plain(cuda, mode, page_size):
    k, v, table, lengths = _paged_setup(cuda, torch.float32, page_size)
    qmax = 127.0 if mode == "int8" else 448.0
    ks = torch.tensor([5.0 / qmax, 6.0 / qmax], device=cuda)
    vs = torch.tensor([4.0 / qmax, 5.0 / qmax], device=cuda)
    k, v = _quantized(k, mode, ks, 1), _quantized(v, mode, vs, 1)  # pools: (L, Hkv, P, ps, D)
    q = torch.randn((4, 8, 128), generator=_gen(cuda), device=cuda).to(torch.bfloat16)
    kw = dict(layer=1, k_scales=ks, v_scales=vs)
    out = paged_decode.paged_flash_decode(q, k, v, table, lengths, **kw)
    ref = paged_decode.paged_flash_decode_plain(q, k, v, table, lengths, **kw)
    assert out.dtype == torch.bfloat16 and _max_err(out, ref) <= 4 * BF16_ULP
    assert _ulps(out, ref) <= 2  # fp32 output times v_scale, one rounding
    assert torch.all(out[0] == 0)


@pytest.mark.parametrize("dtype", [torch.int8, torch.float8_e4m3fn])
@pytest.mark.parametrize("page_size", [16, 128])
def test_append_rows_paged_kernel_moves_one_byte_rows(cuda, dtype, page_size):
    """K8 on int8 / fp8 pools (K3 takes them too, see above): equal bytes."""
    k, v, table, lengths = _paged_setup(cuda, torch.float32, page_size)
    k, v = k.to(dtype), v.to(dtype)
    gen = _gen(cuda)
    kn = torch.randn((4, 2, 128), generator=gen, device=cuda).to(dtype)
    vn = torch.randn((4, 2, 128), generator=gen, device=cuda).to(dtype)
    pos = torch.clamp(lengths, max=table.shape[1] * page_size - 1)
    k2, v2 = k.clone(), v.clone()
    cache_append.append_rows_paged_kv(k, v, kn, vn, 1, table, pos)
    cache_append.append_rows_paged_kv_plain(k2, v2, kn, vn, 1, table, pos)
    assert torch.equal(k.view(torch.uint8), k2.view(torch.uint8))
    assert torch.equal(v.view(torch.uint8), v2.view(torch.uint8))


@pytest.mark.parametrize("hq,hkv,d", [(8, 2, 128), (8, 8, 64), (16, 2, 128), (4, 2, 64), (16, 16, 256),
                                      (16, 2, 256)])
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
    # the decode step's append runs in the decode launch: the standalone K3 never
    counters = (cache_append.append_rows_kv, flash_decode.flash_decode_append, flash_decode.flash_decode,
                flash_prefill.flash_prefill, quant_matmul.quant_matmul)
    before = [fn.launches for fn in counters]
    toks = llama.generate(params, cfg, prompts, lengths, 4, device=cuda)
    assert toks.shape == (3, 4) and toks.dtype == torch.int32
    grew = [fn.launches - b for fn, b in zip(counters, before)]
    n_layers, steps = cfg.num_layers, 3
    assert grew == [0, steps * n_layers, steps * n_layers, n_layers, (4 * n_layers + 1) * (steps + 1)]

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


@pytest.mark.parametrize("weights,overrides", [("int4", dict(quant_mode="int8")),
                                               ("int4", dict(w8a8_prefill=True, quant_mode="fp8")),
                                               ("int8", dict(w8a8_prefill=True))])
def test_quantized_generate_runs_on_the_kernels(cuda, weights, overrides):
    """Quantized deployments on the card: every projection on K6 (or K4),
    the 256-row prefill on K11 / K10 under w8a8_prefill, attention on the
    quantized K1; logits agree with the CPU run of the plain twins within
    5% of the logit range, as above."""
    cfg = ModelConfig.tiny(hidden_size=256, intermediate_size=512, num_q_heads=4, num_kv_heads=2,
                           head_dim=64, max_seq_len=256, dtype="bfloat16", **overrides)
    params = llama.init_params(cfg, _gen(cuda), quantize=weights, device=cuda)
    params = llama.quantize_model_weights(params, weights, lm_head=True)
    prompts = torch.randint(0, cfg.vocab_size, (4, 64), generator=_gen(cuda), device=cuda,
                            dtype=torch.int32)
    lengths = torch.tensor([64, 17, 1, 50], dtype=torch.int32, device=cuda)
    wo = quant_matmul.quant_matmul_int4 if weights == "int4" else quant_matmul.quant_matmul
    a8 = quant_matmul.quant_matmul_w4a8 if weights == "int4" else quant_matmul.quant_matmul_w8a8
    counters = (flash_decode.flash_decode, wo, a8)
    before = [fn.launches for fn in counters]
    toks = llama.generate(params, cfg, prompts, lengths, 3, device=cuda)
    grew = [fn.launches - b for fn, b in zip(counters, before)]
    n = cfg.num_layers
    prefill_a8 = 4 * n if cfg.w8a8_prefill else 0
    assert toks.shape == (4, 3) and grew == [2 * n, 3 * (4 * n + 1) - prefill_a8, prefill_a8]

    def to(tree, dev):
        return {k: to(v, dev) for k, v in tree.items()} if isinstance(tree, dict) else tree.to(dev)

    def logits_on(dev):
        p = to(params, dev)
        cache = contiguous.init_cache(n, 4, cfg.num_kv_heads, cfg.max_seq_len, cfg.head_dim,
                                      dtype=torch.bfloat16, quant_mode=cfg.quant_mode,
                                      calibration_scale=cfg.kv_calibration_scale, device=dev)
        cos, sin = llama.rope_tables(cfg, device=dev)
        logits, cache = llama.prefill(p, cache, prompts.to(dev), lengths.to(dev), cos, sin, cfg)
        out = [logits]
        for tok in toks[:, :2].T:
            logits, cache = llama.decode_step(p, cache, tok.to(dev), cos, sin, cfg)
            out.append(logits)
        return torch.stack(out).float().cpu()

    kern, plain = logits_on(cuda), logits_on(torch.device("cpu"))
    assert _max_err(kern, plain) <= 0.05 * plain.abs().max().item()


def test_serving_engines_run_on_the_kernels(cuda):
    """Both engines serve a narrow bf16 model on the card: the paged engine
    launches the paged decode, its append folded in, once per layer and
    decode step (and the contiguous ones never), preempts, hits its prefix
    cache and replays sampled streams exactly; every request finishes. The
    standalone appends (K3, K8) launch on neither."""
    cfg = ModelConfig.tiny(hidden_size=256, intermediate_size=512, num_q_heads=4, num_kv_heads=2,
                           head_dim=64, max_seq_len=256, dtype="bfloat16")
    params = llama.quantize_model_weights(
        llama.init_params(cfg, _gen(cuda), device=cuda), "int8", lm_head=True)
    g = torch.Generator().manual_seed(3)
    prefix = torch.randint(0, cfg.vocab_size, (32,), generator=g).tolist()
    prompts = [prefix + torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist() for n in (5, 40, 9, 70, 17)]
    counters = (cache_append.append_rows_kv, cache_append.append_rows_paged_kv,
                flash_decode.flash_decode_append, flash_decode.flash_decode,
                paged_decode.paged_flash_decode_append, paged_decode.paged_flash_decode)

    def run(engine):
        before = [fn.launches for fn in counters]
        out = engine.generate(prompts, 12, sampling=samp if engine.enable_sampling else None)
        assert engine.stats.finished == len(prompts) and all(len(o) == 12 for o in out)
        return out, [fn.launches - b for fn, b in zip(counters, before)]

    samp = [SamplingParams(temperature=0.9, top_p=0.9, seed=i) for i in range(len(prompts))]
    _, grew = run(Engine(params, cfg, num_slots=2, steps_per_round=4, device=cuda))
    assert grew[:2] == [0, 0] and grew[4:] == [0, 0] and grew[2] == grew[3] > 0

    def paged(**kw):
        return PagedEngine(params, cfg, num_slots=2, steps_per_round=4, page_size=16, num_pages=10,
                           prefill_chunk=32, prefix_cache=True, device=cuda, **kw)

    eng = paged()
    _, grew = run(eng)
    steps = eng.stats.decode_rounds * 4 * cfg.num_layers
    assert grew == [0, 0, 0, 0, steps, steps]
    assert eng.stats.preemptions > 0 and eng.stats.prefix_hits > 0
    assert run(paged(enable_sampling=True))[0] == run(paged(enable_sampling=True))[0]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8, torch.float8_e4m3fn])
@pytest.mark.parametrize("d", [64, 128])
def test_append_block_kv_kernel_matches_plain(cuda, dtype, d):
    """K9: partial, zero, full and table-edge rows, a block across a 32-row
    boundary and one hanging past the table (skipped): equal bytes."""
    gen = _gen(cuda)
    b, hkv, s, t = 5, 2, 64, 5
    k = torch.randn((2, b, hkv, s, d), generator=gen, device=cuda).to(dtype)
    v = torch.randn((2, b, hkv, s, d), generator=gen, device=cuda).to(dtype)
    kn = torch.randn((b, hkv, t, d), generator=gen, device=cuda).to(dtype)
    vn = torch.randn((b, hkv, t, d), generator=gen, device=cuda).to(dtype)
    pos = torch.tensor([0, 30, 59, 12, 62], dtype=torch.int32, device=cuda)
    n_valid = torch.tensor([t, 4, 5, 0, 5], dtype=torch.int32, device=cuda)
    k2, v2 = k.clone(), v.clone()
    before = cache_append.append_block_kv.launches
    cache_append.append_block_kv(k, v, kn, vn, 1, pos, n_valid)
    assert cache_append.append_block_kv.launches == before + 1
    cache_append.append_block_kv_plain(k2, v2, kn, vn, 1, pos, n_valid)
    assert torch.equal(k.view(torch.uint8), k2.view(torch.uint8))
    assert torch.equal(v.view(torch.uint8), v2.view(torch.uint8))


def test_append_block_kv_zero_rows_launch_nothing(cuda):
    """B == 0, T == 0 or an all-zero host n_valid: no launch, no write."""
    k = torch.randn((1, 2, 2, 64, 128), device=cuda, dtype=torch.bfloat16)
    ref = k.clone()
    before = cache_append.append_block_kv.launches
    for b, t, n_valid in ((0, 3, None), (2, 0, None), (2, 3, torch.zeros(2, dtype=torch.int32))):
        new = torch.ones((b, 2, t, 128), device=cuda, dtype=torch.bfloat16)
        kt = k[:, :b].contiguous() if b == 0 else k
        cache_append.append_block_kv(kt, kt.clone(), new, new, 0,
                                     torch.zeros(b, dtype=torch.int32, device=cuda), n_valid)
    assert cache_append.append_block_kv.launches == before and torch.equal(k, ref)


@pytest.mark.parametrize("kv", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("t", [2, 5, 17])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_verify_kernel_matches_plain_and_decode(cuda, kv, t, d):
    """K1's verify mode against its twin, and token j against the fused K1
    decode at lengths + j: bit for bit (the same tile loop; a tile past a
    token's length leaves its running state unchanged). T = 17 at G = 4
    takes about 95 KB of shared memory, above the default 48 KB."""
    gen = _gen(cuda)
    b, hq, hkv, s = 4, 16, 4, 512
    q = torch.randn((b, hq, t, d), generator=gen, device=cuda, dtype=torch.bfloat16)
    k = torch.randn((2, b, hkv, s, d), generator=gen, device=cuda)
    v = torch.randn((2, b, hkv, s, d), generator=gen, device=cuda)
    kw = dict(layer=1)
    if kv == "bf16":
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    else:
        qmax = 127.0 if kv == "int8" else 448.0
        ks = torch.tensor([5.0, 6.0, 4.0, 5.5], device=cuda) / qmax
        k, v = _quantized(k, kv, ks, 2), _quantized(v, kv, ks, 2)
        kw.update(k_scales=ks, v_scales=ks)
    lengths = torch.tensor([1, 31, 300, s - t + 1], dtype=torch.int32, device=cuda)
    before = flash_decode.flash_verify.launches
    out = flash_decode.flash_verify(q, k, v, lengths, **kw)
    assert flash_decode.flash_verify.launches == before + 1
    ref = flash_decode.flash_verify_plain(q, k, v, lengths, **kw)
    assert out.shape == q.shape and _max_err(out, ref) <= 4 * BF16_ULP
    assert _ulps(out, ref) <= (3 if kv != "bf16" else 2)
    for j in range(t):
        dec = flash_decode.flash_decode(q[:, :, j], k, v, lengths + j, num_splits=1, **kw)
        assert _max_err(out[:, :, j], dec) == 0.0


def test_spec_engines_run_on_the_kernels(cuda):
    """Both draft sources serve a narrow bf16 model on the card: every verify
    step launches K1's verify mode with K9 folded in once a layer, and the
    standalone block append and one-row append never (the draft model's
    decode steps append, folded into their decode launches, on its own
    cache); every request finishes."""
    cfg = ModelConfig.tiny(hidden_size=256, intermediate_size=512, num_q_heads=4, num_kv_heads=2,
                           head_dim=64, max_seq_len=256, dtype="bfloat16", num_splits=1)
    params = llama.quantize_model_weights(
        llama.init_params(cfg, _gen(cuda), device=cuda), "int8", lm_head=True)
    dcfg = ModelConfig.tiny(hidden_size=256, intermediate_size=512, num_q_heads=4, num_kv_heads=2,
                            head_dim=64, max_seq_len=256, dtype="bfloat16", num_splits=1, num_layers=1)
    dparams = llama.init_params(dcfg, torch.Generator(device=cuda).manual_seed(1), device=cuda)
    motif = torch.randint(0, cfg.vocab_size, (12,), generator=torch.Generator().manual_seed(3)).tolist()
    prompts = [motif + [i, i + 1] + motif for i in range(5)]
    counters = (flash_decode.flash_verify, flash_decode.flash_verify_append, cache_append.append_block_kv,
                cache_append.append_rows_kv, flash_decode.flash_decode_append)
    for draft, k in ((None, 3), ((dparams, dcfg), 2)):
        eng = Engine(params, cfg, num_slots=2, steps_per_round=3, spec_decode=k, draft_model=draft,
                     device=cuda)
        before = [fn.launches for fn in counters]
        out = eng.generate(prompts, 12)
        grew = [fn.launches - b for fn, b in zip(counters, before)]
        steps = eng.stats.decode_rounds * 3
        draft_rows = 0 if draft is None else steps * (k + 1) * dcfg.num_layers
        assert grew == [steps * cfg.num_layers, steps * cfg.num_layers, 0, 0, draft_rows]
        assert eng.stats.finished == len(prompts) and all(len(o) == 12 for o in out)
        assert eng.stats.spec_steps > 0


# ---------------------------------------------------------------- training: K5 with the LSE, K12

_TRAIN_Q_OFF = [0, 50, 7]
_TRAIN_LENGTHS = [90, 150, 0]  # ragged; the last sequence has no valid position


def _train_inputs(cuda, g, d, sq=100, skv=200, hkv=2):
    gen = _gen(cuda)
    shape_q, shape_kv = (3, g * hkv, sq, d), (3, hkv, skv, d)
    q, do = (torch.randn(shape_q, generator=gen, device=cuda, dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(shape_kv, generator=gen, device=cuda, dtype=torch.bfloat16) for _ in range(2))
    q_off = torch.tensor(_TRAIN_Q_OFF, dtype=torch.int32, device=cuda)
    lengths = torch.tensor(_TRAIN_LENGTHS, dtype=torch.int32, device=cuda)
    return q, k, v, do, lengths, q_off


def _rel_peak(out, ref):
    return _max_err(out, ref) / max(ref.float().abs().max().item(), 1e-30)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_flash_prefill_lse_kernel_matches_plain(cuda, g, d, causal):
    """K5 with the LSE (Sq = 100 and Skv = 200, not tile multiples; q
    offsets; a zero-length row): the output as K5's other test holds it, the
    LSE within 1e-4 (fp32 sums of the same products in another order, and
    exp2f / log2f against torch's) and exactly 3e38 on the empty rows; the
    output equals the call without the LSE bit for bit."""
    q, k, v, _, lengths, q_off = _train_inputs(cuda, g, d)
    kw = dict(causal=causal, q_offsets=q_off)
    out, lse = flash_prefill.flash_prefill(q, k, v, lengths, return_lse=True, **kw)
    ref, lse_ref = flash_prefill.flash_prefill_plain(q, k, v, lengths, return_lse=True, **kw)
    assert torch.equal(out, flash_prefill.flash_prefill(q, k, v, lengths, **kw))
    assert _max_err(out, ref) <= 2e-2
    empty = lse_ref > 1e38
    assert empty[2].all() and not empty[:2].any()
    assert bool((lse[empty] == lse_ref[empty]).all())
    assert _max_err(lse[~empty], lse_ref[~empty]) <= 1e-4


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_flash_bwd_kernels_match_plain(cuda, g, d, causal):
    """K12 against its plain version on the same o, lse and do: the kernels
    round P and dS to bf16 before their products (as the TPU kernels do)
    and write bf16, the plain version keeps fp32 and rounds once: 2e-2 of
    each gradient's peak. Two runs give the same bytes."""
    q, k, v, do, lengths, q_off = _train_inputs(cuda, g, d)
    kw = dict(causal=causal, q_offsets=q_off)
    o, lse = flash_prefill.flash_prefill(q, k, v, lengths, return_lse=True, **kw)
    before = (flash_bwd.flash_bwd_dq.launches, flash_bwd.flash_bwd_dkdv.launches)
    got = flash_bwd.flash_prefill_bwd(q, k, v, o, lse, do, lengths, **kw)
    assert (flash_bwd.flash_bwd_dq.launches, flash_bwd.flash_bwd_dkdv.launches) == (before[0] + 1,
                                                                                    before[1] + 1)
    ref = flash_bwd.flash_prefill_bwd_plain(q, k, v, o, lse, do, lengths, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert _rel_peak(a, b) <= 2e-2, (name, _rel_peak(a, b))
    assert float(got[0][2].abs().max()) == 0.0  # the zero-length sequence
    again = flash_bwd.flash_prefill_bwd(q, k, v, o, lse, do, lengths, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("g", [3, 5, 6, 7])
def test_flash_bwd_dq_groups_with_idle_rows(cuda, g, d, causal):
    """K12's dq where the group does not divide the block's rows (128, 64
    at D 256): rows past G * (rows // G) idle; 2e-2 of the plain twin's
    peak, 0 on the zero-length sequence, the same bytes twice; and the
    built tiles are ``dq_geometry``'s."""
    q, k, v, do, lengths, q_off = _train_inputs(cuda, g, d)
    kw = dict(causal=causal, q_offsets=q_off)
    o, lse = flash_prefill.flash_prefill(q, k, v, lengths, return_lse=True, **kw)
    args = (q, k, v, lse, do, flash_bwd.bwd_delta(o, do), lengths)
    dq = flash_bwd.flash_bwd_dq(*args, **kw)
    assert _rel_peak(dq, flash_bwd.flash_bwd_dq_plain(*args, **kw)) <= 2e-2
    assert float(dq[2].abs().max()) == 0.0 and torch.equal(dq, flash_bwd.flash_bwd_dq(*args, **kw))
    assert flash_bwd.dq_built_geometry(d, g) == flash_bwd.dq_geometry(d, g)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_autograd_matches_plain(cuda, causal):
    """Gradients through ``flash_attention`` (K5 with the LSE, then K12)
    against autograd through the plain forward on the card, for a loss that
    reads the valid rows: 2e-2 of each gradient's peak."""
    q, k, v, do, lengths, q_off = _train_inputs(cuda, 4, 128)
    q_pos = q_off[:, None] + torch.arange(q.shape[2], device=cuda)[None, :]
    rowmask = (q_pos < lengths[:, None])[:, None, :, None]

    def grads(fn):
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out = fn(*leaves, lengths, causal=causal, q_offsets=q_off)
        return torch.autograd.grad((torch.where(rowmask, out, 0.0).float() * do.float()).sum(), leaves)

    for name, a, b in zip(("dq", "dk", "dv"), grads(flash_bwd.flash_attention),
                          grads(flash_prefill.flash_prefill_plain)):
        assert _rel_peak(a, b) <= 2e-2, (name, _rel_peak(a, b))


def test_training_step_runs_on_the_kernels(cuda):
    """A narrow 2-layer bf16 model: each SGD step launches the attention
    forward with the LSE 2 L times (remat reruns it) and each K12 kernel L
    times; the loss falls over 3 steps (lr 1.0); its gradients agree with
    the plain attention's within 5e-2 of each gradient's peak (bf16
    activations and the kernels' bf16 P and dS)."""
    cfg = ModelConfig.tiny(hidden_size=256, intermediate_size=512, num_q_heads=4, num_kv_heads=2,
                           head_dim=64, max_seq_len=256, dtype="bfloat16")
    params = llama.init_params(cfg, _gen(cuda), device=cuda)
    cos, sin = llama.rope_tables(cfg, device=cuda)
    batch = torch.randint(0, cfg.vocab_size, (2, 129), generator=_gen(cuda), device=cuda)
    _, g_kernels = train.loss_and_grads(params, batch, cfg, cos, sin, use_flash=True)
    _, g_plain = train.loss_and_grads(params, batch, cfg, cos, sin, use_flash=False)
    for a, b in zip(train.tree_leaves(g_kernels), train.tree_leaves(g_plain)):
        assert _rel_peak(a, b) <= 5e-2
    momentum = train.tree_map(torch.zeros_like, params)
    counters = (flash_prefill.flash_prefill, flash_bwd.flash_bwd_dq, flash_bwd.flash_bwd_dkdv)
    losses = []
    for _ in range(3):
        before = [flash_prefill.flash_prefill.launches_lse] + [fn.launches for fn in counters]
        params, momentum, loss = train.train_step(params, momentum, batch, cfg, cos, sin, 1.0)
        grew = [flash_prefill.flash_prefill.launches_lse - before[0]] + [
            fn.launches - b for fn, b in zip(counters, before[1:])]
        n = cfg.num_layers
        assert grew == [2 * n, 2 * n, n, n]
        losses.append(float(loss))
    assert all(torch.isfinite(torch.tensor(losses))) and losses[-1] < losses[0]


def test_moe_training_step_runs_on_the_kernels(cuda, monkeypatch):
    """A narrow 2-layer bf16 Mixtral-routed MoE: each SGD step launches K5
    with the LSE 2 L times and each K12 kernel L times; the loss falls over
    3 steps (lr 1.0); its gradients, the router's and the experts' among
    them, agree with plain attention's within 5e-2 of each gradient's peak,
    the plain route replaying the kernels' routing (a token whose k-th and
    (k+1)-th logits nearly tie may take other experts when the attention's
    rounding moves them)."""
    cfg = ModelConfig.tiny(hidden_size=256, intermediate_size=256, num_q_heads=4, num_kv_heads=2, head_dim=64,
                           max_seq_len=256, dtype="bfloat16", num_experts=4, num_experts_per_tok=2)
    params = llama.init_params(cfg, _gen(cuda), device=cuda)
    cos, sin = llama.rope_tables(cfg, device=cuda)
    batch = torch.randint(0, cfg.vocab_size, (2, 129), generator=_gen(cuda), device=cuda)
    top_k, routes = llama._top_k, []

    def recording(x, k):
        vals, idx = top_k(x, k)
        routes.append(idx)
        return vals, idx

    monkeypatch.setattr(llama, "_top_k", recording)
    _, g_kernels = train.loss_and_grads(params, batch, cfg, cos, sin, use_flash=True)
    replay = iter(routes)

    def pinned(x, k):
        idx = next(replay)
        return x.gather(-1, idx), idx

    monkeypatch.setattr(llama, "_top_k", pinned)
    _, g_plain = train.loss_and_grads(params, batch, cfg, cos, sin, use_flash=False)
    assert next(replay, None) is None and len(routes) == 2 * cfg.num_layers  # each layer's forward and rerun
    monkeypatch.setattr(llama, "_top_k", top_k)
    for a, b in zip(train.tree_leaves(g_kernels), train.tree_leaves(g_plain)):
        assert _rel_peak(a, b) <= 5e-2
    for name in ("moe_router", "moe_gate_up", "moe_down"):
        assert float(g_kernels["layers"][name].abs().max()) > 0
    momentum = train.tree_map(torch.zeros_like, params)
    counters = (flash_prefill.flash_prefill, flash_bwd.flash_bwd_dq, flash_bwd.flash_bwd_dkdv)
    losses = []
    for _ in range(3):
        before = [flash_prefill.flash_prefill.launches_lse] + [fn.launches for fn in counters]
        params, momentum, loss = train.train_step(params, momentum, batch, cfg, cos, sin, 1.0)
        grew = [flash_prefill.flash_prefill.launches_lse - before[0]] + [
            fn.launches - b for fn, b in zip(counters, before[1:])]
        n = cfg.num_layers
        assert grew == [2 * n, 2 * n, n, n]
        losses.append(float(loss))
    assert all(torch.isfinite(torch.tensor(losses))) and losses[-1] < losses[0]


# ------------------------------------------------------------ attention variants

# (window, sinks, softcap): a band, a band with sinks (inside and past the
# first 32-row tile), a softcap, all of them
VARIANTS = [(100, 0, None), (100, 4, None), (64, 40, None), (None, 0, 30.0), (100, 4, 50.0)]


def _poison_below(x, starts, sinks, block=64):
    """A copy of a (L, B, Hkv, S, D) table whose whole ``block``-row blocks
    below each sequence's band start hold NaN (the sink blocks spared)."""
    out = x.clone()
    first = -(-sinks // block) * block
    for b, lo in enumerate(starts.tolist()):
        end = max(lo, 0) // block * block
        if end > first:
            out[:, b, :, first:end] = float("nan")
    return out


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_decode_variants_match_plain(cuda, variant, d, dtype):
    """K1 with a window, sinks and softcap at every head_dim; the rows
    below each band hold NaN and change no bit of the output."""
    w, sk, cap = variant
    gen = _gen(cuda)
    b, hq, hkv, s = 4, 8, 2, 512
    q = torch.randn((b, hq, d), generator=gen, device=cuda, dtype=dtype)
    k = torch.randn((2, b, hkv, s, d), generator=gen, device=cuda, dtype=dtype)
    v = torch.randn((2, b, hkv, s, d), generator=gen, device=cuda, dtype=dtype)
    lengths = torch.tensor([3, 512, 177, 300], dtype=torch.int32, device=cuda)
    kw = dict(layer=1, num_splits=1, window=w, sinks=sk, softcap=cap)
    out = flash_decode.flash_decode(q, k, v, lengths, **kw)
    ref = flash_decode.flash_decode_plain(q, k, v, lengths, **kw)
    tol = 4 * BF16_ULP if dtype == torch.bfloat16 else 1e-5
    assert _max_err(out, ref) <= tol
    if w is not None:
        kp, vp = (_poison_below(x, lengths - w, sk) for x in (k, v))
        assert torch.equal(flash_decode.flash_decode(q, kp, vp, lengths, **kw), out)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("d", [128, 256])
def test_flash_verify_variants_match_plain_and_decode(cuda, variant, d):
    w, sk, cap = variant
    gen = _gen(cuda)
    b, hq, hkv, s, t = 4, 8, 4, 512, 5
    q = torch.randn((b, hq, t, d), generator=gen, device=cuda, dtype=torch.bfloat16)
    k = torch.randn((1, b, hkv, s, d), generator=gen, device=cuda, dtype=torch.bfloat16)
    v = torch.randn_like(k)
    lengths = torch.tensor([1, 130, 300, s - t + 1], dtype=torch.int32, device=cuda)
    kw = dict(layer=0, window=w, sinks=sk, softcap=cap)
    out = flash_decode.flash_verify(q, k, v, lengths, **kw)
    ref = flash_decode.flash_verify_plain(q, k, v, lengths, **kw)
    assert _max_err(out, ref) <= 4 * BF16_ULP
    for j in range(t):
        dec = flash_decode.flash_decode(q[:, :, j], k, v, lengths + j, num_splits=1, **kw)
        assert _max_err(out[:, :, j], dec) == 0.0
    if w is not None:
        kp, vp = (_poison_below(x, lengths - w, sk) for x in (k, v))
        assert torch.equal(flash_decode.flash_verify(q, kp, vp, lengths, **kw), out)


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_flash_decode_variants_on_quantized_kv_match_plain(cuda, kv):
    gen = _gen(cuda)
    b, hq, hkv, s, d = 4, 8, 2, 512, 256
    q = torch.randn((b, hq, d), generator=gen, device=cuda, dtype=torch.bfloat16)
    qmax = 127.0 if kv == "int8" else 448.0
    ks = torch.tensor([5.0, 6.0], device=cuda) / qmax
    k, v = (_quantized(torch.randn((1, b, hkv, s, d), generator=gen, device=cuda), kv, ks, 2)
            for _ in range(2))
    lengths = torch.tensor([3, 512, 177, 300], dtype=torch.int32, device=cuda)
    kw = dict(layer=0, num_splits=1, window=100, sinks=4, softcap=50.0, k_scales=ks, v_scales=ks)
    out = flash_decode.flash_decode(q, k, v, lengths, **kw)
    ref = flash_decode.flash_decode_plain(q, k, v, lengths, **kw)
    assert _ulps(out, ref) <= 3


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_decode_partials_head_dim_256_match_plain(cuda, dtype):
    """K2 at Gemma-7B's head_dim (Hq = Hkv), 4 splits."""
    gen = _gen(cuda)
    q = torch.randn((3, 4, 256), generator=gen, device=cuda, dtype=dtype)
    k = torch.randn((1, 3, 4, 1024, 256), generator=gen, device=cuda, dtype=dtype)
    v = torch.randn_like(k)
    lengths = torch.tensor([1, 600, 1024], dtype=torch.int32, device=cuda)
    kw = dict(layer=0, num_splits=4, block_k=256)
    o, m, l = flash_decode.flash_decode_with_stats(q, k, v, lengths, **kw)
    o_r, m_r, l_r = flash_decode.flash_decode_with_stats_plain(q, k, v, lengths, **kw)
    live = m_r > -1e30
    assert (m - m_r)[live].abs().max().item() <= 1e-4
    assert ((o - o_r) / l_r.clamp(min=1)[..., None])[live].abs().max().item() <= 1e-4
    out = flash_decode.flash_decode(q, k, v, lengths, **kw)
    tol = 4 * BF16_ULP if dtype == torch.bfloat16 else 1e-5
    assert _max_err(out, flash_decode.flash_decode_plain(q, k, v, lengths, **kw)) <= tol


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("page_size", [16, 128])
def test_paged_flash_decode_variants_match_plain(cuda, variant, d, page_size):
    """K7 with the variants; the entries below each band (past the sink
    pages) become the null page, which holds NaN: no bit of the output
    moves."""
    w, sk, cap = variant
    k, v, table, lengths = _paged_setup(cuda, torch.bfloat16, page_size, d=d, pages_per_seq=512 // page_size)
    lengths = torch.tensor([0, 512, 177, 300], dtype=torch.int32, device=cuda)
    q = torch.randn((4, 8, d), generator=_gen(cuda), device=cuda, dtype=torch.bfloat16)
    kw = dict(layer=1, window=w, sinks=sk, softcap=cap)
    out = paged_decode.paged_flash_decode(q, k, v, table, lengths, **kw)
    ref = paged_decode.paged_flash_decode_plain(q, k, v, table, lengths, **kw)
    assert _max_err(out, ref) <= 4 * BF16_ULP and torch.all(out[0] == 0)
    if w is not None:
        nulled = table.clone()
        first = -(-sk // page_size)
        for b, n in enumerate(lengths.tolist()):
            end = max(n - w, 0) // page_size
            if end > first:
                nulled[b, first:end] = 0
        kp, vp = k.clone(), v.clone()
        kp[:, :, 0], vp[:, :, 0] = float("nan"), float("nan")
        assert torch.equal(paged_decode.paged_flash_decode(q, kp, vp, nulled, lengths, **kw), out)


# the split-KV kernel (csrc/flash_decode_split.cu) at head_dim 64, 128 and
# 256: tests/test_torch_split_decode.py's edge cases, name: (lengths of token
# 0, window, sinks, softcap, tokens T)
D256_CASES = {
    "length-0-and-below-a-tile": ((0, 17, 200, 256), None, 0, None, 1),
    "window-below-a-tile": ((5, 17, 150, 256), 20, 0, None, 1),
    "sinks-past-the-band-start": ((60, 100, 200, 256), 40, 70, None, 1),
    "band-across-chunks": ((150, 200, 256, 90), 100, 4, None, 1),
    "softcap-and-band": ((33, 129, 222, 256), 48, 0, 50.0, 1),
    "verify-T5": ((1, 17, 150, 252), 48, 4, 50.0, 5),
    "verify-T5-no-window": ((0, 31, 96, 252), None, 0, None, 5),
}


def _arrivals_at_rest():
    """The split kernel's arrival counters are back at 0 after its calls."""
    torch.cuda.synchronize()
    return all(int(ws["arrivals"].abs().sum()) == 0 for ws in flash_decode._SPLIT_WORKSPACE.values())


@pytest.mark.parametrize("case", sorted(D256_CASES))
@pytest.mark.parametrize("kv", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_d256_decode_and_verify_edge_cases_match_plain(cuda, case, kv, d):
    """The split kernel (split KV walk, one merging launch) on the CPU test's
    edge cases at S 512 (at least 4 chunks: a band across chunk boundaries,
    chunks the walk misses, a row of length 0), at every head_dim: against
    the plain twin; verify token j bit for bit the decode at lengths + j;
    rows below every band poisoned with NaN change no bit; the arrival
    counters end at 0."""
    lens, w, sk, cap, t = D256_CASES[case]
    gen = _gen(cuda)
    b, hq, hkv, s = 4, 8, 2, 512
    assert flash_decode.split_chunking(s, b, hkv, flash_decode.sm_count(cuda), d)[1] >= 4
    q = torch.randn((b, hq, t, d), generator=gen, device=cuda, dtype=torch.bfloat16)
    k = torch.randn((1, b, hkv, s, d), generator=gen, device=cuda)
    v = torch.randn((1, b, hkv, s, d), generator=gen, device=cuda)
    kw = dict(layer=0, window=w, sinks=sk, softcap=cap, sm_scale=d**-0.5)
    if kv == "bf16":
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    else:
        qmax = 127.0 if kv == "int8" else 448.0
        ks = torch.tensor([5.0, 6.0], device=cuda) / qmax
        k, v = _quantized(k, kv, ks, 2), _quantized(v, kv, ks, 2)
        kw.update(k_scales=ks, v_scales=ks)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    roundings = 1 if kv == "bf16" else 2
    if t == 1:
        before = flash_decode.flash_decode.launches
        out = flash_decode.flash_decode(q[:, :, 0], k, v, lengths, num_splits=1, **kw)
        assert flash_decode.flash_decode.launches == before + 1
        ref = flash_decode.flash_decode_plain(q[:, :, 0], k, v, lengths, num_splits=1, **kw)
        run = lambda kk, vv: flash_decode.flash_decode(q[:, :, 0], kk, vv, lengths, num_splits=1, **kw)  # noqa: E731
        zero_row = out[0]
    else:
        before = flash_decode.flash_verify.launches
        out = flash_decode.flash_verify(q, k, v, lengths, **kw)
        assert flash_decode.flash_verify.launches == before + 1
        ref = flash_decode.flash_verify_plain(q, k, v, lengths, **kw)
        for j in range(t):
            dec = flash_decode.flash_decode(q[:, :, j], k, v, lengths + j, num_splits=1, **kw)
            assert _max_err(out[:, :, j], dec) == 0.0
        run = lambda kk, vv: flash_decode.flash_verify(q, kk, vv, lengths, **kw)  # noqa: E731
        zero_row = out[0, :, 0]
    assert _ulps(out, ref) <= roundings + 1
    assert bool(torch.all(zero_row == 0)) == (lens[0] == 0)
    if w is not None and kv == "bf16":
        kp, vp = (_poison_below(x, lengths - w, sk) for x in (k, v))
        assert torch.equal(run(kp, vp), out)
    assert _arrivals_at_rest()


@pytest.mark.parametrize("case", sorted(c for c in D256_CASES if D256_CASES[c][4] == 1))
@pytest.mark.parametrize("kv", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("page_size", [16, 128])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_d256_paged_edge_cases_match_plain(cuda, case, kv, page_size, d):
    """K7 through the same kernel on a shuffled page table, on the
    contiguous decode's chunk grid, at every head_dim; with a window, the
    entries below each band (past the sink pages) become the null page,
    which holds NaN."""
    lens, w, sk, cap, _ = D256_CASES[case]
    dtype = torch.bfloat16 if kv == "bf16" else torch.float32
    k, v, table, _ = _paged_setup(cuda, dtype, page_size, d=d, pages_per_seq=512 // page_size,
                                  layers=1)
    kw = dict(layer=0, window=w, sinks=sk, softcap=cap)
    if kv != "bf16":
        qmax = 127.0 if kv == "int8" else 448.0
        ks = torch.tensor([5.0, 6.0], device=cuda) / qmax
        k, v = _quantized(k, kv, ks, 1), _quantized(v, kv, ks, 1)
        kw.update(k_scales=ks, v_scales=ks)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    q = torch.randn((4, 8, d), generator=_gen(cuda), device=cuda, dtype=torch.bfloat16)
    before = paged_decode.paged_flash_decode.launches
    out = paged_decode.paged_flash_decode(q, k, v, table, lengths, **kw)
    assert paged_decode.paged_flash_decode.launches == before + 1
    ref = paged_decode.paged_flash_decode_plain(q, k, v, table, lengths, **kw)
    assert _ulps(out, ref) <= (2 if kv == "bf16" else 3)
    assert bool(torch.all(out[0] == 0)) == (lens[0] == 0)
    if w is not None and kv == "bf16":
        nulled = table.clone()
        first = -(-sk // page_size)
        for b, n in enumerate(lens):
            end = max(n - w, 0) // page_size
            if end > first:
                nulled[b, first:end] = 0
        kp, vp = k.clone(), v.clone()
        kp[:, :, 0], vp[:, :, 0] = float("nan"), float("nan")
        assert torch.equal(paged_decode.paged_flash_decode(q, kp, vp, nulled, lengths, **kw), out)
    assert _arrivals_at_rest()


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("hq,hkv,d", [(8, 2, 128), (8, 4, 256), (4, 4, 256), (16, 2, 64), (8, 1, 128),
                                      (4, 4, 64), (16, 2, 256)])
def test_flash_prefill_variants_match_plain(cuda, variant, hq, hkv, d):
    """K5 with the variants (D 256 stages Q in shared memory); the rows
    below every chunk row's band hold NaN and change no bit."""
    w, sk, cap = variant
    gen = _gen(cuda)
    q = torch.randn((2, hq, 100, d), generator=gen, device=cuda, dtype=torch.bfloat16)
    k = torch.randn((2, hkv, 512, d), generator=gen, device=cuda, dtype=torch.bfloat16)
    v = torch.randn_like(k)
    q_off = torch.tensor([0, 330], dtype=torch.int32, device=cuda)
    lengths = torch.tensor([90, 430], dtype=torch.int32, device=cuda)  # row 0: 10 padded queries
    kw = dict(window=w, sinks=sk, softcap=cap)
    if cap is not None:
        kw["sm_scale"] = d**-0.5 * 1.5
    out = flash_prefill.flash_prefill(q, k, v, lengths, q_offsets=q_off, **kw)
    ref = flash_prefill.flash_prefill_plain(q, k, v, lengths, q_offsets=q_off, **kw)
    for bi, n in enumerate([90, 100]):
        assert _max_err(out[bi, :, :n], ref[bi, :, :n]) <= 2e-2
    if w is not None:
        kp, vp = (_poison_below(x[None], q_off - w + 1, sk)[0] for x in (k, v))
        assert torch.equal(flash_prefill.flash_prefill(q, kp, vp, lengths, q_offsets=q_off, **kw), out)


@pytest.mark.parametrize("kernel", ["decode", "verify", "paged", "prefill"])
@pytest.mark.parametrize("drop", ["softcap", "sinks"])
def test_variant_checks_see_the_softcap_and_the_sinks(cuda, kernel, drop):
    """Each kernel agrees with its twin within 2 bf16 ulps of each element
    (3 for K5, which rounds P to bf16), and the same kernel without the cap
    of 50, or without the 4 sinks, lies over 10x that far from the twin, so
    the check sees each option. For the cap, q is scaled so that the scores
    (sm_scale 1/16) spread over several times the cap; the sinks are
    checked on unscaled scores, where they hold a share of each row's
    weight (with scores bent to the cap they may hold none)."""
    gen = _gen(cuda)
    b, hq, hkv, s, d, w = 2, 8, 4, 1024, 256, 256
    kw = dict(sm_scale=1 / 16, window=w, sinks=4, softcap=50.0)
    q_shape = {"verify": (b, hq, 5, d), "prefill": (b, hq, 128, d)}.get(kernel, (b, hq, d))
    q = (torch.randn(q_shape, generator=gen, device=cuda) * (40 if drop == "softcap" else 1)).to(torch.bfloat16)
    k = torch.randn((1, b, hkv, s, d), generator=gen, device=cuda, dtype=torch.bfloat16)
    v = torch.randn_like(k)
    lengths = torch.tensor([700, 1000], dtype=torch.int32, device=cuda)
    if kernel == "paged":
        k_pool, v_pool, table, _ = _paged_setup(cuda, torch.bfloat16, 64, d=d, b=b, hkv=hkv,
                                                pages_per_seq=s // 64, layers=1)
        run = lambda **o: paged_decode.paged_flash_decode(q, k_pool, v_pool, table, lengths,  # noqa: E731
                                                         layer=0, **o)
        plain = paged_decode.paged_flash_decode_plain(q, k_pool, v_pool, table, lengths, layer=0, **kw)
    elif kernel == "prefill":
        q_off = lengths - 128
        run = lambda **o: flash_prefill.flash_prefill(q, k[0], v[0], lengths, q_offsets=q_off,  # noqa: E731
                                                      **o)
        plain = flash_prefill.flash_prefill_plain(q, k[0], v[0], lengths, q_offsets=q_off, **kw)
    else:
        fn = flash_decode.flash_verify if kernel == "verify" else flash_decode.flash_decode
        extra = {} if kernel == "verify" else dict(num_splits=1)
        run = lambda **o: fn(q, k, v, lengths, layer=0, **extra, **o)  # noqa: E731
        plain = (flash_decode.flash_verify_plain if kernel == "verify" else flash_decode.flash_decode_plain)(
            q, k, v, lengths, layer=0, **extra, **kw)
    tol = 3 if kernel == "prefill" else 2
    assert _ulps(run(**kw), plain) <= tol
    dropped = {**kw, **({"softcap": None} if drop == "softcap" else {"sinks": 0})}
    assert _ulps(run(**dropped), plain) > 10 * tol


def test_variant_families_generate_on_the_kernels(cuda):
    """Narrow Gemma-2 (softcaps, alternating windows, post-norms, D 256)
    and Mistral (window + sinks) models: greedy generate on the card
    launches the windowed kernels, and the engines agree with it."""
    for cfg in (ModelConfig.gemma2_9b(vocab_size=512, hidden_size=256, intermediate_size=512,
                                      num_layers=4, max_seq_len=512, sliding_window=64),
                ModelConfig.mistral_7b(vocab_size=512, hidden_size=256, intermediate_size=512,
                                       num_layers=2, num_q_heads=4, num_kv_heads=2, max_seq_len=512,
                                       sliding_window=64, attention_sinks=4, num_splits=1)):
        params = llama.init_params(cfg, _gen(cuda), device=cuda)
        prompts = torch.randint(0, cfg.vocab_size, (2, 200), generator=_gen(cuda), device=cuda,
                                dtype=torch.int32)
        before = flash_decode.flash_decode.launches_banded
        toks = llama.generate(params, cfg, prompts, torch.tensor([200, 150], device=cuda), 6, device=cuda)
        assert flash_decode.flash_decode.launches_banded - before == 5 * sum(
            llama._layer_window(cfg, i) < cfg.max_seq_len for i in range(cfg.num_layers))
        eng = PagedEngine(params, cfg, num_slots=2, steps_per_round=2, page_size=16, device=cuda)
        got = eng.generate([prompts[0].tolist(), prompts[1, :150].tolist()], max_new_tokens=6)
        assert all(0 <= t < cfg.vocab_size for row in got for t in row)
        assert toks.shape == (2, 6)


# ------------------------------------------------- training with the attention variants


def _variant_train_inputs(cuda, hq, hkv, d, cap, sq=200, skv=512, scale=1.0):
    """Two sequences: a whole one at offset 0 (190 valid rows, then 10
    padded queries) and a chunk at offset 300 of a 500-row sequence, whose
    band leaves whole 64-row tiles below it: bands, sinks and skipped tiles
    in both kernels."""
    gen = _gen(cuda)
    q = (torch.randn((2, hq, sq, d), generator=gen, device=cuda) * scale).to(torch.bfloat16)
    do = torch.randn((2, hq, sq, d), generator=gen, device=cuda, dtype=torch.bfloat16)
    k, v = (torch.randn((2, hkv, skv, d), generator=gen, device=cuda, dtype=torch.bfloat16) for _ in range(2))
    q_off = torch.tensor([0, 300], dtype=torch.int32, device=cuda)
    lengths = torch.tensor([190, 500], dtype=torch.int32, device=cuda)
    sm = d**-0.5 * (1.5 if cap is not None else 1.0)
    return q, k, v, do, lengths, q_off, sm


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("hq,hkv,d", [(8, 2, 128), (8, 4, 256), (4, 4, 256), (16, 2, 64), (8, 1, 128),
                                      (4, 4, 64), (16, 2, 256)])
def test_flash_prefill_lse_variants_match_plain(cuda, variant, hq, hkv, d):
    """K5 with the LSE and the variants: the output within 2e-2 (P rounded
    to bf16 for PV) and bit for bit the call without the LSE; the LSE of the
    capped, banded scores within 1e-4 (fp32 sums in another order, tanhf /
    exp2f / log2f against torch's), 3e38 exactly on rows with nothing in
    band; two runs give the same bytes."""
    w, sk, cap = variant
    q, k, v, _, lengths, q_off, sm = _variant_train_inputs(cuda, hq, hkv, d, cap)
    kw = dict(q_offsets=q_off, sm_scale=sm, window=w, sinks=sk, softcap=cap)
    out, lse = flash_prefill.flash_prefill(q, k, v, lengths, return_lse=True, **kw)
    ref, lse_ref = flash_prefill.flash_prefill_plain(q, k, v, lengths, return_lse=True, **kw)
    assert torch.equal(out, flash_prefill.flash_prefill(q, k, v, lengths, **kw))
    valid = (q_off[:, None] + torch.arange(q.shape[2], device=cuda)[None, :]) < lengths[:, None]
    assert _max_err(out[valid[:, None].expand(-1, hq, -1)], ref[valid[:, None].expand(-1, hq, -1)]) <= 2e-2
    empty = lse_ref > 1e38
    assert bool((lse[empty] == 3e38).all()) and not bool(empty[valid[:, None].expand(-1, hq, -1)].any())
    assert _max_err(lse[~empty], lse_ref[~empty]) <= 1e-4
    again = flash_prefill.flash_prefill(q, k, v, lengths, return_lse=True, **kw)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("hq,hkv,d", [(8, 2, 128), (8, 4, 256), (4, 4, 256), (16, 2, 64), (8, 1, 128),
                                      (4, 4, 64), (16, 2, 256)])
def test_flash_bwd_variant_kernels_match_plain(cuda, variant, hq, hkv, d):
    """K12 with the variants against its plain version on the same o, lse
    and do: 2e-2 of each gradient's peak (P and dS rounded to bf16 before
    their products); one launch of each kernel; two runs give the same
    bytes; and K/V rows below every q row's band (sinks spared) set to NaN
    change no bit of dq and no bit of dk / dv outside those rows."""
    w, sk, cap = variant
    q, k, v, do, lengths, q_off, sm = _variant_train_inputs(cuda, hq, hkv, d, cap)
    kw = dict(q_offsets=q_off, sm_scale=sm, window=w, sinks=sk, softcap=cap)
    o, lse = flash_prefill.flash_prefill(q, k, v, lengths, return_lse=True, **kw)
    before = (flash_bwd.flash_bwd_dq.launches, flash_bwd.flash_bwd_dkdv.launches)
    got = flash_bwd.flash_prefill_bwd(q, k, v, o, lse, do, lengths, **kw)
    assert (flash_bwd.flash_bwd_dq.launches, flash_bwd.flash_bwd_dkdv.launches) == (before[0] + 1,
                                                                                    before[1] + 1)
    ref = flash_bwd.flash_prefill_bwd_plain(q, k, v, o, lse, do, lengths, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert _rel_peak(a, b) <= 2e-2, (name, _rel_peak(a, b))
    again = flash_bwd.flash_prefill_bwd(q, k, v, o, lse, do, lengths, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if w is not None:
        starts = q_off - w + 1  # each sequence's lowest band start
        kp, vp = (_poison_below(x[None], starts, sk)[0] for x in (k, v))
        poisoned = torch.isnan(kp[:, 0, :, 0])  # (B, Skv)
        assert bool(poisoned.any())
        dq, dk, dv = flash_bwd.flash_prefill_bwd(q, kp, vp, o, lse, do, lengths, **kw)
        assert torch.equal(dq, got[0])
        keep = ~poisoned[:, None, :, None].expand_as(dk)
        assert torch.equal(dk[keep], got[1][keep]) and torch.equal(dv[keep], got[2][keep])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_flash_bwd_head_dim_256_matches_plain(cuda, g, causal):
    """K12 at head_dim 256 without options (Gemma-7B's G 1, Gemma-2's 2,
    and 8) on the ragged inputs of the D 64 / 128 test: 2e-2 of each peak,
    0 on the zero-length sequence, the same bytes twice."""
    q, k, v, do, lengths, q_off = _train_inputs(cuda, g, 256)
    kw = dict(causal=causal, q_offsets=q_off)
    o, lse = flash_prefill.flash_prefill(q, k, v, lengths, return_lse=True, **kw)
    got = flash_bwd.flash_prefill_bwd(q, k, v, o, lse, do, lengths, **kw)
    ref = flash_bwd.flash_prefill_bwd_plain(q, k, v, o, lse, do, lengths, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert _rel_peak(a, b) <= 2e-2, (name, _rel_peak(a, b))
    assert float(got[0][2].abs().max()) == 0.0
    assert all(torch.equal(a, b) for a, b in zip(got, flash_bwd.flash_prefill_bwd(q, k, v, o, lse, do,
                                                                                   lengths, **kw)))


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_bwd_dkdv_split_walk_matches_plain(cuda, d, split):
    """K12's dk/dv with each KV tile's q walk cut into pieces across blocks
    (one KV head of 8 query heads at S 1500: a few long walks, which the
    plan splits, summed in piece order by a second pass) and with every
    walk in one block (B 4, 16 KV heads of 1 at S 600: enough blocks to
    balance unsplit, bf16 written directly): 2e-2 of each peak against the
    twin, the same bytes on two runs, and the split counted on the wrapper."""
    b, hkv, g, s = (1, 1, 8, 1500) if split else (4, 16, 1, 600)
    gen = _gen(cuda)
    q, do = (torch.randn((b, hkv * g, s, d), generator=gen, device=cuda, dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((b, hkv, s, d), generator=gen, device=cuda, dtype=torch.bfloat16) for _ in range(2))
    lengths = torch.full((b,), s - 37, dtype=torch.int32, device=cuda)
    bkv, bq, _ = flash_bwd.dkdv_geometry(d)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    chunk, splits = flash_bwd.dkdv_split_plan(b, hkv, g, s, s, True, None, 0, sms, bkv, bq)
    assert (splits > 1) == split
    o, lse = flash_prefill.flash_prefill(q, k, v, lengths, return_lse=True)
    delta = flash_bwd.bwd_delta(o, do)
    before = flash_bwd.flash_bwd_dkdv.launches_split
    got = flash_bwd.flash_bwd_dkdv(q, k, v, lse, do, delta, lengths)
    assert flash_bwd.flash_bwd_dkdv.launches_split - before == int(split)
    ref = flash_bwd.flash_bwd_dkdv_plain(q, k, v, lse, do, delta, lengths)
    for name, a, r in zip(("dk", "dv"), got, ref):
        assert _rel_peak(a, r) <= 2e-2, (name, _rel_peak(a, r))
    again = flash_bwd.flash_bwd_dkdv(q, k, v, lse, do, delta, lengths)
    assert all(torch.equal(a, r) for a, r in zip(got, again))
    if split:  # the same walks in one block each: the twin's tolerance, and a plan too short is refused
        full = flash_bwd.dkdv_longest_walk(q, k)
        whole = flash_bwd.flash_bwd_dkdv_split(q, k, v, lse, do, delta, lengths, plan=(full, 1))
        for name, a, r in zip(("dk", "dv"), whole, ref):
            assert _rel_peak(a, r) <= 2e-2, (name, _rel_peak(a, r))
        with pytest.raises(ValueError, match="does not cover"):
            flash_bwd.flash_bwd_dkdv_split(q, k, v, lse, do, delta, lengths, plan=(chunk, 1))


@pytest.mark.parametrize("case", ["band_past_length", "q_offset_before_tile"])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_bwd_dkdv_steps_no_row_group_takes(cuda, d, case):
    """Walks that hold a step no row group of the block takes, so that no
    warp needs that ring stage's data: a window of 70 with the length 20
    rows into the KV tile at row 128 (the walk reaches the q tile at 256
    by the tile's last row, the rows below the length stop at 228), and a
    q offset of 40 with Sq 80 (the KV tile at 128 walks q tile 1, whose
    last position is 119). Every thread still waits on each stage before
    it is refilled: dk / dv within 2e-2 of each peak, the same bytes on
    two runs, as many times as it takes a race to show."""
    gen = _gen(cuda)
    hq, hkv = 8, 2
    if case == "band_past_length":
        sq = skv = 512
        q_off, lengths, kw = [0], [148], dict(window=70)
    else:
        sq, skv = 80, 300
        q_off, lengths, kw = [40], [300], {}
    q, do = (torch.randn((1, hq, sq, d), generator=gen, device=cuda, dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((1, hkv, skv, d), generator=gen, device=cuda, dtype=torch.bfloat16) for _ in range(2))
    q_off = torch.tensor(q_off, dtype=torch.int32, device=cuda)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    kw = dict(q_offsets=q_off, **kw)
    o, lse = flash_prefill.flash_prefill(q, k, v, lengths, return_lse=True, **kw)
    delta = flash_bwd.bwd_delta(o, do)
    ref = flash_bwd.flash_bwd_dkdv_plain(q, k, v, lse, do, delta, lengths, **kw)
    got = flash_bwd.flash_bwd_dkdv(q, k, v, lse, do, delta, lengths, **kw)
    for name, a, r in zip(("dk", "dv"), got, ref):
        assert _rel_peak(a, r) <= 2e-2, (name, _rel_peak(a, r))
    for _ in range(20):
        again = flash_bwd.flash_bwd_dkdv(q, k, v, lse, do, delta, lengths, **kw)
        assert all(torch.equal(a, r) for a, r in zip(got, again))


@pytest.mark.parametrize("sinks", [20, 40, 70])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_band_after_sink_tiles_mid_ring(cuda, d, sinks):
    """A q chunk far past its sinks: K5 stages 1-3 sink tiles, then jumps to
    the band, whose first tile lands in another slot of the K/V ring (K5's
    ring has 2 stages of 64 rows at D 64, 3 of 32 at D 128, 2 of 32 at D
    256). K5 (with and without the LSE), dq and dk/dv against the twins;
    K/V rows below the band that are not sinks hold NaN and change no bit
    of the output, the LSE, dq, or dk / dv outside those rows."""
    gen = _gen(cuda)
    hq, hkv, sq, skv, w = 8, 2, 150, 800, 100
    q, do = (torch.randn((1, hq, sq, d), generator=gen, device=cuda, dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((1, hkv, skv, d), generator=gen, device=cuda, dtype=torch.bfloat16) for _ in range(2))
    q_off = torch.tensor([600], dtype=torch.int32, device=cuda)
    lengths = torch.tensor([750], dtype=torch.int32, device=cuda)
    kw = dict(q_offsets=q_off, window=w, sinks=sinks)
    out, lse = flash_prefill.flash_prefill(q, k, v, lengths, return_lse=True, **kw)
    ref, lse_ref = flash_prefill.flash_prefill_plain(q, k, v, lengths, return_lse=True, **kw)
    assert torch.equal(out, flash_prefill.flash_prefill(q, k, v, lengths, **kw))
    assert _max_err(out, ref) <= 2e-2 and _max_err(lse, lse_ref) <= 1e-4
    got = flash_bwd.flash_prefill_bwd(q, k, v, out, lse, do, lengths, **kw)
    want = flash_bwd.flash_prefill_bwd_plain(q, k, v, out, lse, do, lengths, **kw)
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        assert _rel_peak(a, r) <= 2e-2, (name, _rel_peak(a, r))
    below = torch.zeros(skv, dtype=torch.bool, device=cuda)
    below[sinks:600 - w + 1] = True  # below the first row's band, not a sink
    kp, vp = k.clone(), v.clone()
    kp[:, :, below], vp[:, :, below] = float("nan"), float("nan")
    out_p, lse_p = flash_prefill.flash_prefill(q, kp, vp, lengths, return_lse=True, **kw)
    assert torch.equal(out_p, out) and torch.equal(lse_p, lse)
    dq, dk, dv = flash_bwd.flash_prefill_bwd(q, kp, vp, out, lse, do, lengths, **kw)
    assert torch.equal(dq, got[0])
    assert torch.equal(dk[:, :, ~below], got[1][:, :, ~below]) and torch.equal(dv[:, :, ~below], got[2][:, :, ~below])


@pytest.mark.parametrize("drop", ["softcap", "sinks", "window"])
def test_flash_attention_gradients_see_each_option(cuda, drop):
    """Gradients through ``flash_attention`` (K5 with the LSE, K12) with a
    window of 64, 4 sinks and a softcap of 50 at D 256 agree with autograd
    through the plain forward within 2e-2 of each peak; the same kernels
    run without one option lie over 5x that far (for the cap, q is scaled
    so that the scores reach several times the cap)."""
    q, k, v, do, lengths, q_off, _ = _variant_train_inputs(cuda, 8, 4, 256, None,
                                                           scale=40.0 if drop == "softcap" else 1.0)
    kw = dict(q_offsets=q_off, sm_scale=1 / 16, window=64, sinks=4, softcap=50.0)
    rowmask = ((q_off[:, None] + torch.arange(q.shape[2], device=cuda)[None, :]) < lengths[:, None])[:, None, :, None]

    def grads(fn, **opts):
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out = fn(*leaves, lengths, **opts)
        return torch.autograd.grad((torch.where(rowmask, out, 0.0).float() * do.float()).sum(), leaves)

    ref = grads(flash_prefill.flash_prefill_plain, **kw)
    worst = max(_rel_peak(a, b) for a, b in zip(grads(flash_bwd.flash_attention, **kw), ref))
    assert worst <= 2e-2
    dropped = {**kw, **{"softcap": {"softcap": None}, "sinks": {"sinks": 0},
                        "window": {"window": None, "sinks": 0}}[drop]}
    assert max(_rel_peak(a, b) for a, b in zip(grads(flash_bwd.flash_attention, **dropped), ref)) > 0.1


def test_variant_training_steps_run_on_the_kernels(cuda):
    """Narrow Gemma-2 (D 256, softcaps, alternating windows, post-norms,
    GeGLU), Mistral with sinks and Gemma (G 1): each layer's flash path
    against its plain path within 5e-2 of each gradient's peak, and three
    SGD steps (lr 0.2) whose loss falls, each launching K5 with the LSE 2 L
    times and K12's dq L times."""
    cfgs = (ModelConfig.gemma2_9b(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
                                  max_seq_len=256, sliding_window=64, dtype="bfloat16"),
            ModelConfig.mistral_7b(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
                                   num_q_heads=4, num_kv_heads=2, max_seq_len=256, sliding_window=64,
                                   attention_sinks=4, dtype="bfloat16"),
            ModelConfig.gemma_7b(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
                                 num_q_heads=2, num_kv_heads=2, max_seq_len=256, dtype="bfloat16"))
    for cfg in cfgs:
        params = llama.init_params(cfg, _gen(cuda), device=cuda)
        cos, sin = llama.rope_tables(cfg, device=cuda)
        batch = torch.randint(0, cfg.vocab_size, (2, 201), generator=_gen(cuda), device=cuda)
        _, g_kernels = train.loss_and_grads(params, batch, cfg, cos, sin, use_flash=True)
        _, g_plain = train.loss_and_grads(params, batch, cfg, cos, sin, use_flash=False)
        for a, b in zip(train.tree_leaves(g_kernels), train.tree_leaves(g_plain)):
            assert _rel_peak(a, b) <= 5e-2
        momentum = train.tree_map(torch.zeros_like, params)
        losses = []
        for _ in range(3):
            before = (flash_prefill.flash_prefill.launches_lse, flash_bwd.flash_bwd_dq.launches)
            params, momentum, loss = train.train_step(params, momentum, batch, cfg, cos, sin, 0.2)
            n = cfg.num_layers
            assert (flash_prefill.flash_prefill.launches_lse - before[0],
                    flash_bwd.flash_bwd_dq.launches - before[1]) == (2 * n, n)
            losses.append(float(loss))
        assert all(torch.isfinite(torch.tensor(losses))) and losses[-1] < losses[0], (cfg, losses)


# ----------------------------------------------------------------- MLA's latent row, MoE


@pytest.mark.parametrize("hq", [4, 16])
@pytest.mark.parametrize("mode", ["decode", "paged", "partials"])
def test_latent_decode_kernels_match_plain(cuda, mode, hq):
    """K1, K7 and K2 (4 splits) at MLA's latent row (D 640, one KV head; 16
    query heads fill the kernel's m16 tile, DeepSeek-style tests run 4) on
    the D 640 grid's 128-row chunks: lengths 0, 1, 127, 128, 129 and the
    full table, pages shuffled. The merged output within one bf16 rounding
    of each element on either side (2 ulps) and 4 bf16 ulps of |o| <= 4 of
    the twin; a row of length 0 gives 0; K2's partials within 1e-4 of the
    twin's (fp32 sums in another order), l = 0 where a split holds no row;
    the arrival counters end at 0."""
    gen = _gen(cuda)
    lens = (0, 1, 127, 128, 129, 384)
    b, s, d, ps = len(lens), 384, 640, 128
    assert flash_decode.split_chunking(s, b, 1, flash_decode.sm_count(cuda), d)[0] == 128
    q = torch.randn((b, hq, d), generator=gen, device=cuda, dtype=torch.bfloat16)
    k = torch.randn((1, b, 1, s, d), generator=gen, device=cuda, dtype=torch.bfloat16)
    v = torch.randn_like(k)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    kw = dict(layer=0, sm_scale=192.0**-0.5)
    if mode == "paged":
        pps = s // ps
        table = (torch.randperm(b * pps, generator=torch.Generator().manual_seed(0)) + 1).reshape(b, pps)
        table = table.to(device=cuda, dtype=torch.int32)
        pools = []
        for x in (k, v):
            pool = torch.zeros((1, 1, b * pps + 1, ps, d), dtype=x.dtype, device=cuda)
            pool[0, 0, table.reshape(-1).long()] = x[0, :, 0].reshape(b * pps, ps, d)
            pools.append(pool)
        before = paged_decode.paged_flash_decode.launches
        out = paged_decode.paged_flash_decode(q, *pools, table, lengths, **kw)
        assert paged_decode.paged_flash_decode.launches == before + 1
        ref = paged_decode.paged_flash_decode_plain(q, *pools, table, lengths, **kw)
    else:
        kw["num_splits"] = 1 if mode == "decode" else 4
        before = flash_decode.flash_decode.launches
        out = flash_decode.flash_decode(q, k, v, lengths, **kw)
        assert flash_decode.flash_decode.launches == before + 1
        ref = flash_decode.flash_decode_plain(q, k, v, lengths, **kw)
    assert _max_err(out, ref) <= 4 * BF16_ULP
    assert _ulps(out, ref) <= 2
    assert torch.all(out[0] == 0)
    if mode == "partials":
        o, m, l = flash_decode.flash_decode_with_stats(q, k, v, lengths, **kw)
        o_r, m_r, l_r = flash_decode.flash_decode_with_stats_plain(q, k, v, lengths, **kw)
        live = m_r > -1e30
        assert torch.equal(live, m > -1e30)
        assert (m - m_r)[live].abs().max().item() <= 1e-4
        assert ((l - l_r) / l_r.clamp(min=1))[live].abs().max().item() <= 1e-4
        assert ((o - o_r) / l_r.clamp(min=1)[..., None])[live].abs().max().item() <= 1e-4
        assert torch.all(l[~live] == 0) and torch.all(o[~live] == 0)
    assert _arrivals_at_rest()


@pytest.mark.parametrize("hq", [2, 4, 6, 16, 128])
def test_latent_prefill_kernel_matches_plain(cuda, hq):
    """K5's D 640 form, causal: lengths that are no tile multiple, q offsets
    and a zero-length sequence; 2e-2 absolute on the valid rows (the kernel
    rounds P to bf16), 0 for the empty sequence. G 6 leaves 2 of a tile's
    128 rows idle; G 128 is one position a tile."""
    gen = _gen(cuda)
    d = 640
    q = torch.randn((3, hq, 70, d), generator=gen, device=cuda, dtype=torch.bfloat16)
    k = torch.randn((3, 1, 200, d), generator=gen, device=cuda, dtype=torch.bfloat16)
    v = torch.randn_like(k)
    q_off = torch.tensor([0, 120, 0], dtype=torch.int32, device=cuda)
    lengths = torch.tensor([61, 190, 0], dtype=torch.int32, device=cuda)
    out = flash_prefill.flash_prefill(q, k, v, lengths, q_offsets=q_off, sm_scale=192.0**-0.5)
    ref = flash_prefill.flash_prefill_plain(q, k, v, lengths, q_offsets=q_off, sm_scale=192.0**-0.5)
    assert _max_err(out[0, :, :61], ref[0, :, :61]) <= 2e-2
    assert _max_err(out[1], ref[1]) <= 2e-2
    assert torch.all(out[2] == 0)


def test_latent_forms_the_kernels_refuse(cuda):
    """D 640 takes bf16 q and KV, at most 16 query heads a KV head, no
    variant, no verify span and no LSE, at any number of splits; the others
    raise before a launch."""
    q = torch.randn((1, 16, 640), generator=_gen(cuda), device=cuda, dtype=torch.bfloat16)
    k = torch.randn((1, 1, 1, 64, 640), generator=_gen(cuda), device=cuda, dtype=torch.bfloat16)
    lengths = torch.tensor([3], dtype=torch.int32, device=cuda)
    out = flash_decode.flash_decode(q, k, k, lengths, layer=0, num_splits=2, block_k=32)
    ref = flash_decode.flash_decode_plain(q, k, k, lengths, layer=0, num_splits=2, block_k=32)
    assert _max_err(out, ref) <= 4 * BF16_ULP
    with pytest.raises(ValueError, match="640"):
        flash_decode.flash_verify(q[:, :, None].expand(1, 16, 3, 640).contiguous(), k, k, lengths, layer=0)
    with pytest.raises(ValueError, match="640"):
        flash_decode.flash_decode(q, k, k, lengths, layer=0, num_splits=1, window=16)
    with pytest.raises(ValueError, match="640"):
        flash_decode.flash_decode(q.float(), k.float(), k.float(), lengths, layer=0, num_splits=1)
    with pytest.raises(ValueError, match="at most 16"):
        flash_decode.flash_decode(q.repeat(1, 2, 1), k, k, lengths, layer=0, num_splits=1)
    with pytest.raises(ValueError, match="640"):
        flash_prefill.flash_prefill(q[:, :, None], k[0], k[0], lengths, return_lse=True)


def test_deepseek_style_model_runs_on_the_kernels(cuda):
    """A narrow MLA + DeepSeek-MoE model at the card's latent row (kv_lora_rank
    512 + rope 64: 640 lanes) with int4 experts: generate, Engine and
    PagedEngine launch K5, K1 / K7 and K6 as counted, and their greedy
    streams agree with generate's or lie on near-ties (the engines' prefills
    run other row counts)."""
    cfg = ModelConfig.deepseek_v2_lite(vocab_size=512, hidden_size=256, num_layers=3, num_q_heads=4,
                                       intermediate_size=128, num_experts=8, dense_inter_size=256,
                                       max_seq_len=256)
    params = llama.quantize_model_weights(llama.init_params(cfg, _gen(cuda), quantize="int4", device=cuda),
                                          "int4")
    prompts = [[int(t) for t in torch.randint(0, 512, (n,), generator=torch.Generator().manual_seed(n))]
               for n in (70, 33, 5)]
    width = max(map(len, prompts))
    padded = torch.tensor([p + [0] * (width - len(p)) for p in prompts], dtype=torch.int32, device=cuda)
    lengths = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=cuda)
    counters = (flash_prefill.flash_prefill, flash_decode.flash_decode, quant_matmul.quant_matmul_int4,
                paged_decode.paged_flash_decode)
    before = [fn.launches for fn in counters]
    toks = llama.generate(params, cfg, padded, lengths, 4, device=cuda)
    n, per_step = cfg.num_layers, cfg.num_layers + 2 * cfg.num_experts * (cfg.num_layers - cfg.first_k_dense)
    assert [fn.launches - b for fn, b in zip(counters, before)] == [n, 3 * n, 4 * per_step, 0]
    for make in (lambda: Engine(params, cfg, num_slots=2, steps_per_round=2, device=cuda),
                 lambda: PagedEngine(params, cfg, num_slots=2, steps_per_round=2, page_size=64, device=cuda)):
        got = make().generate(prompts, max_new_tokens=4)
        assert all(len(g) == 4 and all(0 <= t < cfg.vocab_size for t in g) for g in got)
    assert paged_decode.paged_flash_decode.launches > before[3]
    assert toks.shape == (3, 4)


@pytest.mark.parametrize("kv_offset", [0, 64, 128])
def test_kv_offset_kernels_match_plain(cuda, kv_offset):
    """K5 with the LSE and K12 with ``kv_offset`` (window 96, 80 sinks: the
    chunk at 64 keeps 16 sinks, the one at 128 none) against their plain
    versions: the output and the gradients within 2e-2 of each peak (P and
    dS rounded to bf16 in the kernels), the LSE within 1e-4. Sequence 1's
    KV chunk lies wholly in its rows' future (q_offsets -64) and sequence 2
    has length 0: both give 0, the LSE 3e38 and zero gradients, exactly."""
    gen = _gen(cuda)
    q, do = (torch.randn((3, 8, 64, 64), generator=gen, device=cuda, dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((3, 2, 64, 64), generator=gen, device=cuda, dtype=torch.bfloat16) for _ in range(2))
    lengths = torch.tensor([64, 64, 0], dtype=torch.int32, device=cuda)
    q_off = torch.tensor([64, -64, 64], dtype=torch.int32, device=cuda)
    kw = dict(q_offsets=q_off, window=96, sinks=80, kv_offset=kv_offset)
    o, lse = flash_prefill.flash_prefill(q, k, v, lengths, return_lse=True, **kw)
    o_ref, lse_ref = flash_prefill.flash_prefill_plain(q, k, v, lengths, return_lse=True, **kw)
    assert _rel_peak(o, o_ref) <= 2e-2
    assert _max_err(lse[0], lse_ref[0]) <= 1e-4
    assert bool((o[1:] == 0).all()) and bool((lse[1:] == 3e38).all())
    got = flash_bwd.flash_prefill_bwd(q, k, v, o, lse, do, lengths, q_off, window=96, sinks=80,
                                      kv_offset=kv_offset)
    ref = flash_bwd.flash_prefill_bwd_plain(q, k, v, o, lse, do, lengths, q_off, window=96, sinks=80,
                                            kv_offset=kv_offset)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert _rel_peak(a, b) <= 2e-2, (name, _rel_peak(a, b))
        assert bool((a[1:] == 0).all()), name

#!/usr/bin/env python3
"""Hold an edit of the verify launch to another commit's bits on the card.

The verify launch is ``ops/flash_decode.flash_verify_append``: K1's verify
mode with the block append (K9) folded in. ``dump`` runs it on seeded
inputs at the forms phase 2 of ``chip_smoke.py`` checks (S 512, T 5, Hq 8,
Hkv 2; D 64, 128 and 256; fp32 and bf16 q on a cache in q's dtype, int8
and fp8; plain and with a window of 64, 4 sinks and a softcap of 30; spans
across tile and chunk edges, clamped past S, partial and inactive) and
saves every output. ``compare`` holds two dumps to each other token by
token: every token that attends at most S rows must keep its bits; tokens
past S are counted apart. Run ``dump`` from the root of each checkout (the
library builds from that checkout's sources), then ``compare``::

    python3 tools/verify_bits.py dump build/new.pt
    python3 tools/verify_bits.py compare build/old.pt build/new.pt
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

S, T, HQ, HKV, LAYER = 512, 5, 8, 2, 1
ROWS = ((30, 5), (126, 5), (0, 5), (S - 2, 5), (S, 5), (200, 3), (40, 0))  # (first write position, rows)
VARIANTS = dict(window=64, sinks=4, softcap=30.0)
KV_SCALE = {"int8": 5.0 / 127.0, "fp8": 5.0 / 448.0}


def _resources() -> None:
    """Build this checkout's decode source and print each kernel form's
    registers and spill stores, as ``ptxas -v`` reports them."""
    from starflashattention_tpu_torch.ops import _build

    log = _build.build(["flash_decode_split"]).get("flash_decode_split", {}).get("ptxas", "")
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), 0
            if shutil.which("c++filt"):
                name = subprocess.run(["c++filt", name], capture_output=True, text=True).stdout.strip()
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            print(f"verify_bits: {name}: {m.group(1)} registers, spill stores {spill} bytes")
            name = None


def dump(out_path: str) -> None:
    sys.path.insert(0, str(Path.cwd()))
    from starflashattention_tpu_torch.core.quant import quantize_value
    from starflashattention_tpu_torch.ops.flash_decode import flash_verify_append

    _resources()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    pos = torch.tensor([p for p, _ in ROWS], dtype=torch.int32, device=dev)
    n_valid = torch.tensor([n for _, n in ROWS], dtype=torch.int32, device=dev)
    b, out = len(ROWS), {}
    for d in (64, 128, 256):
        for q_dtype, mode in ((torch.float32, None), (torch.bfloat16, None), (torch.float32, "int8"),
                              (torch.bfloat16, "int8"), (torch.float32, "fp8"), (torch.bfloat16, "fp8")):
            q = torch.randn((b, HQ, T, d), generator=gen, device=dev, dtype=q_dtype)
            rows = [torch.randn(shape, generator=gen, device=dev, dtype=q_dtype)
                    for shape in ((2, b, HKV, S, d),) * 2 + ((b, HKV, T, d),) * 2]
            sc = {}
            if mode is not None:
                scales = torch.full((HKV,), KV_SCALE[mode], device=dev)
                rows = [quantize_value(x, scales, mode, head_axis=2 if x.dim() == 5 else 1) for x in rows]
                sc = dict(k_scales=scales, v_scales=scales)
            k, v, kn, vn = rows
            for label, opts in (("plain", {}), ("variants", VARIANTS)):
                o = flash_verify_append(q, k.clone(), v.clone(), kn, vn, pos, n_valid, pos + 1, layer=LAYER,
                                        **sc, **opts)
                out[f"D={d} q={str(q_dtype)[6:]} KV={mode or str(q_dtype)[6:]} {label}"] = o.cpu()
    torch.cuda.synchronize()
    torch.save({"rows": ROWS, "outputs": out}, out_path)
    print(f"verify_bits: {len(out)} forms written to {out_path} ({torch.cuda.get_device_name(0)})")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view({2: torch.int16, 4: torch.int32}[t.element_size()])


def compare(a_path: str, b_path: str) -> int:
    a, b = (torch.load(p, weights_only=True) for p in (a_path, b_path))
    if a["rows"] != b["rows"] or sorted(a["outputs"]) != sorted(b["outputs"]):
        print("verify_bits: the dumps hold different forms")
        return 1
    inside = [(i, j) for i, (p, _) in enumerate(a["rows"]) for j in range(T) if p + 1 + j <= S]
    past = [(i, j) for i, (p, _) in enumerate(a["rows"]) for j in range(T) if p + 1 + j > S]
    worst = 0
    for name in sorted(a["outputs"]):
        x, y = _bits(a["outputs"][name]), _bits(b["outputs"][name])
        same = {key: sum(bool(torch.equal(x[i, :, j], y[i, :, j])) for i, j in cells)
                for key, cells in (("inside", inside), ("past", past))}
        worst = max(worst, len(inside) - same["inside"])
        print(f"verify_bits: {name}: tokens within S {same['inside']}/{len(inside)} the same bits, "
              f"past S {same['past']}/{len(past)}")
    print(f"verify_bits: {'every token within S keeps its bits' if worst == 0 else 'tokens within S differ'}")
    return int(worst > 0)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "dump":
        dump(sys.argv[2])
    elif len(sys.argv) == 4 and sys.argv[1] == "compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    else:
        sys.exit(__doc__)

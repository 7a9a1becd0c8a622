"""One rank of the port's parallel tests: a world of processes on the CPU
over gloo, spawned by ``tests/test_torch_ring.py`` and
``tests/test_torch_parallel.py`` (one world per file, through
:func:`run_world`).

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
}
TRAIN_CASES = {  # name: (config, mesh axes, step keyword arguments)
    "cp": ("tiny", {"seq": 4}, dict()),
    "cp_dp": ("tiny", {"data": 2, "seq": 2}, dict(data_axis="data")),
    "cp_accum": ("tiny", {"seq": 4}, dict(grad_accum=2)),
    "window": ("window", {"seq": 4}, dict()),
    "sinks": ("sinks", {"seq": 4}, dict()),
    "gemma2": ("gemma2", {"seq": 4}, dict()),
}
LR = 1e-2


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


SUITES = {"ring": _ring_suite, "parallel": _parallel_suite}


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

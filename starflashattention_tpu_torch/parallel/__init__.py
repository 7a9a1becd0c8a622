"""Multi-GPU parallelism over ``torch.distributed`` — twin of the JAX
``parallel`` package, its sequence-parallel half.

Ported: process meshes (``mesh``), the collectives the JAX code gets from
``jax.lax`` (``comm``), ring attention forward and backward with the zigzag
layout (``ring``), Ulysses (``ulysses``), the sequence-sharded split-KV
decode (``distributed_decode``) and context-parallel (× data-parallel)
training (``train``). The tensor-parallel and pipeline halves
(``parallel/tp.py``, ``parallel/pp.py`` and the training steps built on
them) are not ported: their entry points below raise
``NotImplementedError`` (ROADMAP Queue 1 item 16, the tensor-parallel
half).
"""

from starflashattention_tpu_torch.parallel.distributed_decode import (  # noqa: F401
    make_seq_sharded_decode,
    merge_partials_across_chips,
)
from starflashattention_tpu_torch.parallel.mesh import init_distributed, make_mesh  # noqa: F401
from starflashattention_tpu_torch.parallel.ring import make_ring_prefill, ring_attention  # noqa: F401
from starflashattention_tpu_torch.parallel.train import (  # noqa: F401
    init_opt_state,
    make_cp_train_step,
    make_tp_cp_train_step,
    make_tp_dp_train_step,
    make_tp_dp_value_and_grad,
)
from starflashattention_tpu_torch.parallel.ulysses import make_ulysses_prefill, ulysses_attention  # noqa: F401


def _not_ported(name: str, module: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(f"{name} needs parallel/{module}.py, which is not ported yet (ROADMAP "
                                  "Queue 1 item 16, the tensor-parallel half)")

    fn.__name__ = name
    return fn


make_tp_decode_multi = _not_ported("make_tp_decode_multi", "tp")
make_tp_decode_step = _not_ported("make_tp_decode_step", "tp")
make_tp_prefill = _not_ported("make_tp_prefill", "tp")
make_tp_prefill_serving = _not_ported("make_tp_prefill_serving", "tp")
shard_cache = _not_ported("shard_cache", "tp")
shard_params = _not_ported("shard_params", "tp")
make_pp_decode_step = _not_ported("make_pp_decode_step", "pp")
shard_cache_pp = _not_ported("shard_cache_pp", "pp")
shard_params_pp = _not_ported("shard_params_pp", "pp")

"""Multi-GPU parallelism over ``torch.distributed`` — twin of the JAX
``parallel`` package.

One process a rank (SPMD): process meshes (``mesh``), the collectives the
JAX code gets from ``jax.lax`` (``comm``), tensor + data parallel serving
steps and the sharding of params and caches (``tp``), pipeline-parallel
decode (``pp``), ring attention forward and backward with the zigzag
layout (``ring``), Ulysses (``ulysses``), the sequence-sharded split-KV
decode (``distributed_decode``) and sharded training: context parallel,
TP x DP and TP x CP (``train``). Each rank passes its own shard; see the
modules' docs.
"""

from starflashattention_tpu_torch.parallel.distributed_decode import (  # noqa: F401
    make_seq_sharded_decode,
    merge_partials_across_chips,
)
from starflashattention_tpu_torch.parallel.mesh import init_distributed, make_mesh  # noqa: F401
from starflashattention_tpu_torch.parallel.pp import (  # noqa: F401
    make_pp_decode_step,
    pp_param_specs,
    shard_cache_pp,
    shard_params_pp,
)
from starflashattention_tpu_torch.parallel.ring import make_ring_prefill, ring_attention  # noqa: F401
from starflashattention_tpu_torch.parallel.tp import (  # noqa: F401
    make_tp_decode_multi,
    make_tp_decode_step,
    make_tp_prefill,
    make_tp_prefill_serving,
    shard_cache,
    shard_params,
)
from starflashattention_tpu_torch.parallel.train import (  # noqa: F401
    init_opt_state,
    make_cp_train_step,
    make_tp_cp_train_step,
    make_tp_dp_train_step,
    make_tp_dp_value_and_grad,
)
from starflashattention_tpu_torch.parallel.ulysses import make_ulysses_prefill, ulysses_attention  # noqa: F401

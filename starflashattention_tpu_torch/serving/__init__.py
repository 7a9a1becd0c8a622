"""Serving: continuous batching over fixed decode slots — twin of the JAX
``serving`` package. An engine admits requests into a fixed number of batch
slots, prefills their prompts, decodes every active slot each step and
retires finished sequences; the scheduling lives on the host, and each
decode round keeps its tokens on the device until one readback."""

from starflashattention_tpu_torch.core.sampling import GREEDY, SamplingParams  # noqa: F401
from starflashattention_tpu_torch.serving.engine import Engine, EngineStats, PagedEngine  # noqa: F401
from starflashattention_tpu_torch.serving.prefix_cache import PrefixCache  # noqa: F401
from starflashattention_tpu_torch.serving.scheduler import Request, Scheduler  # noqa: F401

"""Models: the Llama-family dense-GQA transformer (``llama``: generate,
prefill, decode and the serving steps), its training path (``train``:
forward, loss, gradients and SGD) and LoRA fine-tuning (``lora``)."""

from starflashattention_tpu_torch.models import llama, lora, train

__all__ = ["llama", "lora", "train"]

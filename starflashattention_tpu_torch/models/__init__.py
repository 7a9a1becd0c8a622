"""Models: the Llama-family dense-GQA transformer (``llama``: generate,
prefill, decode and the serving steps), its training path (``train``:
forward, loss, gradients and SGD), LoRA fine-tuning (``lora``) and
checkpoints (``checkpoint``: HF weights and the native save / restore)."""

from starflashattention_tpu_torch.models import checkpoint, llama, lora, train

__all__ = ["checkpoint", "llama", "lora", "train"]

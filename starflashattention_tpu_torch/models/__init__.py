"""Models: the Llama-family dense-GQA transformer."""

"""KV-cache layouts: the contiguous multi-layer table."""

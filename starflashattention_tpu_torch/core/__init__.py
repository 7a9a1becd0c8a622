"""Numerics spec of the port: plain reference attention, RoPE, quantization."""

"""Configuration and per-layer attention steps."""

"""Quantized model containers and forwards."""

"""Adapters from a configuration ``kind`` to the program, one module a
kind: the benchmark's raw inputs from the seed (``inputs``, ``images``),
the program's model (``build``), its engine (``engine``), its input
quantization (``quantize``) and the state the reference checks
(``state``)."""

"""The repo's measuring tools on the port, one module a tool of the JAX
package's ``tools/`` with the same name: the corpus LM (``lm_corpus``),
speculative decoding (``spec_bench``), int8 KV quality (``kv8_quality``),
LM quality on held-out text (``lm_quality``), the paged engine
(``paged_bench``, ``paged_spec_bench``) and the ResNet family
(``family_bench``).  Each runs as ``python -m
resnet_accel_tpu_torch.tools.<name>``, on the card unless ``--device cpu``
asks for the CPU, and writes JSON only to the file ``--out`` names.
"""

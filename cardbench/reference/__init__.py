"""Plain PyTorch references, one module a configuration ``kind``, each
with a ``Reference(config, inputs, bits=8)`` giving ``logits`` of fp32
images and ``state_checks`` of the program's state.  They import nothing
of the program."""

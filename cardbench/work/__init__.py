"""Operations and bytes of each layer, one module a configuration
``kind``: ``step_layers(config, traffic, ref)`` and ``bound_s``."""

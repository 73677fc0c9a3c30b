"""Runtime: device seam, inference engine, LM serving (the continuous and
the paged-KV batchers), performance metrics.

The names below are loaded from their modules at first use, so that the
models, which import ``runtime.backend``, and ``runtime.engine``, which
imports the models, can each be imported first.
"""

import importlib

_EXPORTS = {
    "resolve_device": "backend",
    "InferenceEngine": "engine",
    "InferenceResult": "engine",
    "StreamResult": "engine",
    "AcceleratorError": "engine",
    "AccelErrorCode": "engine",
    "preprocess_imagenet": "engine",
    "preprocess_mnist": "engine",
    "softmax": "engine",
    "top_k": "engine",
    "PerfMetrics": "perf",
    "PerfTimer": "perf",
    "LayerProfiler": "perf",
    "Platform": "perf",
    "PLATFORMS": "perf",
    "get_platform": "perf",
    "trace_profile": "perf",
    "ContinuousBatcher": "serving",
    "PagedKVBatcher": "paged",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)

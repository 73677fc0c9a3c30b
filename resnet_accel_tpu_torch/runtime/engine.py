"""Inference engine: load a quantized model once, serve batches.

Counterpart of ``resnet_accel_tpu/runtime/engine.py`` (``run_inference``,
``benchmark``, ``stream``, ``get_model_sparsity``, ``preprocess_imagenet``,
``preprocess_mnist``, ``softmax``, ``top_k``) on an explicit PyTorch
device, for the INT8 ResNet family (ResNet-18/34/50/101/152, dense or
block-sparse) and the MNIST CNN.  ``QuantizingLoader`` stands in for the
JAX package's native C++ ``BatchLoader``: it serves int8 batches quantized
on the host, the input ``stream`` takes.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from resnet_accel_tpu_torch.models.mnist_cnn import (MNIST_MEAN, MNIST_STD,
                                                     MNISTCNNInt8,
                                                     MNISTCNNInt8Module)
from resnet_accel_tpu_torch.models.resnet18 import (ResNet18Int8,
                                                    ResNet18Int8Module)
from resnet_accel_tpu_torch.ops.epilogue import quantize_input
from resnet_accel_tpu_torch.runtime.backend import resolve_device

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def preprocess_imagenet(images_u8: np.ndarray) -> np.ndarray:
    """[N, H, W, 3] uint8 -> normalized [N, 3, H, W] float32."""
    x = images_u8.astype(np.float32) / 255.0
    x = (x - IMAGENET_MEAN) / IMAGENET_STD
    return np.ascontiguousarray(x.transpose(0, 3, 1, 2))


def preprocess_mnist(images_u8: np.ndarray) -> np.ndarray:
    """[N, 28, 28] uint8 -> normalized [N, 1, 28, 28] float32."""
    x = images_u8.astype(np.float32) / 255.0
    x = (x - MNIST_MEAN) / MNIST_STD
    return x.reshape(-1, 1, 28, 28)


def softmax(logits: np.ndarray) -> np.ndarray:
    z = logits - logits.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)


def top_k(logits: np.ndarray, k: int = 5) -> List[List[Tuple[int, float]]]:
    """Per-sample [(class, prob)], best first."""
    probs = softmax(logits)
    idx = np.argsort(-probs, axis=-1)[:, :k]
    return [[(int(i), float(probs[n, i])) for i in idx[n]]
            for n in range(logits.shape[0])]


@dataclasses.dataclass
class InferenceResult:
    logits: np.ndarray
    predictions: np.ndarray
    top5: List[List[Tuple[int, float]]]
    latency_s: float

    @property
    def images_per_s(self) -> float:
        n = self.logits.shape[0]
        return n / self.latency_s if self.latency_s else 0.0


@dataclasses.dataclass
class BenchmarkResult:
    """Median time of one forward on ``device`` (CUDA events on a card,
    the host clock on the CPU)."""

    device: str
    batch: int
    latency_s: float

    @property
    def images_per_s(self) -> float:
        return self.batch / self.latency_s


@dataclasses.dataclass
class StreamResult:
    """``stream`` output: the whole stream's logits and labels, and the
    throughput of the batches after the first.  ``labels`` is None when
    the loader has none."""

    logits: np.ndarray
    predictions: np.ndarray
    labels: Optional[np.ndarray]
    latency_s: float
    images_per_s: float

    @property
    def accuracy(self) -> float:
        if self.labels is None:
            raise ValueError(
                "stream ran without labels; accuracy is undefined")
        return float((self.predictions == self.labels).mean())


class QuantizingLoader:
    """Batches of fp32 NCHW ``images`` quantized on the host with the
    model's input scale (``quantize_input``), in order and round again:
    ``next()`` returns (int8 [batch, C, H, W], labels or None)."""

    def __init__(self, images: np.ndarray, s_input: float, batch: int,
                 labels: Optional[np.ndarray] = None):
        if batch < 1 or batch > len(images):
            raise ValueError(f"batch {batch} not in [1, {len(images)}]")
        self.images = np.asarray(images, np.float32)
        self.labels = None if labels is None else np.asarray(labels)
        self.s_input, self.batch = float(s_input), int(batch)
        self.has_labels = labels is not None
        self._pos = 0

    def next(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        if self._pos + self.batch > len(self.images):
            self._pos = 0
        sl = slice(self._pos, self._pos + self.batch)
        self._pos += self.batch
        q = quantize_input(torch.from_numpy(self.images[sl]), self.s_input)
        return (q.numpy(),
                None if self.labels is None else self.labels[sl])


class InferenceEngine:
    """Upload a quantized ``ResNet18Int8`` (any depth of the family) or
    ``MNISTCNNInt8`` to ``device`` once and run batched int8 inference on
    it many times.  ``stem_fused`` goes to the ResNet module: False serves
    the ImageNet stem through the space-to-depth route (K6, K2) instead of
    the fused stem (see ``ResNet18Int8Module``)."""

    def __init__(self, model: Union[ResNet18Int8, MNISTCNNInt8],
                 device="cuda", stem_fused: bool = True):
        self.device = resolve_device(device)
        self.model = model
        if isinstance(model, MNISTCNNInt8):
            self.module = MNISTCNNInt8Module(model, self.device).eval()
        else:
            self.module = ResNet18Int8Module(
                model, self.device, stem_fused=stem_fused).eval()

    def get_model_sparsity(self) -> Dict[str, float]:
        """Block sparsity of each layer that carries BSR weights."""
        return self.model.sparsity_report()

    def _input(self, x: np.ndarray) -> torch.Tensor:
        if x.ndim != 4:
            raise ValueError(f"expected NCHW input, got shape {x.shape}")
        return torch.from_numpy(
            np.ascontiguousarray(x, np.float32)).to(self.device)

    def run_inference(self, x: np.ndarray, k: int = 5) -> InferenceResult:
        """Forward one batch of fp32 NCHW images; latency includes the
        copies to and from the device."""
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits = self.module(self._input(x)).cpu().numpy()
        dt = time.perf_counter() - t0
        return InferenceResult(
            logits=logits, predictions=logits.argmax(axis=-1),
            top5=top_k(logits, k=min(k, logits.shape[-1])), latency_s=dt)

    def _upload_int8(self, x: np.ndarray) -> torch.Tensor:
        """An int8 NCHW batch to the device: from pinned memory, without
        blocking the host, on a card."""
        if x.ndim != 4 or x.dtype != np.int8:
            raise ValueError(
                f"stream takes int8 NCHW batches quantized with the "
                f"model's s_input, got {x.dtype} of shape {x.shape}")
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def stream(self, loader, n_batches: int) -> StreamResult:
        """Serve ``n_batches`` int8 batches from ``loader`` (``next()`` ->
        (int8 NCHW batch, labels); ``has_labels``), each uploaded and
        queued without waiting for the one before.  The first batch runs
        outside the clock; ``images_per_s`` covers the rest (the first
        batch again when ``n_batches`` is 1), timed by CUDA events on a
        card and the host clock on the CPU."""
        if n_batches < 1:
            raise ValueError(f"n_batches={n_batches} < 1")
        has_labels = getattr(loader, "has_labels", True)
        cuda = self.device.type == "cuda"
        with torch.inference_mode():
            x0, y0 = loader.next()
            outs, labels = [self.module(self._upload_int8(x0))], [y0]
            if cuda:
                torch.cuda.synchronize(self.device)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            if n_batches == 1:
                self.module(self._upload_int8(x0))
                timed_images = x0.shape[0]
            else:
                for _ in range(n_batches - 1):
                    x, y = loader.next()
                    outs.append(self.module(self._upload_int8(x)))
                    labels.append(y)
                timed_images = sum(o.shape[0] for o in outs[1:])
            if cuda:
                end.record()
                end.synchronize()
                dt = start.elapsed_time(end) / 1e3
            else:
                dt = time.perf_counter() - t0
            logits = torch.cat(outs).cpu().numpy()
        return StreamResult(
            logits=logits, predictions=logits.argmax(axis=-1),
            labels=np.concatenate(labels) if has_labels else None,
            latency_s=dt, images_per_s=timed_images / dt)

    def benchmark(self, x: np.ndarray, iters: int = 10) -> BenchmarkResult:
        """Median steady-state time of one forward, input already on the
        device, after one warm-up forward."""
        with torch.inference_mode():
            xt = self._input(x)
            self.module(xt)
            times = []
            for _ in range(iters):
                if self.device.type == "cuda":
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    self.module(xt)
                    end.record()
                    end.synchronize()
                    times.append(start.elapsed_time(end) / 1e3)
                else:
                    t0 = time.perf_counter()
                    self.module(xt)
                    times.append(time.perf_counter() - t0)
        name = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "cpu")
        return BenchmarkResult(device=name, batch=x.shape[0],
                               latency_s=statistics.median(times))

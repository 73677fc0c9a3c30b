"""Inference engine: load a quantized model once, serve batches.

Counterpart of ``resnet_accel_tpu/runtime/engine.py`` (``run_inference``,
``benchmark``, ``stream``, ``verify_accuracy``, ``profile``,
``get_model_sparsity``, the typed errors and the timeout,
``preprocess_imagenet``, ``preprocess_mnist``, ``softmax``, ``top_k``) on an
explicit PyTorch device, for the INT8 ResNet family (ResNet-18/34/50/101/
152, dense or block-sparse) and the MNIST CNN.  ``stream`` takes int8
batches from the native ``BatchLoader`` (``resnet_accel_tpu_torch.native``,
which writes them straight into the engine's pinned buffers) or from any
loader whose ``next()`` returns them as numpy, such as
``QuantizingLoader``, the plain host path the native loader is held
against.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from resnet_accel_tpu_torch.models.mnist_cnn import (MNIST_MEAN, MNIST_STD,
                                                     MNISTCNNInt8,
                                                     MNISTCNNInt8Module)
from resnet_accel_tpu_torch.models.resnet18 import (ResNet18Int8,
                                                    ResNet18Int8Module)
from resnet_accel_tpu_torch.native import BatchLoader
from resnet_accel_tpu_torch.ops.epilogue import quantize_input
from resnet_accel_tpu_torch.runtime.backend import resolve_device
from resnet_accel_tpu_torch.runtime.perf import (LayerProfiler, PerfMetrics,
                                                 median_time_s)
from resnet_accel_tpu_torch.runtime.profile import (profile_resnet18,
                                                    profile_table)
from resnet_accel_tpu_torch.runtime.xprof import scope


class AccelErrorCode(enum.Enum):
    """Typed error codes (the reference driver's AcceleratorError)."""

    INVALID_CONFIG = "invalid_config"
    TIMEOUT = "timeout"
    BACKEND_UNAVAILABLE = "backend_unavailable"
    MODEL_NOT_LOADED = "model_not_loaded"


class AcceleratorError(RuntimeError):
    def __init__(self, code: AccelErrorCode, msg: str):
        super().__init__(f"[{code.value}] {msg}")
        self.code = code

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
    ``next()`` returns (int8 [batch, C, H, W], labels or None).  The plain
    host path, in the calling thread, that the native ``BatchLoader`` is
    held against."""

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


class _StagingRing:
    """The host buffers batches pass through on their way to the device:
    ``depth`` of them, of ``dtype``, pinned on a card, used in turn.  After
    each upload an event is recorded on the current stream, and a buffer
    is handed out again only once the event of its last upload has fired,
    so that nothing overwrites bytes a copy is still reading; while a
    profiler records, that wait is the span ``engine.ring_wait``."""

    def __init__(self, device: torch.device, dtype: torch.dtype,
                 depth: int):
        if depth < 1:
            raise ValueError(f"depth {depth} < 1")
        self.device, self.dtype = device, dtype
        self.bufs: List[Optional[torch.Tensor]] = [None] * depth
        self.events: List[Optional[torch.cuda.Event]] = [None] * depth
        self.i = 0

    def buffer(self, shape) -> torch.Tensor:
        """The next buffer, of ``shape``, free to fill."""
        i = self.i
        if self.events[i] is not None:
            with scope("engine.ring_wait"):
                self.events[i].synchronize()
        buf = self.bufs[i]
        if buf is None or tuple(buf.shape) != tuple(shape):
            buf = torch.empty(shape, dtype=self.dtype,
                              pin_memory=self.device.type == "cuda")
            self.bufs[i] = buf
        return buf

    def upload(self) -> torch.Tensor:
        """The buffer just filled, copied to the device without blocking
        the host (on the CPU, the buffer itself); the ring moves on."""
        i = self.i
        self.i = (i + 1) % len(self.bufs)
        if self.device.type != "cuda":
            return self.bufs[i]
        x = self.bufs[i].to(self.device, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self.events[i] = ev
        return x


class InferenceEngine:
    """Upload a quantized ``ResNet18Int8`` (any depth of the family) or
    ``MNISTCNNInt8`` to ``device`` once and run batched int8 inference on
    it many times.  ``stem_fused`` goes to the ResNet module: False serves
    the ImageNet stem through the space-to-depth route (K6, K2) instead of
    the fused stem (see ``ResNet18Int8Module``).  A call that takes longer
    than ``timeout_s`` raises ``AcceleratorError`` (``TIMEOUT``)."""

    def __init__(self, model: Union[ResNet18Int8, MNISTCNNInt8],
                 device="cuda", stem_fused: bool = True,
                 timeout_s: float = 300.0):
        self.device = resolve_device(device)
        self.model = model
        self.timeout_s = timeout_s
        if isinstance(model, MNISTCNNInt8):
            self.module = MNISTCNNInt8Module(model, self.device).eval()
        else:
            self.module = ResNet18Int8Module(
                model, self.device, stem_fused=stem_fused).eval()
        self.profiler = LayerProfiler()
        # fp32 batches for run_inference and benchmark, which wait for
        # their result, through one buffer; stream's int8 batches through
        # two, one filling while the other is copied
        self._fp32_ring = _StagingRing(self.device, torch.float32, depth=1)
        self._int8_ring = _StagingRing(self.device, torch.int8, depth=2)

    def get_model_sparsity(self) -> Dict[str, float]:
        """Block sparsity of each layer that carries BSR weights."""
        return self.model.sparsity_report()

    def _input(self, x: np.ndarray) -> torch.Tensor:
        """An fp32 NCHW batch on the device, through a pinned buffer on a
        card (on an H100 several times faster for a batch of 128 at 224 x
        224 than a copy straight from pageable memory: ``chip_smoke.py``
        phase 24, ``PERF.md`` section 5)."""
        if x.ndim != 4:
            raise AcceleratorError(
                AccelErrorCode.INVALID_CONFIG,
                f"expected NCHW input, got shape {x.shape}")
        self._fp32_ring.buffer(x.shape).copy_(torch.from_numpy(
            np.ascontiguousarray(x, np.float32)))
        return self._fp32_ring.upload()

    def _host(self, out: torch.Tensor) -> np.ndarray:
        """``out`` copied to the host; a device failure that surfaces at
        this synchronize raises ``BACKEND_UNAVAILABLE``."""
        try:
            return out.cpu().numpy()
        except RuntimeError as e:
            raise AcceleratorError(AccelErrorCode.BACKEND_UNAVAILABLE,
                                   str(e)) from e

    def run_inference(self, x: np.ndarray, k: int = 5) -> InferenceResult:
        """Forward one batch of fp32 NCHW images; latency includes the
        copies to and from the device."""
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits = self._host(self.module(self._input(x)))
        dt = time.perf_counter() - t0
        if dt > self.timeout_s:
            raise AcceleratorError(
                AccelErrorCode.TIMEOUT,
                f"inference took {dt:.3f}s > timeout {self.timeout_s}s")
        return InferenceResult(
            logits=logits, predictions=logits.argmax(axis=-1),
            top5=top_k(logits, k=min(k, logits.shape[-1])), latency_s=dt)

    def verify_accuracy(self, x: np.ndarray, labels: Sequence[int]) -> float:
        """Top-1 accuracy over a labelled batch."""
        res = self.run_inference(x)
        return float((res.predictions == np.asarray(labels)).mean())

    @staticmethod
    def _fill(loader, ring: _StagingRing):
        """The loader's next batch in the ring's next buffer, in the span
        ``engine.fill``: the native loader writes it there itself; another
        loader's int8 NCHW numpy batch is copied in."""
        with scope("engine.fill"):
            if isinstance(loader, BatchLoader):
                if len(loader.item_shape) != 3:
                    raise ValueError(f"stream takes NCHW batches; the "
                                     f"loader's items are "
                                     f"{loader.item_shape}")
                _, y = loader.next(out=ring.buffer(
                    (loader.batch,) + tuple(loader.item_shape)))
                return y
            x, y = loader.next()
            if x.ndim != 4 or x.dtype != np.int8:
                raise ValueError(
                    f"stream takes int8 NCHW batches quantized with the "
                    f"model's s_input, got {x.dtype} of shape {x.shape}")
            ring.buffer(x.shape).copy_(torch.from_numpy(x))
            return y

    def stream(self, loader, n_batches: int) -> StreamResult:
        """Serve ``n_batches`` int8 batches from ``loader`` (a native
        ``BatchLoader`` built with the model's ``s_input``, or any object
        whose ``next()`` returns (int8 NCHW numpy batch, labels); its
        ``has_labels``), each through the staging ring to the device and
        queued without waiting for the one before.  The first batch runs
        outside the clock; ``images_per_s`` covers the rest (the first
        batch again when ``n_batches`` is 1), timed by CUDA events on a
        card (the start event, recorded behind the first batch's work,
        fires when that work ends) and the host clock on the CPU.  While
        a profiler records, each batch's fill is the span ``engine.fill``
        and the call's end, from the last event's wait to the logits,
        predictions and labels on the host, ``engine.drain``; neither
        holds a layer's scope."""
        if n_batches < 1:
            raise AcceleratorError(AccelErrorCode.INVALID_CONFIG,
                                   f"n_batches={n_batches} < 1")
        has_labels = getattr(loader, "has_labels", True)
        cuda = self.device.type == "cuda"
        ring = self._int8_ring
        with torch.inference_mode():
            labels = [self._fill(loader, ring)]
            x0 = ring.upload()
            outs = [self.module(x0)]
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            if n_batches == 1:
                self.module(x0)
                timed_images = x0.shape[0]
            else:
                for _ in range(n_batches - 1):
                    labels.append(self._fill(loader, ring))
                    outs.append(self.module(ring.upload()))
                timed_images = sum(o.shape[0] for o in outs[1:])
            with scope("engine.drain"):
                if cuda:
                    end.record()
                    try:
                        end.synchronize()
                    except RuntimeError as e:
                        raise AcceleratorError(
                            AccelErrorCode.BACKEND_UNAVAILABLE,
                            str(e)) from e
                    dt = start.elapsed_time(end) / 1e3
                else:
                    dt = time.perf_counter() - t0
                logits = self._host(torch.cat(outs))
                predictions = logits.argmax(axis=-1)
                labels = np.concatenate(labels) if has_labels else None
        return StreamResult(
            logits=logits, predictions=predictions, labels=labels,
            latency_s=dt, images_per_s=timed_images / dt)

    def _forward_work(self, x_shape) -> Tuple[int, int]:
        """Operations and bytes of one ResNet forward at ``x_shape``
        (``profile_resnet18``'s sums); (0, 0) for the MNIST CNN."""
        if not isinstance(self.model, ResNet18Int8):
            return 0, 0
        prof = profile_resnet18(self.model, input_hw=x_shape[-1],
                                batch=x_shape[0])
        return (sum(r.total_ops for r in prof.records),
                sum(r.bytes_accessed for r in prof.records))

    def benchmark(self, x: np.ndarray, iters: int = 10) -> BenchmarkResult:
        """Median steady-state time of one forward, input already on the
        device, after one warm-up forward (CUDA events on a card, the host
        clock on the CPU).  Adds a ``forward`` row to ``self.profiler``."""
        with torch.inference_mode():
            xt = self._input(x)
            latency = median_time_s(lambda: self.module(xt), iters,
                                    self.device)
        ops, nbytes = self._forward_work(x.shape)
        self.profiler.add(PerfMetrics(name="forward", latency_s=latency,
                                      total_ops=ops, bytes_accessed=nbytes,
                                      iters=iters))
        name = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "cpu")
        return BenchmarkResult(device=name, batch=x.shape[0],
                               latency_s=latency)

    def profile(self, x: np.ndarray, iters: int = 5) -> str:
        """Per-layer table: the measured forward (``benchmark``)
        distributed over the layers' roofline times
        (``runtime.profile``)."""
        m = self.benchmark(x, iters=iters)
        self.profiler = profile_resnet18(
            self.model, input_hw=x.shape[-1], batch=x.shape[0],
            measured_latency_s=m.latency_s)
        return profile_table(self.profiler)

"""cardbench: the benchmark of the PyTorch/CUDA port
``resnet_accel_tpu_torch`` on NVIDIA cards.  Its entry is
``python3 -m cardbench.run`` (see ``cardbench/run.py``); ``BENCHMARK.json``
at the checkout's root names its cells, configurations and metrics."""

"""Traffic drivers, one module for each ``driver`` a traffic file names.

A driver gives ``library(model_mod, config, traffic, seed, program,
device)`` (the inputs the window serves, made before it),
``warmup(engine, lib, traffic)``, ``window(engine, lib, traffic, seconds,
trace, device)``, ``served(window, traffic)`` (the answers attempted),
``end_to_end(window, traffic)`` (its end-to-end metrics by name) and
``check(window, ref, model_mod, config, traffic, seed, device)`` (each
compared number with its limit, and the failed answers).  With a trace
the window carries ``device_events`` (device records alone), ``device_s``
(that slice's host-clock seconds), ``host_events`` (host and device
records, under the scope ``SLICE``), ``device_batches`` and
``host_batches`` (the steps of each slice), ``untraced_batches`` and
``untraced_s``.
"""

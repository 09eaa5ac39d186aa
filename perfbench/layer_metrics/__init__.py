"""The per-layer metrics: each ``<metric>.py`` here is the reader of the
metric of that name in ``BENCHMARK.json``, a ``read(ctx)`` that returns
the number, or None where its cell gave it nothing to read. ``ctx`` holds
the traced window (``perfbench/trace.py``), the units of work it ran
(steps or frames), the card's peaks and what the cell's mode adds."""

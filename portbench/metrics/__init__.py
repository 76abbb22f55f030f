"""The readers of the per-layer metrics, found by the metric's name in
``BENCHMARK.json``: ``read(ctx)`` returns its value, or None where the cell
gave it nothing to read (the harness then leaves it out). A name of a
pattern that ``_read.by_pattern`` knows (``<kernel>_roofline.*``,
``kernel_roofline.*``, ``mfu.*``, ``device_idle.*``) needs no file; any
other metric is a file ``<name>.py`` here that defines ``read``."""

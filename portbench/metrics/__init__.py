"""Per-layer metric readers, one file per kind of metric: a metric
``<kind>.<cells>`` of ``BENCHMARK.json``'s ``per_layer`` is read by
``<kind>.py``, whose ``read(run)`` returns the value, or None where the run
holds nothing to read.  The unit, the layer, the end-to-end metric it
moves and the cells that report it are ``BENCHMARK.json``'s."""

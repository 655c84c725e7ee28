"""One reader per metric (``metrics/<name>.py``, named as in
``BENCHMARK.json``): ``read(ctx)`` returns the metric's value, or None when
the run holds nothing for it to read (the metric is then left out of the
result line). ``ctx`` is the harness's :class:`~pnpbench.harness.Context`."""

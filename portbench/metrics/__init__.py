"""One file a metric, named as in ``BENCHMARK.json``: ``read(ctx)``
returns the number, or None where the run holds nothing to read.
``_roofline.py`` is the yardstick's arithmetic, shared by the shares."""

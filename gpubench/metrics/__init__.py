"""One reader per metric, found by the metric's name in BENCHMARK.json:
``read(run)`` returns the metric's value from a finished run, or None where
the run holds nothing to read it from (the metric is then left out)."""

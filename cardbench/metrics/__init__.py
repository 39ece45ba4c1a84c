"""One reader per metric, found by the metric's name in BENCHMARK.json:
``<name>.py`` defines ``read(record)``, the metric's value from the
run's record (run.py), or None when the run holds nothing to read."""

"""One reader per per-layer metric family, found by the metric name's part
before its first dot: ``read(name, run)`` returns the value, or None where
the run holds nothing to read it from (the harness then leaves it out)."""

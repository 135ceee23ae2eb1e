"""Metric readers, one module per metric family: ``read(record)``
returns the metric's value from a run's record, or None where the record
holds nothing to read (the harness then leaves the metric out)."""

"""One reader a per-layer metric: ``<name>.py`` holds ``read(record)``,
which returns the metric's value from a traced run's record, or None
where the record holds nothing to read."""

"""Per-layer metric readers, one file a metric: ``read(readings)`` returns
the value, or None when the traced window holds nothing to read."""

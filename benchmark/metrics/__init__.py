"""Per-layer metric readers, one module a metric, found by name."""

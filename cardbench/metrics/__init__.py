"""The per-layer metrics, one reader a metric: `read(trace)` returns the
value, or None where the trace holds nothing to read."""

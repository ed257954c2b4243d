"""One reader module per per-layer metric, found by the metric's name."""

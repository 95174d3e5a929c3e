"""Host utilities: configuration, metrics, tracing, resource usage and the slot-deadline guard."""

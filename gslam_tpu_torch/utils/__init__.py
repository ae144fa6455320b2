"""Host utilities: device probes."""

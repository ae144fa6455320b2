"""Host utilities: device probes, the section timer and logging."""

"""Host utilities of the port (process gauges)."""

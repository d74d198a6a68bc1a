"""Host utilities of the port (config parsing, weight carry-over)."""

"""Host utilities of the port: the stall watchdog and the debug visualizers."""

"""Host utilities of the port (the stall watchdog)."""

"""Host-side utilities: the logger and the serving meters."""

"""Host-side utilities: the logger, the serving meters, the run config
and the training health monitor."""

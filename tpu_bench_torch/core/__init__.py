"""Run configuration, timing, validation and log reporting."""

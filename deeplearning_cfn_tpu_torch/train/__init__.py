"""Trainer, data, schedules and metrics of the port."""

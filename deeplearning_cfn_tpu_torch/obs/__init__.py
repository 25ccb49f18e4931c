"""Observability of the port: the flight recorder and the heartbeater."""

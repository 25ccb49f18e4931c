"""Example trainers of the port."""

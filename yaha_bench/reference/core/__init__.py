"""Frozen copy of the port's core/ in its pure-Python mode."""

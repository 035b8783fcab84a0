"""Frozen copy of the program's module of this name (see each file)."""

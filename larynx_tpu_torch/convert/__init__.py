"""Checkpoint formats the port reads: the native ``.npz`` archive."""

"""Utilities of the port (timing on the card)."""

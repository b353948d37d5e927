"""Measurement scripts for the card (not on any path of the port)."""

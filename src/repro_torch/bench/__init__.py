"""Measurement scripts for the card, and the paper benches' scaling
(not on any path of the port)."""

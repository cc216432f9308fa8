"""Measurement scripts for the card (run them with ``python -m``)."""

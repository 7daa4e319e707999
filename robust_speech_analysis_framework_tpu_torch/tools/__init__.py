"""Measurement scripts for the card that are no part of the port's path."""

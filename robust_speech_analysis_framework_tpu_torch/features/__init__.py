"""Feature extractors."""

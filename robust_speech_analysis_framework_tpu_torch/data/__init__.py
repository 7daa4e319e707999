"""Host-side data handling (numpy)."""

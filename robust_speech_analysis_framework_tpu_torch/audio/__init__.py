"""Host-side audio IO and resampling (numpy)."""

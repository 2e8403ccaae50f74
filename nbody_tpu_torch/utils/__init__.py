"""Host-side utilities (numpy only)."""

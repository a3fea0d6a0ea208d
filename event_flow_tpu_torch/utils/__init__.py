"""Weight conversion helpers."""

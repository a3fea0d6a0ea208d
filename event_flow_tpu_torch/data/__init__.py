"""Event augmentation and the in-memory event stream."""

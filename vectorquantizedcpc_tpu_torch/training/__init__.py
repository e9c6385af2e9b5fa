"""CPC encoder training."""

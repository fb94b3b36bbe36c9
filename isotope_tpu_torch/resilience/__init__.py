"""Host-side resilience helpers of the port (chaos jitter)."""

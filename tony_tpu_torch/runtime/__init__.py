"""Host-side runtime helpers of the port (phase timing, metrics)."""

"""Configuration keys the port reads (copies of ``tony_tpu/conf``'s)."""

"""The flagship decoder LM's serving path in PyTorch: transformer,
KV-cache decoding, continuous batching, and weight conversion."""

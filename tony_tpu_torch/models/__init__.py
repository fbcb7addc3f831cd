"""The flagship decoder LM in PyTorch: transformer, KV-cache decoding,
continuous batching, weight conversion, and single-device training (train
step, loop, checkpoints)."""

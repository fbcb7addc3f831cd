"""Training input of the port: device-prefetched batches."""

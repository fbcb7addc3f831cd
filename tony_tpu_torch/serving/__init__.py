"""The port's serving host: the TONYS1 streaming protocol, its server
over a :class:`~tony_tpu_torch.models.serve.ServeEngine`, the
stdlib-only streaming client, and the server's prefix and weights lanes
(``prefix``, ``kvship``, ``blobcodec``, ``weightstore``) — copies of
``tony_tpu/serving``'s modules, on the same wire."""

"""The port's serving host: the TONYS1 streaming protocol, its server
over a :class:`~tony_tpu_torch.models.serve.ServeEngine`, and the
stdlib-only streaming client (copies of ``tony_tpu/serving``'s
``protocol``, ``server`` and ``client``, on the same wire)."""

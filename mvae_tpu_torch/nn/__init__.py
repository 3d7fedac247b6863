"""Layers of the port: NCHW activations and the reference's OIHW weights,
so the reference `state_dict` keys load with `strict=True`."""

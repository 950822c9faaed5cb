from repro_torch.roofline import model, trace  # noqa: F401

from repro_torch.models.model import forward, init_params  # noqa: F401

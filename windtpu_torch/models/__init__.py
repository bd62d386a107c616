from windtpu_torch.models.generator import Generator  # noqa: F401

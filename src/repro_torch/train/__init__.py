from repro_torch.train.trainer import Trainer  # noqa: F401

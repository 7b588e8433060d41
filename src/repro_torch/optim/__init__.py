from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adam, apply_updates, from_name, momentum, sgd)

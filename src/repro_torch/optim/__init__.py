from repro_torch.optim.optimizers import (  # noqa: F401
    CHUNK, Optimizer, adam, adamw, apply_updates, clip_by_global_norm,
    clip_scale, from_name, global_norm, momentum, sgd)
from repro_torch.optim.schedules import (  # noqa: F401
    constant, cosine_decay, linear_warmup, warmup_cosine)

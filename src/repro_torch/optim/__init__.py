from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adamw, adafactor, lion, sgd, clip_by_global_norm,
    cosine_schedule, chain_clip,
)

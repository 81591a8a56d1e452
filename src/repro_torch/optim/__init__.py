from repro_torch.optim.optimizers import (  # noqa: F401
    make_optimizer, opt_state_defs,
)
from repro_torch.optim.schedules import lr_schedule  # noqa: F401

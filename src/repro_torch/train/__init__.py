from repro_torch.train.optimizer import (OptConfig, adamw_init,  # noqa: F401
                                         adamw_update, global_norm)
from repro_torch.train.schedules import (SCHEDULES, constant,  # noqa: F401
                                         warmup_cosine, wsd)

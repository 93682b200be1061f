"""The storage tier of the port: SSD pricing and geometry planning,
KV-offload planning, the token pipeline and the checkpoint engine — the
JAX package's ``repro.storage``, with ``place_on_device`` in place of
``place_on_mesh``."""

from repro_torch.storage.checkpoint import (CheckpointEngine,  # noqa: F401
                                            place_on_device)
from repro_torch.storage.datapipe import (FileBackedTokens, PipeState,  # noqa: F401
                                          StripedTokenStore, SyntheticTokens,
                                          pipeline_io_requests,
                                          pipeline_io_trace)
from repro_torch.storage.kvoffload import plan_kv_offload  # noqa: F401
from repro_torch.storage.ssd_model import (compare_interfaces,  # noqa: F401
                                           estimate_io, plan_geometry)

"""Distributed services (counterpart of ``paddle_tpu/distributed/``):
the elastic data-dispatch master and the JSON-lines wire substrate the
serving frontend runs on."""

from paddle_tpu_torch.distributed.master import (  # noqa: F401
    MasterClient,
    MasterService,
    Task,
    task_reader,
)

"""Model builders (counterpart of ``paddle_tpu/models/``): each model
module exposes ``build(...) -> (loss, feeds, extras)``. ``ssd`` waits for
the detection ops (ROADMAP A4)."""

from paddle_tpu_torch.models import mnist  # noqa: F401
from paddle_tpu_torch.models import vgg  # noqa: F401
from paddle_tpu_torch.models import resnet  # noqa: F401
from paddle_tpu_torch.models import stacked_lstm  # noqa: F401
from paddle_tpu_torch.models import transformer  # noqa: F401
from paddle_tpu_torch.models import switch_transformer  # noqa: F401
from paddle_tpu_torch.models import machine_translation  # noqa: F401
from paddle_tpu_torch.models import se_resnext  # noqa: F401
from paddle_tpu_torch.models import googlenet  # noqa: F401
from paddle_tpu_torch.models import alexnet  # noqa: F401

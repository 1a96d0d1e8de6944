"""Models of the port. Importing the package registers every model."""

from deepvision_tpu_torch.models import alexnet  # noqa: F401  (registers)
from deepvision_tpu_torch.models import centernet  # noqa: F401  (registers)
from deepvision_tpu_torch.models import gan  # noqa: F401  (registers)
from deepvision_tpu_torch.models import hourglass  # noqa: F401  (registers)
from deepvision_tpu_torch.models import inception  # noqa: F401  (registers)
from deepvision_tpu_torch.models import lenet  # noqa: F401  (registers)
from deepvision_tpu_torch.models import mobilenet  # noqa: F401  (registers)
from deepvision_tpu_torch.models import resnet  # noqa: F401  (registers)
from deepvision_tpu_torch.models import shufflenet  # noqa: F401  (registers)
from deepvision_tpu_torch.models import vgg  # noqa: F401  (registers)
from deepvision_tpu_torch.models import yolo  # noqa: F401  (registers)
from deepvision_tpu_torch.models.registry import create_model, get_model

__all__ = ["create_model", "get_model"]

"""paddle.vision of the port (paddle_tpu/vision): ``models`` (LeNet,
ResNet, VGG, MobileNet v1 / v2), ``transforms`` (numpy, host side),
``datasets`` (local files, synthetic MNIST and CIFAR where the files are
absent) and ``ops``."""
from . import datasets  # noqa: F401
from . import models  # noqa: F401
from . import ops  # noqa: F401
from . import transforms  # noqa: F401
from .models import LeNet  # noqa: F401

"""Image pipeline package: classification (image) + detection surfaces
(counterpart of ``mxnet_tpu/image/``; import-location parity with the
reference python/mxnet/image package)."""
from . import detection  # noqa: F401
from . import image  # noqa: F401
from .detection import *  # noqa: F401,F403
from .image import *  # noqa: F401,F403

# the reference also exposes the detection module as mx.image.det
det = detection

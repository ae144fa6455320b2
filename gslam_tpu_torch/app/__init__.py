"""Application layer (counterpart of ``gslam_tpu/app``): the Svar-style
config, the component registries, the host event bus, the CLI
(:mod:`gslam_tpu_torch.app.cli`) and the HTML viewer
(:mod:`gslam_tpu_torch.app.webviz`).

dlopen plugins become registry entries; the pub/sub bus is host wiring
only (dataset -> SLAM -> eval -> viz).  Importing this package loads no
kernel: the CUDA sources are built on first launch.
"""

from gslam_tpu_torch.app.config import Svar, parse_args, svar  # noqa: F401
from gslam_tpu_torch.app.registry import (  # noqa: F401
    APPS, DATASETS, ESTIMATORS, OPTIMIZERS, SLAMS, Registry,
)
from gslam_tpu_torch.app.messenger import (  # noqa: F401
    Messenger, Publisher, Subscriber, messenger,
)

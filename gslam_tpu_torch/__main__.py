"""``python -m gslam_tpu_torch <app> ...``: the gslam binary analog
(:mod:`gslam_tpu_torch.app.cli`)."""

import sys

from gslam_tpu_torch.app.cli import main

if __name__ == "__main__":
    sys.exit(main())

"""``python -m gpusolve_tpu_torch <config>`` — CLI entry (see cli.py)."""

import sys

from gpusolve_tpu_torch.cli import main

sys.exit(main())
